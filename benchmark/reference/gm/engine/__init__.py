# Frozen copy of glimmer_mg_torch/engine/__init__.py at commit ab5a5d3.
"""Engine layer of the PyTorch port."""
