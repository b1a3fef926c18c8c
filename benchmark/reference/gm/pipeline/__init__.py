# Frozen copy of glimmer_mg_torch/pipeline/__init__.py at commit ab5a5d3.
"""Pipeline front ends of the PyTorch port."""
