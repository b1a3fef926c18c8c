# Frozen copy of glimmer_mg_torch/models/__init__.py at commit ab5a5d3.
"""Model formats of the PyTorch port (copies of glimmer_mg_tpu.models)."""
