# Frozen copy of glimmer_mg_torch/utils/__init__.py at commit ab5a5d3.
"""Host utilities of the PyTorch port (copies of glimmer_mg_tpu.utils)."""
