# Frozen copy of glimmer_mg_torch/io/__init__.py at commit ab5a5d3.
"""File readers and writers of the PyTorch port (copies of glimmer_mg_tpu.io)."""
