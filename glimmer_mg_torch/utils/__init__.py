"""Host utilities of the PyTorch port (copies of glimmer_mg_tpu.utils)."""
