"""File readers and writers of the PyTorch port (copies of glimmer_mg_tpu.io)."""
