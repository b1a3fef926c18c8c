"""Model formats of the PyTorch port (copies of glimmer_mg_tpu.models)."""
