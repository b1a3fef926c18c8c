"""The benchmark of glimmer_mg_torch on one NVIDIA GPU (``run.py``)."""
