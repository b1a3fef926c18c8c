"""Read classification of the PyTorch port (Phymm bank scoring)."""
