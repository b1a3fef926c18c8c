"""Engine layer of the PyTorch port."""
