"""Pipeline front ends of the PyTorch port."""
