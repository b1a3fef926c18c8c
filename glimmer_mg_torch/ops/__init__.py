"""Tensor operations and kernel wrappers of the PyTorch port."""
