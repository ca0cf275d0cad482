"""Hand-written kernels of the PyTorch port."""
