"""Public API of the PyTorch port."""
