"""Network building blocks of the PyTorch port."""
