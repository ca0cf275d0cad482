"""Hand-written kernels of the PyTorch port, and the signal processing
(FIR filters, resampling) its effects use."""
