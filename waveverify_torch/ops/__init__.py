"""Hand-written kernels of the PyTorch port, and the signal processing
(FIR filters, resampling, the STFT) its effects and losses use."""
