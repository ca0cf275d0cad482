"""Hand-written kernels of the PyTorch port, and the signal processing
(FIR filters, resampling, the STFT, the STDCT / MDCT / PQMF transforms)
its effects, losses and users call."""

from waveverify_torch.ops.transforms import (
    MDCT,
    PQMF,
    STDCT,
    design_prototype_filter,
)

__all__ = ["STDCT", "MDCT", "PQMF", "design_prototype_filter"]
