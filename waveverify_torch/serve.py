"""The serving programs (embed+detect, the counterpart of ``bench.py``'s
``_build``, and the locator's presence probabilities), and the device and
precision rules every entry point shares.

dtype rules, as in the JAX package: the network activations run in
``act_dtype``; the clean audio and the watermarked sum stay f32 (the
residual is upcast before the add), and decisions come from f32 logits.
"""

from __future__ import annotations

import logging
from typing import Tuple, Union

import torch

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device`` for an entry point; a CUDA device without a card
    raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' to "
                           "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_dtype(name: str) -> torch.dtype:
    """``"float32"`` or ``"bfloat16"`` -> the torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"serve dtype must be one of {sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


def strict_f32() -> None:
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls, so f32 mode
    computes in f32 (PyTorch's default lets cuDNN use TF32). This is a
    process-wide PyTorch setting."""
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        logger.info("f32 serving: TF32 disabled for cuDNN and cuBLAS")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def set_conv_precision(name: str) -> None:
    """``highest``: f32 convolutions and matmuls in f32 (TF32 off for cuDNN
    and cuBLAS); ``high`` / ``default``: TF32 allowed for both. A
    process-wide PyTorch setting; the resblock-chain kernel ignores it."""
    if name == "highest":
        strict_f32()
    elif name in ("high", "default"):
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    else:
        raise ValueError(f"unknown conv precision {name!r}")


@torch.no_grad()
def embed_detect(models, audio: torch.Tensor, msg: torch.Tensor,
                 act_dtype: str = "float32"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """audio ``[B, T]`` f32, msg ``[B, nbits]`` -> (watermarked ``[B, T]``
    f32, bit probabilities ``[B, nbits]`` f32). ``models`` is a
    :class:`waveverify_torch.models.WatermarkModels`; its parameters are the
    program's weights."""
    act = resolve_dtype(act_dtype)
    residual = models.apply_generator(audio.to(act), msg.to(act))
    watermarked = residual.float() + audio
    logits = models.apply_detector(watermarked.to(act))
    bit_probs = torch.mean(torch.sigmoid(logits.float()), dim=1)
    return watermarked, bit_probs


@torch.no_grad()
def locate_probs(models, audio: torch.Tensor,
                 act_dtype: str = "float32") -> torch.Tensor:
    """audio ``[B, T]`` f32 -> per-sample watermark-presence probabilities
    ``[B, T]`` f32: sigmoid of the locator's f32 logits."""
    logits = models.apply_locator(audio.to(resolve_dtype(act_dtype)))
    return torch.sigmoid(logits.float())
