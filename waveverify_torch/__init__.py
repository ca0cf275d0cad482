"""waveverify_torch: the PyTorch / CUDA port of waveverify_tpu.

Serving (embed, detect, locate), the robustness sweep and GAN training on
an NVIDIA H100. The SEANet residual-block chains run in a hand-written CUDA
kernel (``csrc/resblock_chain.cu``); the rest is PyTorch. The JAX package ``waveverify_tpu`` is the reference this port is
tested against; nothing here imports it or JAX.
"""

from waveverify_torch.api.core import WaveVerify
from waveverify_torch.api.watermark_id import WatermarkID

__all__ = ["WaveVerify", "WatermarkID"]
