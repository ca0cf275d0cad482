"""Operations and bytes of the work a cell asks for, from shapes alone: the
yardstick of the roofline and utilization metrics.

- :func:`chain_cost`: FLOP and bytes of one chain of SEANet residual blocks
  (two C x C products and two k-tap depthwise convs per block, each input
  read once and the output written once); the formula of the JAX
  package's cost estimate for its chain kernel.
- :func:`chain_shapes`: every chain a batch of clips runs through the
  generator and the detector of a configuration; :func:`chains_bound_s`
  the least time the card could take for them.
- :func:`count_flop`: the FLOP that ``torch.utils.flop_counter`` counts
  while a function runs (matrix products and convolutions, backward
  included when the function runs one).
- :data:`PEAKS`: the published dense peaks of one NVIDIA H100 SXM.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAKS = {
    "tf32_flop_per_s": 495e12,
    "bf16_flop_per_s": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}


def chain_cost(b: int, t: int, c: int, m: int, itemsize: int, k: int = 5
               ) -> Tuple[int, int]:
    """(FLOP, bytes) of one chain of ``m`` blocks over ``[b, c, t]``."""
    flops = m * 2 * b * t * c * (2 * c + 2 * k)
    nbytes = itemsize * (2 * b * t * c + m * (2 * c * c + 2 * k * c + 2 * c))
    return flops, nbytes


def _encoder_chains(sec: dict, t: int) -> List[Tuple[int, int, int]]:
    out = []
    c = sec["channels_enc"]
    for ratio in reversed(list(sec["strides"])):
        out.append((t, c, sec["n_residual_enc"]))
        t = -(-t // ratio)
        c *= 2
    return out


def chain_shapes(model: dict, t: int, detector: bool = True
                 ) -> List[Tuple[int, int, int]]:
    """(T, C, blocks) of each chain that embedding (and with ``detector``
    detecting) one clip of ``t`` samples runs, generator first."""
    g = model["Generator"]
    hop = math.prod(g["strides"])
    tp = -(-t // hop) * hop
    out = _encoder_chains(g, tp)
    tl = tp // hop
    c = g["channels_dec"] * 2 ** len(g["strides"])
    for ratio in g["strides"]:
        tl *= ratio
        c //= 2
        out.append((tl, c, g["n_residual_dec"]))
    if detector:
        out += _encoder_chains(model["Detector"], t)
    return out


def chains_bound_s(model: dict, b: int, t: int, bf16: bool = False,
                   detector: bool = True) -> float:
    """The least time the card could take for the chains of
    :func:`chain_shapes` at batch ``b``: each chain's :func:`roofline_s`,
    summed (the chains run one after another)."""
    k = model["Generator"]["residual_kernel_size"]
    return sum(roofline_s(*chain_cost(b, tt, c, m, 2 if bf16 else 4, k), bf16)
               for tt, c, m in chain_shapes(model, t, detector))


def roofline_s(flops: float, nbytes: float, bf16: bool = False) -> float:
    """The least time the card could take: the larger of FLOP over the
    tensor-core peak and bytes over the memory bandwidth."""
    peak = PEAKS["bf16_flop_per_s" if bf16 else "tf32_flop_per_s"]
    return max(flops / peak, nbytes / PEAKS["hbm_bytes_per_s"])


def count_flop(fn: Callable[[], object]) -> Tuple[object, int]:
    """(``fn()``, the FLOP FlopCounterMode counted while it ran)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        out = fn()
    return out, int(counter.get_total_flops())
