"""Operations and bytes of AudioSeal's residual blocks, from shapes alone:
the yardstick of ``resblock_roofline``.

- :func:`resblock_cost`: FLOP and bytes of one of audiocraft's dense
  residual blocks over ``[B, C, T]``: the k-tap conv from C to C / 2 and
  the 1x1 conv back (``2 (C / 2) k C + 2 C (C / 2)`` FLOP a sample, 4 C^2 at
  k = 3), the block's input read once, its output written once, the
  weights and biases read once. The ELUs, biases and the skip's add are
  left out of the FLOP, as FlopCounterMode leaves them out.
- :func:`resblock_shapes`: every block an embed+detect call runs (the
  generator's encoder and decoder, the detector's encoder), as (samples,
  width); :func:`resblock_bound_s` the least time the card could take for
  them, block by block.

The count is the algorithm's, the same whatever computes the blocks.
"""

from __future__ import annotations

from typing import List, Tuple

from counts import roofline_s
from counts_audioseal import frames


def resblock_cost(b: int, t: int, c: int, k: int = 3, compress: int = 2,
                  itemsize: int = 4) -> Tuple[int, int]:
    """(FLOP, bytes) of one block of width ``c`` with a ``k``-tap first conv
    over ``t`` samples of a batch of ``b``."""
    hidden = c // compress
    flops = 2 * b * t * (hidden * c * k + c * hidden)
    weights = hidden * c * k + hidden + c * hidden + c
    return flops, itemsize * (2 * b * t * c + weights)


def _encoder(cfg: dict, t: int) -> List[Tuple[int, int]]:
    out, c = [], cfg["n_filters"]
    for ratio in reversed(cfg["ratios"]):
        out += [(t, c)] * cfg["n_residual_layers"]
        t, c = -(-t // ratio), 2 * c
    return out


def _decoder(cfg: dict, t: int) -> List[Tuple[int, int]]:
    out, f = [], frames(cfg, t)
    c = cfg["n_filters"] * 2 ** len(cfg["ratios"])
    for ratio in cfg["ratios"]:
        f, c = f * ratio, c // 2
        out += [(f, c)] * cfg["n_residual_layers"]
    return out


def resblock_shapes(cfg: dict, t: int) -> List[Tuple[int, int]]:
    """(samples, width) of each residual block of one embed+detect call of
    ``t``-sample clips, for the config ``cfg`` (the cards' ``seanet``
    keys): the generator's encoder, its decoder, the detector's encoder."""
    return _encoder(cfg, t) + _decoder(cfg, t) + _encoder(cfg, t)


def resblock_bound_s(cfg: dict, b: int, t: int) -> float:
    """The least time the card could take for a call's residual blocks:
    each block's larger of its FLOP over the TF32 peak and its bytes over
    the memory bandwidth (:func:`counts.roofline_s`), summed."""
    k, compress = cfg["residual_kernel_size"], cfg["compress"]
    return sum(roofline_s(*resblock_cost(b, tt, c, k, compress))
               for tt, c in resblock_shapes(cfg, t))
