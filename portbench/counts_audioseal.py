"""Operations and bytes of AudioSeal's recurrences, from shapes alone: the
yardstick of ``lstm_roofline``.

- :func:`lstm_cost`: FLOP and bytes of one LSTM layer over ``[T, B, I]``:
  the two products a frame (``x_t W_ih^T`` and ``h W_hh^T``, ``2 B (I + H)
  4H`` FLOP), the weights and biases read once, the input read once and
  the output written once. The gates' elementwise work is left out, as
  FlopCounterMode leaves it out.
- :func:`lstm_shapes`: every LSTM an embed+detect call runs (the
  generator's encoder and decoder, the detector's encoder), by layer;
  :func:`lstm_bound_s` the least time the card could take for them.

The count is the algorithm's, the same whatever computes the recurrence.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from counts import roofline_s


def lstm_cost(b: int, t: int, i: int, h: int, itemsize: int = 4) -> Tuple[int, int]:
    """(FLOP, bytes) of one LSTM layer from input width ``i`` to hidden
    width ``h`` over ``t`` frames of a batch of ``b``."""
    flops = 2 * b * t * 4 * h * (i + h)
    nbytes = itemsize * (4 * h * (i + h) + 2 * 4 * h + b * t * (i + h))
    return flops, nbytes


def frames(cfg: dict, t: int) -> int:
    """Frames the bottleneck of a clip of ``t`` samples holds."""
    return -(-t // math.prod(cfg["ratios"]))


def lstm_shapes(cfg: dict, t: int) -> List[List[Tuple[int, int, int]]]:
    """[(frames, input width, hidden width) per layer] per LSTM of one
    embed+detect call of ``t``-sample clips, for the config ``cfg`` (the
    cards' ``seanet`` keys)."""
    if not cfg["lstm"]:
        return []
    width = cfg["n_filters"] * 2 ** len(cfg["ratios"])
    one = [(frames(cfg, t), width, width)] * cfg["lstm"]
    return [one, one, one]


def lstm_bound_s(cfg: dict, b: int, t: int) -> float:
    """The least time the card could take for a call's recurrences: each
    LSTM's larger of its FLOP over the TF32 peak and its bytes over the
    memory bandwidth (:func:`counts.roofline_s`), summed."""
    out = 0.0
    for net in lstm_shapes(cfg, t):
        costs = [lstm_cost(b, *layer) for layer in net]
        out += roofline_s(sum(f for f, _ in costs), sum(n for _, n in costs))
    return out
