"""Operations and bytes of WavMark's coupling subnets, from shapes alone:
the yardstick of ``inn_roofline``.

- :func:`subnet_cost`: FLOP and bytes of one dense subnet (HiNet's
  ``ResidualDenseBlock_out``) over ``[N, C, H, W]``: five 3x3 convs, conv k
  from ``C + (k - 1) growth`` channels to ``growth`` (to C for conv5), ``2 x
  9 x cin x cout`` FLOP a pixel each; the subnet's input read once, its
  output written once, its weights and biases read once. The LeakyReLUs,
  the concatenations and the biases' adds are left out of the FLOP, as
  FlopCounterMode leaves them out.
- :func:`subnet_shapes`: every subnet an embed+detect call runs (the three
  of each of ``num_layers`` blocks, forward to embed and in reverse to
  decode), as (segments, frames, bins); :func:`inn_bound_s` the least time
  the card could take for them, subnet by subnet.

The count is the algorithm's, the same whatever computes the subnets.
"""

from __future__ import annotations

from typing import List, Tuple

from counts import roofline_s


def subnet_cost(n: int, h: int, w: int, c: int = 2, growth: int = 32,
                itemsize: int = 4) -> Tuple[int, int]:
    """(FLOP, bytes) of one dense subnet over ``[n, c, h, w]``."""
    widths = [(c + k * growth, c if k == 4 else growth) for k in range(5)]
    flops = 2 * n * h * w * sum(9 * cin * cout for cin, cout in widths)
    weights = sum(9 * cin * cout + cout for cin, cout in widths)
    return flops, itemsize * (2 * n * c * h * w + weights)


def subnet_shapes(model: dict, b: int, t: int) -> List[Tuple[int, int, int]]:
    """(segments, frames, bins) of each subnet of one embed+detect call of
    ``b`` clips of ``t`` samples, for the configuration's ``model``
    section: 3 subnets a block, ``num_layers`` blocks, two passes."""
    segments = b * (t // model["num_point"])
    frames = 1 + model["num_point"] // model["hop_length"]
    bins = model["n_fft"] // 2 + 1
    return [(segments, frames, bins)] * (2 * 3 * model["num_layers"])


def inn_bound_s(model: dict, b: int, t: int) -> float:
    """The least time the card could take for a call's subnets: each
    subnet's larger of its FLOP over the TF32 peak and its bytes over the
    memory bandwidth (:func:`counts.roofline_s`), summed."""
    return sum(roofline_s(*subnet_cost(n, h, w, growth=model["growth"]))
               for n, h, w in subnet_shapes(model, b, t))
