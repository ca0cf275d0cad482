"""``counts_resblock``: the residual blocks' products as FlopCounterMode
counts the reference's, and the per-block FLOP and bytes of the published
cards."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import BENCH
from counts import PEAKS, count_flop
from counts_resblock import resblock_bound_s, resblock_cost, resblock_shapes
from reference import audioseal as ra
from reference.ops import Ops

PUBLISHED = json.loads((BENCH / "configs" / "audioseal_16bits.json").read_text())
SEANET = PUBLISHED["model"]["generator"]["seanet"]


def test_counts_match_flop_counter():
    """One block of the reference at width 16: FlopCounterMode's count of
    its two convs is the formula's."""
    b, c, t = 2, 16, 50
    g = torch.Generator().manual_seed(0)
    p = {}
    for conv, shape in (("block.1", (c // 2, c, 3)), ("block.3", (c, c // 2, 1))):
        pre = f"r.{conv}.conv.conv"
        p[pre + ".weight_v"] = torch.randn(shape, generator=g)
        p[pre + ".weight_g"] = torch.ones(shape[0], 1, 1)
        p[pre + ".bias"] = torch.randn(shape[0], generator=g)
    x = torch.randn(b, c, t, generator=g)
    _, flop = count_flop(lambda: ra.resblock(Ops(), p, "r", x, 1))
    assert flop == resblock_cost(b, t, c)[0] == 4 * c * c * b * t


@pytest.mark.parametrize("c,t", [(32, 480000), (64, 240000), (128, 60000), (256, 12000)])
def test_published_blocks(c, t):
    """Per block of the published cards at 8 x 30 s: 4 C^2 B T FLOP; the
    input read and the output written once (2 S), the weights once."""
    f, n = resblock_cost(8, t, c)
    assert f == 4 * c * c * 8 * t
    assert n == 4 * (2 * c * 8 * t + c // 2 * c * 3 + c // 2 + c * c // 2 + c)
    # every block is bound by its bytes
    assert n / PEAKS["hbm_bytes_per_s"] > f / PEAKS["tf32_flop_per_s"]


def test_a_call_s_twelve_blocks():
    """Encoder, decoder, detector's encoder: four blocks each; 311.4 GFLOP
    and 7.96 GB a call at 8 x 30 s, 2.38 ms at the bandwidth."""
    shapes = resblock_shapes(SEANET, 480000)
    enc = [(480000, 32), (240000, 64), (60000, 128), (12000, 256)]
    assert shapes == enc + enc[::-1] + enc
    costs = [resblock_cost(8, t, c) for t, c in shapes]
    assert sum(f for f, _ in costs) == pytest.approx(311.4e9, rel=1e-3)
    assert sum(n for _, n in costs) == pytest.approx(7.965e9, rel=1e-3)
    assert resblock_bound_s(SEANET, 8, 480000) == pytest.approx(2.378e-3, rel=1e-3)
    small = dict(SEANET, n_filters=4, ratios=[2, 2])
    assert resblock_shapes(small, 1001) == [(1001, 4), (501, 8), (502, 8), (1004, 4),
                                           (1001, 4), (501, 8)]
