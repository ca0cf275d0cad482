"""The FLOP and byte arithmetic of the roofline and utilization metrics."""

import json

import pytest
import torch

from conftest import BENCH
from counts import PEAKS, chain_cost, chain_shapes, chains_bound_s, count_flop, roofline_s

R5 = json.loads((BENCH / "configs" / "waveverify_base_r5.json").read_text())["model"]


def test_embed_detect_chains():
    """The 12 chains of a batch-64 x 1 s embed+detect: 1.220e12 FLOP."""
    shapes = chain_shapes(R5, 16000)
    assert shapes == [(16000, 64, 2), (8000, 128, 2), (2000, 256, 2), (400, 512, 2),
                      (400, 768, 3), (2000, 384, 3), (8000, 192, 3), (16000, 96, 3),
                      (16000, 64, 2), (8000, 128, 2), (2000, 256, 2), (400, 512, 2)]
    costs = [chain_cost(64, t, c, m, 4) for t, c, m in shapes]
    flops, nbytes = sum(f for f, _ in costs), sum(n for _, n in costs)
    assert flops == pytest.approx(1.220e12, rel=1e-3)
    # over the whole call operations bound it: 2.47 ms at the TF32 peak
    assert roofline_s(flops, nbytes) == pytest.approx(flops / PEAKS["tf32_flop_per_s"])
    assert roofline_s(flops, nbytes) == pytest.approx(2.465e-3, rel=1e-3)
    # chain by chain the C = 64 and 128 chains are bound by their bytes: 2.66 ms
    assert chains_bound_s(R5, 64, 16000) == pytest.approx(2.664e-3, rel=1e-3)


def test_chain_cost_formula():
    f, n = chain_cost(2, 10, 8, 3, 4, k=5)
    assert f == 3 * 2 * 2 * 10 * 8 * (16 + 10)
    assert n == 4 * (2 * 2 * 10 * 8 + 3 * (2 * 64 + 2 * 5 * 8 + 2 * 8))


def test_count_flop_counts_products():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    out, flop = count_flop(lambda: a @ b)
    assert flop == 2 * 8 * 16 * 4 and out.shape == (8, 4)
