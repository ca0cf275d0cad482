"""The resblock-chain plain version against the JAX chain (plain XLA and the
Pallas kernel in interpret mode, both layouts), its CPU dispatch, its
autograd Function, the kernel's launch plan and product tilings, the
split-TF32 product the kernel computes, and the fragment-ordered weights.

f32 tolerance: atol 2e-5, rtol 1e-5 (tests/test_pallas.py's). bf16: one
bf16 rounding of the output, i.e. 2^-7 of the output's magnitude."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waveverify_tpu.ops.pallas_kernels as pk
from waveverify_torch.ops import resblock_chain as rc

torch.set_num_threads(2)

RES_SCALE = 0.5773502691896258

# (T, C, M) of every chain on the embed+detect path at 1 s / 16 kHz
MAIN_PATH_CHAINS = [(16000, 64, 2), (8000, 128, 2), (2000, 256, 2), (400, 512, 2),
                    (400, 768, 3), (2000, 384, 3), (8000, 192, 3), (16000, 96, 3)]


def _inputs(b, t, c, m, k=5, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, t, c) * 0.3).astype(np.float32)
    ws = [(rng.randn(*s) * 0.2).astype(np.float32)
          for s in [(m, c, c), (m, k, c), (m, c), (m, c, c), (m, k, c), (m, c)]]
    prescales = tuple((1.0 + i * RES_SCALE**2) ** -0.5 for i in range(m))
    return x, ws, prescales


def _port(x_btc, ws, prescales, dtype=torch.float32):
    x = torch.from_numpy(np.ascontiguousarray(x_btc.transpose(0, 2, 1))).to(dtype)
    y = rc.resblock_chain(x, *[torch.from_numpy(w).to(dtype).float() for w in ws],
                          prescales=prescales, res_scale=RES_SCALE)
    return y.float().numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_ref_matches_jax_xla_chain(m):
    x, ws, ps = _inputs(3, 300, 32, m)
    y_j = np.asarray(pk._resblock_chain_xla(
        jnp.asarray(x), *map(jnp.asarray, ws), k=5, d1=1, d2=1, prescales=ps,
        res_scale=RES_SCALE, alpha=1.0))
    np.testing.assert_allclose(_port(x, ws, ps), y_j, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("layout", ["btc", "tbc"])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_ref_matches_pallas_interpret_multi_tile(layout, m, monkeypatch):
    x, ws, ps = _inputs(3, 512, 32, m, seed=m)
    monkeypatch.setattr(pk, "VMEM_BUDGET_BYTES", 1024 * 1024)
    monkeypatch.setattr(pk, "VMEM_BUDGET_BYTES_TBC", 2 * 1024 * 1024)
    monkeypatch.setattr(pk, "_PALLAS_LAYOUT", layout)
    if layout == "tbc":
        assert pk.choose_t_tile_tbc(512, 3, 32, 5, m) < 512
    else:
        assert pk.choose_t_tile(512, 32, 5, m) < 512
    slots = [tuple(jnp.asarray(w[i]) for w in ws) for i in range(m)]
    y_j = np.asarray(pk.fused_resblock_chain(
        jnp.asarray(x), slots, k=5, dilations=(1, 1), prescales=ps,
        res_scale=RES_SCALE, alpha=1.0, interpret=True))
    np.testing.assert_allclose(_port(x, ws, ps), y_j, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("layout", ["btc", "tbc"])
def test_ref_bf16_matches_pallas_interpret(layout, monkeypatch):
    x, ws, ps = _inputs(2, 256, 32, 2, seed=7)
    monkeypatch.setattr(pk, "_PALLAS_LAYOUT", layout)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    slots = [tuple(jnp.asarray(w[i]) for w in ws) for i in range(2)]
    y_j = np.asarray(pk.fused_resblock_chain(
        x16, slots, k=5, dilations=(1, 1), prescales=ps, res_scale=RES_SCALE,
        alpha=1.0, interpret=True).astype(jnp.float32))
    # the same bf16 inputs on both sides
    x_in = np.asarray(x16.astype(jnp.float32))
    y_t = _port(x_in, ws, ps, dtype=torch.bfloat16)
    assert np.abs(y_t - y_j).max() <= 2.0**-7 * np.abs(y_j).max()


def test_cpu_dispatch_uses_plain_version_and_counts_no_launch():
    x, ws, ps = _inputs(2, 64, 16, 2)
    rc.resblock_chain.launches = 0
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    wt = [torch.from_numpy(w) for w in ws]
    y = rc.resblock_chain(xt, *wt, prescales=ps, res_scale=RES_SCALE)
    ref = rc.resblock_chain_ref(xt, *wt, prescales=ps, res_scale=RES_SCALE)
    assert torch.equal(y, ref)
    assert rc.resblock_chain.launches == 0


def test_causal_depthwise_semantics():
    # out[t] = sum_j w[j] * u[t - (k-1-j)], zero history
    u = torch.arange(1, 7, dtype=torch.float32).reshape(1, 1, 6)
    w = torch.tensor([[1.0], [10.0], [100.0]])
    y = rc._causal_dw(u, w, torch.zeros(1))[0, 0]
    np.testing.assert_allclose(y[:3].numpy(), [100.0, 210.0, 321.0])


def test_autograd_function_gradients_match_jax():
    b, t, c, m = 2, 64, 16, 2
    x, ws, ps = _inputs(b, t, c, m, seed=9)

    def loss_j(x, *ws):
        y = pk._resblock_chain_xla(x, *ws, k=5, d1=1, d2=1, prescales=ps,
                                   res_scale=RES_SCALE, alpha=1.0)
        return jnp.sum(jnp.square(y))

    g_j = jax.grad(loss_j, argnums=tuple(range(7)))(
        jnp.asarray(x), *map(jnp.asarray, ws))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    slots = [tuple(w[i] for w in wt) for i in range(m)]
    y = rc.fused_resblock_chain(xt, rc.stack_chain_weights(slots, xt.dtype),
                                prescales=ps, res_scale=RES_SCALE)
    torch.sum(torch.square(y)).backward()
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 1),
                               np.asarray(g_j[0]), atol=2e-4, rtol=1e-4)
    for w, g in zip(wt, g_j[1:]):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(g),
                                   atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("t,c,m", MAIN_PATH_CHAINS)
def test_chain_plan_covers_main_path(t, c, m):
    plan = rc.chain_plan(c, m, 5)
    assert sum(blocks for blocks, _ in plan) == m
    for blocks, t_tile in plan:
        halo = blocks * 8
        assert t_tile >= 1
        assert rc.slab_bytes(c, halo + min(t_tile, t)) <= rc._SMEM_FULL


def test_launches_per_embed_detect():
    # generator encoder + decoder + detector encoder
    enc = sum(rc.launches_per_chain(c, m) for _, c, m in MAIN_PATH_CHAINS[:4])
    dec = sum(rc.launches_per_chain(c, m) for _, c, m in MAIN_PATH_CHAINS[4:])
    assert enc + dec + enc == 18


def test_wrapper_rejects_unsupported_device():
    x = torch.zeros(1, 8, 16, device="meta")
    ws = [torch.zeros(s, device="meta") for s in [(1, 8, 8), (1, 5, 8), (1, 8)] * 2]
    with pytest.raises(RuntimeError):
        rc.resblock_chain(x, *ws, prescales=(1.0,), res_scale=1.0)


F32_TOL = dict(atol=2e-5, rtol=1e-5)
# the locator's 1-block chains ride the same kernel
PLAN_SHAPES = [(c, m) for _, c, m in MAIN_PATH_CHAINS] + [(32, 1), (64, 1)]
WIDTHS = sorted({c for c, _ in PLAN_SHAPES} | {16, 48})


def test_split_tf32_rounds_to_ten_mantissa_bits():
    v = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32))
    v = torch.cat([v, torch.tensor([0.0, -0.0, 1.0, -1.0, 1.0 + 2.0**-11, 3e-30])])
    hi, lo = rc.split_tf32(v)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # hi is v to nearest (half an ulp of 10 bits), hi + lo to 21 bits
    assert bool(((v - hi).abs() <= v.abs() * 2.0**-11).all())
    assert bool(((v - hi - lo).abs() <= v.abs() * 2.0**-21).all())
    assert rc.split_tf32(torch.tensor([1.0 + 2.0**-11]))[0].item() == 1.0 + 2.0**-10


@pytest.mark.parametrize("c", [64, 256, 768])
def test_three_pass_tf32_product_meets_f32_tolerance(c):
    rng = np.random.RandomState(c)
    u = torch.from_numpy((rng.randn(2, c, 40) * 0.5).astype(np.float32))
    pw = torch.from_numpy((rng.randn(c, c) / c**0.5).astype(np.float32))
    ref = rc._pointwise(pw, u)
    torch.testing.assert_close(rc.pointwise_tf32x3(pw, u), ref, **F32_TOL)
    # one TF32 pass is a different result: it is what the two small passes buy
    one = rc._pointwise(rc.split_tf32(pw)[0], rc.split_tf32(u)[0])
    assert (one - ref).abs().max().item() > 10 * F32_TOL["atol"]


def test_two_pass_product_is_exact_for_bf16_weights():
    rng = np.random.RandomState(5)
    u = torch.from_numpy(rng.randn(2, 96, 30).astype(np.float32))
    pw = torch.from_numpy(rng.randn(96, 96).astype(np.float32)).bfloat16().float()
    assert int(rc.split_tf32(pw)[1].abs().max()) == 0
    assert torch.equal(rc.pointwise_tf32x3(pw, u, split_b=False),
                       rc.pointwise_tf32x3(pw, u))


@pytest.mark.parametrize("c,m", [(64, 2), (256, 2), (768, 3)])
def test_chain_with_three_pass_product_meets_f32_tolerance(c, m):
    x, ws, ps = _inputs(1, 40, c, m, seed=c)
    ws[0], ws[3] = [w * (0.2 * c**0.5) ** -1 for w in (ws[0], ws[3])]
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    wt = [torch.from_numpy(w) for w in ws]
    ref = rc.resblock_chain_ref(xt, *wt, prescales=ps, res_scale=RES_SCALE)
    y = rc.resblock_chain_ref(xt, *wt, prescales=ps, res_scale=RES_SCALE,
                              product=rc.pointwise_tf32x3)
    torch.testing.assert_close(y, ref, **F32_TOL)


@pytest.mark.parametrize("c,m", [(256, 2), (768, 3)])
def test_chain_with_three_pass_product_matches_jax_xla_chain(c, m):
    # the kernel's arithmetic model against the reference package
    x, ws, ps = _inputs(1, 40, c, m, seed=c + 1)
    ws[0], ws[3] = [w * (0.2 * c**0.5) ** -1 for w in (ws[0], ws[3])]
    y_j = np.asarray(pk._resblock_chain_xla(
        jnp.asarray(x), *map(jnp.asarray, ws), k=5, d1=1, d2=1, prescales=ps,
        res_scale=RES_SCALE, alpha=1.0))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    y = rc.resblock_chain_ref(xt, *[torch.from_numpy(w) for w in ws], prescales=ps,
                              res_scale=RES_SCALE, product=rc.pointwise_tf32x3)
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 1), y_j, **F32_TOL)


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("c", [64, 96, 768])
def test_pack_chain_weights_round_trip(c, m):
    rng = np.random.RandomState(c + m)
    pw = torch.from_numpy(rng.randn(m, c, c).astype(np.float32))
    packed = rc.pack_chain_weights(pw)
    assert packed.shape == (m, c // 8, c // 16, 32, 4) and packed.is_contiguous()
    assert torch.equal(rc.unpack_chain_weights(packed), pw)
    # lane l = 4 g + t of k-step ks holds b0 = B[t][g], b1 = B[t + 4][g] of
    # the n-tiles 2 p and 2 p + 1
    for _ in range(100):
        i, ks, p = rng.randint(m), rng.randint(c // 8), rng.randint(c // 16)
        lane, q, h = rng.randint(32), rng.randint(2), rng.randint(2)
        g, t = lane >> 2, lane & 3
        assert packed[i, ks, p, lane, 2 * q + h] == pw[i, 8 * ks + 4 * h + t,
                                                       8 * (2 * p + q) + g]


def test_packed_weights_are_kept_until_written():
    pw = torch.randn(2, 32, 32, generator=torch.Generator().manual_seed(0))
    first = rc._packed(pw)
    assert rc._packed(pw) is first
    assert first[1:].is_contiguous()  # a per-block launch takes a slice as it is
    pw.mul_(2.0)
    second = rc._packed(pw)
    assert second is not first
    assert torch.equal(rc.unpack_chain_weights(second), pw)


def test_bf16_activation_needs_bf16_valued_weights():
    # the bf16 kernel skips the a_hi b_lo pass: weights it would cut must raise
    pw = torch.randn(2, 32, 32, generator=torch.Generator().manual_seed(1))
    assert rc._packed(pw) is not None
    with pytest.raises(ValueError, match="bfloat16 values"):
        rc._packed(pw, bf16=True)
    slots = [(pw[i], torch.zeros(5, 32), torch.zeros(32)) * 2 for i in range(2)]
    stacked = rc.stack_chain_weights(slots, torch.bfloat16)
    assert torch.equal(rc.unpack_chain_weights(rc._packed(stacked[0], bf16=True)),
                       pw.bfloat16().float())


@pytest.mark.parametrize("c,m", PLAN_SHAPES)
def test_chain_plan_properties(c, m):
    plan = rc.chain_plan(c, m, 5)
    assert sum(blocks for blocks, _ in plan) == m
    for blocks, t_tile in plan:
        rows = blocks * 8 + t_tile
        assert t_tile > 0
        assert rows % 16 == 0
        assert rc.slab_bytes(c, rows) <= 232448
        if rc.product_tiling(c)[2] == 2 and t_tile >= 4 * blocks * 8:
            assert 2 * (rc.slab_bytes(c, rows) + 1024) <= 228 * 1024


@pytest.mark.parametrize("c", WIDTHS)
def test_product_tiling_fits_the_cta(c):
    nt, mt, ctas = rc.product_tiling(c)
    wn = -(-c // (8 * nt))
    assert (nt, mt, ctas) in rc._TILINGS and nt % 2 == 0
    assert 1 <= wn <= 8 and wn * 8 * nt >= c
    # sums per thread: at most 96 alone on an SM, 48 where two CTAs share it
    assert nt * mt * 4 <= (96 if ctas == 1 else 48)
    assert rc.chunk_rows(c) == 8 // wn * 16 * mt
    assert rc.chunk_rows(c) * min(c, wn * 8 * nt) <= 256 * 96


def test_tilings_match_the_kernel_source():
    src = (Path(rc.__file__).resolve().parent.parent / "csrc"
           / "resblock_chain.cu").read_text()

    def table(name):
        line = re.search(rf"#define {name}\(X\)(.*)", src).group(1)
        return tuple(tuple(int(n) for n in t)
                     for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", line))

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)
                   .replace("2 * kMaxStages * 8", str(2 * rc._MAX_STAGES * 8)))

    assert table("WV_TILINGS") == rc._TILINGS
    # the route table's tilings are the wgmma tilings compiled, and the
    # wrappers the kernel has (wgmma_tf32_n<NB>) cover their column blocks
    assert table("WV_WG_TILINGS") == tuple(rc._WGMMA_WIDTHS.values())
    for nb, _, _ in rc._WGMMA_WIDTHS.values():
        assert f"void wgmma_tf32_n{nb}(" in src
    assert (const("kMaxStages"), const("kBarBytes"), const("kWgRows"), const("kSlabPad"),
            const("kMaxSmem")) == (rc._MAX_STAGES, rc._BAR_BYTES, rc._WG_ROWS,
                                   rc._SLAB_PAD, rc._SMEM_FULL)


@pytest.mark.parametrize("c,ok", [(20, False), (24, False), (40, False), (32, True)])
def test_wrapper_rejects_widths_the_mma_tiles_cannot_take(c, ok):
    x = torch.zeros(1, c, 16)
    ws = [torch.zeros(s) for s in [(1, c, c), (1, 5, c), (1, c)] * 2]
    if ok:
        rc._check(x, ws, 1)
    else:
        with pytest.raises(ValueError, match="multiple of 16"):
            rc._check(x, ws, 1)


@pytest.mark.parametrize("c", [24, 40])
@pytest.mark.parametrize("product", ["f32", "tf32x3"])
def test_padded_channels_leave_the_chain_unchanged(c, product):
    """The kernel runs a width that is no multiple of 16 on zero-padded
    channels: the first C channels of the padded chain are the chain's."""
    x, ws, ps = _inputs(2, 50, c, 3, seed=c)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    wt = [torch.from_numpy(w) for w in ws]
    xp, wp = rc.pad_channels(xt, wt)
    assert xp.shape[1] == rc.padded_width(c) == -(-c // 16) * 16
    kw = dict(prescales=ps, res_scale=RES_SCALE)
    if product == "tf32x3":
        kw["product"] = rc.pointwise_tf32x3
    y = rc.resblock_chain_ref(xp, *wp, **kw)
    assert torch.equal(y[:, c:], torch.zeros_like(y[:, c:]))
    torch.testing.assert_close(y[:, :c], rc.resblock_chain_ref(xt, *wt, **kw),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("m", [9, 10, 17])
@pytest.mark.parametrize("c", [48, 256])
def test_chain_plan_cuts_long_chains(c, m):
    """A chain of more than 8 blocks runs in launches of at most 8."""
    plan = rc.chain_plan(c, m, 5)
    assert sum(blocks for blocks, _ in plan) == m
    assert all(1 <= blocks <= rc._MAX_BLOCKS and t_tile > 0 for blocks, t_tile in plan)
    assert rc.launches_per_chain(c, m) == len(plan) >= -(-m // rc._MAX_BLOCKS)


@pytest.mark.parametrize("c,m", PLAN_SHAPES)
def test_chain_plan_follows_k3(c, m):
    """At k = 3 the halo is 4 rows per block: the slabs still fit and the
    tiles start on multiples of 4 (the kernel's vector loads)."""
    plan = rc.chain_plan(c, m, 3)
    assert sum(blocks for blocks, _ in plan) == m
    for blocks, t_tile in plan:
        rows = blocks * 4 + t_tile
        assert t_tile > 0 and t_tile % 4 == 0 and rows % 16 == 0
        assert rc.slab_bytes(c, rows) <= rc._SMEM_FULL


# chains the kernel takes off the shipped configs: (T, C, M, k); C = 24 and
# 40 run on padded channels, M = 10 in two launches
OFF_CONFIG_CHAINS = [(500, 40, 10, 5), (500, 24, 10, 5), (1000, 64, 2, 3),
                     (400, 256, 2, 3)]


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check on the card")
    from waveverify_torch.modules import seanet as tseanet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for t, c, m in [(1000, 64, 2), (131, 96, 3), (400, 768, 3)]:
        x, ws, ps = _inputs(2, t, c, m)
        xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).cuda()
        wt = [torch.from_numpy(w).cuda() for w in ws]
        y = rc.resblock_chain(xt, *wt, prescales=ps, res_scale=RES_SCALE)
        ref = rc.resblock_chain_ref(xt, *wt, prescales=ps, res_scale=RES_SCALE)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, ref, atol=2e-5, rtol=1e-5)
    # through the seanet gate: C = 1024 runs the plain path, the others the
    # kernel, each against the plain version
    for t, c, m, k in [(200, 1024, 3, 5)] + OFF_CONFIG_CHAINS:
        gen = torch.Generator().manual_seed(c)
        blocks = [tseanet.SEANetResnetBlock(c, kernel_size=k, res_scale=RES_SCALE,
                                            idx=j + 1) for j in range(m)]
        x = torch.randn(2, c, t, generator=gen).cuda()
        with torch.no_grad():
            for p in (p for blk in blocks for p in blk.parameters()):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
            blocks = [blk.cuda() for blk in blocks]
            before = rc.resblock_chain.launches
            y = tseanet._apply_resblock_chain(blocks, x)
            launches = rc.resblock_chain.launches - before
            if c > rc.MAX_CHANNELS:
                ref = x
                for blk in blocks:
                    ref = blk(ref)
            else:
                ref = rc.resblock_chain_ref(
                    x, *tseanet._chain_weights(blocks, x.dtype),
                    prescales=[b.prescale for b in blocks], res_scale=RES_SCALE)
        torch.cuda.synchronize()
        expected = 0 if c > rc.MAX_CHANNELS else rc.launches_per_chain(c, m, k)
        assert launches == expected, (t, c, m, k, launches)
        torch.testing.assert_close(y, ref, atol=2e-5, rtol=1e-5)


# -- the wgmma route: the weight image, its TF32 split, its tables, its plans

def _wgmma_image_index(n, k):
    """Float offset of B[k][n] inside one stage's part (the kernel's
    descriptor: K-major, no swizzle, leading byte offset 128, stride 256)."""
    return (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4


@pytest.mark.parametrize("c,nb,m", [(96, 96, 1), (128, 64, 2), (192, 96, 2), (384, 96, 1)])
def test_wgmma_image_round_trip_and_index_rule(c, nb, m):
    rng = np.random.RandomState(c + nb)
    pw = torch.from_numpy(rng.randn(m, c, c).astype(np.float32))
    packed = rc.pack_wgmma_weights(pw, nb)
    assert packed.shape == (m, c // 8, c // nb, 2, nb // 8, 2, 8, 4)
    assert packed.is_contiguous()
    assert torch.equal(rc.unpack_wgmma_weights(packed), pw)
    hi, lo = packed[:, :, :, 0], packed[:, :, :, 1]
    flat = packed.reshape(-1)
    stage = rc.stage_bytes(c) // 4  # floats of one ring stage: a k-chunk
    for _ in range(200):
        i, ks, cb = rng.randint(m), rng.randint(c // 8), rng.randint(c // nb)
        n, k = rng.randint(nb), rng.randint(8)
        w = pw[i, 8 * ks + k, nb * cb + n]
        # ring stage (block i, k-chunk ks); in it, column block cb's hi, lo
        base = (i * (c // 8) + ks) * stage + cb * 2 * nb * 8
        off = _wgmma_image_index(n, k)
        h, l_ = flat[base + off], flat[base + nb * 8 + off]
        assert h == hi[i, ks, cb].reshape(-1)[off]
        assert l_ == lo[i, ks, cb].reshape(-1)[off]
        assert h + l_ == w


def test_wgmma_image_splits_into_exact_tf32_hi_and_f32_rest():
    rng = np.random.RandomState(3)
    pw = torch.from_numpy(rng.randn(2, 128, 128).astype(np.float32))
    packed = rc.pack_wgmma_weights(pw, 64)
    hi, lo = packed[:, :, :, 0], packed[:, :, :, 1]
    assert int((hi.contiguous().view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert torch.equal(rc.unpack_wgmma_weights(packed), pw)  # hi + lo == w in f32
    # hi is the nearest TF32 value, as the kernel rounds A
    assert torch.equal(rc.unpack_wgmma_weights(packed[:, :, :, :1]), rc.split_tf32(pw)[0])
    # bf16 values are exact in TF32: lo == 0, and the bf16 image is hi alone
    pb = pw.bfloat16().float()
    packed_b = rc.pack_wgmma_weights(pb, 64)
    assert int(packed_b[:, :, :, 1].abs().max()) == 0
    assert torch.equal(rc.pack_wgmma_weights(pb, 64, split=False),
                       packed_b[:, :, :, :1])
    # the wrapper's copy at the route's width, C = 192, is that image
    pb = torch.from_numpy(rng.randn(2, 192, 192).astype(np.float32)).bfloat16().float()
    assert torch.equal(rc._packed(pb, bf16=True), rc.pack_wgmma_weights(pb, 96, split=False))


def test_wgmma_routes_fit_their_tilings():
    assert rc._WGMMA_WIDTHS, "the route table sends no width to wgmma"
    for c, (nb, units, ctas) in rc._WGMMA_WIDTHS.items():
        assert c % 16 == 0 and c % nb == 0 and nb % 8 == 0 and nb <= 256
        # every column block of a row tile in one sweep (the in-place rule)
        assert (2 * units) % (c // nb) == 0
        assert ctas == (2 if c <= 128 else 1)
        assert rc.product_route(c) == ("wgmma", (nb, units, ctas))
        assert rc.rows_per_pass(c) == 2 * units // (c // nb) * 64
        # sums per thread: a unit is 64 x nb sums over a warpgroup's 128
        # threads, carried in the tensor core (no f32 part beside them)
        assert units * nb // 2 <= (96 if ctas == 1 else 64)
    for c in (16, 32, 48, 64, 96, 128, 256, 384, 512, 768):
        assert rc.product_route(c) == ("mma", rc.product_tiling(c))


@pytest.mark.parametrize("c,m", PLAN_SHAPES + [(48, 10), (256, 9)])
def test_chain_plan_fits_slabs_and_ring(c, m):
    """Slabs plus the ring fit one CTA's shared memory at the stages the
    launch takes (f32 and bf16), with room for two stages; two CTAs share
    an SM where the tiling aims at two and the tile covers four halos."""
    route = rc.product_route(c)
    for k in rc.KERNEL_SIZES:
        for blocks, t_tile in rc.chain_plan(c, m, k):
            halo = blocks * 2 * (k - 1)
            rows = halo + t_tile
            assert t_tile > 0 and t_tile % 4 == 0 and rows % 16 == 0
            for bf16 in (False, True):
                stages = rc.ring_stages(c, rows, bf16)
                smem = rc.smem_bytes(c, rows, stages, split=not bf16)
                assert smem <= 232448
                if route[0] == "wgmma":
                    assert 2 <= stages <= rc._MAX_STAGES
                    assert smem == (rc.slab_bytes(c, rows) + rc._BAR_BYTES
                                    + stages * rc.stage_bytes(c, not bf16))
                    if route[1][2] == 2 and t_tile >= 4 * halo:
                        assert 2 * (smem + 1024) <= 228 * 1024
                else:
                    assert stages == 0 and smem == rc.slab_bytes(c, rows)


@pytest.mark.parametrize("c,m,chunk", [(192, 3, 32), (384, 2, 8)])
def test_chunked_flush_model_matches_jax_xla_chain(c, m, chunk):
    """The flush's arithmetic (wgmma at C = 192: every four k-chunks of 8
    input channels; mma.sync: every k-step): per chunk three TF32 passes
    from zero, added to the running sums in f32 in k order; the chain built
    on it against the reference package."""
    from functools import partial

    x, ws, ps = _inputs(1, 40, c, m, seed=c + 2)
    ws[0], ws[3] = [w * (0.2 * c**0.5) ** -1 for w in (ws[0], ws[3])]
    y_j = np.asarray(pk._resblock_chain_xla(
        jnp.asarray(x), *map(jnp.asarray, ws), k=5, d1=1, d2=1, prescales=ps,
        res_scale=RES_SCALE, alpha=1.0))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    product = partial(rc.pointwise_tf32x3, chunk=chunk)
    y = rc.resblock_chain_ref(xt, *[torch.from_numpy(w) for w in ws], prescales=ps,
                              res_scale=RES_SCALE, product=product)
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 1), y_j, **F32_TOL)
    # the chunked sums are the three passes' in another order
    u = torch.from_numpy(x[0].T.copy())[None]
    pw = torch.from_numpy(ws[0][0])
    torch.testing.assert_close(product(pw, u), rc.pointwise_tf32x3(pw, u), **F32_TOL)


@pytest.mark.parametrize("c,m", PLAN_SHAPES + [(48, 10), (256, 9)])
def test_chain_plan_follows_its_break_even(c, m):
    """chain_plan runs the chain in its fewest launches exactly when
    _FLOP_PER_BYTE reaches the cost model's break-even (the number the
    card check refits the constant against)."""
    threshold = rc.plan_threshold(c, m, 5)
    groups = rc._groups(m)
    plan = rc.chain_plan(c, m, 5)
    assert sum(groups) == m and max(groups) <= rc._MAX_BLOCKS
    if threshold is None:
        assert [b for b, _ in plan] == groups == [1] * m
    elif rc._FLOP_PER_BYTE >= threshold:
        assert [b for b, _ in plan] == groups
    else:
        assert [b for b, _ in plan] == [1] * m
