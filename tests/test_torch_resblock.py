"""The resblock-chain plain version against the JAX chain (plain XLA and the
Pallas kernel in interpret mode, both layouts), its CPU dispatch, its
autograd Function, and the kernel's launch plan.

f32 tolerance: atol 2e-5, rtol 1e-5 (tests/test_pallas.py's). bf16: one
bf16 rounding of the output, i.e. 2^-7 of the output's magnitude."""

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


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check on the card")
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
