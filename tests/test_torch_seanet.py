"""Port SEANet encoder and decoder against the JAX modules at small widths,
with a message, both message modes and the FiLM carrier on. Params are the
JAX init with every zero-init bias and the FiLM projections drawn at random,
carried across by path. f32 tolerance: atol 1e-4, rtol 1e-4 (a stack of
~20 convs in f32 with different summation orders; the encoder's output is
L2-normalised to sqrt(C))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveverify_tpu.modules import seanet as jseanet
from waveverify_torch.modules import seanet as tseanet
from waveverify_torch.weights import flatten, load_params

torch.set_num_threads(2)

SMALL = dict(kernel_size=5, last_kernel_size=5, residual_kernel_size=5,
             dilation_base=1, skip="identity", causal=True, use_bias=True,
             zero_init=False)


def _randomize(params, seed):
    rng = np.random.RandomState(seed)
    flat = flatten(jax.tree_util.tree_map(np.asarray, params))
    for k, v in flat.items():
        leaf = k.split("/")[-1]
        if leaf in ("b", "bias"):
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif leaf == "kernel":  # Dense layers (message MLP, FiLM)
            flat[k] = (rng.randn(*v.shape) * 0.3).astype(np.float32)
    return flat


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


@pytest.mark.parametrize("msg_mode,ratios", [("reference", (8, 5, 4, 2)),
                                             ("carrier", (8, 5, 4, 2)),
                                             ("carrier", (4, 2))])
def test_encoder_matches_jax(msg_mode, ratios):
    rng = np.random.RandomState(0)
    t = 2 * int(np.prod(ratios)) * 5 + 7
    audio = (rng.randn(2, t, 1) * 0.1).astype(np.float32)
    msg = rng.randint(0, 2, (2, 16)).astype(np.float32)
    kw = dict(dimension=32, n_filters=8, n_residual_layers=2, ratios=ratios,
              l2norm=True, spec_compression="log", res_scale=0.577,
              film_gamma_bias=1.0, **SMALL)
    jenc = jseanet.SEANetEncoder(msg_mode=msg_mode, film_carrier_gain=0.5, **kw)
    params = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(audio),
                       jnp.asarray(msg))["params"]
    flat = _randomize(params, 1)
    apply = jax.jit(jenc.apply)
    z_j = np.asarray(apply({"params": _unflatten(flat)}, jnp.asarray(audio),
                           jnp.asarray(msg)))
    kw.pop("film_gamma_bias")
    tenc = tseanet.SEANetEncoder(msg_mode=msg_mode, film_carrier_gain=0.5, **kw)
    load_params(tenc, {f"e/{k}": v for k, v in flat.items()}, "e")
    with torch.no_grad():
        z_t = tenc(torch.from_numpy(audio.transpose(0, 2, 1).copy()),
                   torch.from_numpy(msg)).numpy().transpose(0, 2, 1)
    assert z_t.shape == z_j.shape
    np.testing.assert_allclose(z_t, z_j, atol=1e-4, rtol=1e-4)
    # no message: the FiLM sites are skipped
    z_j0 = np.asarray(apply({"params": _unflatten(flat)}, jnp.asarray(audio)))
    with torch.no_grad():
        z_t0 = tenc(torch.from_numpy(audio.transpose(0, 2, 1).copy())
                    ).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(z_t0, z_j0, atol=1e-4, rtol=1e-4)


def test_decoder_matches_jax():
    rng = np.random.RandomState(2)
    z = rng.randn(2, 6, 32).astype(np.float32)
    kw = dict(dimension=32, n_filters=12, n_residual_layers=3,
              ratios=(8, 5, 4, 2), final_activation="Tanh", res_scale=0.577,
              **SMALL)
    jdec = jseanet.SEANetDecoder(**kw)
    params = jax.jit(jdec.init)(jax.random.PRNGKey(0), jnp.asarray(z))["params"]
    flat = _randomize(params, 3)
    y_j = np.asarray(jax.jit(jdec.apply)({"params": _unflatten(flat)},
                                         jnp.asarray(z)))
    tdec = tseanet.SEANetDecoder(**kw)
    load_params(tdec, {f"d/{k}": v for k, v in flat.items()}, "d")
    with torch.no_grad():
        y_t = tdec(torch.from_numpy(z.transpose(0, 2, 1).copy())).numpy()
    y_t = y_t.transpose(0, 2, 1)
    assert y_t.shape == y_j.shape == (2, 6 * 320, 1)
    np.testing.assert_allclose(y_t, y_j, atol=1e-5, rtol=1e-4)


def test_film_carrier_constants_match():
    for nbits, sites in [(16, 16), (16, 8), (4, 3)]:
        np.testing.assert_array_equal(tseanet._film_carrier(nbits, sites),
                                      jseanet._film_carrier(nbits, sites))


def test_resblock_fused_and_eager_paths_agree():
    """The chain gate's two routes (fused chain vs block by block) compute
    the same function."""
    blocks = [tseanet.SEANetResnetBlock(16, kernel_size=5, dilations=(1, 1),
                                        res_scale=0.577, idx=j + 1)
              for j in range(2)]
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for blk in blocks:
            for p in blk.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3 + 0.2)
    x = torch.randn(2, 16, 50, generator=gen)
    assert all(b.fusable() for b in blocks)
    with torch.no_grad():
        fused = tseanet._apply_resblock_chain(blocks, x)
        eager = blocks[1](blocks[0](x))
    torch.testing.assert_close(fused, eager, atol=2e-5, rtol=1e-5)


def _random_blocks(c, seed=0):
    blocks = [tseanet.SEANetResnetBlock(c, kernel_size=5, dilations=(1, 1),
                                        res_scale=0.577, idx=j + 1)
              for j in range(2)]
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for blk in blocks:
            for p in blk.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3 + 0.2)
    return blocks


def test_chain_weights_cached_until_a_parameter_changes():
    blocks = _random_blocks(8)
    with torch.no_grad():
        first = tseanet._chain_weights(blocks, torch.float32)
        assert tseanet._chain_weights(blocks, torch.float32) is first
        blocks[1].block_0_pw.conv.v.mul_(2.0)  # written in place
        second = tseanet._chain_weights(blocks, torch.float32)
        assert second is not first
        assert tseanet._chain_weights(blocks, torch.bfloat16) is not second
    fresh = tseanet._chain_weights(blocks, torch.float32)  # records gradients
    assert fresh[0].requires_grad
    for a, b in zip(fresh, second):
        torch.testing.assert_close(a.detach(), b, atol=0, rtol=0)


def _fused_calls(monkeypatch):
    """A list that gains an entry at every call of the fused chain."""
    calls = []
    fused = tseanet.fused_resblock_chain
    monkeypatch.setattr(tseanet, "fused_resblock_chain",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    return calls


def test_chain_gate_is_structural_only(monkeypatch):
    """Besides the blocks' shape, the gate looks only at the width: a chain
    wider than the kernel takes (768) runs block by block in plain PyTorch,
    as the JAX package's gate sends it to XLA; it never reaches the
    kernel's wrapper, which would raise on the card."""
    calls = _fused_calls(monkeypatch)
    blocks = _random_blocks(800)
    x = torch.randn(1, 800, 12, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        gated_y = tseanet._apply_resblock_chain(blocks, x)
        eager_y = blocks[1](blocks[0](x))
    assert calls == []
    torch.testing.assert_close(gated_y, eager_y, atol=0, rtol=0)


@pytest.mark.parametrize("c,kernel", [(768, True), (1024, False)])
def test_chain_route_matches_jax_gate(monkeypatch, c, kernel):
    """The port sends a chain to the kernel exactly where the JAX package's
    gate (``can_fuse``) sends it to its Pallas kernel: up to 768 channels."""
    from waveverify_tpu.ops.pallas_kernels import can_fuse

    t = 64
    assert can_fuse(t, c, 5, m=2) == kernel
    calls = _fused_calls(monkeypatch)
    blocks = _random_blocks(c)
    x = torch.randn(1, c, t, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        routed = tseanet._apply_resblock_chain(blocks, x)
        eager = blocks[1](blocks[0](x))
    assert calls == ([1] if kernel else [])
    torch.testing.assert_close(routed, eager, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n_filters,k", [(128, 5), (8, 3)])
def test_encoder_off_the_shipped_widths_matches_jax(monkeypatch, n_filters, k):
    """``channels_enc: 128`` (chains at C = 128 ... 1024: the widest runs the
    plain path) and ``residual_kernel_size: 3`` (every chain on the fused
    path, as in the JAX package) against the JAX encoder, at a tiny depth."""
    calls = _fused_calls(monkeypatch)
    rng = np.random.RandomState(3)
    ratios = (2, 2, 2, 2)
    audio = (rng.randn(2, 16 * 6 + 5, 1) * 0.1).astype(np.float32)
    msg = rng.randint(0, 2, (2, 16)).astype(np.float32)
    kw = dict(SMALL, residual_kernel_size=k)
    kw.update(dimension=32, n_filters=n_filters, n_residual_layers=1,
              ratios=ratios, l2norm=True, spec_compression="log",
              res_scale=0.577)
    jenc = jseanet.SEANetEncoder(**kw)
    params = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(audio),
                                jnp.asarray(msg))["params"]
    flat = _randomize(params, 4)
    z_j = np.asarray(jax.jit(jenc.apply)({"params": _unflatten(flat)},
                                         jnp.asarray(audio), jnp.asarray(msg)))
    tenc = tseanet.SEANetEncoder(**kw)
    load_params(tenc, {f"e/{k_}": v for k_, v in flat.items()}, "e")
    with torch.no_grad():
        z_t = tenc(torch.from_numpy(audio.transpose(0, 2, 1).copy()),
                   torch.from_numpy(msg)).numpy().transpose(0, 2, 1)
    widths = [n_filters * 2**i for i in range(len(ratios))]
    assert len(calls) == sum(w <= 768 for w in widths)
    np.testing.assert_allclose(z_t, z_j, atol=1e-4, rtol=1e-4)


def test_encoder_carriers_are_fixed_buffers():
    enc = tseanet.SEANetEncoder(msg_mode="carrier", film_carrier_gain=0.5,
                                ratios=(4, 2), **SMALL)
    rs = np.random.RandomState(16)
    c = np.linalg.qr(rs.randn(64, 16))[0].astype(np.float32)
    np.testing.assert_array_equal(enc.msg_carrier.numpy(), c.T)
    np.testing.assert_array_equal(enc.film_carrier.numpy(),
                                  jseanet._film_carrier(16, 2 * 4))
    assert not any("carrier" in k for k in enc.state_dict())
    plain = tseanet.SEANetEncoder(**SMALL)
    assert not hasattr(plain, "msg_carrier") and not hasattr(plain, "film_carrier")


def test_unported_options_raise():
    """What neither package runs still raises: a decoder whose transposed
    convs carry spectral norm (the JAX package refuses it there too), an
    unknown skip type or activation. The options both packages run build
    (tests/test_torch_seanet_options.py holds them to JAX)."""
    with pytest.raises(NotImplementedError):
        tseanet.SEANetDecoder(norm="spectral_norm")
    with pytest.raises(ValueError):
        tseanet.SEANetEncoder(skip="dense")
    with pytest.raises(ValueError):
        tseanet.SEANetEncoder(activation="Swish")
    tseanet.SEANetEncoder(skip="1x1")
    tseanet.SEANetDecoder(pad_mode="reflect")
