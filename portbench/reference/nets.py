"""Plain reference of the three watermarking networks (generator, detector,
locator) of WaveVerify, as functions of a flat weight dict.

The weights are the flax-named arrays of a ``save_weights_npz`` file
(``generator/encoder/block_0_0/block_0_pw/conv/v``), float32 tensors in the
flax layouts: a conv's ``v`` is ``(K, Cin / groups, Cout)``, a transposed
conv's ``(Cin, Cout / groups, K)``, a Dense ``kernel`` ``(in, out)``. Weight
norm (``w = g * v / ||v||``) is applied here, on every call.

The networks are written for the options of the published configuration
(``conf/base.yml``): weight-normed causal convs with zero padding, ELU,
identity skips, the log-STFT spec blocks, FiLM over four frequency bands,
an L2-normed latent, the Tanh output. :func:`check_config` refuses any
other option. Every residual block runs on its own, as plain convolutions:
no chain kernel, no packed weights, no caches.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.ops import Ops

Params = Dict[str, torch.Tensor]

WAV_STD = 0.1122080159
SPEC_MEANS = (-4.554, -4.315, -4.021, -3.726, -3.477)
SPEC_STDS = (2.830, 2.837, 2.817, 2.796, 2.871)

# option -> the only value the reference implements
_FIXED = {"activation": "ELU", "activation_alpha": 1.0, "norm": "weight_norm",
          "dilation_base": 1, "skip": "identity", "act_all": False,
          "expansion": 1, "groups": -1, "encoder_l2norm": True, "bias": False,
          "spec": "stft", "spec_compression": "log", "pad_mode": "constant",
          "causal": True, "zero_init": False, "inout_norm": True,
          "channels_audio": 1}


def check_config(section: dict, name: str) -> None:
    """Raise if a network's options leave what the reference implements."""
    for key, want in _FIXED.items():
        if key in section and section[key] != want:
            raise ValueError(f"{name}.{key} = {section[key]!r}: the reference "
                             f"implements {want!r} only")
    if name == "Generator":
        if section.get("final_activation", "Tanh") != "Tanh":
            raise ValueError("Generator.final_activation: Tanh only")
        if section.get("spec_learnable_effective", False):
            raise ValueError("Generator.spec_learnable_effective: off only")
        if section.get("msg_mode", "reference") not in ("reference", "carrier"):
            raise ValueError("Generator.msg_mode: reference or carrier")


def elu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.expm1(torch.clamp(x, max=0.0)))


# -- weights -------------------------------------------------------------------


def read_npz(path, device) -> Params:
    """The flax-named arrays of a ``save_weights_npz`` file, as float32 on
    ``device`` (the file's ``__config__`` and other ``__`` entries left
    out)."""
    with np.load(path) as z:
        return {k: torch.as_tensor(np.asarray(z[k], np.float32), device=device)
                for k in z.files if not k.startswith("__")}


def wn_weight(p: Params, pre: str, dims: Tuple[int, ...]) -> torch.Tensor:
    """``g * v / ||v||`` with the norm over ``dims`` of ``v``, per the kept
    axis."""
    v, g = p[pre + "/v"], p[pre + "/g"]
    norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))
    shape = [1] * v.dim()
    kept = [d for d in range(v.dim()) if d not in dims][0]
    shape[kept] = -1
    return v * (g.view(shape) / norm)


def conv_w(p: Params, pre: str) -> torch.Tensor:
    """A weight-normed 1-D conv's kernel in torch's ``(Cout, Cin / g, K)``."""
    return wn_weight(p, pre, (0, 1)).permute(2, 1, 0)


def convtr_w(p: Params, pre: str) -> torch.Tensor:
    """A weight-normed transposed conv's kernel ``(Cin, Cout / g, K)``."""
    return wn_weight(p, pre, (1, 2))


def sconv(ops: Ops, p: Params, pre: str, x: torch.Tensor, k: int,
          stride: int = 1, groups: int = 1, bias: bool = False) -> torch.Tensor:
    """Causal conv: ``(k - 1) - (stride - 1)`` zeros on the left and the
    extra right zeros that make ``out = ceil(in / stride)``."""
    pad = (k - 1) - (stride - 1)
    t = x.shape[-1]
    n_frames = (t - k + pad) / stride + 1
    extra = max(0, (math.ceil(n_frames) - 1) * stride + (k - pad) - t)
    x = F.pad(x, (pad, extra))
    return ops.conv1d(x, conv_w(p, pre + "/conv"),
                      p[pre + "/conv/b"] if bias else None, stride=stride,
                      groups=groups)


def dense(ops: Ops, p: Params, pre: str, x: torch.Tensor) -> torch.Tensor:
    return ops.matmul(x, p[pre + "/kernel"]) + p[pre + "/bias"]


# -- fixed carriers (the model's constants, built as the package builds them) ----


def dft_basis(n_fft: int) -> np.ndarray:
    """Hann-windowed DFT basis ``(2F, 1, n_fft)``, cos rows then sin rows,
    in the model's float32 arithmetic (the rounding of the angle matters at
    large n_fft)."""
    nw = np.arange(n_fft, dtype=np.float32)
    window = (np.float32(0.5) - np.float32(0.5) * np.cos(
        np.float32(2.0 * np.pi / n_fft) * nw, dtype=np.float32)).astype(np.float32)
    n = np.arange(n_fft, dtype=np.float32)[None, :]
    k = np.arange(n_fft // 2 + 1, dtype=np.float32)[:, None]
    s = np.float32(-2.0 * math.pi / n_fft)
    ang = ((s * k).astype(np.float32) * n).astype(np.float32)
    w = np.concatenate([np.cos(ang, dtype=np.float32),
                        np.sin(ang, dtype=np.float32)], axis=0) * window[None, :]
    return np.ascontiguousarray(w[:, None, :].astype(np.float32))


def msg_carrier(embedding_dim: int, nbits: int) -> np.ndarray:
    """``[nbits, embedding_dim]``: QR of ``RandomState(16)`` normals."""
    rs = np.random.RandomState(16)
    c = np.linalg.qr(rs.randn(embedding_dim, nbits))[0]
    return np.ascontiguousarray(c.astype(np.float32).T)


def film_carrier(nbits: int, n_sites: int) -> np.ndarray:
    """``[nbits, 2 * n_sites]`` per-bit signatures over the FiLM slots."""
    slots = 2 * n_sites
    if slots >= nbits + 1 and slots & (slots - 1) == 0:
        h = np.ones((1, 1), np.float64)
        while h.shape[0] < slots:
            h = np.block([[h, h], [h, -h]])
        sig = h[1:nbits + 1] / np.sqrt(slots)
    else:
        rs = np.random.RandomState(17)
        q = np.linalg.qr(rs.randn(max(slots, nbits), nbits))[0]
        sig = q[:slots].T
        sig = sig / np.maximum(np.linalg.norm(sig, axis=1, keepdims=True), 1e-8)
    return sig.astype(np.float32)


def latent_carrier(dimension: int, nbits: int) -> np.ndarray:
    """``[nbits, dimension]``: QR of ``RandomState(18)`` normals."""
    rs = np.random.RandomState(18)
    c = np.linalg.qr(rs.randn(dimension, nbits))[0].astype(np.float32)
    return np.ascontiguousarray(c.T)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


# -- SEANet ----------------------------------------------------------------------


def resblock(ops: Ops, p: Params, pre: str, x: torch.Tensor, k: int,
             prescale: float, res_scale: float) -> torch.Tensor:
    """Two (ELU, 1x1, causal depthwise k) units on ``x * prescale``, scaled
    by ``res_scale``, plus the identity."""
    y = x * prescale
    c = x.shape[1]
    for i in range(2):
        y = sconv(ops, p, f"{pre}/block_{i}_pw", elu(y), 1)
        y = sconv(ops, p, f"{pre}/block_{i}_dw", y, k, groups=c)
    return y * res_scale + x


def spec_block(ops: Ops, p: Params, pre: str, x: torch.Tensor,
               wav: torch.Tensor, n_fft: int, hop: int, mean: float,
               std: float, res_scale: float) -> torch.Tensor:
    """``x`` plus the projected, normalised log-magnitude STFT of the
    waveform at this scale's hop (causal: n_fft - 1 zeros on the left)."""
    basis = _const(dft_basis(n_fft), wav)
    spec = ops.conv1d(F.pad(wav, (n_fft - 1, 0)), basis, stride=hop)
    f = n_fft // 2 + 1
    re, im = spec[:, :f], spec[:, f:]
    y = torch.sqrt(torch.clamp(re * re + im * im, min=1e-12))
    y = (torch.log(torch.clamp(y, min=1e-5)) - mean) / std
    y = sconv(ops, p, pre + "/proj", y, 1)
    return x + y * res_scale


def encoder(ops: Ops, p: Params, pre: str, c: dict, x: torch.Tensor,
            msg: Optional[torch.Tensor]) -> torch.Tensor:
    """SEANet encoder with FiLM: audio ``[B, 1, T]`` -> latent ``[B, D,
    ceil(T / hop)]``; ``msg`` None skips the FiLM."""
    rs = c["res_scale_enc"]
    n_res = c["n_residual_enc"]
    nf = c["channels_enc"]
    wav = x
    x = sconv(ops, p, pre + "/conv_pre", x * (1.0 / WAV_STD), c["kernel_size"])
    cond = offsets = None
    if msg is not None:
        carrier = c.get("msg_mode", "reference") == "carrier"
        s = 2.0 * msg - 1.0 if carrier else msg
        h = dense(ops, p, pre + "/msg_in", s)
        for i in range(c.get("embedding_layers", 2)):
            h = torch.relu(dense(ops, p, f"{pre}/msg_hidden_{i}", h))
        if carrier:
            h = h + ops.matmul(s, _const(msg_carrier(h.shape[1], msg.shape[1]), h)) \
                * c.get("msg_carrier_gain", 1.0)
        cond = h
        gain = c.get("film_carrier_gain", 0.0)
        if gain > 0:
            sig = _const(film_carrier(msg.shape[1], len(c["strides"]) * c["freq_bands"]), h)
            offsets = ops.matmul(2.0 * msg - 1.0, sig) * gain
    mult, stride = 1, 1
    for bi, ratio in enumerate(reversed(list(c["strides"]))):
        dim = mult * nf
        for j in range(n_res):
            x = resblock(ops, p, f"{pre}/block_{bi}_{j}", x,
                         c["residual_kernel_size"],
                         (1.0 + (j + 1) * rs ** 2) ** -0.5, rs)
        x = spec_block(ops, p, f"{pre}/spec_block_{bi}", x, wav,
                       mult * c["n_fft_base"], stride, SPEC_MEANS[bi],
                       SPEC_STDS[bi], rs)
        x = x * (1.0 + n_res * rs ** 2) ** -0.5
        x = sconv(ops, p, f"{pre}/down_{bi}_expand", elu(x), 1)
        x = sconv(ops, p, f"{pre}/down_{bi}_dw", x, 2 * ratio, stride=ratio,
                  groups=2 * dim)
        stride *= ratio
        if cond is not None:
            bands = c["freq_bands"]
            width = x.shape[1] // bands
            parts = []
            for band in range(bands):
                fp = f"{pre}/film_{bi}_{band}"
                gamma = dense(ops, p, fp + "/gamma", cond)
                beta = dense(ops, p, fp + "/beta", cond)
                if offsets is not None:
                    site = bi * bands + band
                    gamma = gamma + offsets[:, 2 * site:2 * site + 1]
                    beta = beta + offsets[:, 2 * site + 1:2 * site + 2]
                parts.append(x[:, band * width:(band + 1) * width]
                             * gamma[:, :, None] + beta[:, :, None])
            x = torch.cat(parts, dim=1)
        mult *= 2
    x = spec_block(ops, p, pre + "/spec_post", x, wav, mult * c["n_fft_base"],
                   stride, SPEC_MEANS[-1], SPEC_STDS[-1], rs)
    x = sconv(ops, p, pre + "/post_dw", elu(x), c["last_kernel_size"],
              groups=x.shape[1])
    x = ops.conv1d(x, conv_w(p, pre + "/post_proj/conv/conv")) \
        + p[pre + "/post_proj/b"][:, None]
    norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.clamp(norm, min=1e-12) * (x.shape[1] ** 0.5)


def decoder(ops: Ops, p: Params, pre: str, c: dict, z: torch.Tensor) -> torch.Tensor:
    """SEANet decoder: latent ``[B, D, T']`` -> audio ``[B, 1, T' * hop]``."""
    rs = c["res_scale_dec"]
    n_res = c["n_residual_dec"]
    ratios = list(c["strides"])
    x = sconv(ops, p, pre + "/conv_in", z, 1)
    x = sconv(ops, p, pre + "/conv_in_dw", x, c["kernel_size"], groups=x.shape[1])
    for i, ratio in enumerate(ratios):
        if i > 0:
            x = x * (1.0 + n_res * rs ** 2) ** -0.5
        dim = x.shape[1]
        y = ops.conv_transpose1d(elu(x), convtr_w(p, f"{pre}/up_{i}_dw/convtr"),
                                 stride=ratio, groups=dim)
        x = y[..., :y.shape[-1] - ratio]  # causal: the k - stride extra on the right
        x = sconv(ops, p, f"{pre}/up_{i}_proj", x, 1)
        for j in range(n_res):
            x = resblock(ops, p, f"{pre}/block_{i}_{j}", x,
                         c["residual_kernel_size"], (1.0 + j * rs ** 2) ** -0.5, rs)
    x = x * (1.0 + n_res * rs ** 2) ** -0.5
    x = sconv(ops, p, pre + "/conv_out", elu(x), c["last_kernel_size"])
    return torch.tanh(x * WAV_STD)


def hop(c: dict) -> int:
    return int(np.prod(c["strides"]))


def bucket(t: int, hop_length: int, min_len: int = 4800) -> int:
    """The serving API's padded length for a clip of ``t`` samples: the
    smallest of ``min_len``, then ~1.26x steps rounded up to hop
    multiples, that holds it. Single clips are right-padded with zeros to
    it and their decisions averaged over the first ``t`` samples."""
    n = max(t, min_len)
    b = min_len
    while b < n:
        b = int(math.ceil(b * 1.26 / hop_length) * hop_length)
    return b


def generator(ops: Ops, p: Params, c: dict, audio: torch.Tensor,
              msg: torch.Tensor) -> torch.Tensor:
    """audio ``[B, T]``, msg ``[B, nbits]`` in {0, 1} -> residual ``[B, T]``."""
    t = audio.shape[-1]
    x = F.pad(audio, (0, -t % hop(c)))[:, None, :]
    latent = encoder(ops, p, "generator/encoder", c, x, msg)
    gain = c.get("latent_carrier_gain", 0.0)
    if gain > 0:
        s = 2.0 * msg - 1.0
        rms = torch.sqrt(torch.mean(latent * latent, dim=(1, 2), keepdim=True)
                         + 1e-12).detach()
        off = ops.matmul(s, _const(latent_carrier(latent.shape[1], msg.shape[1]),
                                   latent))[:, :, None]
        latent = latent + gain * rms * off
    return decoder(ops, p, "generator/decoder", c, latent)[:, 0, :t]


def _head(ops: Ops, p: Params, pre: str, c: dict, audio: torch.Tensor) -> torch.Tensor:
    """Encoder, the k = stride transposed conv, the trim to T and the 1x1
    conv: audio ``[B, T]`` -> logits ``[B, T, out]``."""
    z = encoder(ops, p, pre + "/encoder", c, audio[:, None, :], None)
    y = ops.conv_transpose1d(z, p[pre + "/reverse_convolution/v"],
                             p[pre + "/reverse_convolution/b"], stride=hop(c))
    y = y[..., :audio.shape[-1]]
    w = p[pre + "/last_layer/v"].permute(2, 1, 0)  # (1, Cin, Cout) -> (Cout, Cin, 1)
    y = ops.conv1d(y, w, p[pre + "/last_layer/b"])
    return y.transpose(1, 2)


def detector(ops: Ops, p: Params, c: dict, audio: torch.Tensor) -> torch.Tensor:
    """audio ``[B, T]`` -> bit logits ``[B, T, nbits]``."""
    return _head(ops, p, "detector", c, audio)


def locator(ops: Ops, p: Params, c: dict, audio: torch.Tensor) -> torch.Tensor:
    """audio ``[B, T]`` -> presence logits ``[B, T]``."""
    return _head(ops, p, "locator", c, audio)[..., 0]


# -- the weights' names, shapes and initial draws ----------------------------------


def _conv(name: str, k: int, cin: int, cout: int, bias: bool = False
          ) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    yield name + "/v", (k, cin, cout), "conv"
    yield name + "/g", (cout,), "norm"
    if bias:
        yield name + "/b", (cout,), "zero"


def _dense(name: str, n_in: int, n_out: int, bias_kind: str = "zero"
           ) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    yield name + "/kernel", (n_in, n_out), "dense"
    yield name + "/bias", (n_out,), bias_kind


def _encoder_spec(pre: str, c: dict) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    nf, k, ed = c["channels_enc"], c["kernel_size"], c.get("embedding_dim", 64)
    nbits = c.get("msg_dimension", c.get("nbits", 16))
    yield from _conv(pre + "/conv_pre/conv", k, 1, nf)
    yield from _dense(pre + "/msg_in", nbits, ed)
    for i in range(c.get("embedding_layers", 2)):
        yield from _dense(f"{pre}/msg_hidden_{i}", ed, ed)
    mult = 1
    for bi, ratio in enumerate(reversed(list(c["strides"]))):
        dim = mult * nf
        for j in range(c["n_residual_enc"]):
            for i in range(2):
                yield from _conv(f"{pre}/block_{bi}_{j}/block_{i}_pw/conv", 1, dim, dim)
                yield from _conv(f"{pre}/block_{bi}_{j}/block_{i}_dw/conv",
                                 c["residual_kernel_size"], 1, dim)
        yield from _conv(f"{pre}/spec_block_{bi}/proj/conv", 1,
                         mult * c["n_fft_base"] // 2 + 1, dim)
        yield from _conv(f"{pre}/down_{bi}_expand/conv", 1, dim, 2 * dim)
        yield from _conv(f"{pre}/down_{bi}_dw/conv", 2 * ratio, 1, 2 * dim)
        for band in range(c.get("freq_bands", 4)):
            yield from _dense(f"{pre}/film_{bi}_{band}/gamma", ed, 1, "film_gamma")
            yield from _dense(f"{pre}/film_{bi}_{band}/beta", ed, 1)
        mult *= 2
    top = mult * nf
    yield from _conv(pre + "/spec_post/proj/conv", 1, mult * c["n_fft_base"] // 2 + 1, top)
    yield from _conv(pre + "/post_dw/conv", c["last_kernel_size"], 1, top)
    yield pre + "/post_proj/b", (c["dimension"],), "normal"
    yield from _conv(pre + "/post_proj/conv/conv", 1, top, c["dimension"])


def _decoder_spec(pre: str, c: dict) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    nf, ratios = c["channels_dec"], list(c["strides"])
    mult = 2 ** len(ratios)
    yield from _conv(pre + "/conv_in/conv", 1, c["dimension"], mult * nf)
    yield from _conv(pre + "/conv_in_dw/conv", c["kernel_size"], 1, mult * nf)
    for i, ratio in enumerate(ratios):
        dim = mult * nf
        yield f"{pre}/up_{i}_dw/convtr/v", (dim, 1, 2 * ratio), "convtr"
        yield f"{pre}/up_{i}_dw/convtr/g", (dim,), "norm"
        yield from _conv(f"{pre}/up_{i}_proj/conv", 1, dim, dim // 2)
        for j in range(c["n_residual_dec"]):
            for u in range(2):
                yield from _conv(f"{pre}/block_{i}_{j}/block_{u}_pw/conv", 1,
                                 dim // 2, dim // 2)
                yield from _conv(f"{pre}/block_{i}_{j}/block_{u}_dw/conv",
                                 c["residual_kernel_size"], 1, dim // 2)
        mult //= 2
    yield from _conv(pre + "/conv_out/conv", c["last_kernel_size"], nf, 1)


def _head_spec(pre: str, c: dict, n_out: int) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    yield from _encoder_spec(pre + "/encoder", c)
    h = hop(c)
    yield pre + "/reverse_convolution/v", (c["dimension"], c["output_dim"], h), "convtr"
    yield pre + "/reverse_convolution/b", (c["output_dim"],), "zero"
    yield pre + "/last_layer/v", (1, c["output_dim"], n_out), "conv"
    yield pre + "/last_layer/b", (n_out,), "zero"


def param_spec(sections: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(flax name, flax shape, initial draw) of every weight of the three
    networks of a config (``Generator``, ``Detector``, ``Locator``
    sections)."""
    g, d, loc = sections["Generator"], sections["Detector"], sections["Locator"]
    out = list(_encoder_spec("generator/encoder", g))
    out += list(_decoder_spec("generator/decoder", g))
    out += list(_head_spec("detector", {**d, "msg_dimension": g["msg_dimension"]},
                           d["nbits"]))
    out += list(_head_spec("locator", {**loc, "msg_dimension": g["msg_dimension"]}, 1))
    return out
