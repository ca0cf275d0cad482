"""Plain reference of AudioSeal (San Roman et al., "Proactive Detection of
Voice Cloning with Localized Watermarking", ICML 2024; code at
github.com/facebookresearch/audioseal, modules from audiocraft's
``modules/seanet.py``, ``lstm.py`` and ``conv.py``), as functions of the
state dicts of AudioSeal's two trees.

The weights are AudioSeal's own keys: ``AudioSealWM``'s
(``encoder.model.0.conv.conv.weight_g``, ``...weight_v``, ``...bias``,
``encoder.model.13.lstm.weight_ih_l0``, ``msg_processor.msg_processor.weight``)
and ``AudioSealDetector``'s (``detector.0.model...``,
``detector.0.reverse_convolution.weight``, ``detector.1.weight``), float32
tensors in torch's layouts. Weight norm (``w = g * v / ||v||``, the norm
over every dim but 0) is applied on every call.

Every product goes through ``ops`` (``conv1d``, ``conv_transpose1d``,
``matmul``), which decides its precision; a caller passes an object with
those three methods. The LSTM is a loop over frames of ``ops.matmul`` and
the gates, in PyTorch's gate order (input, forget, cell, output). No fused
head, no cuDNN RNN, no batching of frames; one call of each conv.

The options are the published cards' (``audioseal_wm_16bits.yaml``,
``audioseal_detector_16bits.yaml``): ELU, weight norm, not causal, zero
padding, identity skips, no final activation, all norms on;
:func:`check_config` refuses any other. The widths, ratios, residual
layers, dilation base, compression, LSTM depth and bit count are free.
A config is a dict of the cards' ``seanet`` keys plus ``nbits``,
``output_dim`` and ``alpha``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Params = Dict[str, torch.Tensor]

# option -> the only value the reference implements
FIXED = {"channels": 1, "activation": "ELU", "activation_params": {"alpha": 1.0},
         "norm": "weight_norm", "causal": False, "pad_mode": "constant",
         "true_skip": True, "disable_norm_outer_blocks": 0, "final_activation": None,
         "trim_right_ratio": 1.0}


def check_config(cfg: dict) -> None:
    """Raise if the config leaves what the reference implements."""
    for key, want in FIXED.items():
        if key in cfg and cfg[key] != want:
            raise ValueError(f"{key} = {cfg[key]!r}: the reference implements {want!r} only")


def elu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.expm1(torch.clamp(x, max=0.0)))


def hop(cfg: dict) -> int:
    return math.prod(cfg["ratios"])


# -- the trees' keys -------------------------------------------------------------
#
# A spec entry is (key, shape, draw, scale): ``normal`` N(0, scale^2),
# ``uniform`` U(-scale, scale), ``norm`` the norm of the ``weight_v`` beside it.


def _conv_spec(pre: str, cin: int, cout: int, k: int, stride: int = 1,
               transposed: bool = False):
    """A weight-normed conv's keys. The kernel keeps its input's scale: N(0,
    1/n), n the products summed into one output (``cin * k``, or ``cin * k /
    stride`` for a transposed conv); the bias is PyTorch's default draw."""
    v = (cin, cout, k) if transposed else (cout, cin, k)
    fan = cin * k // stride if transposed else cin * k
    return [(f"{pre}.weight_g", (v[0], 1, 1), "norm", 0.0),
            (f"{pre}.weight_v", v, "normal", fan ** -0.5),
            (f"{pre}.bias", (cout,), "uniform", (v[1] * k) ** -0.5)]


def _lstm_spec(pre: str, dim: int, layers: int):
    """PyTorch's default draw: every tensor U(+-1/sqrt(hidden))."""
    out = []
    for n in range(layers):
        out += [(f"{pre}.weight_ih_l{n}", (4 * dim, dim), "uniform", dim ** -0.5),
                (f"{pre}.weight_hh_l{n}", (4 * dim, dim), "uniform", dim ** -0.5),
                (f"{pre}.bias_ih_l{n}", (4 * dim,), "uniform", dim ** -0.5),
                (f"{pre}.bias_hh_l{n}", (4 * dim,), "uniform", dim ** -0.5)]
    return out


def _resblock_spec(pre: str, cfg: dict, dim: int):
    hidden = dim // cfg["compress"]
    return (_conv_spec(f"{pre}.block.1.conv.conv", dim, hidden, cfg["residual_kernel_size"])
            + _conv_spec(f"{pre}.block.3.conv.conv", hidden, dim, 1))


def encoder_spec(pre: str, cfg: dict):
    """The keys of a SEANet encoder at ``pre`` (``encoder``, ``detector.0``)."""
    nf = cfg["n_filters"]
    out = _conv_spec(f"{pre}.model.0.conv.conv", 1, nf, cfg["kernel_size"])
    i, mult = 1, 1
    for ratio in reversed(cfg["ratios"]):
        for _ in range(cfg["n_residual_layers"]):
            out += _resblock_spec(f"{pre}.model.{i}", cfg, mult * nf)
            i += 1
        out += _conv_spec(f"{pre}.model.{i + 1}.conv.conv", mult * nf, 2 * mult * nf,
                          2 * ratio)
        i += 2
        mult *= 2
    if cfg["lstm"]:
        out += _lstm_spec(f"{pre}.model.{i}.lstm", mult * nf, cfg["lstm"])
        i += 1
    out += _conv_spec(f"{pre}.model.{i + 1}.conv.conv", mult * nf, cfg["dimension"],
                      cfg["last_kernel_size"])
    return out


def decoder_spec(pre: str, cfg: dict):
    nf = cfg["n_filters"]
    mult = 2 ** len(cfg["ratios"])
    out = _conv_spec(f"{pre}.model.0.conv.conv", cfg["dimension"], mult * nf,
                     cfg["kernel_size"])
    i = 1
    if cfg["lstm"]:
        out += _lstm_spec(f"{pre}.model.{i}.lstm", mult * nf, cfg["lstm"])
        i += 1
    for ratio in cfg["ratios"]:
        out += _conv_spec(f"{pre}.model.{i + 1}.convtr.convtr", mult * nf, mult * nf // 2,
                          2 * ratio, stride=ratio, transposed=True)
        i += 2
        for _ in range(cfg["n_residual_layers"]):
            out += _resblock_spec(f"{pre}.model.{i}", cfg, mult * nf // 2)
            i += 1
        mult //= 2
    out += _conv_spec(f"{pre}.model.{i + 1}.conv.conv", nf, 1, cfg["last_kernel_size"])
    return out


def generator_spec(cfg: dict):
    """``AudioSealWM``'s keys: (key, shape, draw, scale)."""
    return (encoder_spec("encoder", cfg) + decoder_spec("decoder", cfg)
            + [("msg_processor.msg_processor.weight", (2 * cfg["nbits"], cfg["dimension"]),
                "normal", 1.0)])


def detector_spec(cfg: dict):
    """``AudioSealDetector``'s keys; the transposed conv (kernel = stride =
    hop) sums one product per input channel into an output."""
    h, d, od = hop(cfg), cfg["dimension"], cfg["output_dim"]
    return encoder_spec("detector.0", cfg) + [
        ("detector.0.reverse_convolution.weight", (d, od, h), "normal", d ** -0.5),
        ("detector.0.reverse_convolution.bias", (od,), "uniform", (od * h) ** -0.5),
        ("detector.1.weight", (2 + cfg["nbits"], od, 1), "normal", od ** -0.5),
        ("detector.1.bias", (2 + cfg["nbits"],), "uniform", od ** -0.5)]


def make_state_dicts(cfg: dict, generator: torch.Generator, device
                     ) -> Tuple[Params, Params]:
    """(``AudioSealWM``'s, ``AudioSealDetector``'s) state dicts drawn from
    ``generator`` (on ``device``) as the specs say, a weight norm's
    ``weight_g`` the norm of its ``weight_v`` (so the kernel is ``v``).

    Every kernel keeps its input's scale, as a trained network's do, so the
    detector's outputs follow its input. Under PyTorch's default draws
    (U(+-1/sqrt(fan_in)), a third of that variance) each conv shrinks its
    input by about sqrt(3), and at AudioSeal's depth the detector's logits
    barely move with the audio (by about 1e-3 over a clip)."""
    out = []
    for spec in (generator_spec(cfg), detector_spec(cfg)):
        sd: Params = {}
        for key, shape, draw, scale in spec:
            if draw == "uniform":
                sd[key] = (torch.rand(shape, generator=generator, device=device)
                           * (2 * scale) - scale)
            elif draw == "normal":
                sd[key] = torch.randn(shape, generator=generator, device=device) * scale
        for key, shape, draw, _ in spec:
            if draw == "norm":
                v = sd[key[:-1] + "v"]
                sd[key] = torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True))
        out.append({key: sd[key] for key, *_ in spec})
    return out[0], out[1]


# -- the layers --------------------------------------------------------------------


def wn(p: Params, pre: str) -> torch.Tensor:
    v, g = p[pre + ".weight_v"], p[pre + ".weight_g"]
    return g * v / torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True))


def sconv(ops, p: Params, pre: str, x: torch.Tensor, stride: int = 1,
          dilation: int = 1) -> torch.Tensor:
    """audiocraft's ``StreamableConv1d``, not causal: zero padding of
    ``(k - 1) d + 1 - stride`` split with the odd sample on the left, plus
    the right padding that completes the last window."""
    w = wn(p, pre)
    k = (w.shape[-1] - 1) * dilation + 1
    total = k - stride
    length = x.shape[-1]
    frames = (length - k + total) / stride + 1
    extra = max(0, (math.ceil(frames) - 1) * stride + (k - total) - length)
    right = total // 2
    x = torch.nn.functional.pad(x, (total - right, right + extra))
    return ops.conv1d(x, w, p[pre + ".bias"], stride=stride, dilation=dilation)


def sconvtr(ops, p: Params, pre: str, x: torch.Tensor, stride: int) -> torch.Tensor:
    """audiocraft's ``StreamableConvTranspose1d``, not causal: ``k - stride``
    samples trimmed, the odd one on the left."""
    w = wn(p, pre)
    y = ops.conv_transpose1d(x, w, p[pre + ".bias"], stride=stride)
    total = w.shape[-1] - stride
    right = total // 2
    return y[..., total - right:y.shape[-1] - right]


def resblock(ops, p: Params, pre: str, x: torch.Tensor, dilation: int) -> torch.Tensor:
    y = sconv(ops, p, f"{pre}.block.1.conv.conv", elu(x), dilation=dilation)
    return x + sconv(ops, p, f"{pre}.block.3.conv.conv", elu(y))


def lstm(ops, p: Params, pre: str, x: torch.Tensor, layers: int) -> torch.Tensor:
    """audiocraft's ``StreamableLSTM``: ``layers`` LSTM layers over the
    frames of ``x`` ``[B, C, T]``, from zero state, plus ``x``."""
    seq = list(x.permute(2, 0, 1))  # T x [B, C]
    for n in range(layers):
        w_ih = p[f"{pre}.weight_ih_l{n}"].t()
        w_hh = p[f"{pre}.weight_hh_l{n}"].t()
        bias = p[f"{pre}.bias_ih_l{n}"] + p[f"{pre}.bias_hh_l{n}"]
        h = torch.zeros(x.shape[0], w_hh.shape[0], dtype=x.dtype, device=x.device)
        c = torch.zeros_like(h)
        out: List[torch.Tensor] = []
        for xt in seq:
            gates = ops.matmul(xt, w_ih) + ops.matmul(h, w_hh) + bias
            i, f, g, o = gates.chunk(4, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        seq = out
    return torch.stack(seq, dim=2) + x


def encoder(ops, p: Params, pre: str, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """``[B, 1, T]`` -> ``[B, dimension, ceil(T / hop)]``."""
    x = sconv(ops, p, f"{pre}.model.0.conv.conv", x)
    i = 1
    for ratio in reversed(cfg["ratios"]):
        for j in range(cfg["n_residual_layers"]):
            x = resblock(ops, p, f"{pre}.model.{i}", x, cfg["dilation_base"] ** j)
            i += 1
        x = sconv(ops, p, f"{pre}.model.{i + 1}.conv.conv", elu(x), stride=ratio)
        i += 2
    if cfg["lstm"]:
        x = lstm(ops, p, f"{pre}.model.{i}.lstm", x, cfg["lstm"])
        i += 1
    return sconv(ops, p, f"{pre}.model.{i + 1}.conv.conv", elu(x))


def decoder(ops, p: Params, pre: str, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    x = sconv(ops, p, f"{pre}.model.0.conv.conv", x)
    i = 1
    if cfg["lstm"]:
        x = lstm(ops, p, f"{pre}.model.{i}.lstm", x, cfg["lstm"])
        i += 1
    for ratio in cfg["ratios"]:
        x = sconvtr(ops, p, f"{pre}.model.{i + 1}.convtr.convtr", elu(x), ratio)
        i += 2
        for j in range(cfg["n_residual_layers"]):
            x = resblock(ops, p, f"{pre}.model.{i}", x, cfg["dilation_base"] ** j)
            i += 1
    return sconv(ops, p, f"{pre}.model.{i + 1}.conv.conv", elu(x))


def msg_processor(p: Params, hidden: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """``hidden [B, H, T'] + sum_k E[2k + msg_k]`` on every frame."""
    table = p["msg_processor.msg_processor.weight"]
    idx = 2 * torch.arange(msg.shape[-1], device=msg.device) + msg.long()
    return hidden + table[idx].sum(dim=1)[:, :, None]


def watermark(ops, p: Params, cfg: dict, audio: torch.Tensor, msg: torch.Tensor
              ) -> torch.Tensor:
    """``AudioSealWM.get_watermark`` at 16 kHz: audio ``[B, T]``, bits
    ``[B, nbits]`` -> the watermark ``[B, T]`` (before ``alpha``)."""
    check_config(cfg)
    hidden = msg_processor(p, encoder(ops, p, "encoder", cfg, audio[:, None, :]), msg)
    return decoder(ops, p, "decoder", cfg, hidden)[:, 0, :audio.shape[-1]]


def detector_logits(ops, p: Params, cfg: dict, audio: torch.Tensor) -> torch.Tensor:
    """audio ``[B, T]`` -> the detector's raw outputs ``[B, 2 + nbits, T]``."""
    check_config(cfg)
    z = encoder(ops, p, "detector.0", cfg, audio[:, None, :])
    up = ops.conv_transpose1d(z, p["detector.0.reverse_convolution.weight"],
                              p["detector.0.reverse_convolution.bias"], stride=hop(cfg))
    up = up[:, :, :audio.shape[-1]]
    return ops.conv1d(up, p["detector.1.weight"], p["detector.1.bias"])


def detect(ops, p: Params, cfg: dict, audio: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``AudioSealDetector.forward``: (presence probability ``[B, T]``,
    softmax channel 1; message probabilities ``[B, nbits]``, the sigmoid
    of each bit logit's time-mean)."""
    logits = detector_logits(ops, p, cfg, audio)
    presence = torch.softmax(logits[:, :2], dim=1)[:, 1]
    return presence, torch.sigmoid(logits[:, 2:].mean(dim=-1))
