"""Plain reference of WavMark (Chen et al., "WavMark: Watermarking for Audio
Generation", arXiv:2308.12770; code at github.com/wavmark/wavmark, whose
``load_model`` builds ``Model(16000, num_bit=32, n_fft=1000, hop_length=400,
num_layers=8)`` with HiNet's coupling blocks), as functions of a state dict
in the published ``Model``'s layout:

- ``hinet.inv_blocks.{i}.{r,y,f}.conv{1..5}.{weight,bias}``: block i's
  three dense subnets (HiNet's ``ResidualDenseBlock_out``, 2 -> 2
  channels, growth 32: five 3x3 convs with bias, each over the input and
  every earlier output, LeakyReLU on the first four);
- ``watermark_fc.{weight,bias}`` (``Linear(32, 16000)``) and
  ``watermark_fc_back.{weight,bias}`` (``Linear(16000, 32)``).

The spectra are ``torch.stft`` / ``torch.istft`` (periodic Hann window,
``center=True``, reflect padding), real and imaginary parts as two channels
``[N, 2, frames, bins]``. Every conv and matrix product goes through
``ops`` (``conv2d``, ``matmul``), which decides its precision; the entry
points set TF32 off for cuBLAS and cuDNN first, so ``ops`` alone lowers
it. No batching beyond one call per transform, no fused layer.

A config is a dict: ``segment``, ``n_fft``, ``hop``, ``num_layers``,
``clamp``, ``growth``, ``slope``, ``num_bits`` (:data:`PUBLISHED` holds the
released model's). Bits are WavMark's: {0, 1} into ``watermark_fc``, a
decoded value of 0.5 or more reads as 1. A clip is cut into whole segments;
a shorter tail is left unmarked and not decoded.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

PUBLISHED = {"segment": 16000, "n_fft": 1000, "hop": 400, "num_layers": 8,
             "clamp": 2.0, "growth": 32, "slope": 0.01, "num_bits": 32}
# conv5's deviation, times 1/sqrt(fan_in): small, so that each coupling keeps
# its input's scale both ways (e(r) stays within about [0.5, 2], where 0.1
# let the reverse pass grow a bin 10^4-fold); the published conv5 starts at
# zero, which makes every block the identity
OUT_GAIN = 0.03


def strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- the state dict ----------------------------------------------------------------
#
# A spec entry is (key, shape, draw, scale): ``normal`` N(0, scale^2),
# ``uniform`` U(-scale, scale), ``zero`` zeros.


def subnet_spec(pre: str, cfg: dict, channels: int = 2) -> List[tuple]:
    """One dense subnet: conv1-4 N(0, 1/fan_in) with PyTorch's default bias
    draw, conv5 N(0, OUT_GAIN^2/fan_in) with a zero bias."""
    out = []
    for k in range(1, 6):
        cin = channels + (k - 1) * cfg["growth"]
        cout = channels if k == 5 else cfg["growth"]
        fan = 9 * cin
        gain = OUT_GAIN if k == 5 else 1.0
        out += [(f"{pre}.conv{k}.weight", (cout, cin, 3, 3), "normal", gain * fan ** -0.5),
                (f"{pre}.conv{k}.bias", (cout,), "zero" if k == 5 else "uniform",
                 fan ** -0.5)]
    return out


def state_spec(cfg: dict) -> List[tuple]:
    """Every key of the published ``Model``; the linears by PyTorch's
    default draw, U(+-1/sqrt(fan_in))."""
    out = []
    for i in range(cfg["num_layers"]):
        for net in ("r", "y", "f"):
            out += subnet_spec(f"hinet.inv_blocks.{i}.{net}", cfg)
    nb, seg = cfg["num_bits"], cfg["segment"]
    for name, cin, cout in (("watermark_fc", nb, seg), ("watermark_fc_back", seg, nb)):
        out += [(f"{name}.weight", (cout, cin), "uniform", cin ** -0.5),
                (f"{name}.bias", (cout,), "uniform", cin ** -0.5)]
    return out


def make_state_dict(seed: int, cfg: dict = PUBLISHED, device="cpu") -> Params:
    """The state dict drawn from ``seed`` on a CPU generator, in
    :func:`state_spec`'s order, then moved to ``device``."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape, draw, scale in state_spec(cfg):
        if draw == "normal":
            v = torch.randn(shape, generator=g) * scale
        elif draw == "uniform":
            v = torch.rand(shape, generator=g) * (2 * scale) - scale
        else:
            v = torch.zeros(shape)
        sd[key] = v.to(device)
    return sd


# -- the network -------------------------------------------------------------------


def spectrum(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """``[N, segment]`` -> ``[N, 2, frames, bins]``."""
    w = torch.hann_window(cfg["n_fft"], device=x.device, dtype=x.dtype)
    s = torch.stft(x, cfg["n_fft"], cfg["hop"], window=w, center=True,
                   pad_mode="reflect", return_complex=True)
    return torch.stack((s.real, s.imag), dim=1).transpose(2, 3)


def signal(cfg: dict, s: torch.Tensor) -> torch.Tensor:
    """``[N, 2, frames, bins]`` -> ``[N, segment]``."""
    w = torch.hann_window(cfg["n_fft"], device=s.device, dtype=s.dtype)
    spec = torch.complex(s[:, 0], s[:, 1]).transpose(1, 2)
    return torch.istft(spec, cfg["n_fft"], cfg["hop"], window=w, center=True,
                       length=cfg["segment"])


def subnet(ops, p: Params, pre: str, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """``ResidualDenseBlock_out``."""
    feats = x
    for k in range(1, 5):
        h = ops.conv2d(feats, p[f"{pre}.conv{k}.weight"], p[f"{pre}.conv{k}.bias"], padding=1)
        feats = torch.cat((feats, F.leaky_relu(h, cfg["slope"])), dim=1)
    return ops.conv2d(feats, p[f"{pre}.conv5.weight"], p[f"{pre}.conv5.bias"], padding=1)


def _e(cfg: dict, s: torch.Tensor) -> torch.Tensor:
    return torch.exp(cfg["clamp"] * 2 * (torch.sigmoid(s) - 0.5))


def block(ops, p: Params, i: int, cfg: dict, x1: torch.Tensor, x2: torch.Tensor,
          rev: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``INV_block`` i, forward or reverse."""
    pre = f"hinet.inv_blocks.{i}"
    if not rev:
        y1 = x1 + subnet(ops, p, f"{pre}.f", cfg, x2)
        y2 = _e(cfg, subnet(ops, p, f"{pre}.r", cfg, y1)) * x2 + subnet(ops, p, f"{pre}.y",
                                                                      cfg, y1)
        return y1, y2
    y2 = (x2 - subnet(ops, p, f"{pre}.y", cfg, x1)) / _e(cfg, subnet(ops, p, f"{pre}.r", cfg, x1))
    return x1 - subnet(ops, p, f"{pre}.f", cfg, y2), y2


def hinet(ops, p: Params, cfg: dict, x1: torch.Tensor, x2: torch.Tensor,
          rev: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    order = range(cfg["num_layers"])
    for i in (reversed(order) if rev else order):
        x1, x2 = block(ops, p, i, cfg, x1, x2, rev)
    return x1, x2


def linear(ops, p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return ops.matmul(x, p[f"{name}.weight"].t()) + p[f"{name}.bias"]


# -- a clip ------------------------------------------------------------------------


def segments(cfg: dict, audio: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``[B, T]`` -> (its whole segments ``[B * n, segment]``, n)."""
    n = audio.shape[-1] // cfg["segment"]
    return audio[:, :n * cfg["segment"]].reshape(-1, cfg["segment"]), n


def embed(ops, p: Params, cfg: dict, audio: torch.Tensor, bits: torch.Tensor
          ) -> torch.Tensor:
    """``Model.encode`` on each whole segment: audio ``[B, T]``, the 32
    bits ``[B, num_bits]`` (pattern, then payload) -> the watermarked audio
    ``[B, T]``, its tail as it came."""
    strict_f32()
    x, n = segments(cfg, audio)
    out = audio.clone()
    if n == 0:
        return out
    m = linear(ops, p, "watermark_fc", bits).repeat_interleave(n, dim=0)
    y1, _ = hinet(ops, p, cfg, spectrum(cfg, x), spectrum(cfg, m))
    out[:, :n * cfg["segment"]] = signal(cfg, y1).reshape(audio.shape[0], -1)
    return out


def decode(ops, p: Params, cfg: dict, audio: torch.Tensor) -> torch.Tensor:
    """``Model.decode`` on each whole segment: audio ``[B, T]`` -> the
    decoded values ``[B, n, num_bits]`` in [-1, 1]."""
    strict_f32()
    x, n = segments(cfg, audio)
    s = spectrum(cfg, x)
    _, y2 = hinet(ops, p, cfg, s, s, rev=True)
    v = torch.clamp(linear(ops, p, "watermark_fc_back", signal(cfg, y2)), -1.0, 1.0)
    return v.reshape(audio.shape[0], n, -1)


def decide(v: torch.Tensor, pattern: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The port's aggregation over a clip's segments, from ``v`` ``[B, n,
    num_bits]``: (payload bit probabilities, each the mean of its values
    clipped to [0, 1]; the share of pattern bits that read as the pattern,
    averaged over the segments)."""
    k = len(pattern)
    want = torch.tensor(pattern, device=v.device) == 1
    probs = torch.clamp(v[..., k:].mean(dim=1), 0.0, 1.0)
    return probs, ((v[..., :k] >= 0.5) == want).double().mean(dim=-1).mean(dim=1)
