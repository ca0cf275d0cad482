"""WavMark (Chen et al., "WavMark: Watermarking for Audio Generation",
arXiv:2308.12770; github.com/wavmark/wavmark) and a holder that serves it
through ``WaveVerify`` as :class:`WatermarkModels` serves WaveVerify's.

WavMark marks 1 s segments. Each segment's STFT (Hann, ``center``, real and
imaginary parts as 2 channels: ``[N, 2, frames, bins]``) goes through an
invertible network of HiNet's coupling blocks, together with the STFT of
the message ``watermark_fc(bits)``:

- :class:`DenseSubnet`: HiNet's ``ResidualDenseBlock_out``, five 3x3 convs,
  each over the input and every earlier output, LeakyReLU on the first four;
- :class:`CouplingBlock`: HiNet's ``INV_block``, three subnets ``r``, ``y``,
  ``f``; forward ``y1 = x1 + f(x2)``, ``y2 = e(r(y1)) x2 + y(y1)``, and the
  exact reverse;
- :class:`InvertibleNet`: the blocks in order (embedding), or in reverse
  order, each reversed (decoding).

Embedding returns ``istft(y1)``; decoding runs the net in reverse on
``(S(audio), S(audio))`` and reads ``clamp(watermark_fc_back(istft(y2)),
-1, 1)``, one value per bit. The bits are the config's fixed pattern, then
the payload.

A clip is cut into whole segments; a tail shorter than a segment is
returned unmarked (the residual is zero there) and detection ignores it.
All segments of a batch run as one batch. Under a profiler the holder
records the spans ``wavmark.stft`` and ``wavmark.istft`` (``device=True``)
around each transform, ``wavmark.inn`` (``device=True``) around each pass
of the network, and inside it ``inn.block`` around each coupling block.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from waveverify_torch import spans
from waveverify_torch.config import WavMarkConfig
from waveverify_torch.modules.conv import NormConv2d
from waveverify_torch.ops.dsp import istft, stft


class DenseSubnet(nn.Module):
    """HiNet's ``ResidualDenseBlock_out``: ``h_k = lrelu(conv_k([x, h_1 ..
    h_{k-1}]))`` for k = 1..4 (``growth`` channels each), then ``conv5``
    over all of them back to the input's channels, without activation."""

    def __init__(self, channels: int, growth: int, slope: float):
        super().__init__()
        self.slope = slope
        for k in range(1, 6):
            setattr(self, f"conv{k}", NormConv2d(
                channels + (k - 1) * growth, channels if k == 5 else growth, (3, 3),
                padding=(1, 1), use_bias=True, norm="none"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = x
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            h = F.leaky_relu(conv(feats), self.slope, inplace=True)
            feats = torch.cat((feats, h), dim=1)
        return self.conv5(feats)


class CouplingBlock(nn.Module):
    """HiNet's ``INV_block`` over two halves of ``channels`` each."""

    def __init__(self, cfg: WavMarkConfig, channels: int = 2):
        super().__init__()
        self.clamp = cfg.clamp
        self.r = DenseSubnet(channels, cfg.growth, cfg.slope)
        self.y = DenseSubnet(channels, cfg.growth, cfg.slope)
        self.f = DenseSubnet(channels, cfg.growth, cfg.slope)

    def e(self, s: torch.Tensor) -> torch.Tensor:
        return torch.exp(2.0 * self.clamp * (torch.sigmoid(s) - 0.5))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        y1 = x1 + self.f(x2)
        return y1, self.e(self.r(y1)) * x2 + self.y(y1)

    def reverse(self, x1: torch.Tensor, x2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        y2 = (x2 - self.y(x1)) / self.e(self.r(x1))
        return x1 - self.f(y2), y2


class InvertibleNet(nn.Module):
    """HiNet: ``num_layers`` coupling blocks (``inv_blocks``)."""

    def __init__(self, cfg: WavMarkConfig):
        super().__init__()
        self.inv_blocks = nn.ModuleList(CouplingBlock(cfg) for _ in range(cfg.num_layers))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, rev: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        with spans.span("wavmark.inn", device=True):
            for block in (reversed(self.inv_blocks) if rev else self.inv_blocks):
                with spans.span("inn.block"):
                    x1, x2 = block.reverse(x1, x2) if rev else block(x1, x2)
        return x1, x2


class WavMarkModels(nn.Module):
    """WavMark's network, message linears and segmenting behind
    ``WatermarkModels``' interface. Its parameters carry the published
    ``Model``'s names (``hinet.inv_blocks.{i}.{r,y,f}.conv{k}``,
    ``watermark_fc``, ``watermark_fc_back``), a conv's ``weight`` / ``bias``
    as the port's ``v`` / ``b``."""

    # segments are cut from the clip as it is: no bucket padding, no windows
    whole_input = True

    def __init__(self, cfg: WavMarkConfig):
        super().__init__()
        if any(b not in (0, 1) for b in cfg.pattern):
            raise ValueError(f"pattern {cfg.pattern!r}: bits are 0 or 1")
        self.config = cfg
        self.hinet = InvertibleNet(cfg)
        self.watermark_fc = nn.Linear(cfg.num_bits, cfg.segment)
        self.watermark_fc_back = nn.Linear(cfg.segment, cfg.num_bits)
        self.register_buffer("pattern", torch.tensor(cfg.pattern, dtype=torch.float32),
                             persistent=False)

    def _segments(self, audio: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """``[B, T]`` -> (its whole segments ``[B * n, segment]``, n)."""
        seg = self.config.segment
        n = audio.shape[-1] // seg
        return audio[:, :n * seg].reshape(-1, seg), n

    # The transforms sum in float64 and round to the input's dtype: as a
    # matmul the rDFT sums n_fft products, which in float32 loses several
    # times an FFT's precision (the decoder's reverse pass then carries it);
    # in float64 (over the float32 window and bases) it costs about 1.5 ms a
    # call on an H100.

    def _spectrum(self, x: torch.Tensor) -> torch.Tensor:
        """``[N, segment]`` -> ``[N, 2, frames, bins]``."""
        with spans.span("wavmark.stft", device=True):
            re, im = stft(x.double(), self.config.n_fft, self.config.hop_length)
            return torch.stack((re, im), dim=1).to(x.dtype)

    def _signal(self, s: torch.Tensor) -> torch.Tensor:
        """``[N, 2, frames, bins]`` -> ``[N, segment]``."""
        with spans.span("wavmark.istft", device=True):
            n, _, frames, bins = s.shape
            spec = s.double().transpose(1, 2).reshape(n, frames, 2 * bins)
            return istft(spec, self.config.n_fft, self.config.hop_length,
                         self.config.segment).to(s.dtype)

    def apply_generator(self, audio: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
        """audio ``[B, T]``, payload ``[B, payload_bits]`` of {0, 1} -> the
        residual ``[B, T]``: the watermarked segments less the audio, zero
        on the tail."""
        b = audio.shape[0]
        x, n = self._segments(audio)
        out = torch.zeros_like(audio)
        if n == 0:
            return out
        bits = torch.cat((self.pattern.expand(b, -1), msg.to(self.pattern.dtype)), dim=1)
        # one message spectrum per clip, shared by its segments
        x2 = self._spectrum(self.watermark_fc(bits)).repeat_interleave(n, dim=0)
        y1, _ = self.hinet(self._spectrum(x), x2)
        out[:, :n * self.config.segment] = (self._signal(y1) - x).reshape(b, -1)
        return out

    def apply_detector(self, audio: torch.Tensor) -> torch.Tensor:
        """audio ``[B, T]`` -> each segment's decoded values ``[B, n,
        num_bits]`` in [-1, 1], pattern first."""
        b = audio.shape[0]
        x, n = self._segments(audio)
        if n == 0:
            return audio.new_zeros(b, 0, self.config.num_bits)
        s = self._spectrum(x)
        _, y2 = self.hinet(s, s, rev=True)
        v = torch.clamp(self.watermark_fc_back(self._signal(y2)), -1.0, 1.0)
        return v.reshape(b, n, -1)

    def decide(self, values: torch.Tensor, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(bit probabilities ``[B, payload_bits]``, confidence ``[B]``) from
        ``values`` ``[B, n, num_bits]`` over the segments that lie whole in
        the first ``t`` samples. A decoded value of 0.5 or more reads as a
        1, WavMark's threshold: a payload bit's probability is the mean of
        its values over the segments, clipped to [0, 1]; the confidence is
        the share of pattern bits that read as the pattern, averaged over
        the segments. Without a whole segment both are 0."""
        n = min(t // self.config.segment, values.shape[1])
        values, k = values[:, :n], len(self.config.pattern)
        probs = torch.clamp(values[..., k:].sum(dim=1) / max(n, 1), 0.0, 1.0)
        agree = ((values[..., :k] >= 0.5) == (self.pattern >= 0.5)).float().mean(dim=-1)
        return probs, agree.sum(dim=1) / max(n, 1)

    def apply_locator(self, audio: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("WavMark has no locator: it decodes whole 1 s "
                                  "segments and gives no per-sample presence")


def init_wavmark(root: WavMarkModels, generator: torch.Generator) -> None:
    """Draw every parameter of ``root`` from ``generator`` (a CPU
    ``torch.Generator``), in module order, by PyTorch's default
    initialisers: weights and biases uniform in +-1/sqrt(fan_in). Each
    subnet's ``conv5`` starts at zero, as HiNet initialises it, so a fresh
    network is the identity and embedding leaves the audio as it is."""
    with torch.no_grad():
        for name, m in root.named_modules():
            if isinstance(m, NormConv2d):
                w, b = m.v, m.b
            elif isinstance(m, nn.Linear):
                w, b = m.weight, m.bias
            else:
                continue
            if name.endswith("conv5"):
                w.zero_()
                b.zero_()
                continue
            bound = 1.0 / math.sqrt(math.prod(w.shape[1:]))
            for p in (w, b):
                p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
