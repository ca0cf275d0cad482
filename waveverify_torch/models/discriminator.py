"""Adversarial discriminator ensemble: MPD + MSD + MRD (counterpart of
``waveverify_tpu/models/discriminator.py``).

Training only. Activations are NCHW (``[B, C, H, W]``) where the JAX
package's are NHWC: an MPD's image is ``[B, C, T / period, period]`` and
an MRD's is ``[B, C, frames, freq]``. Module and parameter names follow the
JAX tree (``mpd_0/conv_0/v`` is ``mpd_0.conv_0.v``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from waveverify_torch.config import DiscriminatorConfig
from waveverify_torch.modules.conv import NormConv1d, NormConv2d
from waveverify_torch.ops.dsp import resample, stft_match_stride

_LEAKY_SLOPE = 0.1

FeatureMaps = List[torch.Tensor]


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=_LEAKY_SLOPE)


class MPD(nn.Module):
    """Multi-period discriminator: audio ``[B, T]`` folded into a
    ``[T / period, period]`` image, (5, 1) convs striding the time axis."""

    _SPECS = [(1, 32), (32, 128), (128, 512), (512, 1024)]

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        for i, (cin, cout) in enumerate(self._SPECS):
            setattr(self, f"conv_{i}", NormConv2d(
                cin, cout, (5, 1), stride=(3, 1), padding=(2, 0),
                norm="weight_norm"))
        self.conv_4 = NormConv2d(1024, 1024, (5, 1), padding=(2, 0),
                                 norm="weight_norm")
        self.conv_post = NormConv2d(1024, 1, (3, 1), padding=(1, 0),
                                    norm="weight_norm")

    def forward(self, x: torch.Tensor) -> FeatureMaps:
        # the pad is period - T % period, a whole period when T divides
        # evenly (the reference's quirk)
        t = x.shape[-1]
        x = F.pad(x[:, None, :], (0, self.period - t % self.period),
                  mode="reflect")
        x = x.reshape(x.shape[0], 1, -1, self.period)
        fmaps: FeatureMaps = []
        for i in range(5):
            x = _lrelu(getattr(self, f"conv_{i}")(x))
            fmaps.append(x)
        fmaps.append(self.conv_post(x))
        return fmaps


class MSD(nn.Module):
    """Multi-scale discriminator: grouped 1-D convs over audio resampled by
    ``rate`` (off in conf/base.yml, ``rates: []``)."""

    # (out channels, kernel, stride, groups, padding)
    _SPECS = [(16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20),
              (1024, 41, 4, 64, 20), (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2)]

    def __init__(self, rate: int = 1, sample_rate: int = 16000):
        super().__init__()
        self.rate, self.sample_rate = rate, sample_rate
        cin = 1
        for i, (cout, k, s, g, _) in enumerate(self._SPECS):
            setattr(self, f"conv_{i}", NormConv1d(cin, cout, k, stride=s,
                                                  groups=g, norm="weight_norm"))
            cin = cout
        self.conv_post = NormConv1d(cin, 1, 3, norm="weight_norm")

    def forward(self, x: torch.Tensor) -> FeatureMaps:
        if self.rate != 1:
            x = resample(x, self.sample_rate, self.sample_rate // self.rate)
        x = x[:, None, :]
        fmaps: FeatureMaps = []
        for i, (*_, p) in enumerate(self._SPECS):
            x = _lrelu(getattr(self, f"conv_{i}")(F.pad(x, (p, p))))
            fmaps.append(x)
        fmaps.append(self.conv_post(F.pad(x, (1, 1))))
        return fmaps


class MRD(nn.Module):
    """Multi-resolution discriminator over the complex STFT, one conv stack
    per frequency band."""

    # (kernel, stride, padding) over (frames, freq)
    _SPECS = [((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)),
              ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
              ((3, 3), (1, 1), (1, 1))]

    def __init__(self, window_length: int, hop_factor: float = 0.25,
                 bands: Sequence[Tuple[float, float]] = DiscriminatorConfig.bands,
                 channels: int = 32):
        super().__init__()
        self.window_length = window_length
        self.hop = int(window_length * hop_factor)
        n_freq = window_length // 2 + 1
        self.band_idx = [(int(b0 * n_freq), int(b1 * n_freq)) for b0, b1 in bands]
        for bi in range(len(bands)):
            cin = 2
            for ci, (k, s, p) in enumerate(self._SPECS):
                setattr(self, f"band_{bi}_conv_{ci}", NormConv2d(
                    cin, channels, k, stride=s, padding=p, norm="weight_norm"))
                cin = channels
        self.conv_post = NormConv2d(channels, 1, (3, 3), padding=(1, 1),
                                    norm="weight_norm")

    def forward(self, x: torch.Tensor) -> FeatureMaps:
        re, im = stft_match_stride(x, self.window_length, self.hop)
        spec = torch.stack([re, im], dim=1)  # [B, 2, frames, freq]
        fmaps: FeatureMaps = []
        processed = []
        for bi, (lo, hi) in enumerate(self.band_idx):
            band = spec[..., lo:hi]
            for ci in range(len(self._SPECS)):
                band = _lrelu(getattr(self, f"band_{bi}_conv_{ci}")(band))
                fmaps.append(band)
            processed.append(band)
        fmaps.append(self.conv_post(torch.cat(processed, dim=-1)))
        return fmaps


class Discriminator(nn.Module):
    """MPDs (one per period), MSDs (per rate), MRDs (per FFT size).

    audio ``[B, T]`` -> one list of feature maps per sub-discriminator; the
    last map of each list is its logit map."""

    def __init__(self, config: DiscriminatorConfig = DiscriminatorConfig()):
        super().__init__()
        self.config = c = config
        for i, period in enumerate(c.periods):
            setattr(self, f"mpd_{i}", MPD(period))
        for i, rate in enumerate(c.rates):
            setattr(self, f"msd_{i}", MSD(rate, c.sample_rate))
        for i, fft_size in enumerate(c.fft_sizes):
            setattr(self, f"mrd_{i}", MRD(fft_size, bands=tuple(c.bands)))
        self.names = ([f"mpd_{i}" for i in range(len(c.periods))]
                      + [f"msd_{i}" for i in range(len(c.rates))]
                      + [f"mrd_{i}" for i in range(len(c.fft_sizes))])

    @staticmethod
    def preprocess(y: torch.Tensor) -> torch.Tensor:
        """DC removal and 0.8 peak normalisation per clip."""
        y = y - torch.mean(y, dim=-1, keepdim=True)
        peak = torch.amax(torch.abs(y), dim=-1, keepdim=True) + 1e-9
        return 0.8 * y / peak

    def forward(self, x: torch.Tensor) -> List[FeatureMaps]:
        x = self.preprocess(x)
        return [getattr(self, name)(x) for name in self.names]
