"""The audio effects of the robustness sweep and of the training bank
(counterpart of the matching part of ``waveverify_tpu/effects/effects.py``).

Every effect maps ``(audio [B, T], mask [B, T] or None, generator,
**params) -> (audio, mask)`` at the same length T, on the audio's device.
``generator`` is a ``torch.Generator`` on that device; only
``random_noise`` draws from it, so its realisation differs from the JAX
package's (other bits from another generator) while its statistics match.
:class:`EffectBank` runs the training branches with their noise drawn
beforehand, so a training step can be replayed exactly.

The host codecs (mp3, aac) round-trip through ``ffmpeg`` when it is on
``PATH``. Encodec needs model weights the repository does not hold, so it
is reported unavailable.
"""

from __future__ import annotations

import wave
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from waveverify_torch.ops.dsp import bandpass_fir, highpass_fir, lowpass_fir, resample

DEFAULT_SAMPLE_RATE = 16000

Mask = Optional[torch.Tensor]


def _linear_resize(x: torch.Tensor, new_len: int) -> torch.Tensor:
    """Linear interpolation along the last axis to ``new_len`` samples
    (``F.interpolate(mode='linear', align_corners=False)`` semantics),
    with the positions computed in f32 as the JAX package computes them."""
    old_len = x.shape[-1]
    if old_len == new_len:
        return x
    scale = old_len / new_len
    pos = (torch.arange(new_len, dtype=torch.float32, device=x.device) + 0.5) \
        * scale - 0.5
    pos = torch.clamp(pos, 0.0, old_len - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=old_len - 1)
    w = (pos - lo).to(x.dtype)
    return x[..., lo] * (1 - w) + x[..., hi] * w


class AudioEffects:
    """The sweep's effects, under the JAX catalog's names."""

    @staticmethod
    def identity(audio, mask=None, generator=None, **kw):
        return audio, mask

    # -- frequency domain -------------------------------------------------------

    @staticmethod
    def highpass_filter(audio, mask=None, generator=None,
                        cutoff_freq: float = 500.0,
                        sample_rate: int = DEFAULT_SAMPLE_RATE, **kw):
        return highpass_fir(audio, cutoff_freq / sample_rate), mask

    @staticmethod
    def lowpass_filter(audio, mask=None, generator=None,
                       cutoff_freq: float = 2000.0,
                       sample_rate: int = DEFAULT_SAMPLE_RATE, **kw):
        return lowpass_fir(audio, cutoff_freq / sample_rate), mask

    @staticmethod
    def bandpass_filter(audio, mask=None, generator=None,
                        cutoff_freq_low: float = 300.0,
                        cutoff_freq_high: float = 4000.0,
                        sample_rate: int = DEFAULT_SAMPLE_RATE, **kw):
        return bandpass_fir(audio, cutoff_freq_low / sample_rate,
                            cutoff_freq_high / sample_rate), mask

    # -- time domain -------------------------------------------------------------

    @staticmethod
    def speed(audio, mask=None, generator=None, speed: float = 1.0,
              sample_rate: int = DEFAULT_SAMPLE_RATE, **kw):
        """Tempo and pitch change, stretched back to the input length:
        resample onto the ``sample_rate / speed`` grid, then linear
        interpolation back to T. The mask is unchanged."""
        if speed == 1.0:
            return audio, mask
        inter_rate = int(round(sample_rate / speed))
        y = resample(audio, sample_rate, inter_rate)
        return _linear_resize(y, audio.shape[-1]), mask

    @staticmethod
    def resample(audio, mask=None, generator=None, new_sample_rate: int = 32000,
                 sample_rate: int = DEFAULT_SAMPLE_RATE, **kw):
        """Down/up resampling round trip, cut or zero-padded back to T."""
        y = resample(audio, sample_rate, new_sample_rate)
        y = resample(y, new_sample_rate, sample_rate)
        t = audio.shape[-1]
        if y.shape[-1] > t:
            y = y[..., :t]
        elif y.shape[-1] < t:
            y = F.pad(y, (0, t - y.shape[-1]))
        return y, mask

    @staticmethod
    def time_shift(audio, mask=None, generator=None, shift: int = 160, **kw):
        """Circular shift by ``shift`` samples, the mask shifted with it."""
        out = torch.roll(audio, int(shift), dims=-1)
        if mask is not None:
            mask = torch.roll(mask, int(shift), dims=-1)
        return out, mask

    # -- noise -------------------------------------------------------------------

    @staticmethod
    def random_noise(audio, mask=None, generator=None, noise_std: float = 0.001,
                     noise: Optional[torch.Tensor] = None, **kw):
        """Additive white Gaussian noise: ``noise`` (unit variance, the
        audio's shape) when given, else drawn from ``generator`` (a fresh
        one seeded 0 on the audio's device when None)."""
        if noise is None:
            if generator is None:
                generator = torch.Generator(device=audio.device).manual_seed(0)
            noise = torch.randn(audio.shape, generator=generator,
                                dtype=audio.dtype, device=audio.device)
        return audio + noise_std * noise, mask

    # -- host codecs -------------------------------------------------------------

    @staticmethod
    def mp3_lossy_compression(audio, mask=None, generator=None,
                              bitrate: str = "128k",
                              sample_rate: int = DEFAULT_SAMPLE_RATE, **kw):
        return _host_codec(audio, mask, "mp3", bitrate, sample_rate)

    @staticmethod
    def aac_lossy_compression(audio, mask=None, generator=None,
                              bitrate: str = "128k",
                              sample_rate: int = DEFAULT_SAMPLE_RATE, **kw):
        return _host_codec(audio, mask, "aac", bitrate, sample_rate)


def _host_codec(audio: torch.Tensor, mask: Mask, codec: str, bitrate: str,
                sample_rate: int) -> Tuple[torch.Tensor, Mask]:
    """FFmpeg encode/decode round trip of each row on the host. Returns the
    input unchanged when ffmpeg is absent, and a row unchanged when its
    round trip fails, as the JAX package does."""
    import os
    import shutil
    import subprocess
    import tempfile

    if shutil.which("ffmpeg") is None:
        return audio, mask
    arr = audio.detach().float().cpu().numpy()
    flat = arr.reshape(-1, arr.shape[-1])
    outs = []
    # encoder delay of the decoded stream
    delay = 1152 if codec == "mp3" else 1024
    suffix = ".mp3" if codec == "mp3" else ".aac"
    for row in flat:
        with tempfile.TemporaryDirectory() as td:
            raw = os.path.join(td, "in.wav")
            enc = os.path.join(td, "out" + suffix)
            dec = os.path.join(td, "dec.wav")
            _write_wav(raw, row, sample_rate)
            try:
                subprocess.run(["ffmpeg", "-y", "-loglevel", "quiet", "-i", raw,
                                "-b:a", bitrate, enc], check=True)
                subprocess.run(["ffmpeg", "-y", "-loglevel", "quiet", "-i", enc,
                                dec], check=True)
                y = _read_wav(dec)[delay:delay + row.shape[-1]]
                if y.shape[-1] < row.shape[-1]:
                    y = np.pad(y, (0, row.shape[-1] - y.shape[-1]))
                outs.append(y)
            except (OSError, EOFError, wave.Error,
                    subprocess.CalledProcessError):
                outs.append(row)
    out = torch.from_numpy(np.stack(outs).reshape(arr.shape))
    return out.to(device=audio.device, dtype=audio.dtype), mask


def _write_wav(path: str, x: np.ndarray, sr: int) -> None:
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


def _read_wav(path: str) -> np.ndarray:
    with wave.open(path, "rb") as f:
        data = np.frombuffer(f.readframes(f.getnframes()), np.int16)
    return data.astype(np.float32) / 32768.0


def codec_available(codec: str) -> bool:
    """Whether the named external codec can run here: mp3 and aac need
    ``ffmpeg`` on ``PATH``; encodec needs weights the repository does not
    hold, so it is never available."""
    import shutil

    if codec in ("mp3", "aac"):
        return shutil.which("ffmpeg") is not None
    return False


def apply_effect(audio: torch.Tensor, effect_name: str, mask: Mask = None,
                 generator: Optional[torch.Generator] = None,
                 **params) -> Tuple[torch.Tensor, Mask]:
    """One effect by name on ``[T]`` or ``[B, T]`` audio, the shape kept."""
    fn = getattr(AudioEffects, effect_name, None)
    if fn is None:
        raise ValueError(f"unknown effect: {effect_name}")
    if audio.dim() == 1:
        y, m = fn(audio[None], None if mask is None else mask[None],
                  generator, **params)
        return y[0], None if m is None else m[0]
    return fn(audio, mask, generator, **params)


# noise effects take their noise as an argument inside the bank
_NOISE_EFFECTS = ("random_noise",)


class EffectBank:
    """The training attacks: a fixed list of (effect, params) branches, one
    chosen per sample by index.

    :meth:`apply` runs each branch only on the samples that chose it. It
    gives what the JAX package's "stack" dispatch gives (every branch on
    the whole batch, each sample taking its own row), since every branch
    acts on each row alone; a noise branch's noise is drawn beforehand for
    the whole batch, ``[len(noise_branches), B, T]``, and each sample takes
    its own row of it."""

    def __init__(self, effects: Sequence[Tuple[str, Dict]],
                 sample_rate: int = DEFAULT_SAMPLE_RATE):
        self.specs: List[Tuple[str, Dict]] = [
            (name, dict(params)) for name, params in effects]
        self.sample_rate = sample_rate
        self._fns = []
        for name, params in self.specs:
            fn = getattr(AudioEffects, name, None)
            if fn is None:
                raise ValueError(f"effect {name!r} is not ported")
            kw = dict(params)
            kw.setdefault("sample_rate", sample_rate)
            self._fns.append(partial(fn, **kw))
        self.noise_branches = [i for i, (name, _) in enumerate(self.specs)
                               if name in _NOISE_EFFECTS]

    def __len__(self) -> int:
        return len(self.specs)

    def apply(self, audio: torch.Tensor, mask: torch.Tensor, effect_idx,
              noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """audio, mask ``[B, T]``; effect_idx ``[B]`` branch indices (host
        numpy or a CPU tensor: the grouping is done on the host);
        noise ``[len(noise_branches), B, T]`` unit normal, on the audio's
        device."""
        idx = np.asarray(torch.as_tensor(effect_idx).cpu())
        out_a, out_m = audio, mask
        for e in np.unique(idx):
            rows = torch.from_numpy(np.flatnonzero(idx == e)).to(audio.device)
            kw = {}
            if e in self.noise_branches:
                kw["noise"] = noise[self.noise_branches.index(e)][rows]
            a, m = self._fns[e](audio[rows], mask[rows], None, **kw)
            out_a = out_a.index_put((rows,), a)
            if m is not None:
                out_m = out_m.index_put((rows,), m.to(mask.dtype))
        return out_a, out_m

    @classmethod
    def default_train_bank(cls, sample_rate: int = DEFAULT_SAMPLE_RATE
                           ) -> "EffectBank":
        """The conf/effects_config.yml train_effects list."""
        return cls(DEFAULT_TRAIN_EFFECTS, sample_rate)


# conf/effects_config.yml train_effects and eval_effects
DEFAULT_TRAIN_EFFECTS: List[Tuple[str, Dict]] = [
    ("identity", {}),
    ("highpass_filter", {"cutoff_freq": 500}),
    ("highpass_filter", {"cutoff_freq": 3500}),
    ("lowpass_filter", {"cutoff_freq": 1000}),
    ("lowpass_filter", {"cutoff_freq": 2000}),
    ("bandpass_filter", {"cutoff_freq_low": 300, "cutoff_freq_high": 4000}),
    ("speed", {"speed": 0.8}),
    ("resample", {"new_sample_rate": 32000}),
    ("random_noise", {"noise_std": 0.001}),
]

DEFAULT_EVAL_EFFECTS: List[Tuple[str, Dict]] = [
    ("identity", {}),
    ("time_shift", {"shift": 161}),
    ("resample", {"new_sample_rate": 32000}),
    ("speed", {"speed": 0.8}),
    ("random_noise", {"noise_std": 0.001}),
    ("lowpass_filter", {"cutoff_freq": 2000}),
    ("highpass_filter", {"cutoff_freq": 3500}),
    ("bandpass_filter", {"cutoff_freq_low": 300, "cutoff_freq_high": 4000}),
]
