"""The audio effect catalog of the robustness sweep and of the training
bank (counterpart of ``waveverify_tpu/effects/effects.py``).

Every effect maps ``(audio [B, T], mask [B, T] or None, generator,
**params) -> (audio, mask)`` at the same length T, on the audio's device.
A random effect takes its draws as keyword arguments (``noise``, ``rows``,
``u``, ``log_freq`` / ``gain_db``, ``duration`` / ``volume``) and draws
them from ``generator`` only when none are given. Each random effect has
one draw function in :data:`RANDOM_EFFECTS`, with the shapes of the JAX
package's draws (its "stack" bank draws once for the whole batch, its
"scan" bank once per sample, at batch 1), so a test can feed an effect
the JAX package's own draws, and the bank, the validation step and the
sweep all draw the same way: beforehand, on a CPU generator, so a step
can be replayed exactly.

Quantization, the median filter and the codec proxy pass the gradient
straight through; shush and sample suppression pass it through the
samples they keep. The host codecs (mp3, aac) round-trip through
``ffmpeg`` when it is on ``PATH``. Encodec needs model weights the
repository does not hold, so it is reported unavailable, and the effect
falls back to the codec proxy with a warning, as the JAX package does
when its round trip fails.
"""

from __future__ import annotations

import logging
import math
import wave
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from waveverify_torch import spans
from waveverify_torch.ops.dsp import (
    bandpass_fir,
    fir_filter,
    frame_signal,
    highpass_fir,
    lowpass_fir,
    resample,
)
from waveverify_torch.ops.uploads import upload_rows

logger = logging.getLogger(__name__)

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


# -- the draws of the random effects ------------------------------------------
#
# One function per random effect: (generator, B, T, **params) -> the
# keyword arguments the effect takes its randomness from, on the
# generator's device. Shapes follow the JAX package's draws: a whole-batch
# [B, ...] array where JAX draws one per sample, a 0-d tensor where it
# draws one scalar for the whole call.


def _uniform(generator: torch.Generator, shape, lo: float, hi: float
             ) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def draw_normal_noise(generator: torch.Generator, b: int, t: int, **params
                      ) -> Dict[str, torch.Tensor]:
    """``random_noise`` and ``white_noise``: a unit normal ``[B, T]``."""
    return {"noise": torch.randn((b, t), generator=generator,
                                 device=generator.device)}


def draw_pink_noise(generator: torch.Generator, b: int, t: int,
                    depth: int = 16, **params) -> Dict[str, Any]:
    """``depth`` unit-normal rows, row d ``[B, ceil(T / 2^d)]``."""
    return {"rows": [torch.randn((b, -(-t // (1 << d))), generator=generator,
                                 device=generator.device)
                     for d in range(depth)]}


def draw_sample_suppression(generator: torch.Generator, b: int, t: int,
                            **params) -> Dict[str, torch.Tensor]:
    """A uniform ``[B, T]`` in [0, 1)."""
    return {"u": torch.rand((b, t), generator=generator,
                            device=generator.device)}


def draw_random_equalization(generator: torch.Generator, b: int, t: int,
                             freq_range: Tuple[float, float] = (200.0, 4000.0),
                             gain_range: Tuple[float, float] = (-6.0, 6.0),
                             **params) -> Dict[str, torch.Tensor]:
    """One log centre frequency and one gain (dB) for the whole batch."""
    return {"log_freq": _uniform(generator, (), math.log(freq_range[0]),
                                 math.log(freq_range[1])),
            "gain_db": _uniform(generator, (), gain_range[0], gain_range[1])}


def draw_echo(generator: torch.Generator, b: int, t: int,
              volume_range: Tuple[float, float] = (0.1, 0.5),
              duration_range: Tuple[float, float] = (0.1, 0.5),
              **params) -> Dict[str, torch.Tensor]:
    """One delay (seconds) and one volume for the whole batch."""
    return {"duration": _uniform(generator, (), duration_range[0],
                                 duration_range[1]),
            "volume": _uniform(generator, (), volume_range[0], volume_range[1])}


def _draws_or(generator: Optional[torch.Generator], audio: torch.Tensor,
              fn: Callable, given: Dict[str, Any], **params) -> Dict[str, Any]:
    """``given`` when every entry is set, else fresh draws of ``fn`` from
    ``generator`` (a fresh one seeded 0 on the audio's device when None),
    moved to the audio's device."""
    if all(v is not None for v in given.values()):
        return given
    if generator is None:
        generator = torch.Generator(device=audio.device).manual_seed(0)
    return move_draws(fn(generator, audio.shape[0], audio.shape[-1], **params),
                      audio.device)


def _map_draws(draws: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """``fn`` applied to every tensor of a draws structure (dicts, lists)."""
    if isinstance(draws, torch.Tensor):
        return fn(draws)
    if isinstance(draws, dict):
        return {k: _map_draws(v, fn) for k, v in draws.items()}
    if isinstance(draws, (list, tuple)):
        return type(draws)(_map_draws(v, fn) for v in draws)
    return draws


def move_draws(draws: Any, device) -> Any:
    """Every tensor of a draws structure moved to ``device``."""
    return _map_draws(draws, lambda t: t.to(device))


def take_rows(draws: Any, rows: torch.Tensor) -> Any:
    """The rows ``rows`` (on the draws' device, or the CPU) of every
    per-sample draw; a 0-d draw (one for the whole batch) is kept as is."""
    return _map_draws(draws, lambda t: t if t.dim() == 0 else t[rows])


class AudioEffects:
    """The effect catalog, under the JAX catalog's names."""

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

    @staticmethod
    def random_equalization(audio, mask=None, generator=None,
                            freq_range: Tuple[float, float] = (200.0, 4000.0),
                            gain_range: Tuple[float, float] = (-6.0, 6.0),
                            q: float = 1.0,
                            sample_rate: int = DEFAULT_SAMPLE_RATE,
                            log_freq: Optional[torch.Tensor] = None,
                            gain_db: Optional[torch.Tensor] = None, **kw):
        """Random peaking EQ: a 257-tap zero-phase FIR sampled from the
        analog peaking-EQ magnitude at a log-uniform centre frequency and a
        uniform gain (dB), one of each for the whole batch. The kernel is
        built on the audio's device in f32, in the JAX package's order of
        operations."""
        d = _draws_or(generator, audio, draw_random_equalization,
                      {"log_freq": log_freq, "gain_db": gain_db},
                      freq_range=freq_range, gain_range=gain_range)
        dev, f32 = audio.device, torch.float32
        f0 = torch.exp(d["log_freq"].to(f32))
        gain = d["gain_db"].to(f32)
        n_taps = 257
        freqs = torch.linspace(0.0, sample_rate / 2, n_taps // 2 + 1,
                               dtype=f32, device=dev)
        a = 10.0 ** (gain / 40.0)
        ratio = freqs / torch.clamp(f0, min=1.0)
        band = 1.0 / (1.0 + ((ratio - 1.0 / torch.clamp(ratio, min=1e-6)) * q) ** 2)
        mag = 1.0 + (a * a - 1.0) * band / (1.0 + (a - 1.0) * band / a)
        n = (torch.arange(n_taps, device=dev) - n_taps // 2).to(f32)
        basis = torch.cos(2 * math.pi * freqs[None, :] * n[:, None] / sample_rate)
        scale = torch.where((freqs == 0) | (freqs == sample_rate / 2), 1.0, 2.0)
        kernel = (basis * (mag * scale)[None, :]).sum(dim=1) / (n_taps - 1)
        kernel = kernel * torch.hann_window(n_taps, periodic=False, dtype=f32,
                                            device=dev)
        return fir_filter(audio, kernel.to(audio.dtype)), mask

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
    def echo(audio, mask=None, generator=None,
             volume_range: Tuple[float, float] = (0.1, 0.5),
             duration_range: Tuple[float, float] = (0.1, 0.5),
             sample_rate: int = DEFAULT_SAMPLE_RATE,
             duration: Optional[torch.Tensor] = None,
             volume: Optional[torch.Tensor] = None, **kw):
        """Single-tap echo, one delay and volume for the whole batch, then
        each row rescaled to its input peak. As the JAX package's
        ``conv_general_dilated`` with padding ``(0, max_delay)`` (a
        cross-correlation), the tap reads ahead: ``y[t] = x[t] + volume *
        x[t + delay]``, zero past the end. A gather keeps the delay on the
        device."""
        d = _draws_or(generator, audio, draw_echo,
                      {"duration": duration, "volume": volume},
                      volume_range=volume_range, duration_range=duration_range)
        t = audio.shape[-1]
        delay = torch.round(d["duration"].to(torch.float32) * sample_rate).long()
        idx = torch.arange(t, device=audio.device) + delay
        ahead = torch.where(idx < t, audio[..., torch.clamp(idx, max=t - 1)],
                            torch.zeros((), dtype=audio.dtype, device=audio.device))
        y = audio + d["volume"].to(audio.dtype) * ahead
        peak = torch.amax(torch.abs(y), dim=-1, keepdim=True) + 1e-9
        in_peak = torch.amax(torch.abs(audio), dim=-1, keepdim=True)
        return y / peak * in_peak, mask

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
        d = _draws_or(generator, audio, draw_normal_noise, {"noise": noise})
        return audio + noise_std * d["noise"].to(audio.dtype), mask

    @staticmethod
    def white_noise(audio, mask=None, generator=None, noise_std: float = 0.01,
                    noise: Optional[torch.Tensor] = None, **kw):
        """``random_noise`` at another default std."""
        return AudioEffects.random_noise(audio, mask, generator,
                                         noise_std=noise_std, noise=noise)

    @staticmethod
    def pink_noise(audio, mask=None, generator=None, noise_std: float = 0.01,
                   depth: int = 16, rows: Optional[Sequence[torch.Tensor]] = None,
                   **kw):
        """Voss-McCartney pink noise: the sum of ``depth`` unit-normal rows,
        row d held for 2^d samples, scaled by 1 / sqrt(depth), then each
        row of the batch centred and normalised to unit std (ddof 0)."""
        d = _draws_or(generator, audio, draw_pink_noise, {"rows": rows},
                      depth=depth)
        t = audio.shape[-1]
        held = [r.to(audio.dtype).repeat_interleave(1 << i, dim=-1)[..., :t]
                for i, r in enumerate(d["rows"])]
        noise = sum(held) / math.sqrt(depth)
        noise = noise - torch.mean(noise, dim=-1, keepdim=True)
        std = torch.std(noise, dim=-1, keepdim=True, correction=0) + 1e-9
        return audio + noise_std * noise / std, mask

    # -- nonlinear and sample operations ---------------------------------------

    @staticmethod
    def amplitude_scaling(audio, mask=None, generator=None, scale: float = 1.0,
                          **kw):
        return audio * scale, mask

    @staticmethod
    def quantization(audio, mask=None, generator=None, bit_depth: int = 8, **kw):
        """Bit-depth reduction, gradient straight through."""
        levels = float(2 ** (bit_depth - 1))
        q = torch.round(torch.clamp(audio, -1.0, 1.0) * levels) / levels
        return audio + (q - audio).detach(), mask

    @staticmethod
    def sample_suppression(audio, mask=None, generator=None,
                           suppression_percentage: float = 0.1,
                           u: Optional[torch.Tensor] = None, **kw):
        """Zero the samples whose uniform draw falls under
        ``suppression_percentage``; the presence mask is zeroed there too."""
        d = _draws_or(generator, audio, draw_sample_suppression, {"u": u})
        keep = d["u"].reshape(audio.shape) >= suppression_percentage
        y = audio * keep.to(audio.dtype)
        if mask is not None:
            mask = mask * keep.to(mask.dtype).reshape(mask.shape)
        return y, mask

    @staticmethod
    def shush(audio, mask=None, generator=None, fraction: float = 0.001, **kw):
        """Zero the quietest ``fraction`` of each row: every sample whose
        magnitude is not above the k-th smallest (ties zeroed together);
        the gradient flows through the kept samples only."""
        t = audio.shape[-1]
        k = max(int(t * fraction), 1)
        mag = torch.abs(audio)
        thresh = torch.kthvalue(mag, k, dim=-1, keepdim=True).values
        keep = (mag > thresh).to(audio.dtype)
        return audio * keep, mask

    @staticmethod
    def median_filter(audio, mask=None, generator=None, kernel_size: int = 3,
                      **kw):
        """Sliding median over ``kernel_size`` zero-padded samples (left
        k // 2, right k - 1 - k // 2), gradient straight through. An even
        window takes the mean of its two middle values, as ``jnp.median``
        does."""
        k = int(kernel_size)
        frames = frame_signal(F.pad(audio, (k // 2, k - 1 - k // 2)), k, 1)
        srt = torch.sort(frames, dim=-1).values
        med = (srt[..., (k - 1) // 2] + srt[..., k // 2]) * 0.5
        return audio + (med - audio).detach(), mask

    @staticmethod
    def smooth(audio, mask=None, generator=None, window_size: int = 5, **kw):
        """Moving average over ``window_size`` samples; the mask becomes
        whether at least half of the same window was marked."""
        k = int(window_size)
        kernel = torch.ones((k,), dtype=audio.dtype, device=audio.device) / k
        y = fir_filter(audio, kernel)
        if mask is not None:
            m = fir_filter(mask.to(audio.dtype), kernel)
            mask = (m >= 0.5).to(audio.dtype)
        return y, mask

    # -- codecs ------------------------------------------------------------------

    @staticmethod
    def codec_proxy(audio, mask=None, generator=None, bit_depth: int = 8,
                    cutoff_freq: float = 7000.0,
                    sample_rate: int = DEFAULT_SAMPLE_RATE, **kw):
        """On-device stand-in for a lossy codec: lowpass, then quantization
        (gradient straight through)."""
        y, mask = AudioEffects.lowpass_filter(audio, mask, generator,
                                              cutoff_freq=cutoff_freq,
                                              sample_rate=sample_rate)
        return AudioEffects.quantization(y, mask, generator, bit_depth=bit_depth)

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

    @staticmethod
    def encodec(audio, mask=None, generator=None,
                sample_rate: int = DEFAULT_SAMPLE_RATE, **kw):
        """Neural-codec attack. The round trip needs Encodec weights, which
        the repository does not hold, so it fails; the effect then logs a
        WARNING, sets ``AudioEffects.encodec_last_was_proxy`` and returns
        :meth:`codec_proxy`, as the JAX package does on failure."""
        try:
            y = _encodec_roundtrip(audio, sample_rate)
            AudioEffects.encodec_last_was_proxy = False
            return y, mask
        except RuntimeError as e:
            logger.warning(
                "encodec round-trip unavailable (%s) - substituting the "
                "on-device codec_proxy (lowpass+quantize). Metrics from this "
                "call measure the PROXY, not Encodec.", e)
            AudioEffects.encodec_last_was_proxy = True
            return AudioEffects.codec_proxy(audio, mask, generator,
                                            sample_rate=sample_rate)

    # set by the last `encodec` call: True when the proxy was substituted
    encodec_last_was_proxy: bool = False


def _encodec_roundtrip(audio: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """The Encodec encode/decode round trip: not available until the
    repository holds the model's weights (nothing is downloaded)."""
    raise RuntimeError("no Encodec weights in the repository")


# effect name -> its draw function
RANDOM_EFFECTS: Dict[str, Callable[..., Dict[str, Any]]] = {
    "random_noise": draw_normal_noise,
    "white_noise": draw_normal_noise,
    "pink_noise": draw_pink_noise,
    "sample_suppression": draw_sample_suppression,
    "random_equalization": draw_random_equalization,
    "echo": draw_echo,
}


def random_indices(effects: Sequence[Tuple[str, Dict]]) -> List[int]:
    """Indices of the effects of a list that take drawn randomness."""
    return [i for i, (name, _) in enumerate(effects) if name in RANDOM_EFFECTS]


def draw_effect(name: str, params: Dict, generator: torch.Generator,
                b: int, t: int) -> Dict[str, Any]:
    """The draws of one random effect, with ``params`` (its range
    parameters) as the effect will take them."""
    return RANDOM_EFFECTS[name](generator, b, t, **params)


def effect_fn(name: str) -> Callable:
    """The catalog's effect ``name``; raises ValueError when there is
    none."""
    fn = getattr(AudioEffects, name, None) if not name.startswith("_") else None
    if not callable(fn):
        raise ValueError(f"unknown effect: {name}")
    return fn


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
    """One effect by name on ``[T]``, ``[B, T]`` or ``[B, T, 1]`` audio,
    the input's shape restored on the output (and on a mask of the same
    rank)."""
    fn = effect_fn(effect_name)
    ndim = audio.dim()
    if ndim == 1:
        audio = audio[None]
        if mask is not None and mask.dim() == 1:
            mask = mask[None]
    elif ndim == 3:
        if audio.shape[-1] != 1:
            raise ValueError("3D effect input must be [B, T, 1]")
        audio = audio[..., 0]
        if mask is not None and mask.dim() == 3:
            mask = mask[..., 0]
    y, m = fn(audio, mask, generator, **params)
    if ndim == 3:
        y = y[..., None]
        if m is not None and m.dim() == 2:
            m = m[..., None]
    elif ndim == 1:
        y = y[0]
        if m is not None and m.dim() == 2:
            m = m[0]
    return y, m


class EffectBank:
    """The training attacks: a fixed list of (effect, params) branches, one
    chosen per sample by index.

    :meth:`apply` runs each branch only on the samples that chose it. Its
    two dispatch modes are the JAX package's, and differ in how a random
    branch's draws are made (beforehand, :meth:`draw_specs` says which):

    - ``"stack"``: what the JAX "stack" dispatch gives (every branch on the
      whole batch, each sample taking its own row), since every branch acts
      on each row alone. A random branch's draws are made for the whole
      batch (``fx_draws`` holds one entry per branch of
      :attr:`random_branches`, in order); each sample takes its own rows of
      them, and a draw the JAX package makes once per call (the echo's
      delay, the equaliser's band) is shared by every sample of the branch.
    - ``"scan"``: what the JAX "scan" dispatch gives (each sample runs its
      branch alone on its ``[1, T]`` row with a key of its own), so every
      draw is made per sample, the echo's delay and the equaliser's band
      too: ``fx_draws`` holds one entry per sample, the draws of its
      branch at batch 1 (empty for a branch without randomness), and a
      random branch runs once per sample.
    """

    def __init__(self, effects: Sequence[Tuple[str, Dict]],
                 sample_rate: int = DEFAULT_SAMPLE_RATE,
                 dispatch: str = "stack"):
        if dispatch not in ("stack", "scan"):
            raise ValueError(f"invalid dispatch mode {dispatch!r}")
        self.specs: List[Tuple[str, Dict]] = [
            (name, dict(params)) for name, params in effects]
        self.sample_rate = sample_rate
        self.dispatch = dispatch
        self._fns = []
        for name, params in self.specs:
            kw = dict(params)
            kw.setdefault("sample_rate", sample_rate)
            self._fns.append(partial(effect_fn(name), **kw))
        self.random_branches = random_indices(self.specs)

    def __len__(self) -> int:
        return len(self.specs)

    @property
    def random_specs(self) -> List[Tuple[str, Dict]]:
        """(name, params) of each random branch, in the order of
        ``fx_draws`` under ``"stack"``."""
        return [self.specs[i] for i in self.random_branches]

    def draw_specs(self, effect_idx) -> List[Tuple[str, Dict]]:
        """What ``fx_draws`` holds draws of, in order: :attr:`random_specs`
        under ``"stack"``; each sample's branch under ``"scan"``, to be drawn
        at batch 1 (``watermarking.draw(..., per_sample=True)``)."""
        if self.dispatch == "stack":
            return self.random_specs
        return [self.specs[e] for e in np.asarray(torch.as_tensor(effect_idx).cpu())]

    def apply(self, audio: torch.Tensor, mask: torch.Tensor, effect_idx,
              fx_draws: Sequence[Dict[str, Any]]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """audio, mask ``[B, T]``; effect_idx ``[B]`` branch indices (host
        numpy or a CPU tensor: the grouping is done on the host); fx_draws:
        the draws :meth:`draw_specs` lists, on the audio's device.

        The rows are grouped by branch on the host and uploaded in one
        copy that does not block (:func:`upload_rows`); each branch reads
        its slice of it."""
        with spans.span("bank.apply"):
            idx = np.asarray(torch.as_tensor(effect_idx).cpu())
            branches, counts = np.unique(idx, return_counts=True)
            order = np.argsort(idx, kind="stable")  # each branch's rows, ascending
            rows = upload_rows(order, audio.device)
            out_a, out_m = audio, mask
            end = 0
            for e, n in zip(branches, counts):
                lo, end = end, end + n
                r = rows[lo:end]
                if self.dispatch == "scan" and e in self.random_branches:
                    # each sample alone, with its own draws
                    calls = [(r[j:j + 1], fx_draws[i])
                             for j, i in enumerate(order[lo:end])]
                else:
                    kw = {}
                    if e in self.random_branches:
                        kw = take_rows(fx_draws[self.random_branches.index(e)], r)
                    calls = [(r, kw)]
                for r, kw in calls:
                    a, m = self._fns[e](audio[r], mask[r], None, **kw)
                    out_a = out_a.index_put((r,), a)
                    if m is not None:
                        out_m = out_m.index_put((r,), m.to(mask.dtype))
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
