"""Audio file I/O and message conversion for the port's public API
(counterpart of ``waveverify_tpu/api/audio_io.py``).

Files are decoded by content (``api/codecs.py``): WAV with the stdlib
``wave`` module, FLAC with the native decoder, other containers through
``ffmpeg`` when it is on ``PATH``; mono mixdown, resampled to 16 kHz with
``scipy.signal.resample_poly``. Output is 16-bit PCM WAV.
"""

from __future__ import annotations

import wave
from math import gcd
from pathlib import Path
from typing import Tuple, Union

import numpy as np

TARGET_SAMPLE_RATE = 16000

# the reference ships an empty placeholder URL
DEFAULT_CHECKPOINT_URL = ""


def download_checkpoint(url: str = DEFAULT_CHECKPOINT_URL,
                        dest_dir: Union[str, Path] = "~/.cache/waveverify_torch"
                        ) -> Path:
    """Fetch and unpack a checkpoint archive into ``dest_dir``. No URL is
    configured, so this raises unless one is passed; pass
    ``checkpoint_path=`` to ``WaveVerify`` instead."""
    if not url:
        raise ValueError(
            "no checkpoint URL configured (the reference ships an empty "
            "placeholder too); pass checkpoint_path= to WaveVerify instead")
    import tarfile
    import urllib.request

    dest = Path(dest_dir).expanduser()
    dest.mkdir(parents=True, exist_ok=True)
    archive = dest / Path(url).name
    if not archive.exists():
        urllib.request.urlretrieve(url, archive)
    if archive.suffixes[-2:] == [".tar", ".gz"] or archive.suffix == ".tgz":
        with tarfile.open(archive) as tf:
            tf.extractall(dest)
    return dest


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """PCM WAV as mono float32 in [-1, 1]: (audio [T], sample rate)."""
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n_ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x, sr


def resample(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resample on the host."""
    if orig_sr == new_sr:
        return x
    from scipy.signal import resample_poly

    g = gcd(orig_sr, new_sr)
    return resample_poly(x, new_sr // g, orig_sr // g).astype(np.float32)


def load_audio(path: Union[str, Path],
               target_sample_rate: int = TARGET_SAMPLE_RATE
               ) -> Tuple[np.ndarray, int]:
    """Load an audio file, decoded by its content, as mono float32 at
    ``target_sample_rate``: (audio [T], rate)."""
    from waveverify_torch.api.codecs import decode_auto

    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"audio file not found: {path}")
    audio, sr = decode_auto(path)
    if sr != target_sample_rate:
        audio = resample(audio, sr, target_sample_rate)
        sr = target_sample_rate
    return audio.astype(np.float32), sr


def save_audio(audio: np.ndarray, path: Union[str, Path],
               sample_rate: int = TARGET_SAMPLE_RATE) -> None:
    """Write mono 16-bit PCM WAV, clamped to [-1, 1]."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    x = np.clip(np.asarray(audio, np.float32).ravel(), -1.0, 1.0)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes((x * 32767.0).astype(np.int16).tobytes())


def message_to_tensor(bits: str) -> np.ndarray:
    """'0101...' (16 chars) -> float32 ``[1, 16]``."""
    if not isinstance(bits, str) or len(bits) != 16 or set(bits) - {"0", "1"}:
        raise ValueError(f"message must be a 16-char bit string, got {bits!r}")
    return np.array([[float(b) for b in bits]], np.float32)


def tensor_to_message(probs: np.ndarray, threshold: float = 0.5) -> str:
    """Bit probabilities -> 16-char bit string; 3-D ``[B, T, nbits]`` input
    is time-averaged first."""
    x = np.asarray(probs)
    if x.ndim == 3:
        x = x.mean(axis=1)
    if x.ndim == 2:
        x = x[0]
    return "".join(str(int(b)) for b in (x > threshold).astype(int))
