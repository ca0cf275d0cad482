"""Host input pipeline: fixed-length float32 clips for training and the
robustness sweep (counterpart of ``waveverify_tpu/train/data.py``).

A copy of the JAX package's clip sources, so one ``RandomState(seed)``
gives the same clips in both packages: :class:`SyntheticAudioDataset`
(drifting harmonics plus pink-ish noise) and :class:`AudioFolderDataset`
(random crops of the audio files under some folders, mono at 16 kHz);
:func:`prefetch_batches` makes (audio, message) batches ahead on a
thread.
WAV files at the target rate are decoded and cropped by the native C++
ingest (:mod:`waveverify_torch.native`) as in the JAX package; other files
are decoded by content (WAV, FLAC natively; other containers through
``ffmpeg``) and resampled on the host.
"""

from __future__ import annotations

import logging
import queue
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from waveverify_torch.api.audio_io import load_audio

logger = logging.getLogger(__name__)

DEFAULT_SAMPLE_RATE = 16000
WAV_SUFFIXES = (".wav", ".wave")
# the folder scan takes the suffixes the JAX package's content-sniffing
# decoder takes, so both packages draw from the same file list
AUDIO_SUFFIXES = WAV_SUFFIXES + (".flac", ".ogg", ".mp3", ".aiff", ".aif")


class AudioFolderDataset:
    """Random fixed-duration crops from audio folders: uniform random file
    choice, uniform random offset, short files zero-padded, mono 16 kHz.

    As in the JAX package, a batch takes the native path when
    ``use_native`` (the default) and the extension builds: the B file
    picks, then one ``randint(1 << 31)`` seed from the ``RandomState``, then
    the C++ thread pool decodes the WAVs and crops row i at the offset its
    ``mt19937_64`` draws from the seed and i. A row whose file is not a WAV
    at the target rate (another rate, FLAC, a failed decode) is redone by
    the Python path, in row order, consuming the same ``RandomState``.
    Without the extension (no compiler) the dataset warns once and takes
    the Python path, one row at a time: file choice, then offset. Files
    are decoded by :func:`waveverify_torch.api.audio_io.load_audio` (by
    content, then ``scipy`` polyphase resampling to the target rate), as
    the JAX package's ``decode_auto`` and ``resample_poly`` decode them.
    So one seed gives the same crops in both packages, either way."""

    def __init__(self, folders: Sequence[str], duration: float = 1.0,
                 sample_rate: int = DEFAULT_SAMPLE_RATE,
                 seed: int = 0, cache_audio: bool = True,
                 use_native: bool = True):
        self.sample_rate = sample_rate
        self.crop_len = int(duration * sample_rate)
        self.rng = np.random.RandomState(seed)
        self.cache_audio = cache_audio
        self.use_native = use_native
        self._cache: dict = {}
        self.files: List[Path] = []
        for folder in folders:
            p = Path(folder)
            if not p.exists():
                logger.warning("data folder %s does not exist, skipping", p)
                continue
            self.files.extend(
                f for f in sorted(p.rglob("*"))
                if f.suffix.lower() in AUDIO_SUFFIXES
            )
        if not self.files:
            raise ValueError(f"no audio files found under {list(folders)}")

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, path: Path) -> np.ndarray:
        if self.cache_audio and path in self._cache:
            return self._cache[path]
        x, _sr = load_audio(path, self.sample_rate)
        if self.cache_audio:
            self._cache[path] = x
        return x

    def sample_crop(self) -> np.ndarray:
        x = self._load(self.files[self.rng.randint(len(self.files))])
        if len(x) <= self.crop_len:
            out = np.zeros(self.crop_len, np.float32)
            out[: len(x)] = x
            return out
        start = self.rng.randint(len(x) - self.crop_len)
        return x[start : start + self.crop_len].astype(np.float32)

    def batch(self, batch_size: int) -> np.ndarray:
        if self.use_native:
            native = self._native_batch(batch_size)
            if native is not None:
                return native
        return np.stack([self.sample_crop() for _ in range(batch_size)])

    def _native_batch(self, batch_size: int) -> Optional[np.ndarray]:
        from waveverify_torch.native import get_wavio

        wavio = get_wavio()
        if wavio is None:
            self.use_native = False
            return None
        picks = [self.files[self.rng.randint(len(self.files))]
                 for _ in range(batch_size)]
        out, srs, err = wavio.load_crop_batch(
            [str(p) for p in picks], self.crop_len,
            int(self.rng.randint(1 << 31)))
        if err:
            logger.warning("native ingest: %s", err)
        for i, (path, sr) in enumerate(zip(picks, srs)):
            if sr == self.sample_rate:
                continue
            # another rate, or a file the native decoder could not read
            x = self._load(path)
            if len(x) <= self.crop_len:
                out[i] = 0.0
                out[i, : len(x)] = x
            else:
                start = self.rng.randint(len(x) - self.crop_len)
                out[i] = x[start : start + self.crop_len]
        return out


class SyntheticAudioDataset:
    """Speech-like synthetic audio: a sum of drifting harmonics plus
    pink-ish noise, peak-normalised."""

    def __init__(self, duration: float = 1.0,
                 sample_rate: int = DEFAULT_SAMPLE_RATE, seed: int = 0):
        self.sample_rate = sample_rate
        self.crop_len = int(duration * sample_rate)
        self.rng = np.random.RandomState(seed)

    def sample_crop(self) -> np.ndarray:
        return self.batch(1)[0]

    def batch(self, batch_size: int) -> np.ndarray:
        """One vectorised expression over ``[B, H, T]``."""
        B, T, H = batch_size, self.crop_len, 5
        rng = self.rng
        t = (np.arange(T, dtype=np.float32) / self.sample_rate)[None, None, :]
        f0 = rng.uniform(80, 300, size=(B, 1, 1)).astype(np.float32)
        h = np.arange(1, H + 1, dtype=np.float32)[None, :, None]
        drift_f = rng.uniform(0.5, 3, size=(B, H, 1)).astype(np.float32)
        drift = 1.0 + 0.01 * np.sin(2 * np.pi * drift_f * t)
        amp = (rng.uniform(0.2, 1.0, size=(B, H, 1)).astype(np.float32) / h)
        phase = rng.uniform(0, 2 * np.pi, size=(B, H, 1)).astype(np.float32)
        x = (amp * np.sin(2 * np.pi * f0 * h * drift * t + phase)).sum(axis=1)
        # crude pink noise: cumulative-summed white noise, detrended
        w = rng.randn(B, T).astype(np.float32)
        pink = np.cumsum(w, axis=1)
        ramp = np.linspace(0.0, 1.0, T, dtype=np.float32)[None, :]
        pink -= pink[:, :1] + (pink[:, -1:] - pink[:, :1]) * ramp
        pink /= np.abs(pink).max(axis=1, keepdims=True) + 1e-9
        x += 0.05 * pink
        x *= 0.5 / (np.abs(x).max(axis=1, keepdims=True) + 1e-9)
        # amplitude envelope so localization segments differ
        env = (0.3 + 0.7 * rng.rand(B, 1)).astype(np.float32)
        return (x * env).astype(np.float32)


def generate_random_message(rng: np.random.RandomState, batch_size: int,
                            nbits: int = 16) -> np.ndarray:
    """Random {0, 1} messages ``[batch_size, nbits]`` float32."""
    return rng.randint(0, 2, size=(batch_size, nbits)).astype(np.float32)


def prefetch_batches(dataset, batch_size: int, nbits: int = 16,
                     seed: int = 0, depth: int = 2
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(audio ``[B, T]``, message ``[B, nbits]``) batches, ``depth`` of
    them made ahead on a daemon thread; closing the generator stops it. An
    exception raised while making a batch (an unreadable file) is raised
    again here, where the batch would have been read."""
    rng = np.random.RandomState(seed)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def worker():
        try:
            while not stop.is_set():
                put((dataset.batch(batch_size),
                     generate_random_message(rng, batch_size, nbits)))
        except Exception as e:
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)
