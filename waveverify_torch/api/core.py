"""Public inference API of the port: WaveVerify embed / detect / locate /
verify (counterpart of ``waveverify_tpu/api/core.py``).

Same signatures, return types and decision rules as the JAX package:
audio is right-padded to a length bucket, the generator's residual is
upcast and added to the clean f32 audio, bits come from sigmoid(logits)
averaged over the real (unpadded) length, thresholded at 0.5, and the
presence mask is the locator's per-sample sigmoid trimmed to the input
length. Audio longer than ``long_threshold`` goes through fixed windows
(the chunked long-audio path). Runs on ``cuda`` unless ``device="cpu"``
is passed.

Not ported yet: multi-card serving and checkpoints other than ``.npz``.
"""

from __future__ import annotations

import logging
import math
from pathlib import Path
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from waveverify_torch.api.audio_io import (
    load_audio,
    message_to_tensor,
    save_audio,
    tensor_to_message,
)
from waveverify_torch.api.watermark_id import WatermarkID
from waveverify_torch.config import TrainConfig, apply_model_config
from waveverify_torch.models import WatermarkModels
from waveverify_torch.serve import (
    locate_probs,
    resolve_device,
    resolve_dtype,
    strict_f32,
)
from waveverify_torch.weights import load_params, read_npz

logger = logging.getLogger(__name__)

SAMPLE_RATE = 16000


def _next_bucket(length: int, hop: int = 320, min_len: int = 4800) -> int:
    """Smallest bucket >= length: hop-aligned, ~1.26x geometric spacing."""
    n = max(length, min_len)
    bucket = min_len
    while bucket < n:
        bucket = int(math.ceil(bucket * 1.26 / hop) * hop)
    return bucket


class WaveVerify:
    """Embed, detect, locate and verify 16-bit watermarks.

    checkpoint_path: a ``.npz`` written by the JAX package's
        ``save_weights_npz``; its ``__config__`` snapshot sets the
        architecture.
    device: ``"cuda"`` (default; raises without a card) or ``"cpu"``.
    serve_dtype: ``"float32"`` (TF32 turned off) or ``"bfloat16"`` network
        activations; audio, sums and decisions stay f32 either way.
    """

    def __init__(self, checkpoint_path: Union[str, Path],
                 device: Union[str, torch.device] = "cuda",
                 serve_dtype: str = "float32"):
        path = Path(checkpoint_path)
        if path.suffix != ".npz":
            raise ValueError(f"{path}: only .npz checkpoints are supported so far")
        self.device = resolve_device(device)
        self.serve_dtype = serve_dtype
        self._act = resolve_dtype(serve_dtype)
        if self._act == torch.float32 and self.device.type == "cuda":
            strict_f32()
        flat, snap = read_npz(path)
        self.config = apply_model_config(TrainConfig(), snap or {})
        self.models = WatermarkModels(self.config)
        for net in ("generator", "detector", "locator"):
            load_params(getattr(self.models, net), flat, net)
        self.models.requires_grad_(False)
        self.models.eval().to(self.device)
        self.sample_rate = self.config.generator.sample_rate
        self.hop = self.config.generator.hop_length

    # -- device programs -------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    @torch.no_grad()
    def _embed(self, audio: np.ndarray, bits: np.ndarray) -> np.ndarray:
        x, msg = self._tensor(audio), self._tensor(bits)
        residual = self.models.apply_generator(x.to(self._act), msg.to(self._act))
        return (residual.float() + x).cpu().numpy()

    @torch.no_grad()
    def _detect_probs(self, audio: np.ndarray) -> torch.Tensor:
        """Per-sample bit probabilities ``[B, T, nbits]`` on the device."""
        x = self._tensor(audio)
        return torch.sigmoid(self.models.apply_detector(x.to(self._act)).float())

    @torch.no_grad()
    def _detect(self, audio: np.ndarray, t: int) -> Tuple[np.ndarray, np.ndarray]:
        """(bit probabilities [B, nbits], confidence [B]) with sigmoid(logits)
        averaged over the first ``t`` samples only."""
        probs = self._detect_probs(audio)
        valid = (torch.arange(probs.shape[1], device=self.device) < t)[None, :, None]
        probs = torch.sum(probs * valid, dim=1) / max(t, 1)
        return probs.cpu().numpy(), probs.mean(dim=1).cpu().numpy()

    def _locate(self, audio: np.ndarray) -> np.ndarray:
        """Presence probabilities ``[B, T]``: sigmoid of the locator."""
        return locate_probs(self.models, self._tensor(audio),
                            self.serve_dtype).cpu().numpy()

    def _pad_bucket(self, audio: np.ndarray) -> Tuple[np.ndarray, int]:
        t = audio.shape[-1]
        x = np.zeros((1, _next_bucket(t, self.hop)), np.float32)
        x[0, :t] = audio
        return x, t

    # -- chunked long-audio path -------------------------------------------------
    #
    # The three networks are causal: the output at sample t depends only on
    # inputs in [t - RF, t]. Audio longer than ``long_threshold`` goes
    # through fixed hop-aligned windows with ``chunk_context`` samples of
    # real left context whose outputs are discarded, so every kept sample
    # equals the full-length computation's (window starts are hop multiples,
    # so conv framing and the spec blocks' STFT phases line up). One window
    # length serves the whole stream.

    long_threshold: int = 60 * 16000   # chunk above this many samples
    chunk_samples: int = 160000        # 10 s per window, context excluded
    chunk_context: int = 16000         # 1 s, far beyond the receptive field

    def _iter_chunks(self, audio: np.ndarray
                     ) -> Iterator[Tuple[np.ndarray, int, int, int]]:
        """Yield (window [1, W], keep_from, out_start, out_len) with
        W = context + chunk for every window.

        The first window starts at sample 0 and keeps its whole output
        (leading zeros would not reproduce the convs' own causal padding).
        Later windows start ``context`` samples early on real audio and
        keep only what follows the context. The last window is zero-padded
        on the right, as the monolithic path pads to its bucket."""
        t = audio.shape[-1]
        ctx, chunk = self.chunk_context, self.chunk_samples
        w = ctx + chunk
        s = 0
        while s < t:
            keep_from = 0 if s == 0 else ctx
            lo = s - keep_from
            piece = audio[lo:lo + w]
            buf = np.zeros((1, w), np.float32)
            buf[0, :piece.shape[-1]] = piece
            out_len = min(w - keep_from, t - s)
            yield buf, keep_from, s, out_len
            s += out_len

    def _embed_long(self, audio: np.ndarray, bits: np.ndarray) -> np.ndarray:
        """audio [T], bits [1, nbits] -> watermarked [T]."""
        out = np.empty_like(audio)
        for x, keep, s, n in self._iter_chunks(audio):
            out[s:s + n] = self._embed(x, bits)[0, keep:keep + n]
        return out

    def _detect_long(self, audio: np.ndarray) -> Tuple[np.ndarray, float]:
        """(bit probabilities [nbits], confidence): the time-mean of
        sigmoid(logits) over the whole stream, summed in float64, the same
        definition as the full-length path."""
        acc = None
        for x, keep, _s, n in self._iter_chunks(audio):
            probs = self._detect_probs(x)[0, keep:keep + n]
            part = probs.double().sum(dim=0)
            acc = part if acc is None else acc + part
        bit_probs = (acc / audio.shape[-1]).float().cpu().numpy()
        return bit_probs, float(bit_probs.mean())

    def _locate_long(self, audio: np.ndarray) -> np.ndarray:
        out = np.empty(audio.shape[-1], np.float32)
        for x, keep, s, n in self._iter_chunks(audio):
            out[s:s + n] = self._locate(x)[0, keep:keep + n]
        return out

    # -- public API ------------------------------------------------------------

    def embed(self, audio_path: Union[str, Path],
              watermark: Union[WatermarkID, str, int, bytes],
              output_path: Optional[Union[str, Path]] = None
              ) -> Tuple[np.ndarray, int, WatermarkID]:
        """Embed a watermark into a file: (watermarked [T], rate, id)."""
        wm = self._validate_watermark_id(watermark)
        audio, sr = load_audio(audio_path, self.sample_rate)
        bits = message_to_tensor(wm.to_bits())
        if audio.shape[-1] > self.long_threshold:
            out = self._embed_long(np.asarray(audio, np.float32).ravel(), bits)
        else:
            x, t = self._pad_bucket(audio)
            out = self._embed(x, bits)[0, :t]
        if output_path is not None:
            save_audio(out, output_path, sr)
        return out, sr, wm

    def detect(self, audio_path: Union[str, Path]) -> Tuple[WatermarkID, float]:
        """Detect the watermark in a file: (id, confidence)."""
        audio, _sr = load_audio(audio_path, self.sample_rate)
        return self.detect_array(audio)

    def detect_array(self, audio: np.ndarray) -> Tuple[WatermarkID, float]:
        """Detect from an in-memory float32 array."""
        audio = np.asarray(audio, np.float32).ravel()
        if audio.shape[-1] > self.long_threshold:
            bit_probs, conf = self._detect_long(audio)
            return WatermarkID.custom(tensor_to_message(bit_probs[None, :])), conf
        x, t = self._pad_bucket(audio)
        probs, conf = self._detect(x, t)
        return WatermarkID.custom(tensor_to_message(probs)), float(conf[0])

    def locate(self, audio_path: Union[str, Path]) -> np.ndarray:
        """Per-sample watermark-presence mask of a file: float32 ``[T]``."""
        audio, _sr = load_audio(audio_path, self.sample_rate)
        return self.locate_array(audio)

    def locate_array(self, audio: np.ndarray) -> np.ndarray:
        """Presence mask from an in-memory float32 array. The locator works
        at sample resolution, so trimming the bucket's padding gives the
        mask at the input's length."""
        audio = np.asarray(audio, np.float32).ravel()
        if audio.shape[-1] > self.long_threshold:
            return self._locate_long(audio)
        x, t = self._pad_bucket(audio)
        return self._locate(x)[0, :t]

    def verify(self, audio_path: Union[str, Path],
               expected_watermark: Union[WatermarkID, str, int, bytes]) -> bool:
        """Whether the detected bits equal the expected watermark's."""
        expected = self._validate_watermark_id(expected_watermark)
        detected, _conf = self.detect(audio_path)
        return detected.to_bits() == expected.to_bits()

    def embed_batch(self, audio: np.ndarray, bits: np.ndarray) -> np.ndarray:
        """audio [B, T] float32, bits [B, 16] -> watermarked [B, T]."""
        return self._embed(audio, bits)

    def detect_batch(self, audio: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """audio [B, T] -> (bits [B, 16] int, confidence [B])."""
        probs, conf = self._detect(audio, np.asarray(audio).shape[-1])
        return (probs > 0.5).astype(int), conf

    @staticmethod
    def _validate_watermark_id(
            watermark: Union[WatermarkID, str, int, bytes]) -> WatermarkID:
        if isinstance(watermark, WatermarkID):
            return watermark
        return WatermarkID.custom(watermark)
