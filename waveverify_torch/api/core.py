"""Public inference API of the port: WaveVerify embed / detect / verify
(counterpart of ``waveverify_tpu/api/core.py``).

Same signatures, return types and decision rules as the JAX package:
audio is right-padded to a length bucket, the generator's residual is
upcast and added to the clean f32 audio, and bits come from
sigmoid(logits) averaged over the real (unpadded) length, thresholded at
0.5. Runs on ``cuda`` unless ``device="cpu"`` is passed.

Not ported yet: ``locate``, the chunked long-audio path, multi-card
serving, and checkpoints other than ``.npz``.
"""

from __future__ import annotations

import logging
import math
from pathlib import Path
from typing import Optional, Tuple, Union

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
from waveverify_torch.serve import resolve_device, resolve_dtype, strict_f32
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
    """Embed, detect and verify 16-bit watermarks.

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
        self._act = resolve_dtype(serve_dtype)
        if self._act == torch.float32 and self.device.type == "cuda":
            strict_f32()
        flat, snap = read_npz(path)
        self.config = apply_model_config(TrainConfig(), snap or {})
        self.models = WatermarkModels(self.config)
        load_params(self.models.generator, flat, "generator")
        load_params(self.models.detector, flat, "detector")
        self.models.requires_grad_(False)
        self.models.eval().to(self.device)
        self.sample_rate = self.config.generator.sample_rate
        self.hop = self.config.generator.hop_length

    # -- device programs -------------------------------------------------------

    @torch.no_grad()
    def _embed(self, audio: np.ndarray, bits: np.ndarray) -> np.ndarray:
        x = torch.tensor(np.asarray(audio, np.float32), device=self.device)
        msg = torch.tensor(np.asarray(bits, np.float32), device=self.device)
        residual = self.models.apply_generator(x.to(self._act), msg.to(self._act))
        return (residual.float() + x).cpu().numpy()

    @torch.no_grad()
    def _detect(self, audio: np.ndarray, t: int) -> Tuple[np.ndarray, np.ndarray]:
        """(bit probabilities [B, nbits], confidence [B]) with sigmoid(logits)
        averaged over the first ``t`` samples only."""
        x = torch.tensor(np.asarray(audio, np.float32), device=self.device)
        logits = self.models.apply_detector(x.to(self._act)).float()
        probs = torch.sigmoid(logits)
        valid = (torch.arange(probs.shape[1], device=self.device) < t)[None, :, None]
        probs = torch.sum(probs * valid, dim=1) / max(t, 1)
        return probs.cpu().numpy(), probs.mean(dim=1).cpu().numpy()

    def _pad_bucket(self, audio: np.ndarray) -> Tuple[np.ndarray, int]:
        t = audio.shape[-1]
        x = np.zeros((1, _next_bucket(t, self.hop)), np.float32)
        x[0, :t] = audio
        return x, t

    # -- public API ------------------------------------------------------------

    def embed(self, audio_path: Union[str, Path],
              watermark: Union[WatermarkID, str, int, bytes],
              output_path: Optional[Union[str, Path]] = None
              ) -> Tuple[np.ndarray, int, WatermarkID]:
        """Embed a watermark into a file: (watermarked [T], rate, id)."""
        wm = self._validate_watermark_id(watermark)
        audio, sr = load_audio(audio_path, self.sample_rate)
        x, t = self._pad_bucket(audio)
        out = self._embed(x, message_to_tensor(wm.to_bits()))[0, :t]
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
        x, t = self._pad_bucket(audio)
        probs, conf = self._detect(x, t)
        return WatermarkID.custom(tensor_to_message(probs)), float(conf[0])

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
