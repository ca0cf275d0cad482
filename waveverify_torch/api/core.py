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

WaveVerify serves AudioSeal too (``config=AudioSealConfig()``;
``models/audioseal.py``): its generator and detector, with its own
decisions (bits from the sigmoid of each logit's time-mean, the detection
score and the presence channel from the detector's softmax). AudioSeal is
neither causal nor stateless in time (its bottleneck is an LSTM), so every
input runs whole at its own length: no bucket padding, no windows.
WavMark too (``config=WavMarkConfig()``; ``models/wavmark.py``): it marks
and decodes whole 1 s segments of the input (a shorter tail is returned
unmarked and ignored by detection), and has no locator.

Weights come from a ``save_weights_npz`` file, a reference ``.pth`` (the
paper's checkpoint format, converted by ``waveverify_torch.convert``), a
checkpoint directory of the port's trainer or of the JAX trainer (orbax,
read without JAX by ``waveverify_torch.train.ocdbt``), or random
initialisation from a seed. After :meth:`WaveVerify.use_mesh`, ``embed_batch`` and
``detect_batch`` split the batch across several devices, as the JAX
package's do over its data mesh.

Under a profiler, ``embed_batch`` and ``detect_batch`` record spans
(:mod:`waveverify_torch.spans`): the roots ``api.embed_batch`` and
``api.detect_batch``, and inside them ``api.upload`` (numpy to the card),
``api.generator`` or ``api.detector`` (the network's enqueue) and
``api.readback`` (the card to numpy); the single-clip paths record the
same three.
"""

from __future__ import annotations

import copy
import logging
import math
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from waveverify_torch import spans
from waveverify_torch.api.audio_io import (
    load_audio,
    message_to_tensor,
    save_audio,
    tensor_to_message,
)
from waveverify_torch.api.watermark_id import WatermarkID
from waveverify_torch.config import (
    AudioSealConfig,
    TrainConfig,
    WavMarkConfig,
    apply_model_config,
    load_config,
)
from waveverify_torch.models import WatermarkModels
from waveverify_torch.models.audioseal import AudioSealModels, init_audioseal
from waveverify_torch.models.wavmark import WavMarkModels, init_wavmark
from waveverify_torch.serve import (
    locate_probs,
    resolve_device,
    resolve_dtype,
    set_conv_precision,
)
from waveverify_torch.weights import flatten, load_params, read_npz

logger = logging.getLogger(__name__)

SAMPLE_RATE = 16000


def _indexed(device: torch.device) -> torch.device:
    """``device`` with its index: a ``cuda`` without one is the current
    card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _next_bucket(length: int, hop: int = 320, min_len: int = 4800) -> int:
    """Smallest bucket >= length: hop-aligned, ~1.26x geometric spacing."""
    n = max(length, min_len)
    bucket = min_len
    while bucket < n:
        bucket = int(math.ceil(bucket * 1.26 / hop) * hop)
    return bucket


class WaveVerify:
    """Embed, detect, locate and verify 16-bit watermarks.

    checkpoint_path:
        - a ``.npz`` written by ``save_weights_npz`` (either package), its
          ``__config__`` snapshot setting the architecture;
        - a reference PyTorch ``.pth`` / ``.pt`` / ``.ckpt``, converted on
          load (it carries no snapshot: the architecture comes from
          ``config_path`` / ``config``);
        - a checkpoint directory of the port's trainer (a tag directory
          holding ``weights.npz``) or of the JAX trainer (an orbax tag
          directory holding ``state/``, whose ``wm_params`` are read), or
          a root holding such a ``latest/``; the architecture comes from
          its ``meta.json``'s ``model_config`` where it has one;
        - ``None``: random initialisation from ``seed`` (drawn on a CPU
          generator, so a seed gives the same weights on every device);
          embedding works end to end, detection needs trained weights.
        Under an ``AudioSealConfig``: a pair of AudioSeal's checkpoints
        (generator, detector: ``generator_base.pth`` / ``detector_base.pth``
        or state dicts of ``AudioSealWM`` / ``AudioSealDetector``), or
        ``None`` for PyTorch's default initialisers drawn from ``seed``.
        Under a ``WavMarkConfig``: the path of WavMark's checkpoint (the
        released ``Model``'s state dict), or ``None`` for PyTorch's
        default initialisers with HiNet's zero ``conv5`` (an identity
        network). A missing, extra or misshapen weight raises.
    config_path: a YAML of the ``conf/base.yml`` schema. config: a
        ``TrainConfig``, an ``AudioSealConfig`` to serve AudioSeal, or a
        ``WavMarkConfig`` to serve WavMark. An
        explicit ``config`` wins; otherwise the checkpoint's snapshot
        overrides the YAML's (or the defaults') model sections, with a
        WARNING when a YAML was given too.
    precision: ``"highest"`` (the default) turns TF32 off for cuDNN and
        cuBLAS, so f32 computes in f32; ``"high"`` / ``"default"`` allow
        TF32; ``None`` leaves the process-wide setting alone. A
        process-wide PyTorch setting; the chain kernel ignores it.
    serve_dtype: ``"float32"`` or ``"bfloat16"`` network activations;
        audio, sums and decisions stay f32 either way.
    device: ``"cuda"`` (default; raises without a card) or ``"cpu"``.
    """

    def __init__(self, checkpoint_path: Optional[Union[str, Path, Sequence]] = None,
                 config_path: Optional[Union[str, Path]] = None,
                 config: Optional[Union[TrainConfig, AudioSealConfig,
                                        WavMarkConfig]] = None,
                 seed: int = 0,
                 precision: Optional[str] = "highest",
                 serve_dtype: str = "float32",
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.serve_dtype = serve_dtype
        self._act = resolve_dtype(serve_dtype)
        if precision is not None:
            set_conv_precision(precision)
        loader = self._LOADERS.get(type(config))
        if loader is None:
            self._load_waveverify(checkpoint_path, config_path, config, seed)
        else:
            loader(self, checkpoint_path, config, seed)
        self.models.requires_grad_(False)
        self.models.eval().to(self.device)
        # the devices batched serving splits over, each with its replica:
        # the constructor's device alone until use_mesh
        self._mesh: List[Tuple[torch.device, WatermarkModels]] = [
            (self.device, self.models)]

    def _load_audioseal(self, checkpoint_path, config: AudioSealConfig, seed: int) -> None:
        self.config = config
        self.models = AudioSealModels(config)
        if checkpoint_path is None:
            logger.warning("no checkpoint given - using randomly initialized "
                           "weights")
            init_audioseal(self.models, torch.Generator().manual_seed(seed))
        else:
            from waveverify_torch.convert import load_audioseal

            generator_path, detector_path = checkpoint_path
            load_audioseal(self.models, generator_path, detector_path)
        self.sample_rate = config.sample_rate
        self.hop = config.hop_length

    def _load_wavmark(self, checkpoint_path, config: WavMarkConfig, seed: int) -> None:
        if self.serve_dtype != "float32":
            raise NotImplementedError(f"serve_dtype {self.serve_dtype!r}: WavMark "
                                      "serves in float32 only")
        self.config = config
        self.models = WavMarkModels(config)
        if checkpoint_path is None:
            logger.warning("no checkpoint given - using randomly initialized "
                           "weights")
            init_wavmark(self.models, torch.Generator().manual_seed(seed))
        else:
            from waveverify_torch.convert import load_wavmark

            load_wavmark(self.models, checkpoint_path)
        self.sample_rate = config.sample_rate
        self.hop = config.hop_length

    # the loader of each model that is not WaveVerify's, by its config's type
    _LOADERS = {AudioSealConfig: _load_audioseal, WavMarkConfig: _load_wavmark}

    def _load_waveverify(self, checkpoint_path, config_path, config, seed: int) -> None:
        path = None if checkpoint_path is None else Path(checkpoint_path)
        is_pth = path is not None and path.suffix in (".pth", ".pt", ".ckpt")
        flat, snap = (None, None) if path is None or is_pth else self._read_weights(path)
        self.config = config if config is not None else load_config(config_path)
        if config is None and snap:
            if config_path is not None:
                logger.warning(
                    "checkpoint model-config snapshot overrides the explicit "
                    "config YAML for model sections %s - pass "
                    "config=load_config(%r) to force the YAML instead",
                    sorted(snap.keys()), str(config_path))
            self.config = apply_model_config(self.config, snap)
            logger.info("applied model-config snapshot from checkpoint")
        self.models = WatermarkModels(self.config)
        if path is None:
            logger.warning("no checkpoint given - using randomly initialized "
                           "weights")
            from waveverify_torch.modules.conv import init_params

            init_params(self.models, torch.Generator().manual_seed(seed))
        else:
            if is_pth:  # the architecture is needed to convert
                from waveverify_torch.convert import convert_torch_checkpoint

                logger.info("converting PyTorch checkpoint %s", path)
                flat = flatten(convert_torch_checkpoint(path, self.config,
                                                        models=self.models))
            consumed = set()
            for net in ("generator", "detector", "locator"):
                consumed |= load_params(getattr(self.models, net), flat, net)
            extra = sorted(set(flat) - consumed)
            if extra:
                raise KeyError(f"{path}: entries no network takes: {extra[:5]}")
        self.sample_rate = self.config.generator.sample_rate
        self.hop = self.config.generator.hop_length

    # -- multi-device serving ------------------------------------------------------

    def use_mesh(self, devices: Optional[Sequence[Union[str, torch.device]]] = None
                 ) -> "WaveVerify":
        """Split batched serving (``embed_batch`` / ``detect_batch``) across
        ``devices``: the three networks are replicated on each (every
        visible card when None, as the JAX package's ``use_mesh`` takes
        every device), the batch is cut into equal shares in order, one per
        listed device (B must divide), every share is launched before any
        result is copied to the host, so the cards overlap, and the results
        are gathered in order. A device listed twice runs two shares on one
        replica. Single-clip methods stay on the constructor's device.
        Returns self."""
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is present; pass devices, "
                                   "e.g. ['cpu', 'cpu']")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        own = _indexed(self.device)
        replicas = {}
        mesh = []
        for d in devices:
            dev = _indexed(resolve_device(d))
            if dev not in replicas:
                replicas[dev] = (self.models if dev == own
                                 else copy.deepcopy(self.models).to(dev))
            mesh.append((dev, replicas[dev]))
        self._mesh = mesh
        return self

    def _shares(self, b: int, what: str) -> List[slice]:
        """The mesh's shares of a batch of ``b`` rows, in order."""
        n = len(self._mesh)
        if b % n:
            raise ValueError(f"{what}: the batch's dimension 0 should be "
                             f"divisible by the mesh's {n} devices, but it is "
                             f"equal to {b}")
        per = b // n
        return [slice(i * per, (i + 1) * per) for i in range(n)]

    # -- checkpoints ---------------------------------------------------------------

    @staticmethod
    def _read_weights(path: Path):
        """(flat flax-named arrays, architecture snapshot or None) of an
        ``.npz``, or of a checkpoint directory: the port trainer's (its
        ``weights.npz``) or the JAX trainer's orbax one (its ``wm_params``),
        each a tag directory or a root holding ``latest/``. A directory's
        snapshot falls back to its ``meta.json``'s ``model_config``."""
        import json

        from waveverify_torch.train.ocdbt import read_params

        flat = snap = None
        if path.suffix == ".npz":
            logger.info("loading %s", path)
            flat, snap = read_npz(path)
        elif path.is_dir():
            for tag_dir in (path, path / "latest"):
                if (tag_dir / "state").is_dir():
                    logger.info("loading orbax checkpoint %s", tag_dir)
                    flat = flatten(read_params(tag_dir))
                    break
                if (tag_dir / "weights.npz").exists():
                    logger.info("loading %s", tag_dir / "weights.npz")
                    flat, snap = read_npz(tag_dir / "weights.npz")
                    break
        if flat is None:
            raise FileNotFoundError(
                f"no checkpoint found at {path} (expected a .npz, a .pth, or "
                "a checkpoint directory of the port's or the JAX trainer)")
        for meta in (path / "meta.json", path / "latest" / "meta.json"):
            if not snap and path.is_dir() and meta.exists():
                snap = json.loads(meta.read_text()).get("model_config")
        return flat, snap

    # -- device programs -------------------------------------------------------

    def _tensor(self, a: np.ndarray, device: Optional[torch.device] = None
                ) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32),
                            device=self.device if device is None else device)

    @torch.no_grad()
    def _embed_on(self, models: WatermarkModels, device: torch.device,
                  audio: np.ndarray, bits: np.ndarray) -> torch.Tensor:
        """Watermarked audio on ``device``, by ``models`` (enqueued)."""
        with spans.span("api.upload"):
            x, msg = self._tensor(audio, device), self._tensor(bits, device)
        with spans.span("api.generator"):
            residual = models.apply_generator(x.to(self._act), msg.to(self._act))
            return residual.float() + x

    def _embed(self, audio: np.ndarray, bits: np.ndarray) -> np.ndarray:
        out = self._embed_on(self.models, self.device, audio, bits)
        with spans.span("api.readback"):
            return out.cpu().numpy()

    @torch.no_grad()
    def _detect_probs(self, audio: np.ndarray,
                      models: Optional[WatermarkModels] = None,
                      device: Optional[torch.device] = None) -> torch.Tensor:
        """Per-sample bit probabilities ``[B, T, nbits]`` on the device."""
        with spans.span("api.upload"):
            x = self._tensor(audio, device)
        models = self.models if models is None else models
        with spans.span("api.detector"):
            return torch.sigmoid(models.apply_detector(x.to(self._act)).float())

    @torch.no_grad()
    def _detect_on(self, models: WatermarkModels, device: torch.device,
                   audio: np.ndarray, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(bit probabilities [B, nbits], confidence [B]) on ``device``
        over the first ``t`` samples only (enqueued), by the holder's
        ``decide``. WaveVerify: the time-mean of sigmoid(logits) per bit,
        and as confidence their mean. AudioSeal: the sigmoid of each bit
        logit's time-mean, and as confidence the detection score, the share
        of samples whose presence probability exceeds 0.5. WavMark: each
        payload value's mean over the whole segments, clipped to [0, 1],
        and as confidence the share of pattern bits read right."""
        with spans.span("api.upload"):
            x = self._tensor(audio, device)
        with spans.span("api.detector"):
            logits = models.apply_detector(x.to(self._act)).float()
        return models.decide(logits, t)

    def _detect(self, audio: np.ndarray, t: int) -> Tuple[np.ndarray, np.ndarray]:
        probs, conf = self._detect_on(self.models, self.device, audio, t)
        with spans.span("api.readback"):
            return probs.cpu().numpy(), conf.cpu().numpy()

    def _locate(self, audio: np.ndarray) -> np.ndarray:
        """Presence probabilities ``[B, T]``: sigmoid of the locator."""
        return locate_probs(self.models, self._tensor(audio),
                            self.serve_dtype).cpu().numpy()

    def _pad_bucket(self, audio: np.ndarray) -> Tuple[np.ndarray, int]:
        """``[1, bucket]`` and the length; a holder that takes its input
        whole (AudioSeal's) has the length as its bucket."""
        t = audio.shape[-1]
        n = t if self.models.whole_input else _next_bucket(t, self.hop)
        x = np.zeros((1, n), np.float32)
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

    long_threshold: int = 60 * 16000   # chunk above this many samples (not whole_input)
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

    def _chunked(self, t: int) -> bool:
        """Whether ``t`` samples go through windows: over the threshold, and
        never for a holder that takes its input whole (AudioSeal's)."""
        return t > self.long_threshold and not self.models.whole_input

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
        if self._chunked(audio.shape[-1]):
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
        if self._chunked(audio.shape[-1]):
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
        mask at the input's length. AudioSeal's mask is its detector's
        presence channel; WavMark has none and raises
        ``NotImplementedError``."""
        audio = np.asarray(audio, np.float32).ravel()
        if self._chunked(audio.shape[-1]):
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
        """audio [B, T] float32, bits [B, 16] -> watermarked [B, T]. After
        :meth:`use_mesh` the batch is split across its devices (B must
        divide over them)."""
        with spans.span("api.embed_batch"):
            audio, bits = np.asarray(audio), np.asarray(bits)
            outs = [self._embed_on(models, dev, audio[sl], bits[sl])
                    for (dev, models), sl in zip(
                        self._mesh, self._shares(audio.shape[0], "embed_batch"))]
            with spans.span("api.readback"):
                return np.concatenate([o.cpu().numpy() for o in outs])

    def detect_batch(self, audio: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """audio [B, T] -> (bits [B, 16] int, confidence [B]; see
        :meth:`_detect_on` for each model's). After :meth:`use_mesh` the
        batch is split across its devices."""
        with spans.span("api.detect_batch"):
            audio = np.asarray(audio)
            outs = [self._detect_on(models, dev, audio[sl], audio.shape[-1])
                    for (dev, models), sl in zip(
                        self._mesh, self._shares(audio.shape[0], "detect_batch"))]
            with spans.span("api.readback"):
                probs = np.concatenate([p.cpu().numpy() for p, _ in outs])
                conf = np.concatenate([c.cpu().numpy() for _, c in outs])
            return (probs > 0.5).astype(int), conf

    @staticmethod
    def _validate_watermark_id(
            watermark: Union[WatermarkID, str, int, bytes]) -> WatermarkID:
        if isinstance(watermark, WatermarkID):
            return watermark
        return WatermarkID.custom(watermark)
