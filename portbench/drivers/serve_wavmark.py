"""Closed loop with one caller of WavMark's batched serving: each call is
``WaveVerify.embed_batch`` on ``batch`` clips of ``clip_s`` seconds, each
with a random 16-bit payload, then ``detect_batch`` on the audio it
returned (``serve_batch``'s loop and traffic parameters).

The weights are drawn from the seed by the reference
(``reference.wavmark.make_state_dict``), written in the published
``Model``'s layout and served through ``WaveVerify``'s loader.

Checked against the plain reference (``reference.wavmark``) on every batch
of the pool, by the last call that served it:

- ``wm_gap``: the largest gap between a watermarked sample and the
  reference's, over the largest magnitude of the reference's residual;
- ``msg_gap``: the largest gap between a segment's decoded value, as the
  call's ``detect_batch`` computed it, and the reference's decoding of the
  same audio, or between a clip's payload probability and the reference's
  (the mean of its values, clipped to [0, 1]);
- ``bit_flips``: bits unlike the reference's where its value lies more than
  ``MARGIN`` from the threshold 0.5: each segment's 32 decoded bits, each
  clip's 16 payload bits as ``detect_batch`` returned them, and the pattern
  bits that the clip's confidence counts unlike the reference's count,
  beyond the reference's bits within ``MARGIN`` of 0.5.

``detect_batch`` returns the payload bits and the confidence; the driver
keeps the decoded values that the same call's detector gave and the
probabilities that its ``WaveVerify._detect_on`` computed (on the card,
not read back inside the window).
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import Dict

import numpy as np
import torch

# the parent commit has no WavMark: the cell fails here, at once
from waveverify_torch.models.wavmark import WavMarkModels  # noqa: F401

from drivers import serve_batch
from pbcore import inputs
from reference import wavmark as rw
from reference.ops import Ops, strict_f32

# Each limit lies between the program's largest reading over 19 seeds and the
# smallest reading ten times larger or more of the control (the reference in
# TF32 in the program's place) or of a planted fault (H100, PERF.md section
# 2): wm_gap 5.7e-6 | 5.1e-4 (control), 0.98 (half the batch); msg_gap 2.9e-6
# | 1.7e-4 (control), 0.042 (detection's mean over half the samples);
# bit_flips is exact (0 for the program, and for the control too).
LIMITS = {"wm_gap": 4e-5, "msg_gap": 2e-5, "bit_flips": 0}
MARGIN = 1e-3


def reference_config(model: dict) -> dict:
    """The reference's config from the configuration's ``model`` section."""
    return {"segment": model["num_point"], "n_fft": model["n_fft"],
            "hop": model["hop_length"], "num_layers": model["num_layers"],
            "clamp": model["clamp"], "growth": model["growth"], "slope": model["slope"],
            "num_bits": model["num_bit"]}


class Driver(serve_batch.Driver):
    def __init__(self, ctx):
        self.ctx = ctx
        self.wl = ctx.workload
        self.model = ctx.config["model"]
        self.sr = ctx.config["sample_rate"]
        self.ref_cfg = reference_config(self.model)
        self.pattern = list(self.model["pattern"])

    def _weights(self) -> Dict[str, torch.Tensor]:
        """The published layout's state dict, drawn from the seed."""
        strict_f32()
        return rw.make_state_dict(inputs.sub_seed(self.ctx.seed, "weights"), self.ref_cfg,
                                  self.ctx.device)

    def program(self):
        """The port's WaveVerify on the seed's weights, loaded from a
        checkpoint file in the published layout."""
        from waveverify_torch import WaveVerify
        from waveverify_torch.config import WavMarkConfig

        cfg, m = self.ctx.config, self.model
        config = WavMarkConfig(
            sample_rate=self.sr, segment=m["num_point"], n_fft=m["n_fft"],
            hop_length=m["hop_length"], num_layers=m["num_layers"], clamp=m["clamp"],
            growth=m["growth"], slope=m["slope"], pattern=tuple(self.pattern),
            payload_bits=m["num_bit"] - len(self.pattern))
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "wavmark.pth"
            torch.save({k: v.cpu() for k, v in self._weights().items()}, path)
            wv = WaveVerify(path, config=config, precision=cfg["precision"],
                            serve_dtype=cfg["serve_dtype"], device=self.ctx.device)
        models, decode = wv.models, wv.models.apply_detector

        def decoded(audio):
            """The detector's own values, kept."""
            self.values = decode(audio)
            return self.values

        def decided(models, device, audio, t):
            """``detect_batch``'s own ``_detect_on``, its outputs kept."""
            self.decided = type(wv)._detect_on(wv, models, device, audio, t)
            return self.decided

        models.apply_detector = decoded
        wv._detect_on = decided
        return wv

    def call(self, audio: np.ndarray, ids: np.ndarray):
        """``serve_batch``'s call, plus the decoded values and the payload
        probabilities that its ``detect_batch`` computed (on the device)."""
        wm, bits, conf = super().call(audio, ids)
        return wm, bits, conf, self.decided[0], self.values

    @torch.no_grad()
    def release(self) -> None:
        """The kept calls' outputs on the host, then the program goes."""
        self.readings = {k: (wm, bits, conf, probs.cpu().numpy(), values.cpu().numpy())
                         for k, (wm, bits, conf, probs, values) in self.kept.items()}
        del self.wv

    # -- the comparison ------------------------------------------------------------

    def _bits(self, ids: torch.Tensor) -> torch.Tensor:
        pattern = torch.tensor(self.pattern, dtype=ids.dtype, device=ids.device)
        return torch.cat((pattern.expand(ids.shape[0], -1), ids), dim=1)

    @torch.no_grad()
    def judge(self, outputs: Dict[int, tuple], count: bool = False) -> dict:
        """The numbers compared, for ``outputs`` {pool index: (watermarked,
        payload bits, confidence, payload probabilities, decoded values)};
        with ``count`` also the FLOP of a call on each batch of the pool
        (the shapes are the same)."""
        from counts import count_flop

        p, cfg, ref = self._weights(), self.ref_cfg, Ops()
        k_pat = len(self.pattern)
        values = {name: 0 if name.endswith("flips") else 0.0 for name in LIMITS}
        detail = {}
        flop = None
        for k, (wm, bits, conf, probs, v) in sorted(outputs.items()):
            audio, ids = self._inputs(k)
            wm_t = torch.as_tensor(wm, device=self.ctx.device)

            def one():
                return (rw.embed(ref, p, cfg, audio, self._bits(ids)),
                        rw.decode(ref, p, cfg, wm_t))

            if count and flop is None:
                (wm_ref, v_ref), flop = count_flop(one)
            else:
                wm_ref, v_ref = one()
            probs_ref, conf_ref = rw.decide(v_ref, self.pattern)
            v_ref, probs_ref = v_ref.cpu().numpy(), probs_ref.cpu().numpy()
            v = np.asarray(v)
            seg_flips = np.sum(((v >= 0.5) != (v_ref >= 0.5)) & (np.abs(v_ref - 0.5) > MARGIN))
            clip_flips = np.sum((np.asarray(bits) != (probs_ref > 0.5))
                                & (np.abs(probs_ref - 0.5) > MARGIN))
            # the confidence's count of pattern bits read right, against the
            # reference's, give or take its bits within MARGIN of 0.5
            n = v_ref.shape[1] * k_pat
            counted = np.rint(np.asarray(conf, np.float64) * n)
            ref_count = np.rint(conf_ref.cpu().numpy() * n)
            unsure = np.sum(np.abs(v_ref[..., :k_pat] - 0.5) <= MARGIN, axis=(1, 2))
            row = {"wm_gap": float(torch.max(torch.abs(wm_t - wm_ref))
                                   / torch.max(torch.abs(wm_ref - audio))),
                   "msg_gap": float(max(np.max(np.abs(v - v_ref)),
                                        np.max(np.abs(np.asarray(probs) - probs_ref)))),
                   "bit_flips": int(seg_flips + clip_flips + np.sum(np.maximum(
                       np.abs(counted - ref_count) - unsure, 0)))}
            detail[k] = row
            for name, x in row.items():
                values[name] = (values[name] + x if name.endswith("flips")
                                else max(values[name], x))
        if flop is not None:
            flop = {k: flop for k in range(len(self.pool))}
        checks = [{"name": n, "value": x, "limit": LIMITS[n]} for n, x in values.items()]
        return {"correct": all(c["value"] <= c["limit"] for c in checks),
                "checks": checks, "flop": flop, "detail": detail}

    def check(self, count: bool = False) -> dict:
        return self.judge(self.readings, count=count)

    @torch.no_grad()
    def control_outputs(self) -> Dict[int, tuple]:
        """The reference in TF32 put in the program's place, on the same
        pool: its watermarked audio, payload bits, confidence, payload
        probabilities and decoded values."""
        p, cfg, low = self._weights(), self.ref_cfg, Ops(tf32=True)
        out = {}
        for k in sorted(self.readings):
            audio, ids = self._inputs(k)
            wm = rw.embed(low, p, cfg, audio, self._bits(ids))
            v = rw.decode(low, p, cfg, wm)
            probs, conf = rw.decide(v, self.pattern)
            out[k] = (wm.cpu().numpy(), (probs > 0.5).int().cpu().numpy(),
                      conf.cpu().numpy(), probs.cpu().numpy(), v.cpu().numpy())
        return out
