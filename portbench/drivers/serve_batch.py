"""Closed loop with one caller of batched serving: each call is
``WaveVerify.embed_batch`` on ``batch`` clips of ``clip_s`` seconds with
random 16-bit ids, then ``detect_batch`` on the audio it returned.

Traffic parameters (the workload file): ``batch``, ``clip_s``, ``pool``
(distinct batches made at set-up from the seed and cycled in a seeded
order), ``profile`` (the calls the traced run profiles).

Checked against the plain reference (``reference.nets``) on every batch of
the pool, by the last call that served it:

- ``wm_gap``: the largest gap between a watermarked sample and the
  reference's, over the largest magnitude of the reference's residual;
- ``conf_gap``: the largest gap between a clip's confidence (the mean bit
  probability) and the reference detector's on the same audio;
- ``bit_flips``: bits that differ from the reference's decision where its
  time-mean probability lies more than ``margin`` from 0.5.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from pbcore import inputs
from reference import nets
from reference.ops import Ops, strict_f32

LIMITS = {"wm_gap": 1e-3, "conf_gap": 1e-5, "bit_flips": 0}
MARGIN = 1e-3



class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.wl = ctx.workload
        self.model = ctx.config["model"]
        self.sr = self.model["Generator"]["sample_rate"]

    def program(self):
        """The port's WaveVerify on the configuration's weights."""
        from waveverify_torch import WaveVerify
        from waveverify_torch.config import TrainConfig, apply_model_config

        cfg = self.ctx.config
        return WaveVerify(self.ctx.root / cfg["weights"],
                          config=apply_model_config(TrainConfig(), self.model),
                          precision=cfg["precision"], serve_dtype=cfg["serve_dtype"],
                          device=self.ctx.device)

    def setup(self) -> None:
        wl = self.wl
        g = inputs.rng(self.ctx.seed, "pool")
        t = int(round(wl["clip_s"] * self.sr))
        self.pool = [(inputs.speech_like(g, wl["batch"], t, self.sr),
                      inputs.bits(g, wl["batch"]).astype(np.int64))
                     for _ in range(wl["pool"])]
        self.order = inputs.rng(self.ctx.seed, "order").permutation(wl["pool"])
        self.wv = self.program()
        for audio, ids in self.pool[:2]:
            self.call(audio, ids)

    def call(self, audio: np.ndarray, ids: np.ndarray):
        tr = self.ctx.tracer
        with tr.span("embed_batch"):
            wm = self.wv.embed_batch(audio, ids)
        with tr.span("detect_batch"):
            bits, conf = self.wv.detect_batch(wm)
        return wm, bits, conf

    def run_window(self, seconds: float) -> dict:
        tr = self.ctx.tracer
        calls: List[Tuple[float, float]] = []
        keys: List[int] = []
        self.kept: Dict[int, tuple] = {}
        audio_s = self.wl["batch"] * self.wl["clip_s"]
        t_start = time.perf_counter()
        deadline = t_start + seconds
        i = 0
        while time.perf_counter() < deadline:
            tr.iteration(i)
            k = int(self.order[i % len(self.order)])
            t0 = time.perf_counter()
            with tr.span("call"):
                out = self.call(*self.pool[k])
            calls.append((t0, time.perf_counter()))
            self.kept[k] = out
            keys.append(k)
            i += 1
        tr.iteration(i)
        t_end = time.perf_counter()
        return {"t_start": t_start, "t_end": t_end, "attempted": len(calls),
                "calls": calls, "audio_s": [audio_s] * len(calls), "keys": keys}

    def release(self) -> None:
        del self.wv

    # -- the comparison ------------------------------------------------------------

    def _weights(self) -> Dict[str, torch.Tensor]:
        for name in ("Generator", "Detector"):
            nets.check_config(self.model[name], name)
        strict_f32()
        return nets.read_npz(self.ctx.root / self.ctx.config["weights"], self.ctx.device)

    def _inputs(self, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = self.ctx.device
        return (torch.as_tensor(self.pool[k][0], device=dev),
                torch.as_tensor(self.pool[k][1], dtype=torch.float32, device=dev))

    @torch.no_grad()
    def judge(self, outputs: Dict[int, tuple], count: bool = False) -> dict:
        """The numbers compared, for ``outputs`` {pool index: (watermarked,
        bits, confidence)}; with ``count`` also the FLOP of a call on each
        batch of the pool ({pool index: FLOP}; the shapes are the same)."""
        from counts import count_flop

        p = self._weights()
        ref = Ops()
        wm_gap = conf_gap = 0.0
        flips = 0
        flop = None
        for k, (wm, bits, conf) in sorted(outputs.items()):
            audio, msg = self._inputs(k)
            wm_t = torch.as_tensor(wm, device=self.ctx.device)

            def one():
                res = nets.generator(ref, p, self.model["Generator"], audio, msg)
                return res, nets.detector(ref, p, self.model["Detector"], wm_t)

            if count and flop is None:
                (res, logits), flop = count_flop(one)
            else:
                res, logits = one()
            wm_gap = max(wm_gap, float(torch.max(torch.abs(wm_t - (audio + res)))
                                       / torch.max(torch.abs(res))))
            probs = torch.sigmoid(logits).mean(1)
            conf_gap = max(conf_gap, float(np.max(np.abs(
                np.asarray(conf) - probs.mean(1).cpu().numpy()))))
            pr = probs.cpu().numpy()
            sure = np.abs(pr - 0.5) > MARGIN
            flips += int(np.sum((np.asarray(bits) != (pr > 0.5)) & sure))
        if flop is not None:
            flop = {k: flop for k in range(len(self.pool))}
        values = {"wm_gap": wm_gap, "conf_gap": conf_gap, "bit_flips": flips}
        checks = [{"name": n, "value": v, "limit": LIMITS[n]} for n, v in values.items()]
        return {"correct": all(c["value"] <= c["limit"] for c in checks),
                "checks": checks, "flop": flop}

    def check(self, count: bool = False) -> dict:
        return self.judge(self.kept, count=count)

    def control_check(self) -> dict:
        """:meth:`check` of the control: the reference in TF32 in the
        program's place."""
        return self.judge(self.control_outputs())

    @torch.no_grad()
    def control_outputs(self) -> Dict[int, tuple]:
        """The reference in TF32 put in the program's place, on the same
        pool: its watermarked audio, bits and confidences."""
        p = self._weights()
        low = Ops(tf32=True)
        out = {}
        for k in sorted(self.kept):
            audio, msg = self._inputs(k)
            wm = audio + nets.generator(low, p, self.model["Generator"], audio, msg)
            probs = torch.sigmoid(nets.detector(low, p, self.model["Detector"], wm)).mean(1)
            out[k] = (wm.cpu().numpy(), (probs > 0.5).int().cpu().numpy(),
                      probs.mean(1).cpu().numpy())
        return out
