"""The plain reference (``portbench/reference``) equals the port on the CPU
at a small size: serving at batch 1 on a short clip, and one training step
at batch 2."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pbcore import harness, inputs
from pbcore.trace import Tracer
from reference import nets
from reference.ops import Ops


def _port(cfg):
    from waveverify_torch import WaveVerify
    from waveverify_torch.config import TrainConfig, apply_model_config

    return WaveVerify(cfg["weights"], config=apply_model_config(TrainConfig(), cfg["model"]),
                      device="cpu")


@torch.no_grad()
def test_serving_networks(serve_config):
    wv = _port(serve_config)
    m = serve_config["model"]
    with np.load(serve_config["weights"]) as z:
        p = {k: torch.as_tensor(np.asarray(z[k], np.float32)) for k in z.files
             if not k.startswith("__")}
    g = inputs.rng(3, "test")
    audio = torch.as_tensor(inputs.speech_like(g, 1, 5000, 16000))
    msg = torch.as_tensor(inputs.bits(g, 1))
    ops = Ops()
    pairs = [
        (wv.models.apply_generator(audio, msg), nets.generator(ops, p, m["Generator"], audio, msg)),
        (wv.models.apply_detector(audio), nets.detector(ops, p, m["Detector"], audio)),
        (wv.models.apply_locator(audio), nets.locator(ops, p, m["Locator"], audio)),
    ]
    for port, ref in pairs:
        assert port.shape == ref.shape
        scale = float(ref.abs().max())
        assert float((port - ref).abs().max()) <= 1e-5 * scale


def test_weight_names_match_the_port(serve_config):
    """The reference's weight table names every weight of the port's three
    networks, at their shapes (the port's loader checks both ways)."""
    from waveverify_torch.weights import export_params

    wv = _port(serve_config)
    spec = {n: s for n, s, _ in nets.param_spec(serve_config["model"])}
    port = {}
    for net in ("generator", "detector", "locator"):
        port.update({k: v.shape for k, v in export_params(getattr(wv.models, net), net).items()})
    assert spec == port


def test_one_train_step(train_config):
    """One step at batch 2 from the same weights and inputs: losses,
    every leaf's gradient as its optimizer got it, every leaf's change.
    The leaf limits are a hundredth of the larger of the leaf's norm and
    the median leaf's: at random init the log-STFT features make single
    leaves swing by a few thousandths of the median on rounding alone
    (the order of a sum; here 1.0e-3 on ``film_1_0/gamma/bias``), where
    the reference in TF32 moves them by more than the median itself."""
    train_config["batch_size"] = 2
    wl = {"driver": "train_step", "checked_steps": 1, "window_check_step": 0}
    ctx = harness.Context("train.step.b32", 11, torch.device("cpu"), train_config, wl,
                          Tracer(False, harness.OUT_DIR))
    d = harness.load_module(harness.BENCH_DIR / "drivers" / "train_step.py").Driver(ctx)
    d.setup()
    d.release()
    got = d.program_readings()
    losses, g1, change = got["losses"], got["g1"], got["change"]
    ref = d.reference_run(Ops())
    for k in ("loss", "adv/disc_loss"):
        assert losses[0][k] == pytest.approx(ref["losses"][0][k], rel=1e-5)
    med = float(np.median(list(ref["g1"].values())))
    assert set(g1) == set(ref["g1"])
    for k, r in ref["g1"].items():
        assert abs(g1[k] - r) <= 1e-2 * max(r, med), k
    medc = float(np.median(list(ref["change"].values())))
    for k, r in ref["change"].items():
        assert abs(change[k] - r) <= 1e-2 * max(r, medc), k
