"""The control of each cell's comparison, at a size a test run holds: the
plain reference computed in TF32 (the precision below the configured
float32) and put in the program's place fails the cell's limits, where
the program passes them. On the card ``portbench/control.py`` reads both
at the cells' own sizes."""

from __future__ import annotations

import pytest
import torch

from pbcore import harness
from pbcore.trace import Tracer

CASES = {
    "serve.embed_detect.b64": ("serve", {"driver": "serve_batch", "batch": 2, "clip_s": 0.25,
                                         "pool": 2}),
    "train.step.b32": ("train", {"driver": "train_step", "checked_steps": 3,
                                 "window_check_step": 0}),
}


@pytest.mark.parametrize("cell", sorted(CASES))
def test_control_fails_where_the_program_passes(cell, serve_config, train_config):
    kind, wl = CASES[cell]
    config = serve_config if kind == "serve" else train_config
    ctx = harness.Context(cell, 17, torch.device("cpu"), config, wl,
                          Tracer(False, harness.OUT_DIR))
    d = harness.load_module(harness.BENCH_DIR / "drivers" / f"{wl['driver']}.py").Driver(ctx)
    d.setup()
    d.run_window(0.3 if kind == "serve" else 0.0)
    d.release()
    program, control = d.check(), d.control_check()
    assert program["correct"], program["checks"]
    assert not control["correct"], control["checks"]
