"""The comparison that decides ``correct`` fails a broken program: each cell
runs end to end on the CPU at a small size (the look for a card skipped),
once sound and once with a fault planted in the port underneath, for each
fault the cell can have. The exchange between cards is no fault of these
one-card cells."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import bench_spec
from pbcore import faults, harness

SERVE_BATCH = {"driver": "serve_batch", "batch": 2, "clip_s": 0.25, "pool": 2}
TRAIN = {"driver": "train_step", "checked_steps": 3, "window_check_step": 1}


def _run(cell, config, workload, seconds=0.5):
    return harness.run_cell(bench_spec(), cell, 5, seconds, False, torch.device("cpu"),
                            time.perf_counter(), config=config, workload=workload)


@pytest.mark.parametrize("fault", [None, *faults.SERVE])
def test_serve_batch(fault, serve_config, monkeypatch):
    if fault:
        faults.SERVE[fault](monkeypatch)
    r = _run("serve.embed_detect.b64", serve_config, SERVE_BATCH)
    assert r["correct"] is (fault is None), r["checks"]
    assert r["attempted"] > 0


@pytest.mark.parametrize("fault", [None, *faults.TRAIN])
def test_train_step(fault, train_config, monkeypatch):
    if fault:
        faults.TRAIN[fault](monkeypatch)
    r = _run("train.step.b32", train_config, TRAIN, seconds=0.0)
    assert r["correct"] is (fault is None), r["checks"]
