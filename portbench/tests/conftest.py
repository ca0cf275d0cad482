"""Shared pieces of the benchmark's tests: the benchmark's folder on the
import path, and small configurations of both kinds that run on the CPU in
seconds (the published ones are for the card)."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = dict(dimension=16, channels_enc=8, n_fft_base=16, n_residual_enc=1,
             strides=[4, 2], kernel_size=5, last_kernel_size=5, residual_kernel_size=5)


def small_model(carrier: bool = False) -> dict:
    """Generator, detector and locator sections at small widths, from the
    training configuration's (all other options as published)."""
    full = json.loads((BENCH / "configs" / "waveverify_base_train.json").read_text())["model"]
    m = copy.deepcopy(full)
    m["Generator"].update(SMALL, channels_dec=8, n_residual_dec=1, embedding_dim=16)
    if carrier:
        m["Generator"].update(msg_mode="carrier", film_carrier_gain=0.5,
                              latent_carrier_gain=0.2, film_gamma_bias=1.0)
    m["Detector"].update(SMALL, output_dim=8)
    m["Locator"].update(SMALL, dimension=8, output_dim=8)
    m["Discriminator"].update(periods=[2, 3], fft_sizes=[256])
    return m


@pytest.fixture
def serve_config(tmp_path):
    """A serving configuration at small widths, with weights drawn from a
    seed and written as a ``save_weights_npz`` file."""
    import torch

    from pbcore import inputs
    from reference import nets

    model = small_model(carrier=True)
    del model["Discriminator"]
    flat = inputs.make_params(nets.param_spec(model), 7, torch.device("cpu"),
                              model["Generator"]["film_gamma_bias"])
    path = tmp_path / "small.npz"
    np.savez(path, **{k: v.numpy().astype(np.float16) for k, v in flat.items()},
             __config__=np.frombuffer(json.dumps(model).encode(), np.uint8))
    return {"model": model, "weights": str(path), "serve_dtype": "float32",
            "precision": "highest"}


@pytest.fixture
def train_config():
    """The training configuration at small widths, batch 4 x 0.2 s, short
    spectral losses."""
    c = json.loads((BENCH / "configs" / "waveverify_base_train.json").read_text())
    c["model"] = small_model()
    c["batch_size"] = 4
    c["train_duration"] = 0.2
    c["loss"].update(stft_window_lengths=[256, 64], mel_n_mels=[5, 10],
                     mel_window_lengths=[64, 128])
    return c


def bench_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
