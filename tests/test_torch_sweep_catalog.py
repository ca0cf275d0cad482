"""The sweep over the whole effect catalog, and the sweep CLI without a
checkpoint, on the CPU at the small config of ``tests/test_torch_eval.py``.

``run_sweep`` takes every catalog effect as a row (random ones drawn on a
CPU generator from ``seed``). Its rows without randomness are held to the
JAX package's ``run_sweep`` as ``PERF.md`` §2 holds the sweep: confidence
and MIoU within 1e-3, BER within 2 of 256 bits (the random-init locator's
logits cross zero often, so a decision may flip); random rows to the ranges
of their metrics (the card-vs-CPU check of ``chip_smoke.py`` holds them to
the same draws). JAX's own ``encodec`` is not run: it would try to fetch
weights; the port's falls back to the codec proxy."""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_eval import pair  # noqa: F401 - the shared fixture
from tests.test_torch_trainer import TINY_YAML
from waveverify_tpu.eval import run_sweep as j_run_sweep
from waveverify_torch.effects.effects import RANDOM_EFFECTS, AudioEffects
from waveverify_torch.eval import _effect_tag, main, run_sweep

torch.set_num_threads(2)

# one row per catalog effect, at the JAX defaults (the host codecs are the
# sweep's codec rows)
CATALOG = ["identity", "highpass_filter", "lowpass_filter", "bandpass_filter",
           "random_equalization", "speed", "resample", "echo", "time_shift",
           "random_noise", "white_noise", "pink_noise", "amplitude_scaling",
           "quantization", "sample_suppression", "shush", "median_filter",
           "smooth", "codec_proxy", "encodec"]
ROWS = [[(name, {})] for name in CATALOG] + [
    [("median_filter", {"kernel_size": 4})],
    [("amplitude_scaling", {"scale": 0.5}), ("quantization", {"bit_depth": 6})]]
# the new rows without randomness, which JAX runs here (the others are
# held to JAX in test_torch_eval.py)
NEW = {"amplitude_scaling", "quantization", "shush", "median_filter", "smooth",
       "codec_proxy"}
JAX_ROWS = [r for r in ROWS if all(n in NEW for n, _ in r)]
LIMITS = {"confidence": 1e-3, "miou": 1e-3, "ber": 2 / 256, "ber_full": 2 / 256}


@pytest.fixture(scope="module")
def sweeps(pair):  # noqa: F811
    jw, tw, _ = pair
    audio = np.random.RandomState(1).randn(4, 4800).astype(np.float32) * 0.1
    ours = run_sweep(tw, audio, seed=3, effects=ROWS, include_codecs=False)
    ref = j_run_sweep(jw, audio, seed=3, effects=JAX_ROWS, include_codecs=False)
    return ours, ref


def test_every_catalog_effect_is_a_sweep_row(sweeps):
    ours, _ = sweeps
    assert set(ours) == {"_quality"} | {_effect_tag(r) for r in ROWS}
    for tag, res in ours.items():
        if tag == "_quality":
            continue
        for k, v in res.items():
            vals = v if isinstance(v, list) else [v]
            assert all(0.0 <= x <= 1.0 for x in vals), (tag, k, v)
    assert AudioEffects.encodec_last_was_proxy is True


@pytest.mark.parametrize("chain", JAX_ROWS, ids=_effect_tag)
def test_deterministic_catalog_row_matches_jax(sweeps, chain):
    ours, ref = sweeps
    tag = _effect_tag(chain)
    for key, lim in LIMITS.items():
        assert abs(ours[tag][key] - ref[tag][key]) <= lim, (
            tag, key, ours[tag][key], ref[tag][key])


def test_random_rows_follow_the_seed(pair):  # noqa: F811
    _, tw, _ = pair
    audio = np.random.RandomState(2).randn(2, 4800).astype(np.float32) * 0.1
    rows = [[(n, {})] for n in RANDOM_EFFECTS]
    a, b = (run_sweep(tw, audio, seed=5, effects=rows, include_codecs=False)
            for _ in range(2))
    assert a == b


def test_cli_runs_with_a_config_and_no_checkpoint(tmp_path, caplog):
    yml = tmp_path / "tiny.yml"
    yml.write_text(TINY_YAML)
    out = tmp_path / "sweep.json"
    main(["--config", str(yml), "--device", "cpu", "--batch", "2",
          "--duration", "0.5", "--json-out", str(out)])
    assert any("randomly initialized" in r.getMessage() for r in caplog.records)
    res = json.loads(out.read_text())
    assert res["_meta"]["checkpoint"] is None and res["_meta"]["batch"] == 2
    assert "identity" in res and np.isfinite(res["identity"]["ber"])
