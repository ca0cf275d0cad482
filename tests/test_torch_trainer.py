"""The port's trainer on the CPU at a tiny size: the CLI end to end (JSONL
log, checkpoints, samples), its weights file read by the port's WaveVerify
and by the JAX package's load_weights_npz, --resume, a warm start, the
options it does not implement raising, and the configuration's YAML
reader."""

import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from waveverify_tpu.convert import load_weights_npz
from waveverify_tpu.config import TrainConfig as JTrainConfig
from waveverify_tpu.config import load_config as jload_config
from waveverify_tpu.train.watermarking import WatermarkModels as JModels
from waveverify_torch import WaveVerify
from waveverify_torch.config import LossConfig, TrainConfig, load_config
from waveverify_torch.train.__main__ import main
from waveverify_torch.train.checkpoint import load_weights
from waveverify_torch.train.data import SyntheticAudioDataset, prefetch_batches
from waveverify_torch.train.loop import TrainerConfig, train
from waveverify_torch.train.state import create_train_state

torch.set_num_threads(2)

TINY_YAML = """
batch_size: 4
val_batch_size: 2
valid_freq: 2
sample_freq: 2
train_duration: 0.2
val_duration: 0.2
Generator: {dimension: 32, channels_enc: 8, channels_dec: 12, n_residual_enc: 1,
            n_residual_dec: 1, bias: true}
Detector: {dimension: 32, channels_enc: 8, n_residual_enc: 1, output_dim: 8, bias: true}
Locator: {dimension: 32, channels_enc: 8, n_residual_enc: 1, output_dim: 8, bias: true}
Discriminator: {periods: [2], fft_sizes: [256]}
MultiScaleSTFTLoss: {window_lengths: [256]}
MelSpectrogramLoss: {n_mels: [5, 10], window_lengths: [128, 256]}
"""


def _args(tmp_path, *extra):
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(TINY_YAML)
    return ["--config", str(cfg), "--device", "cpu", "--ckpt-dir",
            str(tmp_path / "run"), "--log-every", "1", *extra]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Three steps of the CLI, validating and checkpointing at 2 and 3."""
    tmp = tmp_path_factory.mktemp("cli")
    main(_args(tmp, "--max-steps", "3"))
    return tmp


def _log(run):
    return [json.loads(line) for line in
            (run / "run" / "train_log.jsonl").read_text().splitlines()]


def test_cli_writes_a_finite_jsonl_log(run):
    lines = _log(run)
    train_lines = [r for r in lines if "loss" in r]
    val_lines = [r for r in lines if "val/loss" in r]
    assert [r["step"] for r in train_lines] == [0, 1, 2]
    assert [r["step"] for r in val_lines] == [1, 2]
    for r in lines:
        for k, v in r.items():
            assert np.isfinite(v), (k, v)
    for key in ("stft/loss", "mel/loss", "adv/disc_loss", "grad_norm/generator",
                "train/ber", "time/host_s", "step_time", "bits/acc_min"):
        assert key in train_lines[0], key


@pytest.mark.parametrize("net", ["generator", "detector", "locator",
                                 "discriminator"])
def test_cli_logs_each_networks_gradient(run, net):
    """Every step logs each network's gradient norm, and none is zero: a
    network whose gradient were cut off would still move under weight
    decay alone."""
    norms = [r[f"grad_norm/{net}"] for r in _log(run) if "loss" in r]
    assert len(norms) == 3 and all(n > 0 for n in norms), norms


class _Unreadable:
    """A dataset whose second batch fails, as a folder with a bad file."""

    def __init__(self):
        self.inner, self.calls = SyntheticAudioDataset(0.01, 16000, 0), 0

    def batch(self, n):
        self.calls += 1
        if self.calls == 2:
            raise OSError("unreadable clip")
        return self.inner.batch(n)


def test_prefetch_raises_the_workers_error():
    """An error while making a batch reaches the consumer instead of
    leaving it waiting on an empty queue."""
    batches = prefetch_batches(_Unreadable(), 2)
    audio, msg = next(batches)
    assert audio.shape == (2, 160) and msg.shape == (2, 16)
    with pytest.raises(OSError, match="unreadable clip"):
        next(batches)


def test_cli_writes_checkpoints_and_samples(run):
    root = run / "run"
    for tag in ("latest", "best"):
        assert (root / tag / "state.pt").exists()
        assert (root / tag / "weights.npz").exists()
    assert json.loads((root / "latest" / "meta.json").read_text())["step"] == 3
    assert sorted(p.name for p in (root / "samples").iterdir()) == ["step_2", "step_3"]
    assert len(list((root / "samples" / "step_3").glob("*.wav"))) == 4


def test_weights_read_by_the_port_and_by_jax(run):
    """The saved npz serves embed+detect in the port, and the JAX package's
    generator on the same file gives the same residual."""
    path = run / "run" / "latest" / "weights.npz"
    wv = WaveVerify(path, device="cpu")
    rng = np.random.RandomState(0)
    audio = (rng.randn(2, 4800) * 0.1).astype(np.float32)
    bits = rng.randint(0, 2, (2, 16)).astype(np.float32)
    wm = wv.embed_batch(audio, bits)
    assert wm.shape == audio.shape and np.isfinite(wm).all()
    params = load_weights_npz(path)
    jcfg = jload_config(run / "tiny.yml")
    jm = JModels.from_config(jcfg)
    res = np.asarray(jax.jit(jm.apply_generator)(params["generator"], audio, bits))
    np.testing.assert_allclose(wm - audio, res, atol=1e-5, rtol=1e-4)


def test_resume_continues_the_step_count(run, tmp_path):
    import shutil

    shutil.copytree(run / "run", tmp_path / "run")
    (tmp_path / "tiny.yml").write_text(TINY_YAML)
    main(_args(tmp_path, "--max-steps", "4", "--resume"))
    steps = [r["step"] for r in _log(tmp_path) if "loss" in r]
    assert steps == [0, 1, 2, 3]
    meta = json.loads((tmp_path / "run" / "latest" / "meta.json").read_text())
    assert meta["step"] == 4


def test_warm_start_loads_the_weights(run, tmp_path):
    cfg = load_config(run / "tiny.yml")
    path = run / "run" / "latest" / "weights.npz"
    state = train(cfg, TrainerConfig(ckpt_dir=str(tmp_path), init_weights=str(path),
                                     device="cpu", dump_samples=False),
                  max_steps=0)
    fresh = create_train_state(cfg, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    load_weights(fresh.models, path)
    for (n, p), q in zip(state.models.generator.named_parameters(),
                         fresh.models.generator.parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("flag", [
    ["--num-devices", "2"], ["--steps-per-dispatch", "4"], ["--split-disc"],
    ["--init-meta", "meta.json"], ["--reinit-msg-path"], ["--tensorboard", "tb"],
    ["--wandb", "proj"], ["--profile-steps", "1:3"]])
def test_unsupported_flags_raise_naming_themselves(tmp_path, flag):
    with pytest.raises(ValueError, match=flag[0]):
        main(_args(tmp_path, "--max-steps", "1", *flag))


@pytest.mark.parametrize("field,value", [
    ("warmup_steps", 100), ("warmup_ber_gate", 0.2), ("warmup_disc_every", 4),
    ("warmup_alt_period", 50), ("warmup_msg_freeze_gate", 0.1),
    ("warmup_msg_refreeze", True), ("warmup_nbits_start", 4),
    ("warmup_fx_gate", 0.3), ("warmup_init_scale", 0.1)])
def test_unsupported_warmup_knobs_raise(tmp_path, field, value):
    cfg = TrainConfig(loss=LossConfig(**{field: value}))
    with pytest.raises(ValueError, match=field):
        train(cfg, TrainerConfig(ckpt_dir=str(tmp_path), device="cpu"), max_steps=1)


def test_cuda_default_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(TrainConfig(), TrainerConfig(ckpt_dir=str(tmp_path)), max_steps=1)


def test_load_config_equals_defaults_and_jax():
    assert load_config("conf/base.yml") == TrainConfig()
    ours = load_config("conf/base.yml", {"AdamW.lr": 3e-4, "batch_size": 8,
                                         "lambdas": {"dec/loss_clean": 2.0},
                                         "warmup.steps": 7})
    ref = jload_config("conf/base.yml", {"AdamW.lr": 3e-4, "batch_size": 8,
                                          "lambdas": {"dec/loss_clean": 2.0},
                                          "warmup.steps": 7})
    import dataclasses

    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())


def test_config_needs_no_yaml_unless_a_file_is_read():
    program = ("import sys; sys.modules['yaml'] = None\n"
               "from waveverify_torch.config import TrainConfig, load_config\n"
               "assert load_config(None, {'batch_size': 2}).batch_size == 2\n"
               "try:\n    load_config('conf/base.yml')\n"
               "except ImportError as e:\n    print('OK', e)\n")
    out = subprocess.run([sys.executable, "-c", program], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK") and "PyYAML" in out.stdout


def test_resume_refuses_an_orbax_checkpoint(tmp_path):
    (tmp_path / "run" / "latest" / "state").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        main(_args(tmp_path, "--max-steps", "1", "--resume"))
