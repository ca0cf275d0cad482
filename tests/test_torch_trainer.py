"""The port's trainer on the CPU at a tiny size: the CLI end to end (JSONL
log, checkpoints, samples), its weights file read by the port's WaveVerify
and by the JAX package's load_weights_npz, --resume, a warm start, the
training controllers under the r5 recipe's knobs (their log keys, their
states in the checkpoint meta, read by the JAX package's classes), the
r5 snapshot's restore by --init-meta, --reinit-msg-path, the JAX
trainer's other options (--split-disc, --steps-per-dispatch,
--effect-dispatch, --profile-steps, --tensorboard, --wandb,
--debug-nans), the one option it does not implement raising, and the
configuration's YAML reader."""

import json
import logging
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from waveverify_tpu.convert import load_weights_npz
from waveverify_tpu.effects.effects_config import load_effects_config as jload_effects
from waveverify_tpu.effects.scheduler import EffectScheduler as JScheduler
from waveverify_tpu.train.loop import BerGatedRamp as JRamp
from waveverify_tpu.train.loop import NbitsCurriculum as JCurriculum
from waveverify_tpu.config import TrainConfig as JTrainConfig
from waveverify_tpu.config import load_config as jload_config
from waveverify_tpu.train.watermarking import WatermarkModels as JModels
from tests.torch_ranks import TINY_YAML
from waveverify_torch import WaveVerify
from waveverify_torch.config import TrainConfig, load_config
from waveverify_torch.train.__main__ import main
from waveverify_torch.train.checkpoint import load_weights, save_weights
from waveverify_torch.train.data import SyntheticAudioDataset, prefetch_batches
from waveverify_torch.train.loop import TrainerConfig, train
from waveverify_torch.train.state import create_train_state
from waveverify_torch.weights import export_params, read_npz

torch.set_num_threads(2)



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


def test_cli_takes_every_jax_flag():
    """Every flag of ``python -m waveverify_tpu.train`` is a flag of the
    port's CLI, but ``--platform`` and ``--pallas`` (``--device`` takes
    their place)."""
    import re
    from pathlib import Path

    def flags(path):
        return set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', Path(path).read_text()))

    jax_flags = flags("waveverify_tpu/train/__main__.py")
    port_flags = flags("waveverify_torch/train/__main__.py")
    assert "--debug-nans" in jax_flags and "--device" in port_flags
    assert jax_flags - port_flags == {"--platform", "--pallas"}


@pytest.mark.parametrize("flag", [["--num-devices", "2"]])
def test_unsupported_flags_raise_naming_themselves(tmp_path, flag, monkeypatch):
    """``--num-devices`` is ported; what it refuses is more ranks than
    cards on ``cuda`` (one card per rank under NCCL), naming the flag and
    both counts, before it starts any rank."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=rf"{flag[0]} 2: 2 ranks need 2 CUDA "
                       r"devices, 1 visible"):
        main(_args(tmp_path, "--max-steps", "1", *flag, "--device", "cuda"))


def test_split_disc_trains_as_the_monolithic_step(run, tmp_path):
    """--split-disc: the discriminator's own step first, then the
    generator's; the same training as the monolithic step, so its log
    equals the ``run`` fixture's at the same steps."""
    main(_args(tmp_path, "--max-steps", "2", "--split-disc", "--no-samples"))
    split = [r for r in _log(tmp_path) if "loss" in r]
    mono = [r for r in _log(run) if "loss" in r][:2]
    assert [r["step"] for r in split] == [0, 1]
    for a, b in zip(split, mono):
        for k in ("loss", "adv/disc_loss", "grad_norm/discriminator",
                  "grad_norm/generator", "dec/loss", "train/ber"):
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-7), (a["step"], k)
        assert a["adv/disc_loss"] > 0


def test_steps_per_dispatch_logs_and_overshoots(tmp_path):
    """--steps-per-dispatch 2 --max-steps 3: two dispatches (steps 0-1 and
    2-3; the run ends at the first multiple of 2 past 3, as the JAX loop's
    ``while step < total``), a log line at each dispatch's last step,
    validation and samples at the dispatch boundaries, the meta at 4."""
    main(_args(tmp_path, "--max-steps", "3", "--steps-per-dispatch", "2"))
    lines = _log(tmp_path)
    train_lines = [r for r in lines if "loss" in r]
    assert [r["step"] for r in train_lines] == [1, 3]
    assert [r["step"] for r in lines if "val/loss" in r] == [1, 3]
    for r in lines:
        assert all(np.isfinite(v) for v in r.values()), r
    for key in ("adv/disc_loss", "grad_norm/generator", "time/host_s",
                "step_time", "bits/acc_min"):
        assert key in train_lines[0], key
    root = tmp_path / "run"
    assert json.loads((root / "latest" / "meta.json").read_text())["step"] == 4
    assert sorted(p.name for p in (root / "samples").iterdir()) == ["step_2", "step_4"]


def test_split_disc_refuses_steps_per_dispatch(tmp_path):
    with pytest.raises(ValueError, match="split_disc_step requires steps_per_dispatch=1"):
        main(_args(tmp_path, "--max-steps", "2", "--split-disc",
                   "--steps-per-dispatch", "2"))


def test_effect_dispatch_scan_trains(tmp_path):
    """--effect-dispatch scan draws per sample; the run logs finite values,
    and any other mode is refused by the parser."""
    main(_args(tmp_path, "--max-steps", "2", "--effect-dispatch", "scan",
               "--no-samples"))
    lines = [r for r in _log(tmp_path) if "loss" in r]
    assert [r["step"] for r in lines] == [0, 1]
    assert all(np.isfinite(v) for r in lines for v in r.values())
    with pytest.raises(SystemExit):
        main(_args(tmp_path, "--effect-dispatch", "switch"))


def test_match_reference_effect_cap_reaches_the_scheduler(tmp_path, monkeypatch):
    """``TrainerConfig.match_reference_effect_cap`` (a config field, no flag,
    as in the JAX package) is what the loop asks the scheduler for."""
    from waveverify_torch.effects.scheduler import EffectScheduler

    seen = []
    select = EffectScheduler.select_bank_indices

    def spy(self, n, specs, match_reference_cap=False):
        seen.append(match_reference_cap)
        return select(self, n, specs, match_reference_cap=match_reference_cap)

    monkeypatch.setattr(EffectScheduler, "select_bank_indices", spy)
    (tmp_path / "tiny.yml").write_text(TINY_YAML)
    cfg = load_config(tmp_path / "tiny.yml")
    for cap in (False, True):
        train(cfg, TrainerConfig(ckpt_dir=str(tmp_path / f"cap{cap}"), device="cpu",
                                 dump_samples=False, match_reference_effect_cap=cap),
              max_steps=1)
    assert seen == [False, True]


@pytest.fixture(scope="module")
def mirrored(tmp_path_factory):
    """Three steps with --profile-steps 1:2, --tensorboard and --wandb, with
    wandb made unimportable (it is not installed here; this keeps a machine
    that has it from reaching the network); the trainer's warnings kept."""
    tmp = tmp_path_factory.mktemp("mirrored")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("waveverify_torch.train.loop")
    logger.addHandler(handler)
    saved = sys.modules.get("wandb")
    sys.modules["wandb"] = None
    try:
        main(_args(tmp, "--max-steps", "3", "--profile-steps", "1:2",
                   "--tensorboard", str(tmp / "tb"), "--wandb", "proj",
                   "--no-samples"))
    finally:
        logger.removeHandler(handler)
        if saved is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved
    return tmp, [r.getMessage() for r in records]


def test_profile_steps_writes_a_trace(mirrored):
    """--profile-steps 1:2: one Chrome trace of step 1 in <ckpt-dir>/profile,
    holding the step's operators (the chain's plain version among them on
    the CPU)."""
    tmp, _ = mirrored
    traces = list((tmp / "run" / "profile").iterdir())
    assert [t.name for t in traces] == ["steps_1_2.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("resblock_chain_ref" in n for n in names)
    assert any(n.startswith("aten::") for n in names)


def test_tensorboard_mirrors_the_log(mirrored):
    """--tensorboard DIR: an events file whose scalars are the JSONL's."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    tmp, _ = mirrored
    acc = EventAccumulator(str(tmp / "tb"))
    acc.Reload()
    assert {"loss", "val/loss", "step_time"} <= set(acc.Tags()["scalars"])
    losses = [(e.step, e.value) for e in acc.Scalars("loss")]
    jsonl = [(r["step"], r["loss"]) for r in _log(tmp) if "loss" in r]
    assert [s for s, _ in losses] == [s for s, _ in jsonl] == [0, 1, 2]
    np.testing.assert_allclose([v for _, v in losses], [v for _, v in jsonl],
                               rtol=1e-6)


def test_wandb_without_the_package_warns_and_logs_jsonl(mirrored):
    """--wandb where wandb does not import: a warning, as the JAX trainer
    gives, and the run goes on with its JSONL (and TensorBoard)."""
    tmp, messages = mirrored
    assert any(m.startswith("wandb unavailable") for m in messages), messages
    assert [r["step"] for r in _log(tmp) if "loss" in r] == [0, 1, 2]


def _nan_on_second_batch(monkeypatch):
    """Synthetic clips whose second batch holds a NaN sample."""
    import waveverify_torch.train.loop as loop

    class NaNClips(SyntheticAudioDataset):
        calls = 0

        def batch(self, n):
            audio = super().batch(n)
            NaNClips.calls += 1
            if NaNClips.calls == 2:
                audio[0, 10] = np.nan
            return audio

    monkeypatch.setattr(loop, "SyntheticAudioDataset", NaNClips)


def test_debug_nans_raises_where_the_plain_run_goes_on(tmp_path, monkeypatch):
    """A NaN in step 1's batch: without --debug-nans the run ends with NaN
    losses logged; with it, the run stops at step 1 with FloatingPointError."""
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    _nan_on_second_batch(monkeypatch)
    main(_args(tmp_path / "a", "--max-steps", "3", "--no-samples"))
    losses = [r["loss"] for r in _log(tmp_path / "a") if "loss" in r]
    assert np.isfinite(losses[0]) and np.isnan(losses[1]) and len(losses) == 3
    _nan_on_second_batch(monkeypatch)
    with pytest.raises(FloatingPointError, match="step 1"):
        main(_args(tmp_path / "b", "--max-steps", "3", "--no-samples",
                   "--debug-nans"))
    assert [r["step"] for r in _log(tmp_path / "b") if "loss" in r] == [0]


R5_META = "weights/snapshots/demo_r5_latest_meta.json"
# the warmup knobs of scripts/train_demo_r5.sh
R5_WARMUP = dict(steps=6000, init_scale=0.01, ber_gate=0.10, fx_gate=0.12,
                 disc_every=4, alt_period=800, alt_gen_frac=0.25,
                 msg_freeze_gate=0.3, msg_refreeze="true", nbits_start=4,
                 nbits_gate=0.02)
R5_SETS = [a for k, v in R5_WARMUP.items() for a in ("--set", f"warmup.{k}={v}")]
RAMP_KEYS = ("ramp/percep_scale", "ramp/ber_ema", "ramp/fx_on", "ramp/msg_on",
             "ramp/gen_on", "ramp/nbits_active", "bits/acc_min_active")


def _jax_controllers(cfg):
    lc = cfg.loss
    ramp = JRamp(lc.warmup_steps, lc.warmup_init_scale, lc.warmup_ber_gate,
                 fx_gate=lc.warmup_fx_gate,
                 msg_freeze_gate=lc.warmup_msg_freeze_gate,
                 msg_refreeze=lc.warmup_msg_refreeze, nbits=16)
    return ramp, JCurriculum(16, lc.warmup_nbits_start, lc.warmup_nbits_gate)


@pytest.fixture(scope="module")
def controlled(tmp_path_factory):
    """Three steps of the CLI from random init under the r5 recipe's
    warmup knobs: every gate closed, 4 bits active."""
    tmp = tmp_path_factory.mktemp("controlled")
    main(_args(tmp, "--max-steps", "3", "--no-samples", *R5_SETS))
    return tmp


def test_controllers_log_the_jax_keys(controlled):
    lines = [r for r in _log(controlled) if "loss" in r]
    assert [r["step"] for r in lines] == [0, 1, 2]
    for r in lines:
        assert all(k in r for k in RAMP_KEYS), sorted(r)
        assert (r["ramp/percep_scale"], r["ramp/fx_on"], r["ramp/msg_on"],
                r["ramp/gen_on"], r["ramp/nbits_active"]) == (0.0, 0.0, 0.0, 0.0, 4.0)
    # the discriminator trains every 4th step while the ramp is closed
    assert [r["adv/disc_loss"] != 0 for r in lines] == [True, False, False]


def test_port_meta_restores_the_jax_controllers(controlled, tmp_path):
    """The port's checkpoint meta holds the controllers under the JAX
    loop's keys: the JAX package's classes load them equal, and --resume
    restores them (the last step's feedback reaches only the scheduler,
    so a one-step resumed run saves the states it restored)."""
    import shutil

    meta = json.loads((controlled / "run" / "latest" / "meta.json").read_text())
    assert meta["ramp_state"]["ema"] != 0.5  # two steps of feedback
    cfg = load_config(controlled / "tiny.yml",
                      {f"warmup.{k}": v for k, v in R5_WARMUP.items()})
    jramp, jcurr = _jax_controllers(cfg)
    jramp.load_state_dict(meta["ramp_state"])
    jcurr.load_state_dict(meta["nbits_state"])
    assert jramp.state_dict() == meta["ramp_state"]
    assert jcurr.state_dict() == meta["nbits_state"]
    jsched = JScheduler(jload_effects().effect_param_grid)
    jsched.load_state_dict(meta["scheduler_state"])
    assert jsched.state_dict() == meta["scheduler_state"]
    # while the attack latch is closed the scheduler saw the identity only
    assert set(meta["scheduler_state"]["effect_metrics_history"]) == {"identity"}
    shutil.copytree(controlled / "run", tmp_path / "run")
    (tmp_path / "tiny.yml").write_text(TINY_YAML)
    main(_args(tmp_path, "--max-steps", "4", "--resume", "--no-samples", *R5_SETS))
    resumed = json.loads((tmp_path / "run" / "latest" / "meta.json").read_text())
    assert resumed["step"] == 4
    assert resumed["ramp_state"] == meta["ramp_state"]
    assert resumed["nbits_state"] == meta["nbits_state"]


def test_init_meta_continues_the_r5_snapshot(run, tmp_path):
    """--init-weights with --init-meta of the r5 snapshot: the run starts
    at its step, 11000, with its ramp (the perceptual scale the JAX run
    logged) and all 16 bits active."""
    (tmp_path / "tiny.yml").write_text(TINY_YAML)
    weights = run / "run" / "latest" / "weights.npz"
    main(_args(tmp_path, "--max-steps", "11002", "--no-samples",
               "--init-weights", str(weights), "--init-meta", R5_META, *R5_SETS))
    lines = [r for r in _log(tmp_path) if "loss" in r]
    assert [r["step"] for r in lines] == [11000, 11001]
    first = lines[0]
    assert first["ramp/percep_scale"] == 0.015357952969989128
    assert first["ramp/nbits_active"] == 16.0
    assert (first["ramp/fx_on"], first["ramp/msg_on"], first["ramp/gen_on"]) == (
        1.0, 1.0, 1.0)
    assert all(r["adv/disc_loss"] != 0 for r in lines)
    meta = json.loads((tmp_path / "run" / "latest" / "meta.json").read_text())
    assert meta["step"] == 11002


def _msg_key(key):
    """JAX's ``_graft_msg`` predicate on a '/'-joined flax path."""
    return any(part.startswith(("msg_", "film_")) for part in key.split("/"))


@pytest.fixture(scope="module")
def shifted_weights(run, tmp_path_factory):
    """A weights file of the tiny networks that differs from the seed-0
    init in every entry."""
    cfg = load_config(run / "tiny.yml")
    state = create_train_state(cfg, torch.Generator().manual_seed(5),
                               torch.device("cpu"))
    with torch.no_grad():
        for p in state.models.parameters():
            p.add_(1.0)
    return save_weights(state.models, tmp_path_factory.mktemp("w") / "w.npz", cfg)


def _flat_params(state):
    out = {}
    for net in ("generator", "detector", "locator"):
        out.update(export_params(getattr(state.models, net), net))
    return out


def test_reinit_msg_path_grafts_what_jax_grafts(run, shifted_weights, tmp_path):
    """--reinit-msg-path replaces exactly the leaves JAX's graft selects
    (any path part starting with msg_ or film_, in all three networks) with
    the fresh init, and keeps the warm start everywhere else."""
    cfg = load_config(run / "tiny.yml")
    state = train(cfg, TrainerConfig(ckpt_dir=str(tmp_path), device="cpu",
                                     init_weights=str(shifted_weights),
                                     reinit_msg_path=True, dump_samples=False),
                  max_steps=0)
    got = _flat_params(state)
    loaded, _ = read_npz(shifted_weights)
    fresh = _flat_params(create_train_state(cfg, torch.Generator().manual_seed(0),
                                            torch.device("cpu")))
    changed = {k for k in got if not np.array_equal(got[k], loaded[k].astype(np.float32))}
    assert changed == {k for k in got if _msg_key(k)}
    assert {k.split("/")[0] for k in changed} >= {"generator"}
    for k in changed:
        np.testing.assert_array_equal(got[k], fresh[k], err_msg=k)


def test_reinit_msg_path_is_skipped_after_resume(run, shifted_weights, tmp_path):
    import shutil

    shutil.copytree(run / "run", tmp_path / "run")
    cfg = load_config(run / "tiny.yml")
    state = train(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "run"), device="cpu",
                                     init_weights=str(shifted_weights),
                                     reinit_msg_path=True, dump_samples=False),
                  max_steps=3, resume=True)
    saved = torch.load(tmp_path / "run" / "latest" / "state.pt",
                       weights_only=True)["models"]
    fresh = create_train_state(cfg, torch.Generator().manual_seed(0),
                               torch.device("cpu")).models.state_dict()
    assert state.step == 3
    msg = [k for k in saved if any(part.startswith(("msg_", "film_"))
                                   for part in k.split("."))]
    # the graft would have put back the fresh init, which three steps moved
    assert any(not torch.equal(saved[k], fresh[k]) for k in msg)
    for k, v in state.models.state_dict().items():
        assert torch.equal(v, saved[k]), k


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


def test_set_values_read_the_same_without_yaml():
    """--set values read the same with PyYAML and without it: one reader
    takes every scalar (the r5 recipe's and the cases where YAML's own
    reading is unlike Python's), and only a list or mapping needs PyYAML,
    raising without it."""
    sets = [f"{k}={v}" for k, v in R5_WARMUP.items()] + [
        "Generator.msg_mode=carrier", "AdamW.lr=2e-4", "sub_hop_jitter=true",
        "lambdas.dec/loss_bits=20000", "Generator.film_carrier_gain=0.5",
        "a=0x10", "b=.inf", "c='0.5'", 'd="x"', "e=tRuE", "f=~", "g=-3"]
    program = ("import sys, json, argparse\n"
               "{block}"
               "from waveverify_torch.train.__main__ import _parse_set\n"
               f"print(json.dumps(_parse_set({sets!r}, argparse.ArgumentParser())))\n"
               "try:\n"
               "    _parse_set(['strides=[2, 4]'], argparse.ArgumentParser())\n"
               "    print('list read')\n"
               "except ImportError:\n"
               "    print('list refused')\n")
    outs = []
    for block in ("", "sys.modules['yaml'] = None\n"):
        out = subprocess.run([sys.executable, "-c", program.format(block=block)],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        outs.append(out.stdout.splitlines())
    assert outs[0][0] == outs[1][0]
    got = json.loads(outs[0][0])
    assert got["msg_refreeze"] is True and got["AdamW.lr"] == 2e-4
    assert [got[k] for k in "abcdefg"] == ["0x10", ".inf", "0.5", "x", True,
                                           None, -3]
    assert (outs[0][1], outs[1][1]) == ("list read", "list refused")
