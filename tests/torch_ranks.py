"""Shared pieces of the port's multi-process tests (numpy and torch only,
so that a rank never imports JAX): the tiny configuration, a launcher of
N ranks as subprocesses over gloo, and the training cases the 2-rank step
test runs in each rank and, on the global batch, in one process."""

import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from waveverify_torch import config as tcfg
from waveverify_torch.parallel.mesh import free_port

REPO_ROOT = str(Path(__file__).resolve().parent.parent)
# the longest a multi-process test waits for its ranks before killing them
RANK_TIMEOUT = 240

SMALL = dict(dimension=32, channels_enc=8, kernel_size=5, last_kernel_size=5,
             residual_kernel_size=5, dilation_base=1, skip="identity",
             causal=True, encoder_l2norm=True, bias=True,
             spec_compression="log", zero_init=False)
SECTIONS = dict(
    generator=("GeneratorConfig", dict(channels_dec=12, n_residual_enc=1,
                                       n_residual_dec=1, **SMALL)),
    detector=("DetectorConfig", dict(n_residual_enc=1, output_dim=8, **SMALL)),
    locator=("LocatorConfig", dict(n_residual_enc=1, output_dim=8, **SMALL)),
    discriminator=("DiscriminatorConfig", dict(periods=(2,), fft_sizes=(256,))),
    loss=("LossConfig", dict(stft_window_lengths=(256,), mel_n_mels=(5, 10),
                             mel_window_lengths=(128, 256))),
)
# the tiny configuration as a YAML of conf/base.yml's schema, for the CLI
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

# a rank's preamble: argv is (rank, world size, port, output directory)
PREAMBLE = """
import sys
import torch
torch.set_num_threads(2)
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from waveverify_torch import parallel
parallel.initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
"""


def tiny_config(batch_size: int = 4, **top) -> tcfg.TrainConfig:
    """The port's TrainConfig of the tiny configuration
    (``tests/torch_jax_bridge.py`` builds the same one in both packages)."""
    sections = {k: getattr(tcfg, cls)(**kw) for k, (cls, kw) in SECTIONS.items()}
    return tcfg.TrainConfig(batch_size=batch_size, **sections, **top)


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)


def run_ranks(script: str, tmp_path, n: int = 2, timeout: float = RANK_TIMEOUT):
    """Run ``PREAMBLE + script`` as ``n`` ranks over gloo; kill every rank
    (and what it started) when one fails or the time runs out. Returns
    the output directory, where each rank leaves what it wrote."""
    path = Path(tmp_path) / "rank.py"
    path.write_text(PREAMBLE + script)
    out = Path(tmp_path) / "out"
    out.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    port = str(free_port())
    logs = [open(out / f"rank{r}.log", "w") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, str(path), str(r), str(n), port,
                               str(out)], stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env, cwd=REPO_ROOT, start_new_session=True)
             for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.1)
    finally:
        _kill(procs)
        for f in logs:
            f.close()
    for p in procs:
        p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(
        f"rank {r} exit {code}:\n{(out / f'rank{r}.log').read_text()[-3000:]}"
        for r, code in bad)
    return out


def run_cli(argv, cwd, timeout: float = RANK_TIMEOUT):
    """``python -m waveverify_torch.train *argv`` in a session of its own,
    killed with every rank it starts when the time runs out; returns the
    CompletedProcess-like (returncode, output)."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    proc = subprocess.Popen([sys.executable, "-m", "waveverify_torch.train", *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            env=env, cwd=cwd, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        _kill([proc])
    return proc.returncode, out


# -- the 2-rank step cases ------------------------------------------------------

B, T = 4, 3200
BANK = [("identity", {}), ("highpass_filter", {"cutoff_freq": 500}),
        ("random_noise", {"noise_std": 0.001}), ("speed", {"speed": 0.8})]
CASES = ("monolithic", "split", "k2")
SEED = 5


def case_config(remat: bool = True):
    """The tiny configuration at the global batch, with the decoding-bits
    loss on (a ratio of sums over the batch) and 0.02 s localization
    segments, so that each clip has 2 of its 10 segments modified (at
    0.1 s none is) and the cross substitution takes donors across the
    ranks' rows."""
    cfg = tiny_config(B, remat=remat, window_duration=0.02)
    return dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss,
                                                             lambda_dec_bits=1.0))


def case_inputs(step: int):
    """Step ``step``'s global batch: audio, msg, effect indices."""
    rng = np.random.RandomState(step)
    audio = (rng.randn(B, T) * 0.1).astype(np.float32)
    msg = rng.randint(0, 2, (B, 16)).astype(np.float32)
    idx = (np.arange(B) + step) % len(BANK)
    return audio, msg, idx.astype(np.int32)


def run_case(case: str, lo: int = 0, hi: int = B, audio_scale: float = 1.0):
    """Two steps of ``case`` (the monolithic step, the split step, or one
    dispatch of K = 2) from seed 0's state on rows ``[lo, hi)`` of the
    global batches, with the global batch's draws cut to those rows; the
    audio times ``audio_scale`` (1 +- 1e-7 measures the step's own spread).
    Returns (per-step metrics, parameters, optimizer moments, per-step
    gradients), on the CPU, as numpy; a step's gradients are those each
    optimizer steps on (after the all-reduce, the clip and the gates),
    taken just before its ``step()``."""
    from waveverify_torch.effects.effects import EffectBank
    from waveverify_torch.train.loop import step_generator
    from waveverify_torch.train.state import create_train_state
    from waveverify_torch.train.step import disc_step, train_step, train_steps
    from waveverify_torch.train.watermarking import draw

    cfg = case_config(remat=case == "monolithic")
    bank = EffectBank(BANK)
    state = create_train_state(cfg, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    batches = []
    for step in range(2):
        audio, msg, idx = case_inputs(step)
        d = draw(step_generator(SEED, step), B, T, bank.draw_specs(idx),
                 window_duration=cfg.window_duration)
        if (lo, hi) != (0, B):
            d = d.rows(lo, hi)
        audio = (audio * np.float32(audio_scale)).astype(np.float32)
        batches.append((torch.from_numpy(audio[lo:hi]), torch.from_numpy(msg[lo:hi]),
                        idx[lo:hi], d))
    names = {id(p): n for n, p in state.models.named_parameters()}
    grads = [{}, {}]

    def keeper():
        calls = []

        def keep(opt, args, kwargs):
            grads[len(calls)].update(
                {names[id(p)]: p.grad.detach().numpy().copy()
                 for group in opt.param_groups for p in group["params"]
                 if p.grad is not None})
            calls.append(1)
        return keep

    for opt in (state.wm_opt, state.disc_opt):
        opt.register_step_pre_hook(keeper())
    metrics = []
    if case == "k2":
        m = train_steps(state, cfg, bank, torch.stack([b[0] for b in batches]),
                        torch.stack([b[1] for b in batches]),
                        [b[2] for b in batches], [b[3] for b in batches])
        metrics = [{k: v[j] for k, v in m.items()} for j in range(2)]
    for a, m, i, d in ([] if case == "k2" else batches):
        dm = disc_step(state, cfg, a, m, d) if case == "split" else {}
        tm = train_step(state, cfg, bank, a, m, i, d,
                        update_disc=case != "split")
        metrics.append({**tm, **dm})
    params = {n: p.detach().numpy().copy()
              for n, p in state.models.named_parameters()}
    moments = {}
    for opt in (state.wm_opt, state.disc_opt):
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p, {})
                name = names[id(p)]
                for k in ("exp_avg", "exp_avg_sq"):
                    if k in st:
                        moments[f"{name}/{k}"] = st[k].numpy().copy()
    metrics = [{k: v.detach().numpy().copy() for k, v in m.items()} for m in metrics]
    return metrics, params, moments, grads
