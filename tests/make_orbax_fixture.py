"""Regenerate ``tests/fixtures/orbax_tiny_run/``: a run directory of the JAX
trainer after one step, whose ``latest/`` the port must serve and resume.

The configuration is ``config.yml`` beside it (written here): the tiny
widths of ``tests/torch_ranks.py`` with the latent ``dimension`` halved to
16 (at 32 the directory took 12.36 MB, over its 12 MB budget), the
discriminator cut to the MRD at
``fft_sizes (256,)`` (``periods: []``: the MPD alone would hold 8.69 M
parameters), and the r5 recipe's learning-rate multipliers
(``scripts/train_demo_r5.sh``: ``detector_lr_mult 10``,
``generator_lr_mult 2``), so that the watermarking optimizer's state is
the ``optax.multi_transform`` tree, with non-zero moments after the step.
The step is the JAX loop's: the shipped effects bank, indices chosen by
the effect scheduler, which is fed the step's per-sample metrics; the tag
is written by the JAX package's ``save_checkpoint`` with the host state
the loop writes.

Run from the repository root (it imports JAX; pytest does not collect it)::

    python tests/make_orbax_fixture.py
"""

import shutil
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from waveverify_tpu.config import load_config, model_config_dict  # noqa: E402
from waveverify_tpu.effects.effects import EffectBank  # noqa: E402
from waveverify_tpu.effects.effects_config import load_effects_config  # noqa: E402
from waveverify_tpu.effects.scheduler import EffectScheduler  # noqa: E402
from waveverify_tpu.train.checkpoint import save_checkpoint  # noqa: E402
from waveverify_tpu.train.state import create_train_state  # noqa: E402
from waveverify_tpu.train.step import make_train_step  # noqa: E402
from waveverify_tpu.train.watermarking import WatermarkModels  # noqa: E402

OUT = REPO / "tests" / "fixtures" / "orbax_tiny_run"
CONFIG_YAML = """\
batch_size: 4
val_batch_size: 2
valid_freq: 2
sample_freq: 2
train_duration: 0.2
val_duration: 0.2
Generator: {dimension: 16, channels_enc: 8, channels_dec: 12, n_residual_enc: 1,
            n_residual_dec: 1, bias: true}
Detector: {dimension: 16, channels_enc: 8, n_residual_enc: 1, output_dim: 8, bias: true}
Locator: {dimension: 16, channels_enc: 8, n_residual_enc: 1, output_dim: 8, bias: true}
Discriminator: {periods: [], fft_sizes: [256]}
MultiScaleSTFTLoss: {window_lengths: [256]}
MelSpectrogramLoss: {n_mels: [5, 10], window_lengths: [128, 256]}
AdamW: {detector_lr_mult: 10.0, generator_lr_mult: 2.0}
"""


def main() -> None:
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    (OUT / "config.yml").write_text(CONFIG_YAML)
    cfg = load_config(str(OUT / "config.yml"))
    fx = load_effects_config(str(REPO / "conf" / "effects_config.yml"))
    models = WatermarkModels.from_config(cfg)
    bank = EffectBank(fx.train_effects, cfg.generator.sample_rate)
    scheduler = EffectScheduler(effect_params=fx.effect_param_grid, beta=fx.beta,
                                ber_threshold=fx.ber_threshold,
                                miou_threshold=fx.miou_threshold,
                                rng=np.random.RandomState(cfg.seed + 1))
    state = create_train_state(cfg, jax.random.PRNGKey(cfg.seed), models)
    rng = np.random.RandomState(cfg.seed)
    t = int(cfg.train_duration * cfg.generator.sample_rate)
    audio = (rng.randn(cfg.batch_size, t) * 0.1).astype(np.float32)
    msg = rng.randint(0, 2, (cfg.batch_size, cfg.generator.msg_dimension)
                      ).astype(np.float32)
    idx, selections = scheduler.select_bank_indices(cfg.batch_size, bank.specs)
    step = jax.jit(make_train_step(models, cfg, bank))
    state, metrics = step(state, audio, msg, idx, jax.random.PRNGKey(cfg.seed))
    for (name, params), ber, miou in zip(selections,
                                         np.asarray(metrics["per_sample_ber"]),
                                         np.asarray(metrics["per_sample_miou"])):
        scheduler.update_effect_metrics(name, params, float(np.clip(ber, 0, 1)),
                                        float(np.clip(miou, 0, 1)))
    host_state = {"step": int(state.step), "nbits_state": None,
                  "scheduler_state": scheduler.state_dict(),
                  "best_val_loss": float("inf"),
                  "model_config": model_config_dict(cfg)}
    save_checkpoint(str(OUT), "latest", state, host_state)
    size = sum(f.stat().st_size for f in OUT.rglob("*") if f.is_file())
    print(f"wrote {OUT} ({size} bytes) at step {int(state.step)}, "
          f"loss {float(metrics['loss']):.6f}")


if __name__ == "__main__":
    main()
