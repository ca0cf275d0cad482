"""The port stands alone: it imports neither JAX nor the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "waveverify_tpu")


def _port_sources():
    return sorted((REPO / "waveverify_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_no_forbidden_imports_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


_PROGRAM = r"""
import sys
for name in ("jax", "flax", "jaxlib"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
import waveverify_torch
import waveverify_torch.eval
import waveverify_torch.quality
from waveverify_torch.config import (DetectorConfig, GeneratorConfig,
                                     LocatorConfig, TrainConfig)
from waveverify_torch.effects.effects import AudioEffects
from waveverify_torch.metrics import ber, miou
from waveverify_torch.models import WatermarkModels
from waveverify_torch.serve import embed_detect, locate_probs
from waveverify_torch.train.data import SyntheticAudioDataset

small = dict(dimension=32, channels_enc=8, kernel_size=5, last_kernel_size=5,
             residual_kernel_size=5, dilation_base=1, skip="identity",
             causal=True, encoder_l2norm=True, bias=True,
             spec_compression="log", zero_init=False, n_residual_enc=1)
cfg = TrainConfig(generator=GeneratorConfig(channels_dec=12, n_residual_dec=1, **small),
                  detector=DetectorConfig(output_dim=8, **small),
                  locator=LocatorConfig(output_dim=8, **small))
models = WatermarkModels(cfg)
gen = torch.Generator().manual_seed(0)
with torch.no_grad():
    for p in models.parameters():
        p.copy_(torch.rand(p.shape, generator=gen) * 0.2 + 0.1)
rng = np.random.RandomState(0)
audio = torch.from_numpy((rng.randn(2, 960) * 0.1).astype(np.float32))
msg = torch.from_numpy(rng.randint(0, 2, (2, 16)).astype(np.float32))
w, p = embed_detect(models, audio, msg)
assert w.shape == (2, 960) and p.shape == (2, 16)
assert bool(torch.isfinite(w).all()) and bool(torch.isfinite(p).all())
loc = locate_probs(models, audio)
assert loc.shape == (2, 960) and bool(torch.isfinite(loc).all())
clip = torch.from_numpy(SyntheticAudioDataset(0.06, 16000, 0).batch(2))
for name, kw in waveverify_torch.eval.EVAL_SINGLE:
    y, _ = getattr(AudioEffects, name)(clip, None, None, **kw)
    assert y.shape == clip.shape and bool(torch.isfinite(y).all()), name
with torch.no_grad():
    logits = models.apply_detector(w)
assert 0.0 <= float(ber(logits, msg)) <= 1.0
assert 0.0 <= float(miou(loc, torch.ones_like(loc))) <= 1.0
# training: one step of the tiny config, imports and all
import waveverify_torch.losses
import waveverify_torch.train.__main__
import waveverify_torch.train.checkpoint
import waveverify_torch.train.loop
from waveverify_torch.config import DiscriminatorConfig, LossConfig
from waveverify_torch.effects.effects import DEFAULT_TRAIN_EFFECTS, EffectBank
from waveverify_torch.train.state import create_train_state
from waveverify_torch.train.step import train_step
from waveverify_torch.train.watermarking import draw
import dataclasses
tcfg = dataclasses.replace(
    cfg, discriminator=DiscriminatorConfig(periods=(2,), fft_sizes=(256,)),
    loss=LossConfig(stft_window_lengths=(256,), mel_n_mels=(5,),
                    mel_window_lengths=(128,)))
state = create_train_state(tcfg, torch.Generator().manual_seed(0), torch.device("cpu"))
bank = EffectBank(DEFAULT_TRAIN_EFFECTS)
d = draw(torch.Generator().manual_seed(1), 2, 960, bank.random_specs)
m = train_step(state, tcfg, bank, audio, msg, np.array([0, 8]), d)
assert bool(torch.isfinite(m["loss"])) and state.step == 1
# the rest of the user surface: the converter, the decoders, the examples,
# random init, the whole effect catalog
import waveverify_torch.api.codecs
import waveverify_torch.convert
import waveverify_torch.examples.basic_usage
import waveverify_torch.examples.watermark_strategies
import waveverify_torch.examples.web_api_integration
from waveverify_torch.effects.effects import RANDOM_EFFECTS, draw_effect
wv = waveverify_torch.WaveVerify(None, config=cfg, device="cpu")
for name in ("random_equalization", "echo", "white_noise", "pink_noise",
             "amplitude_scaling", "quantization", "sample_suppression", "shush",
             "median_filter", "smooth", "codec_proxy", "encodec"):
    kw = (draw_effect(name, {}, torch.Generator().manual_seed(2), 2, clip.shape[1])
          if name in RANDOM_EFFECTS else {})
    y, _ = getattr(AudioEffects, name)(clip, None, None, **kw)
    assert y.shape == clip.shape and bool(torch.isfinite(y).all()), name
# the trainer's other options (split step, K-step dispatch, the scan bank)
# and the ops utilities
from waveverify_torch.ops import MDCT, PQMF, STDCT, design_prototype_filter
from waveverify_torch.ops.audio_processor import AudioProcessor
from waveverify_torch.train.loop import Tracker, check_finite, dispatch_inputs
from waveverify_torch.train.step import disc_step, train_steps
spec = STDCT(64, 32, np.hanning(64))(clip)
assert spec.shape == (2, 30, 64) and STDCT(64, 32).inverse(spec).shape == (2, 960)
assert MDCT(32).inverse(MDCT(32)(clip)).shape == clip.shape
assert PQMF().synthesis(PQMF().analysis(clip)).shape == clip.shape
assert design_prototype_filter().shape == (63,)
assert AudioProcessor.adjust_audio_length(clip, 1000, "stretch").shape == (2, 1000)
assert AudioProcessor.adjust_mask_length(clip > 0, 500, "nearest-exact").shape == (2, 500)
scan = EffectBank(DEFAULT_TRAIN_EFFECTS, dispatch="scan")
idxs = [np.array([0, 8]), np.array([8, 1])]
ds = [draw(torch.Generator().manual_seed(3 + j), 2, 960, scan.draw_specs(i),
           per_sample=True) for j, i in enumerate(idxs)]
dm = disc_step(state, tcfg, audio, msg, ds[0])
ms = train_steps(state, tcfg, scan, torch.stack([audio, audio]),
                 torch.stack([msg, msg]), idxs, ds, train_disc=[True, False])
assert ms["loss"].shape == (2,) and bool(torch.isfinite(ms["loss"]).all())
check_finite(ms, 1)
assert state.step == 3 and float(ms["adv/disc_loss"][1]) == 0.0
# the native ingest, and the option variants of tests/variants.py
import waveverify_torch.native
from tests import variants
from waveverify_torch.modules.conv import init_params
assert waveverify_torch.native.get_wavio() is not None
for name in variants.VARIANTS:
    vm = WatermarkModels(variants.apply(cfg, name))
    init_params(vm, torch.Generator().manual_seed(0))
    w, p = embed_detect(vm, audio, msg)
    loc = locate_probs(vm, audio)
    for out in (w, p, loc):
        assert bool(torch.isfinite(out).all()), name
# data parallelism: one process is a no-op
import waveverify_torch.parallel
from waveverify_torch.parallel import initialize_distributed, is_active, make_mesh
initialize_distributed()
assert not is_active() and make_mesh(device="cpu").size == 1
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "waveverify_tpu")
          and sys.modules[m] is not None]
assert not loaded, loaded
print("OK")
"""


def test_port_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
