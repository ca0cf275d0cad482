"""``waveverify_torch.parallel`` on the CPU: two gloo ranks as
subprocesses (``tests/torch_ranks.py``) against the JAX package's
global-batch program, and multi-device serving.

- batch assembly and the gradient all-reduce, the counterpart of
  ``tests/test_multihost.py::test_two_process_batch_assembly_and_allreduce``
  on the same numbers;
- the ratio-of-sums terms: ``train.step.global_decoding_loss_bits``
  (``decoding_loss_bits`` with a presence mask over the global batch),
  its gradient, and the per-bit accuracy and ``train/ber`` of
  ``train.step.feedback``, with the ranks holding different counts of
  valid (watermarked) rows, against ``waveverify_tpu.losses`` and the JAX
  step's expressions on the global batch;
- ``WaveVerify.use_mesh(["cpu", "cpu"])`` against the unsplit call;
- the one-process forms: no-ops, the mesh's errors, ``Draws.rows`` and the
  localization's donors from the global batch;
- the trainer CLI: ``--device cpu --num-devices 2`` on a tiny YAML, and
  ``--num-devices 3`` with ``batch_size`` 4 refused with the JAX
  package's message.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_ranks import TINY_YAML, T, case_config, run_cli, run_ranks, tiny_config
from waveverify_tpu.losses import decoding_loss_bits as jdecoding_loss_bits
from waveverify_tpu.metrics import ber as jber
from waveverify_torch import WaveVerify, parallel
from waveverify_torch.effects.augment import (
    draw_localization,
    localization_augmentation,
    localization_segments,
)
from waveverify_torch.effects.effects import EffectBank
from waveverify_torch.train.__main__ import main
from waveverify_torch.train.watermarking import draw

torch.set_num_threads(2)

RANKS = """
import numpy as np
from waveverify_torch.train.step import feedback, global_decoding_loss_bits
out_file = f"{out}/rank{rank}.npz"
res = {}

# assembly: rank p contributes 4 rows valued p * 4 + [0..3]
local = torch.from_numpy(((np.arange(4)[:, None] + 4.0 * rank)
                          * np.ones((4, 16))).astype(np.float32))
x = parallel.all_gather_rows(local)
res["assembled"] = x.numpy()
res["total"] = float(parallel.global_sum(local.sum()))
w = torch.nn.Parameter(torch.ones(16))
torch.mean((local @ w) ** 2).backward()
parallel.all_reduce_grads([w])
res["grad"] = w.grad.numpy()

# the ratio-of-sums terms, on this rank's rows of the global batch
g = np.load(f"{out}/../global.npz")
per = g["x"].shape[0] // world
rows = slice(rank * per, (rank + 1) * per)
feat = torch.from_numpy(g["x"][rows])
mask = torch.from_numpy(g["mask"][rows])
msg = torch.from_numpy(g["msg"][rows])
bit_mask = torch.from_numpy(g["bit_mask"])
for name, bm, pm in (("plain", None, mask), ("bits", bit_mask, mask),
                     ("clean", bit_mask, None)):
    proj = torch.nn.Parameter(torch.from_numpy(g["proj"]))
    loss = global_decoding_loss_bits(feat @ proj, pm, msg, bit_mask=bm)
    loss.backward()
    parallel.all_reduce_grads([proj])
    res[f"loss_{name}"] = float(parallel.global_mean(loss.detach()))
    res[f"grad_{name}"] = proj.grad.numpy()
with torch.no_grad():
    logits = feat @ torch.from_numpy(g["proj"])
fb = feedback({"detector_logits": logits, "mask": mask,
               "locator_logits": torch.zeros_like(mask)}, msg)
for k in ("per_bit_acc", "train/ber", "per_sample_ber"):
    res[k.replace("/", "_")] = fb[k].numpy()
np.savez(out_file, **res)
"""

# the ratio test's global batch: 6 rows, 3 per rank; rank 0 holds three
# watermarked rows, rank 1 one (its other two rows have no watermarked frame)
NB, NT, NF, NBITS = 6, 24, 5, 16


def _global_batch(path):
    rng = np.random.RandomState(11)
    mask = (rng.rand(NB, NT) > 0.3).astype(np.float32)
    mask[4:] = 0.0
    batch = dict(x=rng.randn(NB, NT, NF).astype(np.float32),
                 proj=(rng.randn(NF, NBITS) * 0.7).astype(np.float32),
                 mask=mask,
                 msg=rng.randint(0, 2, (NB, NBITS)).astype(np.float32),
                 bit_mask=(np.arange(NBITS) < 8).astype(np.float32))
    np.savez(path, **batch)
    return batch


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ratio")
    g = _global_batch(tmp / "global.npz")
    out = run_ranks(RANKS, tmp)
    return g, [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def test_two_rank_batch_assembly_and_allreduce(ranked):
    """Each rank contributes 4 rows; the gathered batch holds all 8, and
    the all-reduced gradient is the global batch's (the numbers of
    ``test_multihost.py``)."""
    full = (np.arange(8)[:, None] * np.ones((8, 16))).astype(np.float32)
    expected = 2.0 * (full * (full @ np.ones(16))[:, None]).mean(axis=0)
    for r in ranked[1]:
        np.testing.assert_array_equal(r["assembled"], full)
        assert float(r["total"]) == float(sum(range(8)) * 16)
        np.testing.assert_allclose(r["grad"], expected, rtol=1e-5)


def _jax_loss(g, name):
    bm = None if name == "plain" else jnp.asarray(g["bit_mask"])
    pm = None if name == "clean" else jnp.asarray(g["mask"])

    def loss(proj):
        return jdecoding_loss_bits(jnp.asarray(g["x"]) @ proj, pm,
                                   jnp.asarray(g["msg"]), bit_mask=bm)

    value, grad = jax.value_and_grad(loss)(jnp.asarray(g["proj"]))
    return float(value), np.asarray(grad)


@pytest.mark.parametrize("name", ["plain", "bits", "clean"])
def test_decoding_loss_bits_is_the_global_batch_loss(ranked, name):
    """The mean over the ranks of the loss, and the all-reduced gradient,
    equal JAX's ``decoding_loss_bits`` on the global batch, though the
    ranks hold 3 and 1 watermarked rows."""
    g, ranks = ranked
    ref, ref_grad = _jax_loss(g, name)
    for r in ranks:
        assert float(r[f"loss_{name}"]) == pytest.approx(ref, rel=1e-6)
        np.testing.assert_allclose(r[f"grad_{name}"], ref_grad, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref_grad).max())


def test_per_bit_accuracy_is_the_global_batch_one(ranked):
    """``feedback``'s per-bit accuracy and train/ber: the JAX step's
    expressions (``waveverify_tpu/train/step.py``) on the global batch."""
    g, ranks = ranked
    logits = jnp.asarray(g["x"]) @ jnp.asarray(g["proj"])
    pm = jnp.asarray(g["mask"])[:, :, None]
    denom = jnp.sum(pm, axis=1)
    z = jnp.sum(logits * pm, axis=1) / jnp.maximum(denom, 1.0)
    valid = (denom > 0).astype(jnp.float32)
    correct = ((z > 0) == (jnp.asarray(g["msg"]) > 0.5)).astype(jnp.float32) * valid
    acc = np.asarray(jnp.sum(correct, axis=0) / jnp.maximum(jnp.sum(valid), 1.0))
    per_sample = np.asarray(jber(logits, jnp.asarray(g["msg"]), jnp.asarray(g["mask"]),
                                 per_sample=True))
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r["per_bit_acc"], acc, atol=1e-6)
        assert float(r["train_ber"]) == pytest.approx(float(per_sample.mean()), abs=1e-6)
        np.testing.assert_allclose(r["per_sample_ber"], per_sample[3 * i: 3 * i + 3],
                                   atol=1e-6)


# -- serving over several devices -------------------------------------------------

@pytest.fixture(scope="module")
def server():
    return WaveVerify(None, config=tiny_config(), seed=3, device="cpu")


def test_use_mesh_splits_batched_serving(server):
    rng = np.random.RandomState(4)
    audio = (rng.randn(4, 4800) * 0.1).astype(np.float32)
    bits = rng.randint(0, 2, (4, 16)).astype(np.float32)
    plain = server.embed_batch(audio, bits)
    d_bits, d_conf = server.detect_batch(plain)
    sharded = WaveVerify(None, config=tiny_config(), seed=3,
                         device="cpu").use_mesh(["cpu", "cpu"])
    out = sharded.embed_batch(audio, bits)
    np.testing.assert_allclose(out, plain, atol=1e-6, rtol=0)
    s_bits, s_conf = sharded.detect_batch(out)
    np.testing.assert_array_equal(s_bits, d_bits)
    np.testing.assert_allclose(s_conf, d_conf, atol=1e-6, rtol=0)
    assert len(sharded._mesh) == 2 and sharded._mesh[0][1] is sharded._mesh[1][1]


def test_use_mesh_refuses_a_batch_that_does_not_divide():
    wv = WaveVerify(None, config=tiny_config(), seed=3, device="cpu")
    wv.use_mesh(["cpu", "cpu"])
    audio = np.zeros((3, 4800), np.float32)
    with pytest.raises(ValueError, match="divisible by the mesh's 2 devices"):
        wv.embed_batch(audio, np.zeros((3, 16), np.float32))
    with pytest.raises(ValueError, match="divisible by the mesh's 2 devices"):
        wv.detect_batch(audio)


def test_use_mesh_without_a_card_asks_for_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WaveVerify(None, config=tiny_config(), device="cpu").use_mesh()


# -- one process -----------------------------------------------------------------

def test_one_process_is_a_no_op():
    assert parallel.initialize_distributed(device="cpu") == torch.device("cpu")
    assert not parallel.is_active()
    assert parallel.world_size() == 1 and parallel.rank() == 0
    t = torch.arange(3.0)
    assert parallel.global_sum(t) is t and parallel.global_mean(t) is t
    assert parallel.all_gather_rows(t) is t
    assert parallel.all_gather_object(5) == [5]
    w = torch.nn.Parameter(torch.ones(2))
    w.grad = torch.full((2,), 3.0)
    parallel.all_reduce_grads([w])
    parallel.broadcast_tensors([w])
    parallel.barrier()
    assert w.grad.tolist() == [3.0, 3.0] and w.tolist() == [1.0, 1.0]


def _record_threads(seen):
    seen.append((torch.get_num_threads(), os.environ["RANK"], os.environ["WORLD_SIZE"]))


@pytest.mark.parametrize("omp, threads", [(None, 1), ("3", 3)])
def test_spawned_rank_takes_omp_num_threads_else_one(monkeypatch, omp, threads):
    """A rank ``spawn`` starts gets ``OMP_NUM_THREADS`` threads when it is
    set, else one, as torchrun gives each rank: never a share of the
    host's cores, which oversubscribes a loaded host."""
    from waveverify_torch.parallel.mesh import _spawned

    for name in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.setenv(name, "")
    if omp is None:
        monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    else:
        monkeypatch.setenv("OMP_NUM_THREADS", omp)
    before, seen = torch.get_num_threads(), []
    try:
        _spawned(1, (__name__, "_record_threads"), 4, 12345, (seen,))
    finally:
        torch.set_num_threads(before)
    assert seen == [(threads, "1", "4")]


def test_make_mesh_checks_the_device_count():
    mesh = parallel.make_mesh(None, "cpu")
    assert (mesh.size, mesh.index, mesh.axis_names) == (1, 0, ("data",))
    assert mesh.rows(4) == (0, 4)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        parallel.make_mesh(2, "cpu")
    with pytest.raises(ValueError, match="batch_size 3 must divide over 2 devices"):
        parallel.Mesh(2, 1, torch.device("cpu")).rows(3)
    assert parallel.Mesh(2, 1, torch.device("cpu")).rows(4) == (2, 4)


@pytest.mark.parametrize("dispatch", ["stack", "scan"])
def test_draws_rows_cut_the_global_draws(dispatch):
    """A rank's rows of a step's draws: batch-shaped draws sliced, the
    sequence augmentation's kept, the bank's per-branch draws cut to the
    rows (0-d draws kept) or, per sample, sliced."""
    bank = EffectBank([("identity", {}), ("random_noise", {"noise_std": 0.01}),
                       ("echo", {})], dispatch=dispatch)
    idx = np.array([1, 2, 0, 2])
    d = draw(torch.Generator().manual_seed(0), 4, 3200, bank.draw_specs(idx),
             jitter_hop=8, per_sample=dispatch == "scan")
    part = d.rows(2, 4)
    assert part.row0 == 2 and part.per_sample == d.per_sample
    for name in ("loc_scores", "loc_probs", "loc_offset", "jitter",
                 "jitter_clean", "gp_alpha"):
        assert torch.equal(getattr(part, name), getattr(d, name)[2:4]), name
    assert (part.seq_u, part.seq_shift) == (d.seq_u, d.seq_shift)
    assert torch.equal(part.seq_perm, d.seq_perm)
    if dispatch == "scan":
        assert part.fx == d.fx[2:4]
        return
    assert len(part.fx) == len(d.fx) == 2
    for whole, cut in zip(d.fx, part.fx):
        for k, v in whole.items():
            ref = v if v.dim() == 0 else v[2:4]
            assert torch.equal(cut[k], ref), k


def test_localization_takes_donors_from_the_global_batch():
    """Rows [2, 4) of the global batch's localization, computed by the rank
    holding them from the global batch's clean audio, equal the global
    computation's rows, cross substitutions included."""
    g = torch.Generator().manual_seed(1)
    b, t = 4, 3200
    original = torch.randn(b, t, generator=g)
    watermarked = original + 0.01 * torch.randn(b, t, generator=g)
    scores, probs, offset = draw_localization(g, b, t, 16000, 0.02)
    full = localization_augmentation(original, watermarked, scores, probs,
                                     offset, 16000, 0.02)
    part = localization_augmentation(original[2:], watermarked[2:], scores[2:],
                                     probs[2:], offset[2:], 16000, 0.02,
                                     donors=original, row0=2)
    for a, b_ in zip(part, full):
        assert torch.equal(a, b_[2:])
    # the segment draws do cross-substitute in these rows
    alone = localization_augmentation(original[2:], watermarked[2:], scores[2:],
                                      probs[2:], offset[2:], 16000, 0.02)
    assert not torch.equal(alone[0], full[0][2:])


def test_steps_config_exercises_cross_substitution():
    """The 2-rank step test's configuration modifies localization segments
    (0.1 s segments on its 0.2 s clips would modify none)."""
    cfg = case_config()
    _, n = localization_segments(T, 16000, cfg.window_duration)
    assert int(n * 0.2) >= 1
    assert int(localization_segments(T, 16000, 0.1)[1] * 0.2) == 0
    assert cfg.loss.lambda_dec_bits > 0


# -- the CLI ----------------------------------------------------------------------

def test_cli_trains_two_cpu_ranks(tmp_path):
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(TINY_YAML)
    code, out = run_cli(["--config", str(cfg), "--device", "cpu", "--num-devices",
                         "2", "--ckpt-dir", str(tmp_path / "run"), "--max-steps",
                         "2", "--log-every", "1", "--no-samples", "--no-remat"],
                        tmp_path)
    assert code == 0, out[-3000:]
    log = [json.loads(line) for line in
           (tmp_path / "run" / "train_log.jsonl").read_text().splitlines()]
    train = [r for r in log if "loss" in r]
    assert [r["step"] for r in train] == [0, 1]
    assert all(np.isfinite(v) for r in log for v in r.values())
    assert (tmp_path / "run" / "latest" / "state.pt").exists()


def test_cli_refuses_a_batch_that_does_not_divide(tmp_path):
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(TINY_YAML)
    with pytest.raises(ValueError, match="batch_size 4 must divide over 3 devices"):
        main(["--config", str(cfg), "--device", "cpu", "--num-devices", "3",
              "--ckpt-dir", str(tmp_path / "run"), "--max-steps", "1"])
