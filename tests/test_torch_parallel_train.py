"""Data-parallel training of the port against its one-process training on
the global batch, f32 on the CPU at the tiny configuration, two gloo
ranks as subprocesses (``tests/torch_ranks.py``):

- the step: two steps of the monolithic step, the split step and one
  K = 2 dispatch, each rank on 2 of the global batch's 4 rows with the
  global batch's draws cut to its rows, against the one-process step at
  batch 4: losses within rel 1e-5; the gradients each optimizer steps on,
  leaf by leaf, within ``GRAD_REL`` at each step; and, as a backstop,
  every parameter and AdamW moment after the two steps within a limit
  per network of its network's largest (1e-6 for the detector and the
  locator; ``PARAM_REL`` says why the generator and the discriminator
  take more); the two ranks bit for bit equal. The one-process step is
  held to the JAX package's global-batch program by
  ``tests/test_torch_train.py`` and its kin, so this closes the chain to
  the JAX package's sharded step;
- the loop: ``train()`` for 2 steps on 2 ranks with the BER-gated ramp
  and the nbits curriculum on: only rank 0 writes the log and the
  checkpoint; both ranks feed their controllers the global values and
  their schedulers their own rows; a resume continues on both ranks from
  rank 0's checkpoint;
(the CLI's ``--num-devices`` is in ``test_torch_parallel.py``, so that
the two files take about the same time).
"""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tests.torch_ranks import B, CASES, run_case, run_ranks

NETS = ("generator", "detector", "locator", "discriminator")
THREADS = 2  # each rank's and the one-process run's: the same sums' order
LOSS_REL = 1e-5
# After two steps, the largest deviation of a parameter (AdamW moment) from
# the one-process run, over the largest of its network's. Readings (2
# threads; the ranks' sums of two halves against one sum): generator
# 1.3e-5 (1.1e-3), detector 1.8e-7 (2.0e-7), locator 1.1e-8 (7.6e-8),
# discriminator 1.1e-6 (9.1e-7). The generator's and the discriminator's
# second step amplifies f32 rounding at random init (the log-STFT features
# and the gradient penalty): the one-process run against itself with the
# audio moved by 1e-7 relative (``run_case(case, audio_scale=1 +- 1e-7)``)
# deviates by 1.4e-4 (1.25) and 9.7e-5 (1.4e-4), and with 1 thread instead
# of 2 by 1.5e-4 (0.40) and 9.7e-5 (1.4e-4). AdamW's first step already moves a parameter with a gradient
# near eps by up to 0.2 lr. Ranks that stepped on their own half's
# gradient, or on a per-rank ratio, are off by O(1) in the moments.
PARAM_REL = {"generator": 1e-4, "detector": 1e-6, "locator": 1e-6,
             "discriminator": 1e-5}
MOMENT_REL = {"generator": 1e-2, "detector": 1e-6, "locator": 1e-6,
              "discriminator": 1e-5}
# the gradient norms of the first step (one state) to LOSS_REL; of the
# second, the generator's (reading 2.5e-4; 0.14-1.1 under the 1e-7 move)
SECOND_NORM_REL = {"generator": 1e-3, "detector": 1e-5, "locator": 1e-5,
                   "discriminator": 1e-5}


# The gradients each optimizer steps on (after the all-reduce, the clip
# and the gates), leaf by leaf: the relative norm of a leaf's deviation
# from the one-process run, measured against at least GRAD_FLOOR of its
# network's gradient norm (a leaf far below it cannot be compared relative
# to itself). Readings (2 threads): the first step (one state) 2.2e-06
# (generator), 1.3e-06 (detector), 1.1e-06 (locator), 1.3e-06
# (discriminator); the second, after the first step's AdamW update of the
# parameters, 2.7e-03, 1.0e-05, 2.8e-06, 1.5e-06, where the one-process run
# with the audio moved by 1e-7 relative reads 0.33, 4.3e-04, 1.9e-04 and
# 1.1e-02. A rank that stepped on its own half's gradient is off by O(1).
GRAD_FLOOR = 1e-3
GRAD_REL = ({"generator": 1e-5, "detector": 1e-5, "locator": 1e-5,
             "discriminator": 1e-5},
            {"generator": 1e-2, "detector": 5e-5, "locator": 2e-5,
             "discriminator": 1e-5})


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """For each case: both ranks' results and the one-process run's (made
    here while the ranks run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        with ThreadPoolExecutor(1) as pool:
            one = pool.submit(lambda: {c: run_case(c) for c in CASES})
            out = run_ranks(f"""
from tests.torch_ranks import B, CASES, run_case
torch.set_num_threads({THREADS})
per = B // world
results = {{c: run_case(c, rank * per, (rank + 1) * per) for c in CASES}}
torch.save(results, f"{{out}}/rank{{rank}}.pt")
""", tmp_path_factory.mktemp("steps"))
            one = one.result()
    finally:
        torch.set_num_threads(threads)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {c: dict(ranks=[r[c] for r in ranks], one=one[c]) for c in CASES}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


@pytest.mark.parametrize("case", CASES)
def test_two_rank_losses_equal_the_global_batch_step(steps, case):
    """Every loss the step reports, train/ber, train/miou and the per-bit
    accuracy are the global batch's; so are the gradient norms."""
    r = steps[case]
    for step, (mine, ref) in enumerate(zip(r["ranks"][0][0], r["one"][0])):
        assert set(mine) == set(ref)
        for k, v in ref.items():
            if k.startswith("per_sample"):
                continue
            tol = (SECOND_NORM_REL[k.split("/")[1]]
                   if step == 1 and k.startswith("grad_norm/") else LOSS_REL)
            for a, b in zip(np.ravel(mine[k]), np.ravel(v)):
                assert _rel(a, b) <= tol, (case, step, k, float(a), float(b))


@pytest.mark.parametrize("case", CASES)
def test_two_rank_per_sample_metrics_are_each_ranks_rows(steps, case):
    r = steps[case]
    per = B // 2
    for step, ref in enumerate(r["one"][0]):
        for k in ("per_sample_ber", "per_sample_miou"):
            got = np.concatenate([r["ranks"][i][0][step][k] for i in range(2)])
            np.testing.assert_allclose(got, ref[k], rtol=1e-5, atol=1e-6)
            assert r["ranks"][0][0][step][k].shape == (per,)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("step", [0, 1])
def test_two_rank_gradients_equal_the_global_batch_step(steps, case, step):
    """Each network's gradients, leaf by leaf, as its optimizer steps on
    them: the global batch's."""
    mine, ref = steps[case]["ranks"][0][3][step], steps[case]["one"][3][step]
    assert set(mine) == set(ref) and ref
    for net in NETS:
        keys = [k for k in ref if k.startswith(net + ".")]
        norm = float(np.sqrt(sum(float(np.sum(ref[k].astype(np.float64) ** 2))
                                 for k in keys)))
        devs = {k: float(np.linalg.norm(mine[k] - ref[k])
                         / max(float(np.linalg.norm(ref[k])), GRAD_FLOOR * norm))
                for k in keys}
        worst = max(devs, key=devs.get)
        assert devs[worst] <= GRAD_REL[step][net], (case, step, worst, devs[worst])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("what", ["params", "moments"])
def test_two_rank_state_equals_the_global_batch_step(steps, case, what):
    """After two steps every parameter and AdamW moment is within its
    network's limit of the largest of the network's, against the
    one-process run."""
    i, limits = (1, PARAM_REL) if what == "params" else (2, MOMENT_REL)
    mine, ref = steps[case]["ranks"][0][i], steps[case]["one"][i]
    assert set(mine) == set(ref) and ref
    for net in NETS:
        keys = [k for k in ref if k.startswith(net + ".")]
        scale = max(float(np.abs(ref[k]).max()) for k in keys)
        worst = max(float(np.abs(mine[k] - ref[k]).max()) for k in keys)
        assert worst <= limits[net] * scale, (case, what, net, worst / scale)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_stay_bit_for_bit_equal(steps, case):
    (_, p0, m0, g0), (_, p1, m1, g1) = steps[case]["ranks"]
    for a, b in ((p0, p1), (m0, m1), *zip(g0, g1)):
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), (case, k)


# -- the loop ---------------------------------------------------------------------

LOOP = """
import json
import dataclasses
from waveverify_torch.train import loop
from tests.torch_ranks import tiny_config
cfg = tiny_config(4, val_batch_size=2, valid_freq=2, sample_freq=10**9,
                  train_duration=0.2, val_duration=0.2, remat=False)
cfg = dataclasses.replace(cfg, loss=dataclasses.replace(
    cfg.loss, warmup_ber_gate=0.6, warmup_steps=10, warmup_nbits_start=8,
    warmup_nbits_gate=0.4))
seen = {"controllers": [], "feeds": [], "sched": [], "scheduler": []}
make_controllers, feed, feed_sched = (loop.make_controllers, loop.feed_controllers,
                                      loop._feed_scheduler)
Scheduler = loop.EffectScheduler

def made(*a):
    seen["controllers"].append(make_controllers(*a))
    return seen["controllers"][-1]

def fed(ramp, curr, ber, acc, k=1):
    seen["feeds"].append([float(np.mean(ber)), np.asarray(acc).tolist()])
    return feed(ramp, curr, ber, acc, k)

def fed_sched(s, m, sel):
    seen["sched"].append(np.asarray(m["per_sample_ber"]).tolist())
    return feed_sched(s, m, sel)

def scheduler(*a, **kw):
    seen["scheduler"].append(Scheduler(*a, **kw))
    return seen["scheduler"][-1]

import numpy as np
loop.make_controllers, loop.feed_controllers = made, fed
loop._feed_scheduler, loop.EffectScheduler = fed_sched, scheduler
trainer = loop.TrainerConfig(ckpt_dir=f"{out}/ckpt", log_file=f"{out}/log.jsonl",
                             dump_samples=False, log_every=1, device="cpu",
                             num_devices=world)
runs = []
for steps, resume in ((2, False), (4, True)):
    state = loop.train(cfg, trainer, max_steps=steps, resume=resume)
    ramp, curr = seen["controllers"][-1]
    runs.append({"step": state.step, "ramp": ramp.state_dict(),
                 "curr": curr.state_dict(),
                 "scheduler": json.loads(json.dumps(
                     seen["scheduler"][-1].state_dict(), default=str)),
                 "params": {n: p.detach().numpy().tolist()
                            for n, p in state.models.named_parameters()
                            if n.startswith("detector.")}})
json.dump({"runs": runs, "feeds": seen["feeds"], "sched": seen["sched"]},
          open(f"{out}/rank{rank}.json", "w"))
"""


@pytest.fixture(scope="module")
def looped(tmp_path_factory):
    out = run_ranks(LOOP, tmp_path_factory.mktemp("loop"))
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    log = [json.loads(line) for line in (out / "log.jsonl").read_text().splitlines()]
    meta = json.loads((out / "ckpt" / "latest" / "meta.json").read_text())
    return ranks, log, meta


def test_loop_only_rank0_logs_and_checkpoints(looped):
    """One log line per step (rank 1 wrote none), validation at 2 and 4,
    and rank 0's ``latest`` at the resumed run's end."""
    _, log, meta = looped
    assert [r["step"] for r in log if "loss" in r] == [0, 1, 2, 3]
    assert [r["step"] for r in log if "val/loss" in r] == [1, 3]
    assert meta["step"] == 4


def test_loop_controllers_take_the_global_values(looped):
    """Both ranks feed their ramp and curriculum the same values, the
    global train/ber that rank 0 logs, so their states stay equal."""
    (r0, r1), log, _ = looped
    assert r0["feeds"] == r1["feeds"] and len(r0["feeds"]) == 2
    logged = {r["step"]: r["train/ber"] for r in log if "loss" in r}
    # a step is fed while the next one runs: step 0 in the first run, step 2
    # in the resumed one
    for (ber, acc), step in zip(r0["feeds"], (0, 2)):
        assert ber == pytest.approx(logged[step], abs=1e-7)
        assert len(acc) == 16
    for a, b in zip(r0["runs"], r1["runs"]):
        assert a["ramp"] == b["ramp"] and a["curr"] == b["curr"]


def test_loop_schedulers_take_each_ranks_own_rows(looped):
    """Each rank's scheduler is fed its own 2 rows per step, whose mean
    with the other rank's is the global train/ber; a resume restores rank
    0's scheduler (fed step 0 when it saved at step 2) on both ranks."""
    (r0, r1), log, _ = looped
    logged = {r["step"]: r["train/ber"] for r in log if "loss" in r}
    # the first run feeds steps 0 and 1, the resumed run steps 2 and 3
    assert len(r0["sched"]) == len(r1["sched"]) == 4
    for step, (a, b) in enumerate(zip(r0["sched"], r1["sched"])):
        assert len(a) == len(b) == 2
        assert np.mean(a + b) == pytest.approx(logged[step], abs=1e-6)
    for r in (r0, r1):
        assert [run["scheduler"]["updates"] for run in r["runs"]] == [4, 2 + 4]
    assert r0["runs"][0]["scheduler"] != r1["runs"][0]["scheduler"]


def test_loop_resume_continues_on_both_ranks(looped):
    (r0, r1), _, _ = looped
    assert [r["step"] for r in r0["runs"]] == [r["step"] for r in r1["runs"]] == [2, 4]
    for a, b in zip(r0["runs"], r1["runs"]):
        assert a["params"] == b["params"]
    assert r0["runs"][0]["params"] != r0["runs"][1]["params"]
