"""The port's spans (``waveverify_torch.spans``): off without a profiler;
names, parents and roots under one; the profiler's clock; the spans of a
training step, of the split step and of K steps per dispatch; the serving
API's spans; ``_StepProfile``'s trace. On the CPU; one test reads the
spans against a trace of the card and skips without one."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tests.torch_ranks import tiny_config
from waveverify_torch import spans

torch.set_num_threads(2)

B, T = 2, 3200
BANK = [("identity", {}), ("highpass_filter", {"cutoff_freq": 500}),
        ("random_noise", {"noise_std": 0.001})]
PHASES = ["step.forward", "step.disc", "step.gen_backward", "step.update"]


@pytest.fixture(autouse=True)
def _drained():
    spans.drain()
    yield
    spans.drain()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def _children(records, parent):
    """Names of ``parent``'s children, in the order they started."""
    return [r["name"] for r in sorted(records, key=lambda r: r["start_ns"])
            if r["parent"] == parent["id"]]


@pytest.mark.parametrize("device", [False, True])
def test_off_is_the_shared_null_context(device, monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made with no profiler running")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    ctx = spans.span("a", device=device)
    assert ctx is spans.span("b") is spans._NULL
    with ctx, spans.span("inner", device=device):
        torch.ones(4).sum()
    assert spans.drain() == ([], 0)


def test_names_parents_and_roots():
    with _cpu_profile():
        with spans.span("outer"):
            with spans.span("inner"):
                torch.ones(4).sum()
        with spans.span("second", device=True):
            torch.ones(4).sum()
    records, dropped = spans.drain()
    assert dropped == 0
    by = _by_name(records)
    outer, inner, second = by["outer"][0], by["inner"][0], by["second"][0]
    assert [r["name"] for r in records] == ["inner", "outer", "second"]  # by end
    assert outer["parent"] is None and outer["root"] == outer["id"]
    assert inner["parent"] == outer["id"] and inner["root"] == outer["id"]
    assert second["parent"] is None and second["root"] == second["id"] != outer["id"]
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer["end_ns"]
    assert second["device_ms"] is None  # no card in use
    assert set(outer) == {"name", "id", "parent", "root", "start_ns", "end_ns", "device_ms"}


def test_records_past_the_bound_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(spans, "MAX_RECORDS", 2)
    with _cpu_profile():
        for name in "abc":
            with spans.span(name):
                pass
    records, dropped = spans.drain()
    assert [r["name"] for r in records] == ["a", "b"] and dropped == 1
    assert spans.drain() == ([], 0)


def test_spans_share_the_profilers_clock(tmp_path):
    """A range opened inside a span lies inside it once the span is mapped
    onto the Chrome trace's clock by ``baseTimeNanoseconds``."""
    with _cpu_profile() as prof:
        for _ in range(5):
            with spans.span("outer"), record_function("probe"):
                torch.ones(64).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    probes = sorted((e for e in trace["traceEvents"] if e.get("name") == "probe"),
                    key=lambda e: float(e["ts"]))
    records, _ = spans.drain()
    assert len(probes) == len(records) == 5
    for r, e in zip(records, probes):
        lo, hi = (r["start_ns"] - base) / 1e3, (r["end_ns"] - base) / 1e3
        assert lo - 50 <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= hi + 50


# -- the training step -----------------------------------------------------------------


def _step_inputs(cfg, bank, step=0):
    from waveverify_torch.train.loop import step_generator
    from waveverify_torch.train.watermarking import draw

    rng = np.random.RandomState(step)
    audio = torch.from_numpy((rng.randn(B, T) * 0.1).astype(np.float32))
    msg = torch.from_numpy(rng.randint(0, 2, (B, 16)).astype(np.float32))
    idx = np.array([1, 2], np.int32)  # a filter and a random branch
    d = draw(step_generator(3, step), B, T, bank.draw_specs(idx),
             window_duration=cfg.window_duration)
    return audio, msg, idx, d


@pytest.fixture(scope="module")
def trainer():
    from waveverify_torch.effects.effects import EffectBank
    from waveverify_torch.train.state import create_train_state

    cfg = tiny_config(B, remat=True)
    state = create_train_state(cfg, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    return cfg, EffectBank(BANK), state


def _traced(fn):
    with _cpu_profile():
        fn()
    records, dropped = spans.drain()
    assert dropped == 0
    return records


# (how the step runs, the roots it records with their children)
STEP_CASES = {
    "train_step": [("train_step", PHASES)],
    "no_disc": [("train_step", ["step.forward", "step.gen_backward", "step.update"])],
    "split": [("disc_step", ["step.forward", "step.disc"]),
              ("train_step", ["step.forward", "step.gen_backward", "step.update"])],
    "k2": [("train_step", PHASES), ("train_step", PHASES)],
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_records_its_phases(case, trainer):
    from waveverify_torch.train.step import disc_step, train_step, train_steps

    cfg, bank, state = trainer
    a, m, i, d = _step_inputs(cfg, bank)

    def run():
        if case == "split":
            disc_step(state, cfg, a, m, d)
            train_step(state, cfg, bank, a, m, i, d, update_disc=False)
        elif case == "k2":
            a2, m2, i2, d2 = _step_inputs(cfg, bank, 1)
            train_steps(state, cfg, bank, torch.stack([a, a2]), torch.stack([m, m2]),
                        [i, i2], [d, d2])
        else:
            train_step(state, cfg, bank, a, m, i, d, train_disc=case != "no_disc")

    records = _traced(run)
    roots = sorted((r for r in records if r["parent"] is None),
                   key=lambda r: r["start_ns"])
    assert [(r["name"], _children(records, r)) for r in roots] == STEP_CASES[case]
    for root in roots:
        mine = [r for r in records if r["root"] == root["id"]]
        phases = sorted((r for r in mine if r["parent"] == root["id"]),
                        key=lambda r: r["start_ns"])
        # one after another, inside the root
        assert root["start_ns"] <= phases[0]["start_ns"]
        assert all(p["end_ns"] <= q["start_ns"] for p, q in zip(phases, phases[1:]))
        assert phases[-1]["end_ns"] <= root["end_ns"]
        if root["name"] == "train_step":
            # remat recomputes the attacks inside the generator's backward
            by_id = {r["id"]: r for r in mine}
            under = sorted(by_id[r["parent"]]["name"] for r in mine
                           if r["name"] == "bank.apply")
            assert under == ["step.forward", "step.gen_backward"]


# -- serving ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def server():
    from waveverify_torch import WaveVerify

    return WaveVerify(None, config=tiny_config(B), device="cpu")


@pytest.mark.parametrize("call,root,net", [
    ("embed_batch", "api.embed_batch", "api.generator"),
    ("detect_batch", "api.detect_batch", "api.detector"),
])
def test_serving_calls_record_upload_network_and_readback(call, root, net, server):
    audio = (np.random.RandomState(0).randn(B, 1600) * 0.1).astype(np.float32)
    args = (audio, np.ones((B, 16), np.float32)) if call == "embed_batch" else (audio,)
    records = _traced(lambda: getattr(server, call)(*args))
    (top,) = [r for r in records if r["parent"] is None]
    assert top["name"] == root
    assert _children(records, top) == ["api.upload", net, "api.readback"]
    assert all(r["root"] == top["id"] for r in records)


def test_step_profile_writes_the_spans_into_its_trace(tmp_path):
    from waveverify_torch.train.loop import _StepProfile

    prof = _StepProfile(str(tmp_path), 1, 2, torch.device("cpu"))
    prof.at(0)
    with spans.span("before"):  # no profiler yet: not recorded
        pass
    prof.at(1)
    with spans.span("train_step"):
        with spans.span("step.forward"), record_function("probe"):
            torch.ones(8).sum()
    prof.at(2)
    trace = json.loads((tmp_path / "profile" / "steps_1_2.json").read_text())
    events = trace["traceEvents"]
    track = [e for e in events if e.get("cat") == "program_span"]
    assert sorted(e["name"] for e in track) == ["step.forward", "train_step"]
    assert all(e["tid"] == spans.TRACK_TID for e in track)
    assert any(e.get("ph") == "M" and e["args"].get("name") == spans.TRACK
               for e in events)
    (fwd,) = [e for e in track if e["name"] == "step.forward"]
    (probe,) = [e for e in events if e.get("name") == "probe"]
    assert fwd["ts"] - 50 <= float(probe["ts"])
    assert float(probe["ts"]) + float(probe["dur"]) <= fwd["ts"] + fwd["dur"] + 50
    assert spans.drain() == ([], 0)


@pytest.mark.cuda
def test_spans_on_the_card(tmp_path):
    """Under a profiler of the card alone: a blocking upload and a
    ``.cpu()`` inside a span are one blocking runtime call each in the
    trace, an enqueued matmul none and its launch inside its span; the
    matmul's span is timed on the card; the sync debug mode is untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = torch.randn(256, 256, device="cuda")
    host = torch.randn(256, 256)
    x @ x  # cuBLAS's set-up, outside the profile
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with spans.span("root"):
            with spans.span("upload"):
                host.to("cuda")
            with spans.span("readback"):
                x.cpu()
            with spans.span("matmul", device=True):
                x @ x
    assert torch.cuda.get_sync_debug_mode() == mode
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    runtime = [e for e in trace["traceEvents"] if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    records, _ = spans.drain()
    by = {r["name"]: r for r in records}

    def inside(name, pred, slack=0.0):
        lo, hi = [(by[name][k] - base) / 1e3 for k in ("start_ns", "end_ns")]
        return [e for e in runtime
                if pred(e["name"]) and lo - slack <= float(e["ts"]) <= hi + slack]

    def blocks(call):
        return "Synchronize" in call or (call.startswith("cudaMemcpy") and "Async" not in call)

    found = {n: [e["name"] for e in inside(n, blocks)] for n in ("upload", "readback", "matmul")}
    assert [len(v) for v in found.values()] == [1, 1, 0], found
    assert inside("matmul", lambda call: "Launch" in call, slack=50.0)
    assert by["matmul"]["device_ms"] > 0
