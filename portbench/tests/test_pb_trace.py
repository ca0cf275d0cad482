"""The reduction from a device trace and spans to per-layer metrics, on a
synthetic Chrome trace; every reader returns nothing where there is
nothing to read."""

from __future__ import annotations

import json

import pytest

from conftest import BENCH, ROOT
from pbcore import harness
from pbcore.trace import PROFILED, DeviceTrace, Tracer, gaps, union_length


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert union_length(iv) == 4
    assert gaps(iv, 0, 8) == [(3, 5), (6, 8)]
    assert gaps([], 1, 2) == [(1, 2)]


def _events():
    ev = [{"cat": "user_annotation", "name": PROFILED, "ts": 0, "dur": 100, "tid": 1},
          {"cat": "user_annotation", "name": "pb:call", "ts": 0, "dur": 48, "tid": 1},
          {"cat": "user_annotation", "name": "pb:call", "ts": 50, "dur": 48, "tid": 1},
          {"cat": "user_annotation", "name": "resblock_chain_ref_backward", "ts": 60,
           "dur": 10, "tid": 2}]
    kernels = [("void resblock_chain_kernel<float>", 5, 20, 1, 1),
               ("elementwise", 25, 10, 2, 1), ("resblock_chain_wgmma_kernel", 55, 10, 3, 1),
               ("gemm", 66, 20, 4, 2)]
    for name, ts, dur, corr, tid in kernels:
        ev.append({"cat": "kernel", "name": name, "ts": ts, "dur": dur,
                   "args": {"correlation": corr}})
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts - 3,
                   "dur": 1, "tid": tid, "args": {"correlation": corr}})
    ev.append({"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90, "dur": 4})
    return ev


def test_device_trace():
    tr = DeviceTrace(_events(), n_iter=2)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx((20 + 10 + 10 + 20 + 4) * 1e-6)
    assert len(tr.kernels) == 4
    assert tr.kernel_s("resblock_chain") == pytest.approx(30e-6)
    assert tr.range_kernel_s("resblock_chain_ref_backward") == pytest.approx(20e-6)
    top = tr.top_ops(2)
    assert top[0][1] == pytest.approx(20e-6) and len(top) == 2
    longest = tr.idle_gaps(1)[0]
    assert longest[0] == "call" and longest[1] == pytest.approx(20e-6)
    # a trace of the device alone: the stretch starts at its first operation
    dev = DeviceTrace([e for e in _events() if e["cat"] != "user_annotation"], 2,
                      window_s=100e-6)
    assert dev.window_s == pytest.approx(100e-6)
    assert dev.busy_s == pytest.approx(64e-6) and dev.lo == 5


def _record(trace, tracer, config, workload, window, flop=None):
    return {"setup_s": 1.0, "window": window, "peak_bytes": 2 ** 30, "tracer": tracer,
            "trace": trace, "annotated": trace, "config": config, "workload": workload,
            "flop": flop}


def test_readers():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "waveverify_base_r5.json").read_text())
    wl = {**json.loads((BENCH / "workloads" / "serve.embed_detect.b64.json").read_text()),
          "profile": [0, 2, 4]}
    tracer = Tracer(True, harness.OUT_DIR)
    tracer.spans = [("embed_batch", 0.0, 0.06, "call"), ("detect_batch", 0.06, 0.1, "call")]
    window = {"t_start": 0.0, "t_end": 1.0, "calls": [(0.0, 0.1)] * 10,
              "audio_s": [64.0] * 10, "keys": [0] * 10, "attempted": 10}
    rec = _record(DeviceTrace(_events(), 2), tracer, cfg, wl, window, {0: 2.2e12})
    got = {m["name"]: harness.load_module(harness.reader_path(BENCH / "layer_metrics",
                                                               m["name"])).read(rec)
           for m in bench["per_layer"]}
    assert got["launches_per_call.serve"] == 2
    assert got["embed_ms.embed_detect"] == pytest.approx(60.0)
    assert got["detect_ms.embed_detect"] == pytest.approx(40.0)
    assert got["idle_share.serve"] == pytest.approx(36.0)
    assert got["mfu.serve"] == pytest.approx(2 * 2.2e12 / 100e-6 / 495e12 * 100)
    # the roofline of the chains' 1.22e12 FLOP against 15 us of chain kernels a call
    assert got["chain_roofline.embed_detect"] > 100  # a synthetic trace: far too fast
    assert got["host_ms.train"] is None
    assert got["mfu.train"] == got["mfu.serve"]  # one reader per quantity
    train = _record(DeviceTrace(_events(), 2), tracer, cfg, wl,
                    {"t_start": 0.0, "t_end": 1.0, "steps": 4, "attempted": 4}, 1.0e10)
    mfu = harness.load_module(harness.reader_path(BENCH / "layer_metrics", "mfu.train"))
    assert mfu.read(train) == pytest.approx(2 * 1.0e10 / 100e-6 / 495e12 * 100)
    e2e = {m["name"]: harness.load_module(harness.reader_path(BENCH / "e2e_metrics",
                                                               m["name"])).read(rec)
           for m in bench["end_to_end"]}
    assert e2e["audio_s_per_s"] == pytest.approx(640.0)
    assert e2e["call_ms_p95"] == pytest.approx(100.0)
    assert e2e["peak_gib"] == 1.0 and e2e["step_ms"] is None


def test_readers_find_nothing():
    """Without a trace, spans or counts every per-layer reader gives None."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "waveverify_base_r5.json").read_text())
    rec = _record(None, Tracer(True, harness.OUT_DIR), cfg, {"clip_s": 1.0, "batch": 64},
                  {"t_start": 0.0, "t_end": 1.0, "attempted": 0})
    for m in bench["per_layer"]:
        path = harness.reader_path(BENCH / "layer_metrics", m["name"])
        assert harness.load_module(path).read(rec) is None, m["name"]
