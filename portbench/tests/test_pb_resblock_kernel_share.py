"""The readers of AudioSeal's residual blocks: ``resblock_kernel_share`` on
synthetic span records (the share of the kept serve roots'
``seanet.resblock`` spans that hold a ``resblock.fused`` child, None for a
port without the kernel or a call with no block), ``resblock_ms`` and
``resblock_roofline`` on a synthetic trace, and their entries in
``BENCHMARK.json``."""

from __future__ import annotations

import json

import pytest

from conftest import BENCH, ROOT
from counts_resblock import resblock_bound_s
from pbcore import harness
from pbcore.trace import DeviceTrace
from test_pb_program_spans import _read, _record, _Spans

CELL = "serve.audioseal.embed_detect.b8x30s"
NAMES = ("resblock_ms.audioseal", "resblock_roofline.audioseal",
         "resblock_kernel_share.audioseal")


def _audioseal_call(s, lo, fused):
    """An AudioSeal embed+detect call at ``lo`` us: eight ``seanet.resblock``
    spans under ``api.generator``, four under ``api.detector``, each with a
    ``resblock.fused`` child where ``fused`` (one flag a block) says so."""
    flags = iter(fused)
    for root_name, net, n in (("api.embed_batch", "api.generator", 8),
                              ("api.detect_batch", "api.detector", 4)):
        root = s.add(root_name, lo, lo + 2000)
        parent = s.add(net, lo + 300, lo + 1300, root)
        for j in range(n):
            blk = s.add("seanet.resblock", lo + 310 + 100 * j, lo + 390 + 100 * j, parent)
            if next(flags):
                s.add("resblock.fused", lo + 320 + 100 * j, lo + 380 + 100 * j, blk)
        lo += 2000


@pytest.mark.parametrize("calls,want", [
    ([[True] * 12, [True] * 12], 100.0),
    ([[True] * 6 + [False] * 6, [True] * 12], 75.0),
    ([[False] * 12, [False] * 12], None),  # the parent's port: no fused span
    ([], None),  # no block: a call of another model
])
def test_resblock_kernel_share(calls, want, tmp_path, monkeypatch):
    s = _Spans()
    for j, fused in enumerate(calls):
        _audioseal_call(s, 1000 + 4000 * j, fused)
    _audioseal_call(s, 20000, [False] * 12)  # outside the stretch
    if not calls:
        s.call(1000)
    got = _read("resblock_kernel_share.audioseal", _record(tmp_path, s, monkeypatch))
    assert got == (None if want is None else pytest.approx(want))


def _trace(blocks, n_iter=2):
    """A traced stretch of ``n_iter`` calls: per call twelve
    ``seanet.resblock`` ranges on the host, each launching ``blocks``
    kernels of 100 us (the weight norms and the fused kernel), and one
    kernel launched outside any range."""
    events = [{"cat": "user_annotation", "name": "pb:profiled", "ts": 0.0, "dur": 1e7}]
    corr = 0
    for call in range(n_iter):
        base = 1e5 + call * 1e6
        for j in range(12):
            lo = base + j * 1e4
            events.append({"cat": "user_annotation", "name": "seanet.resblock", "ts": lo,
                           "dur": 50.0, "tid": 1})
            for n in range(blocks):
                corr += 1
                events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                               "ts": lo + 5 + n, "dur": 1.0, "tid": 1,
                               "args": {"correlation": corr}})
                events.append({"cat": "kernel", "name": f"k{n}", "ts": lo + 100 + 200 * n,
                               "dur": 100.0, "args": {"correlation": corr}})
        corr += 1
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": base + 5e5,
                       "dur": 1.0, "tid": 1, "args": {"correlation": corr}})
        events.append({"cat": "kernel", "name": "other", "ts": base + 5e5 + 10, "dur": 500.0,
                       "args": {"correlation": corr}})
    return DeviceTrace(events, n_iter)


def _audioseal_record(tr):
    published = json.loads((BENCH / "configs" / "audioseal_16bits.json").read_text())
    wl = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    return {"annotated": tr, "config": published, "workload": wl}


def test_resblock_ms_and_roofline():
    """Twelve blocks of 3 kernels of 100 us a call: 3.6 ms a call, and the
    roofline share is the blocks' bound over it; none without the ranges."""
    record = _audioseal_record(_trace(3))
    assert _read("resblock_ms.audioseal", record) == pytest.approx(3.6)
    cfg = record["config"]["model"]["generator"]["seanet"]
    bound = resblock_bound_s(cfg, 8, 480000)
    assert _read("resblock_roofline.audioseal", record) == pytest.approx(
        bound / 3.6e-3 * 100.0)
    empty = _audioseal_record(_trace(0))
    assert _read("resblock_ms.audioseal", empty) is None
    assert _read("resblock_roofline.audioseal", empty) is None
    assert _read("resblock_ms.audioseal", {"annotated": None}) is None


def test_resblock_metrics_are_in_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = {m["name"]: m for m in bench["per_layer"]}
    assert [m["name"] for m in bench["per_layer"][-3:]] == list(NAMES)
    for name in NAMES:
        m = metrics[name]
        assert (m["layer"], m["moves"], m["workloads"]) == ("networks", "audio_s_per_s", [CELL])
        assert harness.reader_path(BENCH / "layer_metrics", name).name == \
            name.split(".")[0] + ".py"
    assert metrics["resblock_kernel_share.audioseal"]["source"] == "program_span"
    assert metrics["resblock_ms.audioseal"]["source"] == "device_trace"
