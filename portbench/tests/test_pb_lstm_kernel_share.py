"""The reader of ``lstm_kernel_share.audioseal`` on synthetic span records:
the share of AudioSeal's ``seanet.lstm`` spans in the kept serve roots that
hold a ``lstm.persistent`` child, and None for a port without the kernel
or a call with no LSTM."""

from __future__ import annotations

import json

import pytest

from conftest import BENCH, ROOT
from pbcore import harness
from test_pb_program_spans import _read, _record, _Spans


def _audioseal_call(s, lo, kernel=(True, True, True)):
    """An AudioSeal embed+detect call at ``lo`` us: two ``seanet.lstm``
    spans under ``api.generator``, one under ``api.detector``, each with a
    ``lstm.persistent`` child where ``kernel`` says so."""
    flags = iter(kernel)
    for root_name, net, n in (("api.embed_batch", "api.generator", 2),
                              ("api.detect_batch", "api.detector", 1)):
        root = s.add(root_name, lo, lo + 2000)
        parent = s.add(net, lo + 300, lo + 1300, root)
        for j in range(n):
            lstm = s.add("seanet.lstm", lo + 400 + 300 * j, lo + 600 + 300 * j, parent)
            if next(flags):
                s.add("lstm.persistent", lo + 450 + 300 * j, lo + 550 + 300 * j, lstm)
        lo += 2000


@pytest.mark.parametrize("calls,want", [
    ([(True, True, True), (True, True, True)], 100.0),
    ([(True, False, True), (True, True, True)], 500 / 6),
    ([(False, False, False), (False, False, False)], None),  # the parent's port
    ([], None),  # no LSTM: a call of another model
])
def test_lstm_kernel_share(calls, want, tmp_path, monkeypatch):
    s = _Spans()
    for j, kernel in enumerate(calls):
        _audioseal_call(s, 1000 + 4000 * j, kernel)
    _audioseal_call(s, 20000, (False, False, False))  # outside the stretch
    if not calls:
        s.call(1000)
    got = _read("lstm_kernel_share.audioseal", _record(tmp_path, s, monkeypatch))
    assert got == (None if want is None else pytest.approx(want))


def test_lstm_kernel_share_is_in_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in bench["per_layer"]}["lstm_kernel_share.audioseal"]
    assert (m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "program_span", "recurrence", "audio_s_per_s", ["serve.audioseal.embed_detect.b8x30s"])
    assert harness.reader_path(BENCH / "layer_metrics", m["name"]).name == "lstm_kernel_share.py"
