"""Spans inside the port, on the profiler's clock.

A span names one stretch of the port's work::

    with spans.span("step.forward", device=True):
        ...

Spans are recorded only while a ``torch.profiler`` session runs in the
process (a traced benchmark run, the trainer's ``--profile-steps``). With
none running, :func:`span` returns one shared null context: no clock read,
no allocation, no CUDA event.

Each record (a dict) holds:

- ``name``; ``start_ns`` and ``end_ns`` from ``time.time_ns()``, the clock
  of the profiler's Chrome trace: an event's ``ts`` (us) there is
  ``t_ns / 1e3 - baseTimeNanoseconds / 1e3``;
- ``id``, ``parent`` (the enclosing span's id, None for a root) and
  ``root`` (the root's id, shared by every span of one call or step);
- ``device_ms``: for a span opened with ``device=True`` while CUDA is in
  use, the device time between two CUDA events recorded on the current
  stream at its entry and exit, resolved by :func:`drain` (a span never
  synchronises); None otherwise.

Each span also opens a profiler range of its name. The host's waits on
the card are in the same trace, as the CUDA runtime's blocking calls
(``cudaStreamSynchronize`` and the like) on the same clock: a reader
counts those inside a span's interval.

The port opens spans from one thread at a time (autograd's device thread
runs a backward while the calling thread waits in ``backward()``), so the
open spans of a process form one stack. Records are kept in memory, at
most :data:`MAX_RECORDS` (later ones are dropped and counted), until
:func:`drain` hands them over; :func:`add_to_chrome_trace` writes them into
a profiler's Chrome trace as a track of their own.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_RECORDS = 1 << 16
TRACK = "waveverify_torch spans"
# the track's thread id in a Chrome trace: above Linux's largest (2**22)
TRACK_TID = 2 ** 22 + 1

_NULL = contextlib.nullcontext()
# true under any profiler session, of the card alone too, and on autograd's
# device thread inside one
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Log:
    """The process's open spans and kept records."""

    def __init__(self):
        self.stack: List["_Span"] = []
        self.records: List[dict] = []
        self.dropped = 0
        self.next_id = 0


_log = _Log()


def span(name: str, device: bool = False):
    """A context that records the span ``name`` while a profiler runs, else
    the shared null context. ``device``: also time it on the card."""
    if not _profiler_enabled():
        return _NULL
    return _Span(name, device)


class _Span:
    __slots__ = ("name", "device", "id", "parent", "root", "start_ns", "_range",
                 "_events")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device

    def __enter__(self) -> "_Span":
        parent = _log.stack[-1] if _log.stack else None
        self.id = _log.next_id
        _log.next_id += 1
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        _log.stack.append(self)
        self.start_ns = time.time_ns()
        self._range = _autograd_profiler.record_function(self.name)
        self._range.__enter__()
        self._events = None
        if self.device and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._events[1].record()
        self._range.__exit__(*exc)
        end_ns = time.time_ns()
        _log.stack.pop()
        if len(_log.records) >= MAX_RECORDS:
            _log.dropped += 1
            return
        _log.records.append({"name": self.name, "id": self.id, "parent": self.parent,
                             "root": self.root, "start_ns": self.start_ns,
                             "end_ns": end_ns, "device_ms": None, "_events": self._events})


def drain() -> Tuple[List[dict], int]:
    """(the records kept since the last drain, how many were dropped), and
    forget both. Resolves each device span's ``device_ms``, waiting for its
    end event."""
    records, dropped = _log.records, _log.dropped
    _log.records, _log.dropped = [], 0
    for r in records:
        events = r.pop("_events")
        if events is not None:
            events[1].synchronize()
            r["device_ms"] = events[0].elapsed_time(events[1])
    return records, dropped


def add_to_chrome_trace(path, records: Sequence[dict]) -> None:
    """Append the records to the Chrome trace at ``path`` (a profiler's
    ``export_chrome_trace``), on its clock, as complete events on a thread
    of their own named :data:`TRACK` in this process."""
    path = Path(path)
    trace: Dict = json.loads(path.read_text())
    base_ns = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": TRACK_TID,
                   "args": {"name": TRACK}})
    for r in records:
        events.append({"ph": "X", "cat": "program_span", "name": r["name"], "pid": pid,
                       "tid": TRACK_TID, "ts": (r["start_ns"] - base_ns) / 1e3,
                       "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
                       "args": {k: r[k] for k in ("id", "parent", "root", "device_ms")}})
    path.write_text(json.dumps(trace))
