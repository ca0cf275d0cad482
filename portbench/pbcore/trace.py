"""Spans, counts and the device trace of one run.

A :class:`Tracer` is handed to a driver. With tracing off it records
nothing. With tracing on it keeps host spans in memory for the whole
window (name, start, end, parent; each also a ``torch.profiler`` range
named ``pb:<name>``), and runs ``torch.profiler`` over two short steady
stretches of the driver's loop, ``profile = (a, b, c)``:

- the device stretch, iterations [a, b): the device's activity alone,
  which costs the host little (a training step 4% against 14% with the
  host's operators recorded too), so the device's busy and idle time
  stand as they are without the profiler;
- the annotated stretch, iterations [b, c): the host's operators and
  ranges too, for what only they show (the program's named ranges, the
  benchmark span open during an idle gap).

Each stretch's Chrome trace is written under the run's output directory
and read into a :class:`DeviceTrace` as the stretch ends (a profiler
session clears what an earlier one kept); :meth:`Tracer.finish` writes
the spans after the window.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PROFILED = "pb:profiled"


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length covered by ``intervals`` (start, end)."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


class DeviceTrace:
    """The profiled stretch, read from a Chrome trace (times in us)."""

    def __init__(self, events: List[dict], n_iter: int, window_s: Optional[float] = None):
        """``window_s``: the stretch's wall time by the host's clock, for a
        trace of the device alone (it starts at the first device
        operation); without it the trace's ``pb:profiled`` range bounds
        the stretch."""
        self.n_iter = n_iter
        if window_s is None:
            win = [e for e in events if e.get("name") == PROFILED
                   and e.get("cat") == "user_annotation"]
            if not win:
                raise RuntimeError("the trace holds no profiled range")
            self.lo = float(win[0]["ts"])
            self.hi = self.lo + float(win[0]["dur"])
        else:
            starts = [float(e["ts"]) for e in events if e.get("cat") in DEVICE_CATS]
            self.lo = min(starts) if starts else 0.0
            self.hi = self.lo + window_s * 1e6
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and self.lo <= float(e["ts"]) < self.hi]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.ranges = [e for e in events if e.get("cat") == "user_annotation"
                       and e.get("name") != PROFILED]
        self.runtime = [e for e in events if e.get("cat") == "cuda_runtime"]

    def _iv(self, evs) -> List[Tuple[float, float]]:
        return [(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), self.hi))
                for e in evs]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return union_length(self._iv(self.device)) * 1e-6

    def kernel_s(self, substring: str) -> float:
        """Device seconds of the kernels whose name holds ``substring``."""
        return sum(float(e["dur"]) for e in self.kernels if substring in e["name"]) * 1e-6

    def range_kernel_s(self, name: str) -> float:
        """Device seconds of the kernels launched inside the host ranges
        called ``name`` (matched through the launches' correlation ids)."""
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
                 for e in self.ranges if e["name"] == name]
        ids = set()
        for r in self.runtime:
            t = float(r["ts"])
            if any(a <= t <= b and tid == r.get("tid") for a, b, tid in spans):
                ids.add(r.get("args", {}).get("correlation"))
        return sum(float(k["dur"]) for k in self.kernels
                   if k.get("args", {}).get("correlation") in ids) * 1e-6

    def top_ops(self, n: int = 10) -> List[List[object]]:
        """[[device operation, seconds]] of the ``n`` that took most time."""
        by: Dict[str, float] = {}
        for e in self.device:
            by[e["name"]] = by.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List[object]]:
        """[[the benchmark span open on the host when the gap began,
        seconds]] of the ``n`` longest gaps with no device operation."""
        spans = [e for e in self.ranges if e["name"].startswith("pb:")]
        longest = sorted(gaps(self._iv(self.device), self.lo, self.hi),
                         key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in longest:
            open_ = [e for e in spans if float(e["ts"]) <= a <= float(e["ts"]) + float(e["dur"])]
            # the innermost open span: the one that started last
            label = max(open_, key=lambda e: float(e["ts"]))["name"][3:] if open_ else "none"
            out.append([label, (b - a) * 1e-6])
        return out


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Tracer:
    """Host spans and the two profiled stretches of one run (see the module
    docstring); ``profile`` is (a, b, c) in the driver's iterations."""

    def __init__(self, enabled: bool, out_dir: Path,
                 profile: Sequence[int] = (0, 0, 0), tag: str = "run"):
        self.enabled = enabled
        self.tag = tag  # the outputs' file names start with it
        self.open = False  # spans and iterations count once the window opens
        self.out_dir = out_dir
        self.profile = tuple(profile)
        self.spans: List[Tuple[str, float, float, Optional[str]]] = []
        self._stack: List[str] = []
        self._prof = None      # the running profiler and its stretch's kind
        self._kind = None
        self._range = None
        self._t0 = 0.0
        self._at = 0
        self._done: set = set()
        self.trace: Optional[DeviceTrace] = None      # the device stretch
        self.annotated: Optional[DeviceTrace] = None  # the annotated stretch

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if not (self.enabled and self.open):
            yield
            return
        import torch

        parent = self._stack[-1] if self._stack else None
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("pb:" + name):
                yield
        finally:
            self.spans.append((name, t0, time.perf_counter(), parent))
            self._stack.pop()

    def iteration(self, i: int) -> None:
        """Called by the driver at the top of loop iteration ``i`` (and once
        after its last): starts and stops the profiler at the stretches'
        ends."""
        if not (self.enabled and self.open):
            return
        a, b, c = self.profile
        self._at = i
        if i == a and "device" not in self._done and self._prof is None:
            self._start("device", i)
        elif i == b and self._kind == "device":
            self._stop()
            self._start("annotated", i)
        elif i == c and self._kind == "annotated":
            self._stop()

    def _start(self, kind: str, i: int) -> None:
        import torch

        _sync()
        acts = []
        if kind == "annotated" or not torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CPU)
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._kind, self._first = kind, i
        if kind == "annotated":
            self._range = torch.profiler.record_function(PROFILED)
            self._range.__enter__()
        self._t0 = time.perf_counter()

    def _stop(self) -> None:
        """End the running stretch and read its trace at once: a later
        profiler session in the process clears what an earlier one kept."""
        _sync()
        wall = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self._prof.__exit__(None, None, None)
        n_iter = self._at - self._first
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / f"{self.tag}.{self._kind}.trace.json"
        self._prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        if self._kind == "device":
            self.trace = DeviceTrace(events, n_iter, window_s=wall)
        else:
            self.annotated = DeviceTrace(events, n_iter)
        self._done.add(self._kind)
        self._prof = self._kind = None

    def span_s(self, *names: str) -> float:
        """Host seconds inside the spans called any of ``names``."""
        return sum(b - a for n, a, b, _ in self.spans if n in names)

    def span_count(self, name: str) -> int:
        return sum(1 for n, *_ in self.spans if n == name)

    def finish(self) -> None:
        """Stop a profiler still running and write the spans under
        ``out_dir``."""
        self.open = False
        if not self.enabled:
            return
        if self._prof is not None:
            self._stop()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        (self.out_dir / f"{self.tag}.spans.json").write_text(json.dumps(
            [{"name": n, "start": a, "end": b, "parent": p} for n, a, b, p in self.spans]))
