"""The port's own spans (``waveverify_torch.spans``) in a traced run, on
the device stretch's clock, for the readers whose ``source`` is
``program_span``.

The port records its spans while a profiler runs, so a traced run leaves
in the process those of both stretches. :func:`kept_roots` drains them
once per run, maps each root onto the device stretch's Chrome trace by its
``baseTimeNanoseconds`` and keeps the roots that lie mostly inside the
stretch (``record["trace"].lo`` to ``.hi``). The host's waits on the card
are read from the same trace: the CUDA runtime's blocking calls
(:func:`blocking`) that start inside a root. :func:`idle_by_span` splits
the stretch's idle time by the innermost span open when each gap began;
it is written with the spans beside the stretch's trace, as
``<tag>.program_spans.json``. A port without spans, or a run without a
device stretch, gives nothing, and the readers None.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from pbcore.trace import gaps

KEY = "program_spans"
TRAIN = ("train_step",)  # a step's root
SERVE = ("api.embed_batch", "api.detect_batch")  # an embed+detect call's roots
# runtime calls that return only once the card has caught up
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def blocking(name: str) -> bool:
    """Whether the CUDA runtime call ``name`` blocks the host on the card:
    a synchronise, or a copy that is not ``Async``."""
    base = name.split("_v")[0]  # a CUPTI version suffix
    return base in SYNCS or (base.startswith("cudaMemcpy") and "Async" not in base)


def _load(record) -> Optional[Tuple[List[dict], int]]:
    tracer, tr = record.get("tracer"), record.get("trace")
    if tracer is None or tr is None:
        return None
    try:
        from waveverify_torch import spans
    except ImportError:
        return None
    out = Path(tracer.out_dir)
    trace = out / f"{tracer.tag}.device.trace.json"
    if not trace.exists():
        return None
    base_ns = int(json.loads(trace.read_text()).get("baseTimeNanoseconds", 0))
    records, _ = spans.drain()
    (out / f"{tracer.tag}.program_spans.json").write_text(json.dumps(
        {"baseTimeNanoseconds": base_ns, "lo_us": tr.lo, "hi_us": tr.hi,
         "n_iter": tr.n_iter, "idle_ms_by_span": idle_by_span(tr, records, base_ns),
         "spans": records}))
    return records, base_ns


def _interval(span: dict, base_ns: int) -> Tuple[float, float]:
    """The span on the trace's clock (us)."""
    return (span["start_ns"] - base_ns) / 1e3, (span["end_ns"] - base_ns) / 1e3


def kept_roots(record, name: str) -> List[List[dict]]:
    """The spans of each root called ``name`` that lies mostly inside the
    device stretch (each root with all its descendants)."""
    if KEY not in record:
        record[KEY] = _load(record)
    if record[KEY] is None:
        return []
    records, base_ns = record[KEY]
    tr = record["trace"]
    out = []
    for r in records:
        if r["parent"] is None and r["name"] == name:
            lo, hi = _interval(r, base_ns)
            if min(hi, tr.hi) - max(lo, tr.lo) > 0.5 * (hi - lo):
                out.append([s for s in records if s["root"] == r["id"]])
    return out


def per_root(record, roots: Sequence[str],
             value: Callable[[List[dict]], Optional[float]]) -> Optional[float]:
    """The sum over the root names ``roots`` of the mean of ``value`` over
    the kept roots of that name: per step for ``("train_step",)``, per
    embed+detect call for ``("api.embed_batch", "api.detect_batch")``.
    None where a name has no root kept or ``value`` gives None."""
    total = 0.0
    for name in roots:
        values = [value(tree) for tree in kept_roots(record, name)]
        if not values or any(v is None for v in values):
            return None
        total += sum(values) / len(values)
    return total


def device_ms(tree: List[dict], name: str) -> Optional[float]:
    """Device ms of the spans called ``name`` (0 where there is none);
    None where one was not timed on the card."""
    times = [s["device_ms"] for s in tree if s["name"] == name]
    return None if None in times else float(sum(times))


def host_ms(tree: List[dict], *names: str) -> float:
    """Host ms inside the spans called any of ``names``."""
    return sum(s["end_ns"] - s["start_ns"] for s in tree if s["name"] in names) / 1e6


def host_waits(record, tree: List[dict]) -> Optional[int]:
    """The host's waits on the card in the tree: the blocking runtime calls
    of the device stretch's trace that start inside its root. None where
    the trace holds no runtime call at all."""
    tr = record["trace"]
    if not tr.runtime:
        return None
    if "blocking_us" not in record:
        record["blocking_us"] = [float(e["ts"]) for e in tr.runtime if blocking(e["name"])]
    lo, hi = _interval(next(s for s in tree if s["parent"] is None), record[KEY][1])
    return sum(1 for t in record["blocking_us"] if lo <= t <= hi)


def _innermost(spans: Sequence[dict], base_ns: int, times: Sequence[float]
               ) -> List[Optional[str]]:
    """For each of ``times`` (us on the trace's clock, ascending), the name
    of the innermost span open then, the one that started last; None where
    none is open. A span is open from its start to its end, both included."""
    ivs = [_interval(s, base_ns) for s in spans]
    # at one instant starts come before ends
    marks = sorted([(lo, 0, i) for i, (lo, _) in enumerate(ivs)]
                   + [(hi, 1, i) for i, (_, hi) in enumerate(ivs)])
    out, open_, j = [], [], 0
    for t in times:
        while j < len(marks) and (marks[j][0] < t or (marks[j][0] == t and not marks[j][1])):
            _, end, i = marks[j]
            if end:
                open_.remove(i)
            else:
                open_.append(i)
            j += 1
        out.append(spans[open_[-1]]["name"] if open_ else None)
    return out


def idle_by_span(tr, spans: Sequence[dict], base_ns: int) -> Dict[str, float]:
    """Idle ms per iteration of the stretch ``tr`` (a ``DeviceTrace``) by
    the innermost span open when each gap with no device operation began
    (``outside`` for none); the values sum to the stretch's idle time."""
    idle = gaps(tr._iv(tr.device), tr.lo, tr.hi)
    out: Dict[str, float] = {}
    for (a, b), name in zip(idle, _innermost(spans, base_ns, [a for a, _ in idle])):
        label = "outside" if name is None else name
        out[label] = out.get(label, 0.0) + (b - a) / 1e3 / max(tr.n_iter, 1)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
