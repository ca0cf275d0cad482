"""Device milliseconds per call of AudioSeal's recurrences: the time in
which a kernel launched inside one of the port's ``seanet.lstm`` ranges
(one per LSTM call) ran, in the annotated stretch. Kernels are matched to
the ranges through their launches' correlation ids (a replayed CUDA
graph's kernels carry its launch's), and their intervals are joined, since
a graph's kernels overlap their neighbours."""

from pbcore.trace import union_length

RANGE = "seanet.lstm"


def recurrence_s(tr) -> float:
    """Device seconds covered by the kernels launched inside ``RANGE``."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
             for e in tr.ranges if e["name"] == RANGE]
    ids = {r.get("args", {}).get("correlation") for r in tr.runtime
           if any(a <= float(r["ts"]) <= b and tid == r.get("tid") for a, b, tid in spans)}
    return union_length([(float(k["ts"]), float(k["ts"]) + float(k["dur"]))
                         for k in tr.kernels
                         if k.get("args", {}).get("correlation") in ids]) * 1e-6


def read(record):
    tr = record["annotated"]
    if tr is None or not tr.n_iter:
        return None
    s = recurrence_s(tr)
    return s / tr.n_iter * 1e3 if s > 0 else None
