"""Device milliseconds per call of WavMark's invertible network: the
kernels launched inside the port's ``wavmark.inn`` ranges (one per pass,
two an embed+detect: 24 dense subnets each), in the annotated stretch.
Kernels are matched to the ranges through their launches' correlation ids,
the runtime's launches and the driver's (cuDNN launches through either), so
the annotated stretch's Chrome trace is read again for the driver's. None
on a port without the ranges."""

import json
from pathlib import Path

RANGE = "wavmark.inn"


def launched_kernel_s(record, names) -> float:
    """Device seconds of the annotated stretch's kernels launched inside
    the host ranges called any of ``names`` (0 where there are none)."""
    tr, tracer = record["annotated"], record["tracer"]
    path = Path(tracer.out_dir) / f"{tracer.tag}.annotated.trace.json"
    if tr is None or not path.exists():
        return 0.0
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
             for e in events if e.get("cat") == "user_annotation" and e.get("name") in names]
    if not spans:
        return 0.0
    ids = {e.get("args", {}).get("correlation") for e in events
           if e.get("cat") in ("cuda_runtime", "cuda_driver")
           and any(a <= float(e["ts"]) <= b and tid == e.get("tid") for a, b, tid in spans)}
    return sum(float(k["dur"]) for k in tr.kernels
               if k.get("args", {}).get("correlation") in ids) * 1e-6


def read(record):
    tr = record["annotated"]
    if tr is None or not tr.n_iter:
        return None
    s = launched_kernel_s(record, {RANGE})
    return s / tr.n_iter * 1e3 if s > 0 else None
