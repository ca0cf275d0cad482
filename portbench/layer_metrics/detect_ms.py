"""Mean host milliseconds of ``detect_batch`` per call over the window,
from the benchmark's spans."""


def read(record):
    t = record["tracer"]
    n = t.span_count("detect_batch")
    return t.span_s("detect_batch") / n * 1e3 if n else None
