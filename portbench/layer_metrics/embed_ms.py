"""Mean host milliseconds of ``embed_batch`` per call over the window,
from the benchmark's spans."""


def read(record):
    t = record["tracer"]
    n = t.span_count("embed_batch")
    return t.span_s("embed_batch") / n * 1e3 if n else None
