"""Host milliseconds per training step of the loop's own work: the batch,
the controllers' inputs, the scheduler's attacks and the draws
(``host_inputs``), feeding the scheduler and the controllers (``feed``) and
starting the metrics' copy back (``readback``), over the window."""


def read(record):
    t = record["tracer"]
    steps = record["window"].get("steps")
    if not steps or not t.spans:
        return None
    return t.span_s("host_inputs", "feed", "readback") / steps * 1e3
