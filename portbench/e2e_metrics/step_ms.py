"""Milliseconds per training step: the window's wall time (host clock,
until the last step's metrics are back) over the steps it completed."""


def read(record):
    w = record["window"]
    if not w.get("steps"):
        return None
    return (w["t_end"] - w["t_start"]) / w["steps"] * 1e3
