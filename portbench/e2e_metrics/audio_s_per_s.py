"""Seconds of audio served over the window's wall seconds (host clock,
from the window's start to the end of its last call)."""


def read(record):
    w = record["window"]
    if "audio_s" not in w or not w["calls"]:
        return None
    return sum(w["audio_s"]) / (w["t_end"] - w["t_start"])
