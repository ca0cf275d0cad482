"""The 95th percentile of the window's calls' latencies, host clock, from
the call to its numpy result."""

import numpy as np


def read(record):
    calls = record["window"].get("calls")
    if not calls:
        return None
    return float(np.percentile([b - a for a, b in calls], 95)) * 1e3
