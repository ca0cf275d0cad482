"""AudioSeal's recurrences' share of their roofline per embed+detect call
(%): the least time the card could take for the call's three LSTMs (each
LSTM's larger of its FLOP over the TF32 peak and its bytes over the memory
bandwidth, from its shape by ``counts_audioseal``: weights, inputs and
outputs counted once) over the recurrences' device time (``lstm_ms``)."""

from counts_audioseal import lstm_bound_s
from layer_metrics.lstm_ms import recurrence_s


def read(record):
    tr = record["annotated"]
    if tr is None or not tr.n_iter:
        return None
    busy = recurrence_s(tr) / tr.n_iter
    if busy <= 0:
        return None
    cfg, wl = record["config"], record["workload"]
    t = int(round(wl["clip_s"] * cfg["sample_rate"]))
    return lstm_bound_s(cfg["model"]["generator"]["seanet"], wl["batch"], t) / busy * 100.0
