"""WavMark's coupling subnets' share of their roofline per embed+detect
call (%): the least time the card could take for the call's 48 subnets
(each subnet's larger of its FLOP over the TF32 peak and its bytes over the
memory bandwidth, from its shape by ``counts_wavmark``: the subnet's input
read once, its output written once, its weights once) over the network's
device time (``inn_ms``)."""

from counts_wavmark import inn_bound_s
from layer_metrics.inn_ms import RANGE, launched_kernel_s


def read(record):
    tr = record["annotated"]
    if tr is None or not tr.n_iter:
        return None
    busy = launched_kernel_s(record, {RANGE}) / tr.n_iter
    if busy <= 0:
        return None
    model, wl = record["config"]["model"], record["workload"]
    t = int(round(wl["clip_s"] * record["config"]["sample_rate"]))
    return inn_bound_s(model, wl["batch"], t) / busy * 100.0
