"""AudioSeal's residual blocks' share of their roofline per embed+detect
call (%): the least time the card could take for the call's twelve blocks
(each block's larger of its FLOP over the TF32 peak and its bytes over the
memory bandwidth, from its shape by ``counts_resblock``: the block's input
read once, its output written once, its weights once) over the blocks'
device time (``resblock_ms``)."""

from counts_resblock import resblock_bound_s
from layer_metrics.resblock_ms import RANGE


def read(record):
    tr = record["annotated"]
    if tr is None or not tr.n_iter:
        return None
    busy = tr.range_kernel_s(RANGE) / tr.n_iter
    if busy <= 0:
        return None
    cfg, wl = record["config"], record["workload"]
    t = int(round(wl["clip_s"] * cfg["sample_rate"]))
    return resblock_bound_s(cfg["model"]["generator"]["seanet"], wl["batch"], t) / busy * 100.0
