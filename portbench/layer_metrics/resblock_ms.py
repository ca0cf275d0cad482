"""Device milliseconds per call of AudioSeal's residual blocks: the kernels
launched inside the port's ``seanet.resblock`` ranges (one per block call,
twelve an embed+detect: the convs' weight norms, the weights' packing and
the fused kernel), matched through their launches' correlation ids, in the
annotated stretch. None on a port without the ranges."""

RANGE = "seanet.resblock"


def read(record):
    tr = record["annotated"]
    if tr is None or not tr.n_iter:
        return None
    s = tr.range_kernel_s(RANGE)
    return s / tr.n_iter * 1e3 if s > 0 else None
