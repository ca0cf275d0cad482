"""Device milliseconds per training step of the chains' plain backward:
the kernels launched inside the program's ``resblock_chain_ref_backward``
ranges, in the annotated stretch."""

RANGE = "resblock_chain_ref_backward"


def read(record):
    tr = record["annotated"]
    if tr is None or not tr.n_iter:
        return None
    s = tr.range_kernel_s(RANGE)
    return s / tr.n_iter * 1e3 if s > 0 else None
