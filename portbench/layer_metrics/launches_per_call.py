"""Kernel launches per served call, from the device stretch's device
trace."""


def read(record):
    tr = record["trace"]
    if tr is None or not tr.n_iter or not tr.kernels:
        return None
    return len(tr.kernels) / tr.n_iter
