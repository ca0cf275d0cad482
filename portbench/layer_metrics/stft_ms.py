"""Device milliseconds per call of WavMark's spectra: the kernels launched
inside the port's ``wavmark.stft`` and ``wavmark.istft`` ranges (three
STFTs and two inverses an embed+detect), matched as ``inn_ms`` matches
them, in the annotated stretch. None on a port without the ranges."""

from layer_metrics.inn_ms import launched_kernel_s

RANGES = {"wavmark.stft", "wavmark.istft"}


def read(record):
    tr = record["annotated"]
    if tr is None or not tr.n_iter:
        return None
    s = launched_kernel_s(record, RANGES)
    return s / tr.n_iter * 1e3 if s > 0 else None
