"""Host milliseconds per embed+detect call in the port's ``api.generator``
and ``api.detector`` spans: the host's enqueue of the two networks, over
the ``api.embed_batch`` and ``api.detect_batch`` roots of the device
stretch."""

from pbcore.program_spans import SERVE, host_ms, per_root


def read(record):
    return per_root(record, SERVE, lambda tree: host_ms(tree, "api.generator", "api.detector"))
