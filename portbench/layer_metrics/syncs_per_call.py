"""The host's waits on the card per embed+detect call: the CUDA runtime's
blocking calls (a synchronise, a copy that is not ``Async``) that the
device stretch's trace shows inside one ``api.embed_batch`` and one
``api.detect_batch`` root, over the roots of the stretch."""

from pbcore.program_spans import SERVE, host_waits, per_root


def read(record):
    return per_root(record, SERVE, lambda tree: host_waits(record, tree))
