"""The host's waits on the card per training step: the CUDA runtime's
blocking calls (a synchronise, a copy that is not ``Async``) that the
device stretch's trace shows inside a ``train_step`` root, over the roots
of the stretch."""

from pbcore.program_spans import TRAIN, host_waits, per_root


def read(record):
    return per_root(record, TRAIN, lambda tree: host_waits(record, tree))
