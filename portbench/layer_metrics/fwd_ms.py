"""Device milliseconds per training step of the port's ``step.forward``
span (the composite forward), from the CUDA events at its ends, over the
``train_step`` roots of the device stretch."""

from pbcore.program_spans import TRAIN, device_ms, per_root


def read(record):
    return per_root(record, TRAIN, lambda tree: device_ms(tree, "step.forward"))
