"""Device milliseconds per training step of the port's ``step.update``
span (the all-reduce, the norms, the clip and scaling, AdamW, the
schedules, the scheduler's feedback), from the CUDA events at its ends,
over the ``train_step`` roots of the device stretch."""

from pbcore.program_spans import TRAIN, device_ms, per_root


def read(record):
    return per_root(record, TRAIN, lambda tree: device_ms(tree, "step.update"))
