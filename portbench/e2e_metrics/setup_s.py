"""Seconds from the start of the process to the first timed call: loading,
the weights, the inputs, the warm-up of every shape the window uses, and
in the first run of a checkout the kernel build."""


def read(record):
    return record["setup_s"]
