"""The most device memory allocated during the window (GiB), counted from a
reset at its start."""


def read(record):
    return record["peak_bytes"] / 2 ** 30 if record["peak_bytes"] else None
