"""Share of the device stretch in which no operation ran on the device
(%): 1 - the union of the device operations' intervals over its wall
time."""


def read(record):
    tr = record["trace"]
    if tr is None or not tr.device:
        return None
    return (1.0 - tr.busy_s / tr.window_s) * 100.0
