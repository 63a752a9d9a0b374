"""The share of a traced block in which no operation ran on the device, in %."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
