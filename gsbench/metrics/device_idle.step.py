"""The share of the traced window in which no operation ran on the device
(the union of the device operations' intervals, overlapping streams
counted once)."""


def read(run):
    if run.trace.window_s <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
