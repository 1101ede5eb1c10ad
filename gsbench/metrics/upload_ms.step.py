"""Device ms a step of the operations launched inside ``train.upload``:
the copies of the step's views and background to the device. Nothing
where the trace holds no such span."""

SPAN = "train.upload"


def read(run):
    t = run.trace
    if not t.device or not any(name == SPAN for evs in t.host.values()
                               for _, _, name in evs):
        return None
    ms, _ = t.device_ms(span=lambda s: s == SPAN)
    return ms / run.steps
