"""Device ms a step of the kernels launched inside ``render.post`` and
``train.losses``: the channel post-processing, the semantic head and the
losses, forward."""


def span_ms(run, span):
    ms, n = run.trace.device_ms(span=span)
    return ms / run.steps if n else None


def read(run):
    return span_ms(run, lambda s: s in ("render.post", "train.losses"))
