"""Device ms a step of the kernels launched inside ``train.adam``: the
Gaussians' Adam and the densification statistics."""


def span_ms(run, span):
    ms, n = run.trace.device_ms(span=span)
    return ms / run.steps if n else None


def read(run):
    return span_ms(run, lambda s: s == "train.adam")
