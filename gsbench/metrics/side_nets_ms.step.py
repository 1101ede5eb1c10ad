"""Device ms a step of the kernels launched inside ``train.side_nets``:
the side networks' Adam. Nothing where no kernel runs there."""


def span_ms(run, span):
    ms, n = run.trace.device_ms(span=span)
    return ms / run.steps if n else None


def read(run):
    return span_ms(run, lambda s: s == "train.side_nets")
