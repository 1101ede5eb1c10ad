"""Device ms a step of the kernels launched inside ``train.losses.curv``:
the curvature of the depth normals and its mean, forward (its backward
runs in autograd's nodes, so in ``backward_other_ms.step``). Nothing where
the program has no such span."""


def span_ms(run, span):
    ms, n = run.trace.device_ms(span=span)
    return ms / run.steps if n else None


def read(run):
    return span_ms(run, lambda s: s == "train.losses.curv")
