"""Device ms a step of the kernels launched inside the ``render.project``
span: projection, SH, the normals and the packing."""


def span_ms(run, span):
    ms, n = run.trace.device_ms(span=span)
    return ms / run.steps if n else None


def read(run):
    return span_ms(run, lambda s: s == "render.project")
