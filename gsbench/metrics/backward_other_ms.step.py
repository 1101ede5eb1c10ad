"""Device ms a step of the kernels the autograd engine's nodes launch,
less the compositing backward (K2, taken by its kernel's name, since its
launch is filed under the engine's node): the eager chain's backward."""

K2 = "rasterize_bwd"


def read(run):
    def node(s):
        return s.startswith("autograd::engine::evaluate_function")

    ms, n = run.trace.device_ms(span=node)
    k2, _ = run.trace.device_ms(span=node, kernel=lambda k: K2 in k)
    return (ms - k2) / run.steps if n else None
