"""Device idle ms a step over the idle gaps (as ``Trace.idle_gaps`` forms
them) that open inside a ``render.binning.readback`` span, on any thread:
the device drained while the host waits for binning's entry count. Nothing
where the trace holds no such span."""

SPAN = "render.binning.readback"


def read(run):
    t = run.trace
    spans = [(s, e) for evs in t.host.values() for s, e, name in evs
             if name == SPAN]
    if not t.device or not spans:
        return None
    lo, hi = t.window
    gaps, at = [], lo
    for s, e in t._busy():
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    idle = sum(e - s for s, e in gaps if any(a <= s < b for a, b in spans))
    return idle / 1e3 / run.steps
