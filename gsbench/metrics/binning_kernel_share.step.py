"""Share of the traced steps' views that binning's kernels binned, in %:
the mean of the program's ``render.binning.kernel`` counter (1 a view
binned by the hand-written passes of ``csrc/binning.cu``, 0 a view binned
by the plain chain), times 100. Nothing where the program keeps no such
counter, or where the trace does not hold a ``train.step`` span for each
traced step (the records are then not of this window)."""

STEP = "train.step"
COUNTER = "render.binning.kernel"


def records(run):
    try:
        from vcr_gaus_tpu_torch.utils import tracing
    except ImportError:
        return None
    lo, hi = run.trace.window
    n = sum(1 for evs in run.trace.host.values() for s, e, name in evs
            if name == STEP and lo <= s and e <= hi)
    return tracing.steps(run.steps) if run.steps and n >= run.steps else None


def read(run):
    values = [v for r in records(run) or () for v in r.get(COUNTER, ())]
    return 100.0 * sum(values) / len(values) if values else None
