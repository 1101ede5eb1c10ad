"""Tiles a binned Gaussian covers, over the traced views: the mean of the
program's ``render.entries`` over its ``render.binned`` (the Gaussians
binning gave at least one tile), both read back with the entry count.
Nothing where the program keeps no ``render.binned`` counter, or where the
trace does not hold a ``train.step`` span for each traced step (the records
are then not of this window)."""

STEP = "train.step"


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
    ratios = [e / b for r in records(run) or ()
              for e, b in zip(r.get("render.entries", ()),
                              r.get("render.binned", ()))
              if b]
    return sum(ratios) / len(ratios) if ratios else None
