"""Share of the walked slots that binning gave a tile, over the traced
views: the mean of the program's ``render.binned`` (the Gaussians binning
gave at least one tile, read with the entry count) over its
``render.preprocess.slots`` (the slots the preprocess walked for the same
view), in %. Nothing where the program lacks either counter, or where
the trace does not hold a ``train.step`` span for each traced step (the
records are then not of this window)."""

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
    shares = [100.0 * b / s for r in records(run) or ()
              for b, s in zip(r.get("render.binned", ()),
                              r.get("render.preprocess.slots", ()))
              if s]
    return sum(shares) / len(shares) if shares else None
