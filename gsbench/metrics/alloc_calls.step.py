"""The CUDA caching allocator's device allocations and frees a step
(``cudaMalloc`` and ``cudaFree`` calls, those of a failed allocation's
retry included): the mean over the traced steps of the program's
``cuda.alloc_calls`` counter. Nothing where the program keeps no step
records with it, or where the trace does not hold a ``train.step`` span
for each traced step (the records are then not of this window)."""

STEP = "train.step"
COUNTER = "cuda.alloc_calls"


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
    recs = records(run)
    if not recs or not all(COUNTER in r for r in recs):
        return None
    return sum(sum(r[COUNTER]) for r in recs) / len(recs)
