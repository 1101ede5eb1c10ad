"""The readers of the program's own spans and counters (the view upload,
binning's readback, the entries a view, the allocator's calls) on a
hand-made device trace, and on the tiny cell traced on the CPU."""

from __future__ import annotations

import collections
import math

import pytest

from gsbench import harness as H
from gsbench.reference import render as RR
from gsbench.tests.tiny import SEED, TINY
from gsbench.trace import Trace
from vcr_gaus_tpu_torch.utils import tracing

PEAKS = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


def x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
         "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# busy [0, 30], [60, 80], [150, 160], [250, 400]; gaps open at 30 and 80
# (inside train.upload), at 160 (inside the readback) and at 400 (in the
# step alone)
EVENTS = [
    x("user_annotation", "gsbench.window", 0, 1000),
    x("user_annotation", "train.step", 0, 900),
    x("kernel", "last_steps_adam", 0, 30, tid=7),
    x("user_annotation", "train.upload", 5, 95),
    x("cpu_op", "aten::copy_", 10, 80),
    x("cuda_runtime", "cudaMemcpyAsync", 20, 5, corr=1),
    x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 60, 20, tid=7,
      corr=1),
    x("user_annotation", "render.binning", 120, 180),
    x("cuda_runtime", "cudaLaunchKernel", 125, 5, corr=2),
    x("kernel", "reduce_kernel", 150, 10, tid=7, corr=2),
    x("user_annotation", "render.binning.readback", 130, 70),
    x("cpu_op", "aten::_local_scalar_dense", 135, 60),
    x("cuda_runtime", "cudaLaunchKernel", 210, 5, corr=3),
    x("kernel", "sort_kernel", 250, 150, tid=7, corr=3),
]


def traced(events, steps=1):
    return H.Traced(Trace(events), steps, [], 0.01, PEAKS)


def read(name, run):
    return H.load_reader(name)(run)


def test_a_gap_opened_in_the_upload_is_the_uploads():
    run = traced(EVENTS)
    assert math.isclose(read("upload_idle_ms.step", run), (30 + 70) / 1e3)
    assert math.isclose(read("readback_idle_ms.step", run), 90 / 1e3)
    # gaps the step alone holds count for neither
    gaps = dict(run.trace.idle_gaps())
    assert math.isclose(gaps["train.step"], 600e-6)
    assert math.isclose(read("upload_idle_ms.step", traced(EVENTS, 2)),
                        (30 + 70) / 2e3)


def test_a_copy_launched_in_the_upload_is_the_uploads():
    run = traced(EVENTS)
    assert math.isclose(read("upload_ms.step", run), 0.02)


def test_spans_with_nothing_in_them_read_zero():
    # no gap opens inside the spans, no operation is launched there
    quiet = [e for e in EVENTS if e.get("args", {}).get("correlation") != 1]
    quiet += [x("kernel", "fill", 30, 95, tid=7),
              x("kernel", "fill", 160, 90, tid=7)]
    run = traced(quiet)
    assert read("upload_ms.step", run) == 0
    assert read("upload_idle_ms.step", run) == 0
    assert read("readback_idle_ms.step", run) == 0


def test_span_readers_find_nothing_without_their_spans():
    bare = [e for e in EVENTS if e["name"] not in
            ("train.upload", "render.binning.readback")]
    for name in ("upload_ms.step", "upload_idle_ms.step",
                 "readback_idle_ms.step"):
        assert read(name, traced(bare)) is None, name


@pytest.fixture
def records(monkeypatch):
    held = collections.deque(maxlen=tracing.MAX_STEPS)
    monkeypatch.setattr(tracing, "_records", held)
    return held


def test_counter_readers_find_nothing_without_records(records):
    run = traced(EVENTS)
    assert read("entries_per_view.step", run) is None
    assert read("alloc_calls.step", run) is None


def test_counter_readers_read_the_traced_steps(records):
    records.append({"iteration": 1, "render.entries": [999],
                    "cuda.alloc_calls": [50]})
    records.append({"iteration": 2, "render.entries": [10, 30],
                    "cuda.alloc_calls": [4]})
    records.append({"iteration": 3, "render.entries": [20],
                    "cuda.alloc_calls": [0]})
    two = EVENTS + [x("user_annotation", "train.step", 905, 90)]
    assert read("entries_per_view.step", traced(two, 2)) == 20
    assert read("alloc_calls.step", traced(two, 2)) == 2
    # a record without the allocator's counter (a CPU step) reads nothing
    records.append({"iteration": 4, "render.entries": [5]})
    assert read("alloc_calls.step", traced(two, 2)) is None
    # the records are not this trace's: it holds fewer train.step spans
    assert read("entries_per_view.step", traced(EVENTS, 2)) is None
    assert read("alloc_calls.step", traced(EVENTS, 2)) is None


@pytest.mark.parametrize("workload", ("dtu.step_late", "tnt.step_late"))
def test_entries_per_view_on_the_tiny_cell(workload, monkeypatch):
    """The program's binned entries a view equal the reference's own
    binning of the same steps' views. The census counts only the entries of
    the 256-entry batches each tile composites before its early stop, so it
    is at most that, and equal where no tile stops early."""
    binned, census = [], RR.census

    def counted(feats, binn):
        binned.append(binn.sorted_gid.numel())
        return census(feats, binn)

    monkeypatch.setattr(RR, "census", counted)
    res = H.run(workload, SEED, 0.2, True, "cpu", overrides=TINY)
    entries = res["metrics"]["entries_per_view.step"]["value"]
    assert len(binned) == TINY["traffic"]["traced_steps"]
    assert entries == sum(binned) / len(binned)
    assert all(0 < c["entries"] <= b
               for c, b in zip(res["census"], binned, strict=True))
    for name in ("upload_ms.step", "upload_idle_ms.step",
                 "readback_idle_ms.step", "alloc_calls.step"):
        assert name not in res["metrics"], name     # the CPU has no device
    assert res["correct"]
