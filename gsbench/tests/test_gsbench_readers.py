"""The trace reader and the per-layer metrics' readers, on a hand-made
device trace and on a small profile of the CPU (which has no device
operations, so every reader finds nothing)."""

from __future__ import annotations

import json
import math

import pytest
import torch

from gsbench import harness as H
from gsbench.trace import Trace

PEAKS = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


def x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
         "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    x("user_annotation", "gsbench.window", 0, 1000),
    x("user_annotation", "render.project", 10, 100),
    x("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
    x("kernel", "proj_kernel", 50, 30, tid=7, corr=1),
    x("user_annotation", "render.composite", 120, 30),
    x("cuda_runtime", "cudaLaunchKernel", 130, 5, corr=4),
    x("kernel", "void rasterize_fwd_kernel<0>", 150, 40, tid=7, corr=4),
    x("cpu_op", "autograd::engine::evaluate_function: XBackward", 200, 200,
      tid=2),
    x("cuda_runtime", "cudaLaunchKernel", 210, 5, tid=2, corr=2),
    x("kernel", "void rasterize_bwd_kernel<0>", 300, 100, tid=7, corr=2),
    x("cuda_runtime", "cudaLaunchKernel", 220, 5, tid=2, corr=3),
    x("kernel", "elementwise", 400, 50, tid=7, corr=3),
    x("user_annotation", "train.adam", 500, 10),
]
COUNTS = [{"k1_ops": 67_000_000, "k1_bytes": 0, "k2_ops": 0,
           "k2_bytes": 33_500_000, "step_ops": 67_000_000}]


@pytest.fixture
def run():
    return H.Traced(Trace(EVENTS), 1, COUNTS, 0.01, PEAKS)


def read(name, run):
    return H.load_reader(name)(run)


def test_span_device_times(run):
    assert math.isclose(read("project_ms.step", run), 0.03)
    assert math.isclose(read("backward_other_ms.step", run), 0.05)
    assert read("adam_ms.step", run) is None       # a span with no kernel
    assert read("side_nets_ms.step", run) is None  # no span at all
    assert read("binning_ms.step", run) is None


def test_rooflines_and_shares(run):
    # K1: 67e6 ops = 1 us at the peak over 40 us; K2: 33.5e6 bytes = 10 us
    # over 100 us
    assert math.isclose(read("k1_roofline.step", run), 2.5)
    assert math.isclose(read("k2_roofline.step", run), 10.0)
    assert math.isclose(read("step_mfu", run), 100 * 67e6 / 0.01 / 67e12)
    # busy: [50, 80], [150, 190], [300, 450] of a 1000 us window
    assert math.isclose(read("device_idle.step", run), 78.0)


def test_breakdown(run):
    t = run.trace
    assert math.isclose(t.busy_s(), 220e-6)
    assert math.isclose(t.window_s, 1e-3)
    assert t.top_ops(2)[0] == ["void rasterize_bwd_kernel<0>", 1e-4]
    gaps = dict(t.idle_gaps())
    assert math.isclose(gaps["render.project"], 70e-6)
    assert math.isclose(gaps["host idle"], (50 + 110 + 550) * 1e-6)


def test_readers_find_nothing_in_a_cpu_profile(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("gsbench.window"):
            with record_function("render.project"):
                torch.ones(64).cumsum(0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = Trace.load(str(path))
    assert trace.window_s > 0 and trace.device == []
    run = H.Traced(trace, 1, COUNTS, 0.01, PEAKS)
    for m in H.manifest()["per_layer"]:
        assert H.load_reader(m["name"])(run) is None, m["name"]


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        Trace([x("cpu_op", "aten::add", 0, 1)])
    assert json.dumps(EVENTS)
