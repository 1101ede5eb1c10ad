"""The port's spans and counters (``utils/tracing.py``): free with no
profiler, and under one, a training step's spans nested as the benchmark's
readers expect and its counter record.

The card's case builds its trainer from the benchmark's tiny cell and
imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_tracing.py -q -m cuda
"""

import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsbench.trace import Trace
from vcr_gaus_tpu_torch.train import trainer as T
from vcr_gaus_tpu_torch.utils import tracing

INSIDE_STEP = ("train.upload", "render.project", "render.binning",
               "render.binning.readback", "train.losses", "train.adam")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from fixtures import write_colmap_scene

    root = str(tmp_path_factory.mktemp("tracing_scene"))
    write_colmap_scene(root, n_cams=3, n_pts=150, width=48, height=32)
    return root


@pytest.fixture
def cpu_trainer(scene_dir, tmp_path):
    from test_torch_debug_hooks import config

    return T.Trainer(config(scene_dir, tmp_path), device="cpu")


def profiled_step(trainer, device, tmp_path):
    """One ``train_step`` under the profiler inside a ``gsbench.window``
    span, as the benchmark traces it: (Trace, the step's record, aux)."""
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("gsbench.window"):
            _, aux = trainer.train_step()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    return Trace.load(path), tracing.steps(1)[0], aux


def spans_of(trace, name):
    return [(s, e) for evs in trace.host.values()
            for s, e, n in evs if n == name]


def test_no_profiler_no_span_no_record(cpu_trainer, monkeypatch):
    def refused(name):
        raise AssertionError(f"a profiler handle for {name!r}")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not tracing.enabled()
    null = tracing.span("render.project")
    assert tracing.span("train.adam") is null
    assert tracing.step(1, "cpu") is null
    with null:
        pass
    before = tracing.steps(tracing.MAX_STEPS)
    tracing.count("render.entries", 5)
    cpu_trainer.train_step()
    assert tracing.steps(tracing.MAX_STEPS) == before


def test_a_step_under_the_profiler(cpu_trainer, tmp_path):
    it = cpu_trainer.iteration + 1
    trace, record, aux = profiled_step(cpu_trainer, "cpu", tmp_path)
    (step,) = spans_of(trace, "train.step")
    for name in INSIDE_STEP:
        inner = spans_of(trace, name)
        assert inner, name
        assert all(step[0] <= s and e <= step[1] for s, e in inner), name
    (readback,) = spans_of(trace, "render.binning.readback")
    (binning,) = spans_of(trace, "render.binning")
    assert binning[0] <= readback[0] and readback[1] <= binning[1]
    # the span opened inside autograd's backward records too
    assert spans_of(trace, "render.composite_backward")
    assert not spans_of(trace, "train.reset_opacity")
    # the Gaussians given a tile (held to the reference's binning in
    # test_torch_m360.py)
    (binned,) = record["render.binned"]
    assert 0 < binned <= min(int(cpu_trainer.state.active.sum()),
                             aux["num_entries"])
    # a fresh trainer's first step uploads its view itself (a miss)
    assert record == {"iteration": it,
                      "train.upload.prefetched": [0],
                      "render.preprocess.slots": [
                          cpu_trainer.state.capacity],
                      "render.entries": [aux["num_entries"]],
                      "render.binned": [binned],
                      "render.binning.kernel": [0]}


def test_the_curvature_span_is_inside_the_losses(scene_dir, cpu_trainer,
                                                 tmp_path):
    """With the curvature weighted and its gate open (the ScanNet++
    recipe's), a step holds ``train.losses.curv`` inside ``train.losses``;
    a step with the term off has no such span."""
    from test_torch_debug_hooks import config

    off, _, _ = profiled_step(cpu_trainer, "cpu", tmp_path)
    assert spans_of(off, "train.losses") and not spans_of(
        off, "train.losses.curv")
    trainer = T.Trainer(config(scene_dir, tmp_path, **{
        "optim.loss_weight.depth_normal": 0.01,
        "optim.loss_weight.curv": 0.05,
        "optim.curv_from_iter": 0}), device="cpu")
    trace, _, _ = profiled_step(trainer, "cpu", tmp_path)
    (losses,) = spans_of(trace, "train.losses")
    (curv,) = spans_of(trace, "train.losses.curv")
    assert losses[0] <= curv[0] and curv[1] <= losses[1]


def test_records_are_bounded_and_closed():
    first = tracing.steps(tracing.MAX_STEPS)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(tracing.MAX_STEPS + 3):
            with tracing.step(i, "cpu"):
                tracing.count("render.entries", i)
                tracing.count("render.entries", 1)
        tracing.count("render.entries", 7)     # no record open: dropped
    got = tracing.steps(tracing.MAX_STEPS + 10)
    assert len(got) == tracing.MAX_STEPS and got != first
    assert got[-1] == {"iteration": tracing.MAX_STEPS + 2,
                       "render.entries": [tracing.MAX_STEPS + 2, 1]}
    assert tracing.steps(2) == got[-2:] and tracing.steps(0) == []


@pytest.mark.cuda
def test_the_card_step_counts_allocator_calls(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the compositing kernels have no "
                    "CPU mode")
    from gsbench import build as BLD
    from gsbench import harness as H
    from gsbench.tests.tiny import SEED, TINY

    c = H.cell("dtu.step_late", overrides=TINY)
    scene = BLD.make_scene(c.cfg, SEED, str(tmp_path / "scene"), "cuda")
    trainer = BLD.build_trainer(c.cfg, scene, SEED, "cuda")
    trainer.train_step()
    trace, record, aux = profiled_step(trainer, "cuda", tmp_path)
    assert record["render.entries"] == [aux["num_entries"]]
    (binned,) = record["render.binned"]
    assert 0 < binned <= aux["num_entries"]
    # the card's view is binned by the kernels
    assert record["render.binning.kernel"] == [1]
    (calls,) = record["cuda.alloc_calls"]
    assert isinstance(calls, int) and calls >= 0
    # the update kernel's counter, on the card's path alone
    assert record["train.adam.slots"] == [trainer.state.capacity]
    assert spans_of(trace, "train.upload")
    assert spans_of(trace, "render.composite_backward")
