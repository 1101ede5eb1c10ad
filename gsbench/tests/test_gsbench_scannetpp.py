"""The room cell ``scannetpp.step_late`` at a tiny size on the CPU: the
program's plain path against the reference (``correct`` true), each fault
the cells can have (``correct`` false), the control in bfloat16 failing a
limit; the manifest's new entries found by name; and on the card, the
control and the faults at a size a test run holds."""

from __future__ import annotations

import json
import os

import pytest
import torch

from gsbench import control as CTL
from gsbench import faults as FLT
from gsbench import harness as H
from gsbench.drivers import train_steps_room as RD
from gsbench.tests.tiny import SEED
from gsbench.tests.tiny_room import CELL, TINY

# the per-layer metrics of the other cells that the room cell reports too
# (it has no side networks)
SHARED = ("project_ms.step", "binning_ms.step", "k1_roofline.step",
          "k2_roofline.step", "losses_ms.step", "backward_other_ms.step",
          "adam_ms.step", "device_idle.step", "step_mfu", "upload_ms.step",
          "upload_idle_ms.step", "readback_idle_ms.step",
          "entries_per_view.step", "alloc_calls.step",
          "preprocess_slots.step", "binned_share.step",
          "entries_per_binned.step")


def test_sound_run_is_correct():
    res = H.run(CELL, SEED, 0.2, False, "cpu", overrides=TINY)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "step_ms", "step_p95_ms"}


@pytest.mark.parametrize("fault", FLT.FAULTS)
def test_fault_is_not_correct(fault, monkeypatch):
    build = RD.build_trainer
    held = {}

    def broken(*a, **k):
        trainer = build(*a, **k)
        cm = FLT.planted(fault, trainer)
        cm.__enter__()
        held["cm"] = cm
        return trainer

    monkeypatch.setattr(RD, "build_trainer", broken)
    try:
        res = H.run(CELL, SEED, 0.2, False, "cpu", overrides=TINY)
    finally:
        held["cm"].__exit__(None, None, None)
    assert not res["correct"], res["checks"]


def test_control_fails_a_limit():
    out = CTL.readings(CELL, SEED, "cpu", False, TINY)
    limits = H.cell(CELL).limits
    assert all(out["sound"][k] <= limits[k] for k in limits), out
    assert any(out["control"][k] > limits[k] for k in limits), out


def test_the_traced_line_holds_the_depth_range():
    res = H.run(CELL, SEED, 0.2, True, "cpu", overrides=TINY)
    assert res["correct"], res["checks"]
    ranges = res["depth_range"]
    assert len(ranges) == len(res["census"]) == 2
    assert all(0.2 < lo < hi for lo, hi in ranges)


def test_the_new_entries_point_at_files():
    bench = H.manifest()
    (conf,) = [c for c in bench["configs"] if c["name"] == "scannetpp_base"]
    assert os.path.isfile(os.path.join(H.ROOT, conf["file"]))
    assert conf["reduced"] == ["tpu", "bench"]
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == (
        "scannetpp_base", "step_late_room", 1)
    with open(os.path.join(H.HERE, "traffic", w["traffic"] + ".json")) as f:
        kind = json.load(f)["kind"]
    assert os.path.isfile(os.path.join(H.HERE, "drivers", kind + ".py"))
    assert os.path.isfile(os.path.join(H.HERE, "checks", CELL + ".json"))
    (m,) = [m for m in bench["per_layer"] if m["name"] == "curv_ms.step"]
    assert m["workloads"] == [CELL] and m["moves"] == "step_ms"
    assert os.path.isfile(os.path.join(H.HERE, "metrics",
                                       "curv_ms.step.py"))
    listed = {m["name"] for m in bench["per_layer"]
              if CELL in m.get("workloads", [CELL])}
    assert set(SHARED) | {"curv_ms.step"} == listed


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the compositing kernels have no "
                    "CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    out = CTL.readings(CELL, SEED, card, True, TINY)
    limits = H.cell(CELL).limits
    assert all(out["sound"][k] <= limits[k] for k in limits), out
    for name in ("control", *FLT.PLANTED):
        assert any(out[name][k] > limits[k] for k in limits), (name, out)
