"""The unbounded cell ``m360.step_late`` at a tiny size on the CPU: the
program's plain path against the reference (``correct`` true), each fault
the cells can have (``correct`` false), the control in bfloat16 failing a
limit; the readers of the binned Gaussians' counter on hand-made records;
the manifest's new entries found by name; and on the card, the control and
the faults at a size a test run holds."""

from __future__ import annotations

import collections
import json
import math
import os

import pytest
import torch

from gsbench import control as CTL
from gsbench import faults as FLT
from gsbench import harness as H
from gsbench.drivers import train_steps_unbounded as UD
from gsbench.tests.test_gsbench_tracing_readers import EVENTS, read, traced, x
from gsbench.tests.tiny import SEED
from gsbench.tests.tiny_unbounded import CELL, TINY
from vcr_gaus_tpu_torch.utils import tracing

NEW_READERS = ("binned_share.step", "entries_per_binned.step")
# the per-layer metrics of the two shells' cells that the unbounded cell
# reports too (it has no side networks)
SHARED = ("project_ms.step", "binning_ms.step", "k1_roofline.step",
          "k2_roofline.step", "losses_ms.step", "backward_other_ms.step",
          "adam_ms.step", "device_idle.step", "step_mfu", "upload_ms.step",
          "upload_idle_ms.step", "readback_idle_ms.step",
          "entries_per_view.step", "alloc_calls.step",
          "preprocess_slots.step")


def test_sound_run_is_correct():
    res = H.run(CELL, SEED, 0.2, False, "cpu", overrides=TINY)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "step_ms", "step_p95_ms"}


@pytest.mark.parametrize("fault", FLT.FAULTS)
def test_fault_is_not_correct(fault, monkeypatch):
    build = UD.build_trainer
    held = {}

    def broken(*a, **k):
        trainer = build(*a, **k)
        cm = FLT.planted(fault, trainer)
        cm.__enter__()
        held["cm"] = cm
        return trainer

    monkeypatch.setattr(UD, "build_trainer", broken)
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


def test_the_population_is_in_three_parts():
    """The object on its shell, the ground on its plane inside its radii,
    the surroundings inside theirs; each part's scale grows with its
    spacing."""
    cfg = H.cell(CELL, overrides=TINY).cfg
    pop = cfg["bench"]["population"]
    params, active = UD.make_population(cfg, SEED, "cpu")
    assert int(active.sum()) == pop["count"] == 3000
    xyz = params["xyz"][active]
    ls = params["log_scale"][active]
    r = torch.linalg.vector_norm(xyz, dim=1)
    obj = torch.isclose(r, torch.tensor(1.0), atol=1e-5)
    ground = xyz[:, 1] == -1.0
    back = ~obj & ~ground
    assert (int(obj.sum()), int(ground.sum()), int(back.sum())) == (
        500, 1000, 1500)
    rg = torch.linalg.vector_norm(xyz[ground][:, [0, 2]], dim=1)
    assert 1.2 <= float(rg.min()) and float(rg.max()) <= 40.0
    assert 4.0 <= float(r[back].min()) and float(r[back].max()) <= 40.0
    # the ground is thin along y, 0.1 of its spacing; the surroundings'
    # scale follows their radius
    thin = ls[ground][:, 1] - ls[ground][:, 0]
    assert abs(float(thin.mean()) - math.log(0.1)) < 0.02
    far = r[back] > 20
    assert float(ls[back][far].mean()) > float(ls[back][~far].mean()) + 1.0
    assert torch.equal(params["xyz"][~active],
                       torch.zeros_like(params["xyz"][~active]))


@pytest.fixture
def records(monkeypatch):
    held = collections.deque(maxlen=tracing.MAX_STEPS)
    monkeypatch.setattr(tracing, "_records", held)
    return held


def test_binned_readers_find_nothing_without_records(records):
    for name in NEW_READERS:
        assert read(name, traced(EVENTS)) is None, name


def test_binned_readers_read_the_traced_steps(records):
    records.append({"iteration": 1, "render.binned": [9],
                    "render.entries": [90],
                    "render.preprocess.slots": [10]})
    records.append({"iteration": 2, "render.binned": [100],
                    "render.entries": [500],
                    "render.preprocess.slots": [400]})
    records.append({"iteration": 3, "render.binned": [300],
                    "render.entries": [900],
                    "render.preprocess.slots": [400]})
    two = EVENTS + [x("user_annotation", "train.step", 905, 90)]
    assert math.isclose(read("binned_share.step", traced(two, 2)),
                        (25.0 + 75.0) / 2)
    assert math.isclose(read("entries_per_binned.step", traced(two, 2)),
                        (5.0 + 3.0) / 2)
    # the records are not this trace's: it holds fewer train.step spans
    for name in NEW_READERS:
        assert read(name, traced(EVENTS, 2)) is None, name


def test_binned_readers_find_nothing_at_a_program_without_the_counter(
        records):
    """A parent program records the entries and the slots, not the binned
    Gaussians."""
    for i in (1, 2):
        records.append({"iteration": i, "render.entries": [90],
                        "render.preprocess.slots": [10]})
    two = EVENTS + [x("user_annotation", "train.step", 905, 90)]
    for name in NEW_READERS:
        assert read(name, traced(two, 2)) is None, name


def test_the_tiny_cell_reads_the_binned_share():
    res = H.run(CELL, SEED, 0.2, True, "cpu", overrides=TINY)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    share = m["binned_share.step"]["value"]
    per = m["entries_per_binned.step"]["value"]
    assert 0 < share < 100 * 3000 / 4096
    assert per >= 1
    assert math.isclose(share / 100 * 4096 * per,
                        m["entries_per_view.step"]["value"], rel_tol=0.1)


def test_the_new_entries_point_at_files():
    bench = H.manifest()
    (conf,) = [c for c in bench["configs"] if c["name"] == "m360_base"]
    assert os.path.isfile(os.path.join(H.ROOT, conf["file"]))
    assert conf["reduced"] == ["tpu", "bench"]
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == (
        "m360_base", "step_late_unbounded", 1)
    with open(os.path.join(H.HERE, "traffic", w["traffic"] + ".json")) as f:
        kind = json.load(f)["kind"]
    assert os.path.isfile(os.path.join(H.HERE, "drivers", kind + ".py"))
    assert os.path.isfile(os.path.join(H.HERE, "checks", CELL + ".json"))
    for name in NEW_READERS:
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == ["dtu.step_late", "tnt.step_late", CELL]
        assert os.path.isfile(os.path.join(H.HERE, "metrics", name + ".py"))
    listed = {m["name"] for m in bench["per_layer"]
              if CELL in m.get("workloads", [CELL])}
    assert set(SHARED) | set(NEW_READERS) <= listed
    assert "side_nets_ms.step" not in listed


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
