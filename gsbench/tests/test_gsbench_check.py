"""The check at a tiny size on the CPU: the program's plain path against the
reference (``correct`` true), each fault the cells can have (``correct``
false), the control in bfloat16 failing a limit; and on the card, the
same control at a size a test run holds."""

from __future__ import annotations

import pytest
import torch

from gsbench import build as BLD
from gsbench import control as CTL
from gsbench import faults as FLT
from gsbench import harness as H
from gsbench.tests.tiny import CELLS, SEED, TINY


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = H.run(workload, SEED, 0.2, False, "cpu", overrides=TINY)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "step_ms", "step_p95_ms"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", FLT.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    build = BLD.build_trainer
    held = {}

    def broken(*a, **k):
        trainer = build(*a, **k)
        cm = FLT.planted(fault, trainer)
        cm.__enter__()
        held["cm"] = cm
        return trainer

    monkeypatch.setattr(BLD, "build_trainer", broken)
    try:
        res = H.run(workload, SEED, 0.2, False, "cpu", overrides=TINY)
    finally:
        held["cm"].__exit__(None, None, None)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(workload):
    out = CTL.readings(workload, SEED, "cpu", False, TINY)
    limits = H.cell(workload).limits
    assert all(out["sound"][k] <= limits[k] for k in limits), out
    assert any(out["control"][k] > limits[k] for k in limits), out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the compositing kernels have no "
                    "CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(card, workload):
    out = CTL.readings(workload, SEED, card, True, TINY)
    limits = H.cell(workload).limits
    assert all(out["sound"][k] <= limits[k] for k in limits), out
    for name in ("control", *FLT.PLANTED):
        assert any(out[name][k] > limits[k] for k in limits), (name, out)
