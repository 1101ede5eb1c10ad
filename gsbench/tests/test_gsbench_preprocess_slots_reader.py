"""The reader of the preprocess's slot counter, on hand-made records and on
the tiny cell traced on the CPU."""

from __future__ import annotations

import collections

import pytest

from gsbench import harness as H
from gsbench.tests.test_gsbench_tracing_readers import EVENTS, read, traced, x
from gsbench.tests.tiny import SEED, TINY
from vcr_gaus_tpu_torch.utils import tracing


@pytest.fixture
def records(monkeypatch):
    held = collections.deque(maxlen=tracing.MAX_STEPS)
    monkeypatch.setattr(tracing, "_records", held)
    return held


def test_preprocess_slots_finds_nothing_without_records(records):
    assert read("preprocess_slots.step", traced(EVENTS)) is None


def test_preprocess_slots_reads_the_traced_steps(records):
    records.append({"iteration": 1, "render.preprocess.slots": [7]})
    records.append({"iteration": 2, "render.preprocess.slots": [4096, 4096]})
    records.append({"iteration": 3, "render.preprocess.slots": [1024]})
    two = EVENTS + [x("user_annotation", "train.step", 905, 90)]
    assert read("preprocess_slots.step", traced(two, 2)) == (
        2 * 4096 + 1024) / 3
    # a program that keeps no such counter reads nothing
    records.append({"iteration": 4, "render.entries": [5]})
    records.append({"iteration": 5, "render.entries": [6]})
    assert read("preprocess_slots.step", traced(two, 2)) is None
    # the records are not this trace's: it holds fewer train.step spans
    assert read("preprocess_slots.step", traced(EVENTS, 2)) is None


@pytest.mark.parametrize("workload", ("dtu.step_late", "tnt.step_late"))
def test_preprocess_slots_on_the_tiny_cell(workload):
    """The preprocess walks every slot of the tiny cell once a view."""
    res = H.run(workload, SEED, 0.2, True, "cpu", overrides=TINY)
    assert res["metrics"]["preprocess_slots.step"]["value"] == (
        TINY["config"]["tpu"]["capacity"])
    assert res["correct"]
