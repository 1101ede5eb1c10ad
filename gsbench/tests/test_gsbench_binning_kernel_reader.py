"""The reader of binning's kernel counter, on hand-made records, on a
program without the counter and on the tiny cell traced on the CPU."""

from __future__ import annotations

import collections

import pytest

from gsbench import harness as H
from gsbench.tests.test_gsbench_tracing_readers import EVENTS, read, traced, x
from gsbench.tests.tiny import SEED, TINY
from vcr_gaus_tpu_torch.utils import tracing

NAME = "binning_kernel_share.step"
TWO_STEPS = EVENTS + [x("user_annotation", "train.step", 905, 90)]


@pytest.fixture
def records(monkeypatch):
    held = collections.deque(maxlen=tracing.MAX_STEPS)
    monkeypatch.setattr(tracing, "_records", held)
    return held


def test_binning_kernel_share_finds_nothing_without_records(records):
    assert read(NAME, traced(EVENTS)) is None


@pytest.mark.parametrize("views, share", [
    (([1], [1]), 100.0),
    (([0], [0]), 0.0),
    # only the last two records are the traced steps'
    (([0], [1, 1, 0], [1]), 75.0),
])
def test_binning_kernel_share_reads_the_traced_steps(records, views, share):
    for i, v in enumerate(views):
        records.append({"iteration": i + 1, "render.binning.kernel": v})
    assert read(NAME, traced(TWO_STEPS, 2)) == pytest.approx(share)
    # the records are not this trace's: it holds fewer train.step spans
    assert read(NAME, traced(EVENTS, 2)) is None


def test_binning_kernel_share_is_silent_on_a_program_without_it(records):
    """The parent's records: binning's other counters, not this one."""
    records.append({"iteration": 1, "render.entries": [5],
                    "render.binned": [2]})
    records.append({"iteration": 2, "render.entries": [6],
                    "render.binned": [3]})
    assert read(NAME, traced(TWO_STEPS, 2)) is None


def test_binning_kernel_share_on_the_tiny_cell():
    """On the CPU every view takes the plain chain."""
    res = H.run("dtu.step_late", SEED, 0.2, True, "cpu", overrides=TINY)
    assert res["metrics"][NAME] == {"value": 0.0, "unit": "%"}
    assert res["correct"]
