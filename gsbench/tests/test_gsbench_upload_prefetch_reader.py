"""The reader of the upload's prefetch counter, on hand-made records, on a
program without the counter and on the tiny cells traced on the CPU."""

from __future__ import annotations

import collections

import pytest

from gsbench import harness as H
from gsbench.tests.test_gsbench_tracing_readers import EVENTS, read, traced, x
from gsbench.tests.tiny import SEED, TINY
from vcr_gaus_tpu_torch.utils import tracing

NAME = "upload_prefetch_share.step"


@pytest.fixture
def records(monkeypatch):
    held = collections.deque(maxlen=tracing.MAX_STEPS)
    monkeypatch.setattr(tracing, "_records", held)
    return held


def test_upload_prefetch_share_finds_nothing_without_records(records):
    assert read(NAME, traced(EVENTS)) is None


def test_upload_prefetch_share_reads_the_traced_steps(records):
    records.append({"iteration": 1, "train.upload.prefetched": [0]})
    records.append({"iteration": 2, "train.upload.prefetched": [1, 0]})
    records.append({"iteration": 3, "train.upload.prefetched": [1, 1]})
    two = EVENTS + [x("user_annotation", "train.step", 905, 90)]
    assert read(NAME, traced(two, 2)) == 75.0
    # the records are not this trace's: it holds fewer train.step spans
    assert read(NAME, traced(EVENTS, 2)) is None


def test_upload_prefetch_share_is_silent_on_a_program_without_it(records):
    """The parent's records: other counters, no prefetch counter."""
    records.append({"iteration": 1, "render.entries": [5],
                    "render.preprocess.slots": [4096]})
    records.append({"iteration": 2, "render.entries": [6],
                    "render.preprocess.slots": [4096]})
    two = EVENTS + [x("user_annotation", "train.step", 905, 90)]
    assert read(NAME, traced(two, 2)) is None


@pytest.mark.parametrize("workload", ("dtu.step_late", "tnt.step_late"))
def test_upload_prefetch_share_on_the_tiny_cell(workload):
    """Every traced step takes over the views the step before uploaded."""
    res = H.run(workload, SEED, 0.2, True, "cpu", overrides=TINY)
    assert res["metrics"][NAME] == {"value": 100.0, "unit": "%"}
    assert res["correct"]
