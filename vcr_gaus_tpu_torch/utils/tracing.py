"""The port's spans and counters, read only while a profiler runs.

``span(name)`` is a ``torch.profiler.record_function`` while a profiler
runs (``enabled()``) and one shared null context otherwise, so a span costs
one check when nothing traces. The names are the readers' (the benchmark's
per-layer metrics, ``chip_smoke.py``'s stage table), kept as they are.

Counters are host numbers kept in memory, one record a training step:
``step(iteration, device)`` wraps ``Trainer.train_step`` in the
``train.step`` span and, while a profiler runs, opens the record
``{"iteration": i}``; ``count(name, value)`` appends ``value`` to the open
record's list ``name``; ``steps(n)`` gives the last ``n`` records (the last
``MAX_STEPS`` are kept). On a CUDA device the step's record closes with
``cuda.alloc_calls``, the step's change in the caching allocator's
``num_device_alloc + num_device_free`` (a failed allocation that is retried
frees the cache, so its frees count too). No counter reads a device value,
so none adds a synchronisation to the step.
"""

from __future__ import annotations

import collections
import contextlib

import torch

MAX_STEPS = 1024

# True while a profiler records this thread (the autograd engine's threads
# take the profiler's state with the backward's)
enabled = torch._C._autograd._profiler_enabled

_NULL = contextlib.nullcontext()
_records: collections.deque = collections.deque(maxlen=MAX_STEPS)
_open: list = []


def span(name: str):
    """A profiler span named ``name``, or the shared null context when no
    profiler runs."""
    if enabled():
        return torch.profiler.record_function(name)
    return _NULL


def count(name: str, value) -> None:
    """Append the host number ``value`` to the open step record's ``name``;
    nothing when no profiler runs or no record is open."""
    if _open and enabled():
        _open[-1].setdefault(name, []).append(value)


def steps(n: int) -> list[dict]:
    """The last ``n`` step records, oldest first."""
    return list(_records)[-n:] if n > 0 else []


def _alloc_calls(device) -> int:
    stats = torch.cuda.memory_stats(device)
    return stats["num_device_alloc"] + stats["num_device_free"]


@contextlib.contextmanager
def _step(iteration: int, device):
    record = {"iteration": iteration}
    cuda = torch.device(device).type == "cuda"
    with torch.profiler.record_function("train.step"):
        before = _alloc_calls(device) if cuda else 0
        _open.append(record)
        try:
            yield record
        finally:
            _open.pop()
            if cuda:
                record["cuda.alloc_calls"] = [_alloc_calls(device) - before]
            _records.append(record)


def step(iteration: int, device):
    """The ``train.step`` span and the step's counter record while a
    profiler runs; the shared null context otherwise."""
    if enabled():
        return _step(iteration, device)
    return _NULL
