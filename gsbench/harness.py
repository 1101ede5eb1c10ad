"""One run of a benchmark cell: set-up, the measured window, the traced
window, the per-layer readers and the check against the plain reference.

Everything a cell is made of is found by the names in BENCHMARK.json:

- its configuration, ``configs/<config>.yaml`` (the recipe as it runs, with
  a ``bench`` block sizing the population and the views);
- its traffic mix, ``traffic/<mix>.json``: a ``kind`` and the parameters
  the driver of that kind reads;
- the driver of the mix's kind, ``drivers/<kind>.py``: its ``Run`` builds
  the program, drives the window, profiles the traced steps and gives the
  check's numbers (see ``drivers/train_steps.py``);
- its per-layer metrics, readers under ``metrics/<name>.py``;
- the limits of its check, ``checks/<workload>.json``: each number the
  driver gives that the check holds, with its limit.

The harness itself knows no kind of work: it times set-up, asks the driver
for the end-to-end numbers the manifest gives the cell, reads the device's
memory peak, runs the readers over the driver's trace and holds the
driver's numbers to the cell's limits once the program's state is freed.
"""

from __future__ import annotations

import copy
import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import tempfile
import time
from typing import NamedTuple

import torch
import yaml

from .build import deep_update
from .trace import Trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


class Cell(NamedTuple):
    name: str
    cfg: dict                    # the configuration file's content
    traffic: dict
    end_to_end: list             # the manifest's entries this cell reports
    per_layer: list
    limits: dict                 # {number: limit} of the check


def cell(workload: str, bench: dict | None = None,
         overrides: dict | None = None) -> Cell:
    """The cell ``workload`` of the manifest, its files read."""
    bench = manifest() if bench is None else bench
    w = next((x for x in bench["workloads"] if x["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    c = next(x for x in bench["configs"] if x["name"] == w["config"])
    with open(os.path.join(ROOT, c["file"])) as f:
        cfg = yaml.safe_load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(HERE, "checks", workload + ".json")) as f:
        limits = json.load(f)
    if overrides:
        deep_update(cfg, copy.deepcopy(overrides.get("config", {})))
        deep_update(traffic, copy.deepcopy(overrides.get("traffic", {})))

    def mine(m):
        return workload in m.get("workloads", [workload])

    return Cell(workload, cfg, traffic,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)], limits)


def load_reader(name: str):
    """The ``read`` function of the per-layer metric ``name``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gsbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_driver(kind: str):
    """The module ``drivers/<kind>.py``."""
    if not os.path.isfile(os.path.join(HERE, "drivers", kind + ".py")):
        raise ValueError(f"no driver for traffic of kind {kind!r}")
    return importlib.import_module(f"{__package__}.drivers.{kind}")


class Traced(NamedTuple):
    """What a per-layer metric's reader reads."""
    trace: Trace
    steps: int                   # units of work in the traced window
    counts: list                 # per traced unit: its counted work (dicts)
    step_s: float                # the untraced window's seconds a unit
    peaks: dict


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    return (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)


def passed(checks: dict) -> bool:
    return bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())


def card() -> dict:
    """The card's name, count and power limit (nvidia-smi), as measured."""
    import subprocess
    out = {"kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        out["nvidia_smi"] = q.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = f"unavailable: {e}"
    return out


def run(workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: float | None = None,
        overrides: dict | None = None) -> dict:
    """One run of ``workload``; returns the result object (without the
    device's name, which the caller adds)."""
    t_start = time.perf_counter() if t_start is None else t_start
    c = cell(workload, overrides=overrides)
    driver = load_driver(c.traffic["kind"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="gsbench-")
    try:
        r = driver.Run(c, seed, device, tmp)
        r.setup()
        sync(device)
        setup_s = time.perf_counter() - t_start
        win = r.window(seconds)
        values = {"setup_s": setup_s, **win["metrics"]}
        result = {"correct": False, "attempted": win["attempted"],
                  "failed": win["failed"], "metrics": {}}
        if not trace:
            peak = memory_peak(device)
            for m in c.end_to_end:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
        else:
            r.trace()
            peak = memory_peak(device)
            ctx, extra = r.traced()
            for m in c.per_layer:
                v = load_reader(m["name"])(ctx)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": v,
                                                    "unit": m["unit"]}
            result["busy_s"] = ctx.trace.busy_s()
            result["window_s"] = ctx.trace.window_s
            result["breakdown"] = {"device_ops": ctx.trace.top_ops(10),
                                   "idle_gaps": ctx.trace.idle_gaps(10)}
            result.update(extra)
        result["memory_peak_bytes"] = peak
        # the program's state goes before the reference runs
        r.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        nums = r.numbers()
        checks = {k: {"value": float(nums.get(k, math.inf)),
                      "limit": float(v)} for k, v in c.limits.items()}
        result["correct"] = passed(checks) and win["failed"] == 0
        result["reference_s"] = time.perf_counter() - t_ref
        result["readings"] = r.readings()
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
