"""The driver of traffic of the kind ``train_steps``: training iterations
through ``Trainer.train_step``, one view a step in the trainer's camera
order, from ``start_iteration``.

The mix's parameters: ``start_iteration``, ``checked_steps`` (the first
steps, in set-up, whose readings the check compares), ``warmup_steps``
(more set-up steps, so that every view's shapes are warm) and
``traced_steps`` (the steps a traced run profiles after its window).

End-to-end numbers: ``step_ms`` (the window's wall time over the steps it
completed, with no synchronisation inside) and ``step_p95_ms`` (the 95th
percentile of the intervals between consecutive step starts, CUDA events on
the step's stream). The check's numbers (``numbers``): ``loss_gap``,
``grad_gap`` and ``update_gap``, the program's first steps against the
plain reference's (``reference/step.py``) over the same inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import time

import numpy as np
import torch

from .. import build as BLD
from .. import counts as CNT
from .. import faults as FLT
from .. import population as POP
from ..harness import Traced, sync
from ..reference import camera as RC
from ..reference import render as RR
from ..reference import step as RS
from ..trace import Trace

B1 = 0.9
# the check's numbers this driver gives; a cell's checks file holds them
NUMBERS = ("loss_gap", "grad_gap", "update_gap")


def _net_mu(trainer) -> list:
    opts = [o for o in (trainer.nets.app_opt, trainer.nets.cls_opt) if o]
    return [m for o in opts for m in o.mu]


def program_readings(trainer, n_steps: int, start: int) -> dict:
    """Run the first ``n_steps`` iterations from ``start`` through
    ``Trainer.train_step`` and read what the check compares: each step's
    losses by term, with the total; each leaf's gradient at the first step
    (Adam's first moment over 1 - beta1); each leaf's change over the
    steps. Adam returns new tensors, so the state held before the first
    step is the start; the side networks step in place and are copied."""
    from vcr_gaus_tpu_torch.models import gaussians as GM

    trainer.iteration = start - 1
    names = [f.name for f in dataclasses.fields(GM.GaussianParams)]
    start_params = trainer.state.params
    start_nets = [x.detach().clone() for x in trainer.nets.leaves()]
    losses, grad = [], {}
    for s in range(n_steps):
        ls, _ = trainer.train_step()
        losses.append(ls)
        if s == 0:
            mu = trainer.state.adam.mu
            grad = RS.leaf_norms(
                {k: getattr(mu, k) / (1 - B1) for k in names},
                [m / (1 - B1) for m in _net_mu(trainer)])
    p = trainer.state.params
    delta = RS.leaf_norms(
        {k: getattr(p, k) - getattr(start_params, k) for k in names},
        [a.detach() - b for a, b in zip(trainer.nets.leaves(), start_nets,
                                        strict=True)])
    return {"loss": [{k: float(v) for k, v in ls.items()} for ls in losses],
            "grad": grad, "delta": delta}


def window(trainer, seconds: float, device) -> dict:
    """Steps until ``seconds`` have passed, with no synchronisation inside:
    step_ms is the window's wall time over the steps it completed,
    step_p95_ms the 95th percentile of the intervals between consecutive
    step starts (the last interval ends at the window's end)."""
    cuda = torch.device(device).type == "cuda"
    marks, totals = [], []
    sync(device)
    t0 = time.perf_counter()
    while True:
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())
        ls, _ = trainer.train_step()
        totals.append(ls["total"])
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
    sync(device)
    t1 = time.perf_counter()
    n = len(marks)
    if cuda:
        iv = [marks[i].elapsed_time(marks[i + 1]) for i in range(n - 1)]
        iv.append(marks[-1].elapsed_time(end))
    else:
        iv = [1e3 * (b - a) for a, b in zip(marks, marks[1:] + [t1])]
    failed = int((~torch.isfinite(torch.stack(totals))).sum())
    return {"attempted": n, "failed": failed, "seconds": t1 - t0,
            "metrics": {"step_ms": 1e3 * (t1 - t0) / n,
                        "step_p95_ms": float(np.percentile(iv, 95))}}


def traced_window(trainer, n_steps: int, device, tmp: str):
    """Profile ``n_steps`` steps inside a ``gsbench.window`` span; returns
    (Trace, the state each step started from)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    states = []
    sync(device)
    with profile(activities=acts) as prof:
        with record_function("gsbench.window"):
            for _ in range(n_steps):
                states.append((trainer.state.params, trainer.state.active))
                with record_function("gsbench.step"):
                    trainer.train_step()
            sync(device)
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    trace = Trace.load(path)
    os.remove(path)
    return trace, states


@torch.no_grad()
def count_steps(cfg: dict, scene, order: list, states: list, device) -> list:
    """The counted work of each traced step, from the reference's own
    projection and binning of the state the step started from and of its
    view."""
    m = cfg["model"]
    ch_sem = BLD.ch_sem_of(cfg)
    mode = m["depth_type"]
    w, h = scene.width, scene.height
    out = []
    for (params, active), vi in zip(states, order, strict=True):
        v = scene.views[vi]
        cam = RC.make_cam(v.qvec, v.tvec, scene.fovx, scene.fovy, w, h, device)
        p = {k: getattr(params, k).detach() for k in POP.PARAM_NAMES}
        feats, binn, _ = RR.prepare(p, active, cam, w, h,
                                    int(m["sh_degree"]), ch_sem)
        c = RR.census(feats, binn)
        nf = feats.shape[1]
        k1 = CNT.k1(c, w, h, nf, ch_sem, mode)
        k2 = CNT.k2(c, w, h, nf, ch_sem, mode)
        per_g = sum(int(np.prod(x.shape[1:])) for x in p.values())
        out.append({"k1_ops": k1[0], "k1_bytes": k1[1], "k2_ops": k2[0],
                    "k2_bytes": k2[1], "census": c,
                    "step_ops": CNT.step_ops(
                        c, w, h, nf, ch_sem, mode, int(active.sum()), per_g,
                        int(m["num_cls"]),
                        bool(m["use_decoupled_appearance"]))})
        del feats, binn
    return out


def reference_inputs(cfg: dict, scene, seed: int, start: int,
                     device) -> RS.Inputs:
    params, active = BLD.make_population(cfg, seed, device)
    return RS.Inputs(cfg, seed, scene.views, scene.fovx, scene.fovy, params,
                     active, BLD.make_net_weights(cfg, len(scene.views), seed,
                                                  device),
                     scene.trans, scene.scale, start)


def numbers(prog: dict, ref: dict) -> dict:
    """The check's numbers of the program's readings against the
    reference's (see ``reference/step.py``)."""
    return {"loss_gap": RS.loss_gap(prog["loss"], ref["loss"]),
            "grad_gap": RS.gap(prog["grad"], ref["grad"],
                               floor=RS.rounding_floor(ref["grad"]))[0],
            "update_gap": RS.gap(prog["delta"], ref["delta"],
                                 RS.rounding_leaves(ref["grad"]))[0]}


class Run:
    """One run of a ``train_steps`` cell, in the order the harness calls
    it: ``setup``, ``window``, with a trace ``trace`` and ``traced``, then
    ``release`` and ``numbers``."""

    def __init__(self, cell, seed: int, device, tmp: str):
        self.cfg, self.tr = cell.cfg, cell.traffic
        self.seed, self.device, self.tmp = seed, device, tmp
        self.start = int(self.tr["start_iteration"])
        self.n_check = int(self.tr["checked_steps"])
        self.done = 0

    def setup(self) -> None:
        self.scene = BLD.make_scene(self.cfg, self.seed,
                                    os.path.join(self.tmp, "scene"),
                                    self.device)
        self.trainer = BLD.build_trainer(self.cfg, self.scene, self.seed,
                                         self.device)
        self.prog = program_readings(self.trainer, self.n_check, self.start)
        for _ in range(int(self.tr["warmup_steps"])):
            self.trainer.train_step()
        self.done = self.n_check + int(self.tr["warmup_steps"])

    def window(self, seconds: float) -> dict:
        win = window(self.trainer, seconds, self.device)
        self.done += win["attempted"]
        self.step_s = win["seconds"] / win["attempted"]
        return win

    def trace(self) -> None:
        n = int(self.tr["traced_steps"])
        self.tr_obj, self.states = traced_window(self.trainer, n,
                                                 self.device, self.tmp)

    def traced(self) -> tuple[Traced, dict]:
        """What the readers read, and what the result's line adds (each
        traced step's census). Frees the trainer first: counting runs the
        reference's projection and binning on the device."""
        n = len(self.states)
        order = RS.camera_order(self.seed, len(self.scene.views),
                                self.done + n)
        self.release()
        counted = count_steps(self.cfg, self.scene, order[self.done:],
                              self.states, self.device)
        self.states = None
        return (Traced(self.tr_obj, n, counted, self.step_s, CNT.peaks()),
                {"census": [x["census"] for x in counted]})

    def release(self) -> None:
        self.trainer = None
        gc.collect()

    def reference(self, dtype=torch.float32) -> dict:
        inp = reference_inputs(self.cfg, self.scene, self.seed, self.start,
                               self.device)
        return RS.run_reference(inp, self.n_check, self.device, dtype=dtype)

    def numbers(self) -> dict:
        self.ref = self.reference()
        return numbers(self.prog, self.ref)

    def readings(self) -> dict:
        return {"program": self.prog, "reference": self.ref}


def control_readings(cell, seed: int, device, with_faults: bool,
                     tmp: str) -> dict:
    """The check's numbers at ``cell``'s size on ``seed``: of the program's
    sound run, of each fault of ``faults.py`` planted in it (with
    ``with_faults``; a state left unchanged reads 1 and needs no run) and
    of the control, the reference computed in bfloat16 (the precision
    below the configuration's float32) put in the program's place; with
    the raw readings of each."""
    cfg, tr = cell.cfg, cell.traffic
    start, n = int(tr["start_iteration"]), int(tr["checked_steps"])
    scene = BLD.make_scene(cfg, seed, os.path.join(tmp, "scene"), device)
    runs = {"sound": None}
    if with_faults:
        runs.update(dict.fromkeys(FLT.PLANTED))
    for name in runs:
        trainer = BLD.build_trainer(cfg, scene, seed, device)
        with (FLT.planted(name, trainer) if name != "sound"
              else contextlib.nullcontext()):
            runs[name] = program_readings(trainer, n, start)
        del trainer
        gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    inp = reference_inputs(cfg, scene, seed, start, device)
    t0 = time.perf_counter()
    ref = RS.run_reference(inp, n, device)
    out = {"reference_s": time.perf_counter() - t0}
    runs["control"] = RS.run_reference(inp, n, device, dtype=torch.bfloat16)
    for name, prog in runs.items():
        out[name] = numbers(prog, ref)
    out["raw"] = {"reference": ref, **runs}
    return out
