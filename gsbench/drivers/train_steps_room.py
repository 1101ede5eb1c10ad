"""The driver of traffic of the kind ``train_steps_room``: the
``train_steps`` driver's training iterations over the room of ``room.py``
(its walls, floor, ceiling and furniture closing around the cameras), with
the recipe's metadata split.

Under ``model.eval`` and ``model.split`` the trainer trains on the views
that meta.json lists under ``train``, in name order; the camera order, the
camera extent (so the position rate), the reference's steps and the
counted steps are over those views alone, and the reference's box is
meta.json's. The side networks' weights are drawn for every view, train
and test, as the trainer holds them.

The mix's parameters, the end-to-end numbers and the check's numbers are
``train_steps``'s (see ``drivers/train_steps.py``). On a card the run
keeps torch to one CPU thread. A traced run's line adds each traced step's
depth range: the nearest and the farthest camera depth of the Gaussians
the reference's binning gave a tile.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import os
import time

import torch

from .. import build as BLD
from .. import faults as FLT
from .. import population as POP
from .. import room as RM
from ..reference import camera as RC
from ..reference import render as RR
from ..reference import step as RS
from . import train_steps as TS

NUMBERS = TS.NUMBERS


def train_views(cfg: dict, views: list) -> list:
    """The views the trainer trains on, in its index order."""
    m = cfg["model"]
    if float(m.get("ratio", 0) or 0) > 0 or not (m.get("eval")
                                                 and m.get("split")):
        raise ValueError("the driver follows the metadata split alone")
    train, _ = RM.split(cfg["bench"]["views"])
    return [views[i] for i in train]


def make_population(cfg: dict, seed: int, device):
    return RM.make_population(cfg["bench"], int(cfg["model"]["sh_degree"]),
                              BLD.ch_sem_of(cfg), seed, device)


def make_scene(cfg: dict, seed: int, root: str, device):
    return RM.make_scene(cfg, seed, root, device, BLD.weights_of(cfg))


def build_trainer(cfg: dict, scene, seed: int, device):
    """The program's trainer over ``scene`` (every view written), holding
    the room's population and the side networks' weights drawn from
    ``seed`` (``train_steps_unbounded.build_trainer`` over the room)."""
    from vcr_gaus_tpu_torch.config import Config
    from vcr_gaus_tpu_torch.models import gaussians as GM
    from vcr_gaus_tpu_torch.train.trainer import Trainer

    data = copy.deepcopy(cfg)
    data.pop("bench", None)
    BLD.deep_update(data, {"model": {"source_path": scene.root},
                           "logdir": os.path.join(scene.root, "run"),
                           "seed": int(seed)})
    trainer = Trainer(Config(data=data), device)
    # the init cloud's state goes before the population is drawn, so the
    # set-up never holds two states of the capacity
    trainer.state = None
    gc.collect()
    params, active = make_population(cfg, seed, trainer.device)
    trainer.state = GM.new_state(GM.GaussianParams(**params), active,
                                 int(cfg["model"]["sh_degree"]))
    w = BLD.make_net_weights(cfg, len(scene.views), seed, trainer.device)
    nets = trainer.nets
    with torch.no_grad():
        if nets.app is not None:
            nets.emb.copy_(w["emb"])
            for p, x in zip(nets.app.parameters(), w["app"], strict=True):
                p.copy_(x)
        if nets.cls is not None:
            for p, x in zip(nets.cls.parameters(), w["cls"], strict=True):
                p.copy_(x)
    return trainer


def reference_inputs(cfg: dict, train_scene, n_images: int, seed: int,
                     start: int, device) -> RS.Inputs:
    """The reference's inputs over the train views of ``train_scene``, the
    side networks' weights drawn for ``n_images`` views."""
    params, active = make_population(cfg, seed, device)
    return RS.Inputs(cfg, seed, train_scene.views, train_scene.fovx,
                     train_scene.fovy, params, active,
                     BLD.make_net_weights(cfg, n_images, seed, device),
                     train_scene.trans, train_scene.scale, start)


@torch.no_grad()
def depth_ranges(cfg: dict, scene, order: list, states: list,
                 device) -> list:
    """[nearest, farthest] camera depth of the Gaussians the reference's
    binning gives a tile, for each traced step's state and view."""
    w, h = scene.width, scene.height
    out = []
    for (params, active), vi in zip(states, order, strict=True):
        v = scene.views[vi]
        cam = RC.make_cam(v.qvec, v.tvec, scene.fovx, scene.fovy, w, h,
                          device)
        p = {k: getattr(params, k).detach() for k in POP.PARAM_NAMES}
        _, binn, _ = RR.prepare(p, active, cam, w, h,
                                int(cfg["model"]["sh_degree"]),
                                BLD.ch_sem_of(cfg))
        xyz = p["xyz"][torch.unique(binn.sorted_gid)]
        z = xyz @ cam.viewmatrix[:3, 2] + cam.viewmatrix[3, 2]
        out.append([float(z.min()), float(z.max())] if z.numel() else [])
        del binn
    return out


class Run(TS.Run):
    """One run of a ``train_steps_room`` cell; ``self.scene`` holds the
    train views alone once the trainer is built."""

    def setup(self) -> None:
        if torch.device(self.device).type == "cuda":
            # the host only issues work to the card: with torch's CPU pool
            # of a thread a core, the step's host time spread step_ms by 11%
            # between runs on the card, with one thread by 3.6%
            torch.set_num_threads(1)
        scene = make_scene(self.cfg, self.seed,
                           os.path.join(self.tmp, "scene"), self.device)
        self.n_images = len(scene.views)
        self.trainer = build_trainer(self.cfg, scene, self.seed, self.device)
        self.scene = scene._replace(views=train_views(self.cfg, scene.views))
        self.prog = TS.program_readings(self.trainer, self.n_check,
                                        self.start)
        for _ in range(int(self.tr["warmup_steps"])):
            self.trainer.train_step()
        self.done = self.n_check + int(self.tr["warmup_steps"])

    def traced(self):
        states = self.states
        order = RS.camera_order(self.seed, len(self.scene.views),
                                self.done + len(states))[self.done:]
        ctx, extra = super().traced()
        extra["depth_range"] = depth_ranges(self.cfg, self.scene, order,
                                            states, self.device)
        return ctx, extra

    def reference(self, dtype=torch.float32) -> dict:
        inp = reference_inputs(self.cfg, self.scene, self.n_images,
                               self.seed, self.start, self.device)
        return RS.run_reference(inp, self.n_check, self.device, dtype=dtype)


def control_readings(cell, seed: int, device, with_faults: bool,
                     tmp: str) -> dict:
    """``train_steps.control_readings`` over the room and the metadata
    train views."""
    cfg, tr = cell.cfg, cell.traffic
    start, n = int(tr["start_iteration"]), int(tr["checked_steps"])
    scene = make_scene(cfg, seed, os.path.join(tmp, "scene"), device)
    runs = {"sound": None}
    if with_faults:
        runs.update(dict.fromkeys(FLT.PLANTED))
    for name in runs:
        trainer = build_trainer(cfg, scene, seed, device)
        with (FLT.planted(name, trainer) if name != "sound"
              else contextlib.nullcontext()):
            runs[name] = TS.program_readings(trainer, n, start)
        del trainer
        gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    train = scene._replace(views=train_views(cfg, scene.views))
    inp = reference_inputs(cfg, train, len(scene.views), seed, start, device)
    t0 = time.perf_counter()
    ref = RS.run_reference(inp, n, device)
    out = {"reference_s": time.perf_counter() - t0}
    runs["control"] = RS.run_reference(inp, n, device, dtype=torch.bfloat16)
    for name, prog in runs.items():
        out[name] = TS.numbers(prog, ref)
    out["raw"] = {"reference": ref, **runs}
    return out
