"""The driver of traffic of the kind ``train_steps_unbounded``: the
``train_steps`` driver's training iterations over the unbounded population
of ``unbounded.py`` (an object, the ground under it and surroundings to the
horizon, the cameras inside them), with the recipe's train split.

Under ``model.eval`` the trainer trains on the views whose index, in name
order, is not a multiple of ``model.llffhold``; the camera order, the
camera extent (so the position rate and the depth cut), the reference's
steps and the counted steps are over those views alone. The side networks'
weights are drawn for every view, train and test, as the trainer holds
them.

The mix's parameters, the end-to-end numbers and the check's numbers are
``train_steps``'s (see ``drivers/train_steps.py``).
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
from .. import unbounded as UB
from ..reference import step as RS
from . import train_steps as TS

NUMBERS = TS.NUMBERS


def train_views(cfg: dict, views: list) -> list:
    """The views the trainer trains on, in its index order."""
    m = cfg["model"]
    if float(m.get("ratio", 0) or 0) > 0 or m.get("split"):
        raise ValueError("the driver follows the llffhold split alone")
    if not m.get("eval"):
        return list(views)
    hold = int(m["llffhold"])
    return [v for i, v in enumerate(views) if i % hold]


def make_population(cfg: dict, seed: int, device):
    return UB.make_population(cfg["bench"]["population"],
                              int(cfg["model"]["sh_degree"]),
                              BLD.ch_sem_of(cfg), seed, device)


def build_trainer(cfg: dict, scene, seed: int, device):
    """The program's trainer over ``scene`` (every view written), holding
    the unbounded population and the side networks' weights drawn from
    ``seed``."""
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


class Run(TS.Run):
    """One run of a ``train_steps_unbounded`` cell; ``self.scene`` holds
    the train views alone once the trainer is built."""

    def setup(self) -> None:
        scene = BLD.make_scene(self.cfg, self.seed,
                               os.path.join(self.tmp, "scene"), self.device)
        self.n_images = len(scene.views)
        self.trainer = build_trainer(self.cfg, scene, self.seed, self.device)
        self.scene = scene._replace(views=train_views(self.cfg, scene.views))
        self.prog = TS.program_readings(self.trainer, self.n_check,
                                        self.start)
        for _ in range(int(self.tr["warmup_steps"])):
            self.trainer.train_step()
        self.done = self.n_check + int(self.tr["warmup_steps"])

    def reference(self, dtype=torch.float32) -> dict:
        inp = reference_inputs(self.cfg, self.scene, self.n_images,
                               self.seed, self.start, self.device)
        return RS.run_reference(inp, self.n_check, self.device, dtype=dtype)


def control_readings(cell, seed: int, device, with_faults: bool,
                     tmp: str) -> dict:
    """``train_steps.control_readings`` over the unbounded population and
    the train views."""
    cfg, tr = cell.cfg, cell.traffic
    start, n = int(tr["start_iteration"]), int(tr["checked_steps"])
    scene = BLD.make_scene(cfg, seed, os.path.join(tmp, "scene"), device)
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
