"""What a run of a cell on the trainer starts from: the scene, the
population and the side networks' weights, all drawn from the seed by the
configuration's ``bench`` block, and the program's ``Trainer`` holding
them. Shared by the drivers of every kind of traffic on the trainer."""

from __future__ import annotations

import copy
import os

import torch

from . import population as POP
from . import scene as SC
from .reference import nets as RN
from .reference import step as RS


def deep_update(base: dict, new: dict) -> dict:
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base


def weights_of(cfg: dict) -> dict:
    return RS.recipe_weights(cfg["optim"])


def ch_sem_of(cfg: dict) -> int:
    return (int(cfg["model"]["ch_sem_feat"])
            if weights_of(cfg).get("semantic", 0) > 0 else 0)


def make_net_weights(cfg: dict, n_images: int, seed: int, device) -> dict:
    o, m = cfg["optim"], cfg["model"]
    return RN.init_weights(n_images, ch_sem_of(cfg), int(m["num_cls"]),
                           bool(m["use_decoupled_appearance"]),
                           POP.generator(seed, 3, device), device,
                           o["appearance_embeddings_lr"], o["cls_lr"])


def make_population(cfg: dict, seed: int, device):
    return POP.make_population(cfg["bench"]["population"],
                               int(cfg["model"]["sh_degree"]), ch_sem_of(cfg),
                               seed, device)


def make_scene(cfg: dict, seed: int, root: str, device) -> SC.Scene:
    b, w = cfg["bench"], weights_of(cfg)
    views, fovx, fovy = SC.make_views(
        b["views"], b["population"],
        want_normal="mono_normal" in w or "depth_normal" in w,
        want_labels="semantic" in w, seed=seed, device=device)
    return SC.write_scene(root, views, int(b["views"]["width"]),
                          int(b["views"]["height"]), fovx, fovy,
                          b["population"], cfg["model"]["normal_folder"],
                          int(b["init_points"]), seed)


def build_trainer(cfg: dict, scene: SC.Scene, seed: int, device):
    """The program's trainer over ``scene``, holding the population and the
    side networks' weights drawn from ``seed``."""
    from vcr_gaus_tpu_torch.config import Config
    from vcr_gaus_tpu_torch.models import gaussians as GM
    from vcr_gaus_tpu_torch.train.trainer import Trainer

    data = copy.deepcopy(cfg)
    data.pop("bench", None)
    deep_update(data, {"model": {"source_path": scene.root},
                       "logdir": os.path.join(scene.root, "run"),
                       "seed": int(seed)})
    trainer = Trainer(Config(data=data), device)
    params, active = make_population(cfg, seed, trainer.device)
    trainer.state = GM.new_state(GM.GaussianParams(**params), active,
                                 int(cfg["model"]["sh_degree"]))
    w = make_net_weights(cfg, len(scene.views), seed, trainer.device)
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
