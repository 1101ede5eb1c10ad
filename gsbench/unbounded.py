"""The unbounded population of a 360 capture, drawn from the seed on the
device: the cameras stand inside it.

Three parts, y up, in ``count`` random slots of ``capacity`` (the slot rule
and the generator's salt are ``population.py``'s, as are the colours, the
SH rest coefficients, the random rotations, the one opacity and the
N(0, 0.05^2) jitter of the log-scales):

- the object: ``count - ground.count - background.count`` Gaussians on a
  sphere shell (``shell_radius`` around ``shell_center``), isotropic scale
  ``scale_mult`` times the mean point spacing;
- the ground: ``ground.count`` on the plane y = the centre's y +
  ``ground.height``, at radial distances from the centre log-uniform in
  [``r_min``, ``r_max``], scales (s, ``thin`` s, s) with s the local
  spacing there;
- the surroundings: ``background.count`` in random directions from the
  centre at radii log-uniform in [``r_min``, ``r_max``], isotropic scale
  ``scale_mult`` times the local spacing there.

A log-uniform radius puts n / ln(r_max / r_min) points in each unit of
ln r, so the local spacing grows with the radius: on the plane it is
r sqrt(2 pi ln(r_max / r_min) / n), in space r (4 pi ln(r_max / r_min) /
n)^(1/3). Both the program and the reference receive exactly these
tensors (drawn again for each), nothing derived from them.
"""

from __future__ import annotations

import math

import torch

from .population import PARAM_NAMES, SH_C0, generator


def make_population(pop: dict, sh_degree: int, ch_sem: int, seed: int,
                    device) -> tuple[dict, torch.Tensor]:
    """(params {name: (capacity, ...) float32}, active (capacity,) bool)."""
    gen = generator(seed, 1, device)
    n, cap = int(pop["count"]), int(pop["capacity"])
    gr, bg = pop["ground"], pop["background"]
    n_gr, n_bg = int(gr["count"]), int(bg["count"])
    n_obj = n - n_gr - n_bg
    if n_obj <= 0:
        raise ValueError("the ground and the surroundings leave no object")
    k = (sh_degree + 1) ** 2 - 1
    center = torch.tensor(pop["shell_center"], dtype=torch.float32,
                          device=device)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def sphere(m):
        theta = rand(m) * (2 * math.pi)
        z = rand(m) * 2 - 1
        rho = torch.sqrt(1 - z * z)
        return torch.stack([rho * torch.cos(theta), rho * torch.sin(theta),
                            z], 1)

    def log_uniform(m, lo, hi):
        return torch.exp(math.log(lo) + rand(m) * math.log(hi / lo))

    r = float(pop["shell_radius"])
    obj = sphere(n_obj) * r + center
    obj_s = torch.full((n_obj, 3), math.log(
        float(pop["scale_mult"]) * math.sqrt(4 * math.pi * r * r / n_obj)),
        device=device)

    lo, hi = float(gr["r_min"]), float(gr["r_max"])
    dist = log_uniform(n_gr, lo, hi)
    phi = rand(n_gr) * (2 * math.pi)
    ground = torch.stack([dist * torch.cos(phi),
                          torch.full_like(dist, float(gr["height"])),
                          dist * torch.sin(phi)], 1) + center
    s = torch.log(dist * math.sqrt(2 * math.pi * math.log(hi / lo) / n_gr))
    ground_s = torch.stack([s, s + math.log(float(gr["thin"])), s], 1)

    lo, hi = float(bg["r_min"]), float(bg["r_max"])
    rad = log_uniform(n_bg, lo, hi)
    back = sphere(n_bg) * rad[:, None] + center
    spacing = rad * (4 * math.pi * math.log(hi / lo) / n_bg) ** (1 / 3)
    back_s = torch.log(float(bg["scale_mult"]) * spacing)[:, None].expand(
        n_bg, 3)

    op = float(pop["opacity"])
    dense = {
        "xyz": torch.cat([obj, ground, back]),
        "f_dc": ((rand(n, 1, 3) - 0.5) / SH_C0),
        "f_rest": 0.1 * randn(n, k, 3),
        "log_scale": (torch.cat([obj_s, ground_s, back_s])
                      + 0.05 * randn(n, 3)),
        "quat": randn(n, 4),
        "logit_opacity": torch.full((n, 1), math.log(op / (1 - op)),
                                    device=device),
        "obj_dc": (rand(n, 1, ch_sem) - 0.5) / SH_C0,
    }
    slots = torch.randperm(cap, generator=gen, device=device)[:n]
    params = {}
    for name in PARAM_NAMES:
        a = dense[name]
        full = torch.zeros((cap,) + tuple(a.shape[1:]), dtype=torch.float32,
                           device=device)
        full[slots] = a
        params[name] = full
    active = torch.zeros(cap, dtype=torch.bool, device=device)
    active[slots] = True
    return params, active
