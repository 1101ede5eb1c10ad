"""The Gaussian population and the side networks' weights of a run, drawn
from the seed on the device.

The population is bench.py's dtu_full shell, rewritten in PyTorch: ``count``
Gaussians on a sphere shell (``shell_radius`` around ``shell_center``)
with random colours, SH rest coefficients N(0, 0.1^2), isotropic
log-scales of ``scale_mult`` times the mean point spacing (jittered by
N(0, 0.05^2) so that no two axes tie), random rotations and one opacity,
placed in ``count`` random slots of ``capacity``; the other slots hold
zeros, as a pruned slot does. Both the program and the reference receive
exactly these tensors (drawn again for each), nothing derived from them.
"""

from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814
PARAM_NAMES = ("xyz", "f_dc", "f_rest", "log_scale", "quat", "logit_opacity",
               "obj_dc")


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of the run's draws."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + salt) % (1 << 63))


def make_population(pop: dict, sh_degree: int, ch_sem: int, seed: int,
                    device) -> tuple[dict, torch.Tensor]:
    """(params {name: (capacity, ...) float32}, active (capacity,) bool)."""
    gen = generator(seed, 1, device)
    n, cap = int(pop["count"]), int(pop["capacity"])
    r = float(pop["shell_radius"])
    k = (sh_degree + 1) ** 2 - 1

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    theta = rand(n) * (2 * math.pi)
    z = rand(n) * 2 - 1
    rho = torch.sqrt(1 - z * z)
    center = torch.tensor(pop["shell_center"], dtype=torch.float32,
                          device=device)
    xyz = torch.stack([rho * torch.cos(theta), rho * torch.sin(theta), z],
                      1) * r + center
    spacing = math.sqrt(4 * math.pi * r * r / n)
    op = float(pop["opacity"])
    dense = {
        "xyz": xyz,
        "f_dc": ((rand(n, 1, 3) - 0.5) / SH_C0),
        "f_rest": 0.1 * randn(n, k, 3),
        "log_scale": math.log(float(pop["scale_mult"]) * spacing)
        + 0.05 * randn(n, 3),
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
