"""Gaussian model PLY IO (vcr_gaus_tpu/models/ply_io.py).

The vertex layout is the reference 3DGS one: x,y,z, nx,ny,nz(=0),
f_dc_0..2, f_rest_0..3K-1 (channel-major), opacity, scale_0..2, rot_0..3
[, obj_dc_0..S-1], all raw (pre-activation) float32. Only the active slots
are written.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.ply import read_ply, write_ply
from .convert import state_from_numpy, state_to_numpy
from .gaussians import GaussianState


def save_gaussian_ply(state: GaussianState, path: str) -> None:
    params, act = state_to_numpy(state)
    d = {k: v[act] for k, v in params.items()}
    n = d["xyz"].shape[0]
    # explicit flat widths: reshape(n, -1) cannot infer them when n == 0
    f_dc = d["f_dc"].transpose(0, 2, 1).reshape(n, 3 * d["f_dc"].shape[1])
    f_rest = d["f_rest"].transpose(0, 2, 1).reshape(
        n, 3 * d["f_rest"].shape[1])
    props: dict[str, np.ndarray] = {}
    for i, k in enumerate("xyz"):
        props[k] = d["xyz"][:, i].astype(np.float32)
    for k in ("nx", "ny", "nz"):
        props[k] = np.zeros(n, np.float32)
    for i in range(f_dc.shape[1]):
        props[f"f_dc_{i}"] = f_dc[:, i].astype(np.float32)
    for i in range(f_rest.shape[1]):
        props[f"f_rest_{i}"] = f_rest[:, i].astype(np.float32)
    props["opacity"] = d["logit_opacity"][:, 0].astype(np.float32)
    for i in range(3):
        props[f"scale_{i}"] = d["log_scale"][:, i].astype(np.float32)
    for i in range(4):
        props[f"rot_{i}"] = d["quat"][:, i].astype(np.float32)
    ch_sem = d["obj_dc"].shape[2]
    for i in range(ch_sem):
        props[f"obj_dc_{i}"] = d["obj_dc"][:, 0, i].astype(np.float32)
    write_ply(path, props)


def load_gaussian_ply(path: str, capacity: int | None = None,
                      max_sh_degree: int = 3,
                      device: str | torch.device = "cuda") -> GaussianState:
    """Load a 3DGS-layout PLY into a state of ``capacity`` slots (default:
    exactly the PLY's count) on ``device``."""
    d = read_ply(path)
    n = len(d["x"])
    capacity = n if capacity is None else capacity
    if n > capacity:
        raise ValueError(f"PLY holds {n} gaussians, capacity is {capacity}")
    k_rest = 3 * (max_sh_degree + 1) ** 2 - 3
    f_rest_names = sorted((k for k in d if k.startswith("f_rest_")),
                          key=lambda s: int(s.split("_")[-1]))
    if len(f_rest_names) != k_rest:
        raise ValueError(f"PLY has {len(f_rest_names)} f_rest columns, "
                         f"SH degree {max_sh_degree} needs {k_rest}")
    obj_names = sorted((k for k in d if k.startswith("obj_dc_")),
                       key=lambda s: int(s.split("_")[-1]))

    def col(names):
        return np.stack([d[k] for k in names], 1).astype(np.float32)

    dense = {
        "xyz": col(["x", "y", "z"]),
        "f_dc": col([f"f_dc_{i}" for i in range(3)])[:, None, :],
        "f_rest": col(f_rest_names).reshape(n, 3, -1).transpose(0, 2, 1),
        "log_scale": col([f"scale_{i}" for i in range(3)]),
        "quat": col([f"rot_{i}" for i in range(4)]),
        "logit_opacity": col(["opacity"]),
        "obj_dc": (col(obj_names)[:, None, :] if obj_names
                   else np.zeros((n, 1, 0), np.float32)),
    }
    params = {}
    for k, v in dense.items():
        full = np.zeros((capacity,) + v.shape[1:], np.float32)
        full[:n] = v
        params[k] = full
    active = np.zeros(capacity, bool)
    active[:n] = True
    return state_from_numpy(params, active, device,
                            active_sh_degree=max_sh_degree)
