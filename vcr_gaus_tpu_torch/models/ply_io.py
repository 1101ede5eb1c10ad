"""Gaussian model PLY, splat and checkpoint IO
(vcr_gaus_tpu/models/ply_io.py).

The vertex layout is the reference 3DGS one: x,y,z, nx,ny,nz(=0),
f_dc_0..2, f_rest_0..3K-1 (channel-major), opacity, scale_0..2, rot_0..3
[, obj_dc_0..S-1], all raw (pre-activation) float32. Only the active slots
are written. Checkpoints are the JAX package's .npz, key for key, so either
package resumes from the other's.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..utils.ply import read_ply, write_ply
from .convert import (STATS, state_from_arrays, state_from_numpy,
                      state_to_arrays, state_to_numpy)
from .gaussians import GaussianState


def _compact(state: GaussianState) -> dict[str, np.ndarray]:
    params, act = state_to_numpy(state)
    return {k: v[act] for k, v in params.items()}


def _vertex_props(d: dict[str, np.ndarray],
                  normals: np.ndarray | None = None) -> dict[str, np.ndarray]:
    """The PLY columns of the compacted params ``d``; the normal slots hold
    ``normals`` (default zeros)."""
    n = d["xyz"].shape[0]
    # explicit flat widths: reshape(n, -1) cannot infer them when n == 0
    f_dc = d["f_dc"].transpose(0, 2, 1).reshape(n, 3 * d["f_dc"].shape[1])
    f_rest = d["f_rest"].transpose(0, 2, 1).reshape(
        n, 3 * d["f_rest"].shape[1])
    props: dict[str, np.ndarray] = {}
    for i, k in enumerate("xyz"):
        props[k] = d["xyz"][:, i].astype(np.float32)
    if normals is None:
        normals = np.zeros((n, 3), np.float32)
    for i, k in enumerate(("nx", "ny", "nz")):
        props[k] = normals[:, i].astype(np.float32)
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
    return props


def save_gaussian_ply(state: GaussianState, path: str) -> None:
    write_ply(path, _vertex_props(_compact(state)))


def save_inside_ply(state: GaussianState, path: str,
                    inside_mask: np.ndarray) -> None:
    """The PLY of the active Gaussians inside the box, with their
    shortest-axis normals in the normal slots and no semantic columns."""
    sub = state.replace(active=state.active & torch.as_tensor(
        np.asarray(inside_mask, bool), device=state.active.device))
    normals = sub.shortest_axis_normal()[sub.active].detach().cpu().numpy()
    d = _compact(sub)
    d["obj_dc"] = d["obj_dc"][:, :, :0]
    write_ply(path, _vertex_props(d, normals))


def save_splat(state: GaussianState, path: str) -> None:
    """The web viewers' .splat export: 32 bytes per Gaussian, position f32x3,
    activated scale f32x3, rgba u8x4 (SH DC colour and opacity), normalized
    quaternion u8x4; sorted by descending volume x opacity."""
    d = _compact(state)
    xyz = d["xyz"].astype(np.float32)
    scale = np.exp(d["log_scale"]).astype(np.float32)
    opacity = 1.0 / (1.0 + np.exp(-d["logit_opacity"][:, 0]))
    rgb = np.clip(0.5 + 0.28209479177387814 * d["f_dc"][:, 0, :], 0.0, 1.0)
    quat = d["quat"]
    quat = quat / np.maximum(np.linalg.norm(quat, axis=1, keepdims=True),
                             1e-12)
    order = np.argsort(-(scale.prod(axis=1) * opacity))
    n = xyz.shape[0]
    rec = np.zeros((n, 32), np.uint8)
    rec[:, 0:12] = xyz[order].view(np.uint8).reshape(n, 12)
    rec[:, 12:24] = scale[order].view(np.uint8).reshape(n, 12)
    rec[:, 24:27] = np.clip(rgb[order] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    rec[:, 27] = np.clip(opacity[order] * 255.0 + 0.5, 0, 255
                         ).astype(np.uint8)
    rec[:, 28:32] = np.clip(quat[order] * 128.0 + 128.0, 0, 255
                            ).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def save_checkpoint(path: str, state: GaussianState, iteration: int,
                    extra: dict | None = None) -> None:
    """The whole training state (parameters, Adam moments and step, active
    mask, statistics) and ``extra`` (pickled) as the JAX package's .npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    a = state_to_arrays(state)
    flat = {"iteration": np.asarray(iteration),
            "active_sh_degree": np.asarray(a["active_sh_degree"], np.int32),
            "active": a["active"],
            **{k: a[k] for k in STATS},
            "adam_step": np.asarray(a["step"], np.int32)}
    for k in a["params"]:
        flat[f"p_{k}"] = a["params"][k]
        flat[f"mu_{k}"] = a["mu"][k]
        flat[f"nu_{k}"] = a["nu"][k]
    if extra:
        flat["extra"] = np.frombuffer(pickle.dumps(extra), np.uint8)
    np.savez(path, **flat)


def load_checkpoint(path: str, device: str | torch.device = "cuda"
                    ) -> tuple[GaussianState, int, dict]:
    """(state on ``device``, iteration, extra) of a checkpoint written by
    either package."""
    z = np.load(path, allow_pickle=False)
    names = [k[2:] for k in z.files if k.startswith("p_")]
    arrays = {"params": {k: z[f"p_{k}"] for k in names},
              "mu": {k: z[f"mu_{k}"] for k in names},
              "nu": {k: z[f"nu_{k}"] for k in names},
              "step": int(z["adam_step"]), "active": z["active"],
              "active_sh_degree": int(z["active_sh_degree"]),
              **{k: z[k] for k in STATS}}
    extra = pickle.loads(z["extra"].tobytes()) if "extra" in z.files else {}
    return state_from_arrays(arrays, device), int(z["iteration"]), extra


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
