"""Quaternion / covariance math, the LR schedule and the box test
(vcr_gaus_tpu/utils/math.py)."""

from __future__ import annotations

import numpy as np
import torch


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000) -> float:
    """Log-linear interpolated LR with an optional delay, evaluated in
    float32 as the JAX package does; a host float."""
    f32 = np.float32
    step = f32(step)
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = f32(lr_delay_mult + (1 - lr_delay_mult) * np.sin(
            0.5 * np.pi * np.clip(step / f32(lr_delay_steps), 0, 1)))
    else:
        delay_rate = f32(1.0)
    t = np.clip(step / f32(max_steps), f32(0), f32(1))
    log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                      + np.log(f32(lr_final)) * t)
    return 0.0 if step < 0 else float(delay_rate * log_lerp)


def normalize_pts(pts: torch.Tensor, trans, scale) -> torch.Tensor:
    """World points -> normalized box space; ``trans`` is a translation (3,)
    or an oriented-box 4x4 transform."""
    trans = torch.as_tensor(np.asarray(trans, np.float32), device=pts.device)
    scale = torch.as_tensor(np.asarray(scale, np.float32), device=pts.device)
    if trans.ndim == 1:
        return (pts - trans) / scale
    return (pts @ trans[:3, :3].T + trans[:3, 3]) / scale


def get_inside_normalized(xyz: torch.Tensor, trans, scale, bound=1.0):
    """(inside-the-box mask, normalized points)."""
    pts = normalize_pts(xyz, trans, scale)
    return torch.all(torch.abs(pts) < bound, dim=-1), pts


def safe_normalize(v: torch.Tensor, eps: float = 1e-24) -> torch.Tensor:
    """x / ||x|| with eps inside the rsqrt, finite at x == 0 (inactive
    padding slots hold zero vectors)."""
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w,x,y,z), normalized first -> rotation matrix (...,3,3)."""
    q = safe_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def covariance_from_scaling_rotation(scale, quat, modifier: float = 1.0):
    """3D covariance as the 6 upper-triangular entries (xx, xy, xz, yy, yz,
    zz) of L L^T with L = R diag(scale)."""
    L = quat_to_rotmat(quat) * (modifier * scale)[..., None, :]
    C = L @ L.transpose(-1, -2)
    return torch.stack(
        [C[..., 0, 0], C[..., 0, 1], C[..., 0, 2],
         C[..., 1, 1], C[..., 1, 2], C[..., 2, 2]], dim=-1)


def shortest_axis_normal(scale: torch.Tensor, quat: torch.Tensor):
    """Per-Gaussian normal = rotation column of the smallest scale axis
    (first one on ties, as jnp.argmin)."""
    R = quat_to_rotmat(quat)
    axis = torch.argmin(scale, dim=-1)
    idx = axis[:, None, None].expand(-1, 3, 1)
    return torch.gather(R, 2, idx)[..., 0]


def longest_axis_dir(scale: torch.Tensor, quat: torch.Tensor):
    """(direction, magnitude, index) of the largest scale axis (first one on
    ties, as jnp.argmax)."""
    R = quat_to_rotmat(quat)
    axis = torch.argmax(scale, dim=-1)
    max_scaling = torch.gather(scale, 1, axis[:, None])[:, 0]
    dirs = torch.gather(R, 2, axis[:, None, None].expand(-1, 3, 1))[..., 0]
    return dirs, max_scaling, axis


def set_axis_value(arr: torch.Tensor, axis_idx: torch.Tensor,
                   value: torch.Tensor) -> torch.Tensor:
    """arr[i, axis_idx[i]] = value[i] for (N, 3) arrays, functionally."""
    onehot = torch.nn.functional.one_hot(axis_idx, arr.shape[-1]).to(arr.dtype)
    return arr * (1 - onehot) + onehot * value[..., None]
