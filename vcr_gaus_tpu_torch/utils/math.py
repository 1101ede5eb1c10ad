"""Quaternion / covariance math on tensors (vcr_gaus_tpu/utils/math.py)."""

from __future__ import annotations

import torch


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
