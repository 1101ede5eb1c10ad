"""Camera/projection math (vcr_gaus_tpu/utils/graphics.py).

4x4 transforms are stored ROW-VECTOR style (transposed vs. the column
convention); points transform as ``p_out = p_hom @ M``; the projection
matrix is the 3DGS/GLM one with z in [0,1]. The constructors are numpy; the
per-pixel helpers take tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def fov2focal(fov, pixels):
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal, pixels):
    return 2 * math.atan(pixels / (2 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=np.zeros(3), scale=1.0) -> np.ndarray:
    """World->camera 4x4 (column convention) with optional recentering.
    ``R`` is the camera-to-world rotation as the COLMAP reader stores it."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
    return np.float32(np.linalg.inv(C2W))


def projection_matrix(znear, zfar, fovx, fovy) -> np.ndarray:
    """3DGS perspective projection; column convention."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def intrinsic_matrix(fovx, fovy, h, w) -> np.ndarray:
    """Pixel intrinsics with the principal point at the image center."""
    K = np.eye(3, dtype=np.float32)
    K[0, 0] = fov2focal(fovx, w)
    K[1, 1] = fov2focal(fovy, h)
    K[0, 2] = w / 2
    K[1, 2] = h / 2
    return K


def depth_to_points_cam(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Back-project a (H,W) z-depth map to camera-space points (H,W,3) at
    half-pixel centers."""
    H, W = depth.shape
    ys = torch.arange(H, dtype=torch.float32, device=depth.device) + 0.5
    xs = torch.arange(W, dtype=torch.float32, device=depth.device) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x = (px - cx) / fx * depth
    y = (py - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def transform_points(pts: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """``[pts, 1] @ M`` for a row-vector 4x4 ``M``, (..., 4), as elementwise
    products summed pairwise, (p0 M0 + p1 M1) + (p2 M2 + M3): the order of
    XLA's CPU matmul, and no TF32 on the card."""
    return ((pts[..., 0:1] * M[0] + pts[..., 1:2] * M[1])
            + (pts[..., 2:3] * M[2] + M[3]))


def depth_to_points_world(depth: torch.Tensor, K: torch.Tensor,
                          w2c_rowmajor: torch.Tensor):
    """(camera-space points, world points), each (H,W,3), of a z-depth map;
    ``w2c_rowmajor`` is the row-vector world->camera transform as cameras
    store it."""
    cam = depth_to_points_cam(depth, K)
    c2w = torch.linalg.inv(w2c_rowmajor.T)
    return cam, transform_points(cam, c2w.T)[..., :3]


def _grad_axis(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Central differences inside, one-sided at the borders."""
    n = a.shape[dim]
    interior = (a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)) / 2.0
    first = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
    last = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
    return torch.cat([first, interior, last], dim=dim)


def compute_normals_from_depth(depth: torch.Tensor, K: torch.Tensor):
    """Depth map -> camera-space normals (H,W,3) from the cross product of
    the image-space gradients of the back-projected points."""
    pts = depth_to_points_cam(depth, K)
    n = torch.linalg.cross(_grad_axis(pts, 1), _grad_axis(pts, 0), dim=-1)
    # eps inside the rsqrt keeps flat/empty pixels finite
    return n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-24)
