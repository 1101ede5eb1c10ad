"""Camera matrices of the benchmark's views, worked out from their poses.

A frozen copy of the port's camera arithmetic (the 3DGS conventions):
row-vector 4x4 transforms (points transform as ``p_hom @ M``), the GLM
projection with z in [0, 1], the principal point at the image centre, the
camera extent as 1.1 x the largest distance of a camera centre from their
mean. Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

ZNEAR, ZFAR = 0.01, 100.0


def fov2focal(fov, pixels):
    return pixels / (2 * math.tan(fov / 2))


def world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """World->camera 4x4 (column convention); ``R`` is the camera-to-world
    rotation (the transpose of COLMAP's world-to-camera one)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    return np.float32(np.linalg.inv(C2W))


def projection_matrix(znear, zfar, fovx, fovy) -> np.ndarray:
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


class Cam(NamedTuple):
    """One view's geometry as float32 tensors."""
    viewmatrix: torch.Tensor     # (4,4) row-vector world->cam
    projmatrix: torch.Tensor     # (4,4) row-vector world->clip
    cam_center: torch.Tensor     # (3,)
    intr: torch.Tensor           # (4,) fx, fy, cx, cy
    tanfov: torch.Tensor         # (2,)


def qvec_to_rotmat(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def make_cam(qvec, tvec, fovx: float, fovy: float, width: int, height: int,
             device) -> Cam:
    """The view of a COLMAP pose (world-to-camera quaternion ``qvec``,
    translation ``tvec``) as the scene reader builds it: R is the
    camera-to-world rotation qvec_to_rotmat(qvec).T."""
    R = qvec_to_rotmat(np.asarray(qvec, np.float64)).T
    wv = world_to_view(R, np.asarray(tvec, np.float64)).T
    full = wv @ projection_matrix(ZNEAR, ZFAR, fovx, fovy).T
    center = np.linalg.inv(wv.T)[:3, 3]
    intr = np.array([fov2focal(fovx, width), fov2focal(fovy, height),
                     width / 2.0, height / 2.0], np.float32)
    tanfov = np.array([math.tan(fovx / 2), math.tan(fovy / 2)], np.float32)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return Cam(f32(wv), f32(full), f32(center), f32(intr), f32(tanfov))


def camera_extent(centers: np.ndarray) -> float:
    """1.1 x the largest distance of a camera centre from their mean."""
    c = np.asarray(centers, np.float64)
    return float(np.linalg.norm(c - c.mean(0), axis=1).max() * 1.1)
