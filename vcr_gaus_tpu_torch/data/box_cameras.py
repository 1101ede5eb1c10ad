"""Cameras on the scene box for the visibility-gated densify
(vcr_gaus_tpu/data/box_cameras.py).

Cameras sit on the faces of the normalized scene box (the top face and the
four side faces) and look at a target below the top; the stats kernel
renders them to tell which Gaussians are visible from outside the scene
volume. The geometry is numpy float64 exactly as in the JAX package, so the
matrices equal its matrices bit for bit; only the finished matrices become
float32 tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import graphics as G
from ..utils.device import resolve_device
from .cameras import CameraArrays


def find_axis(R: np.ndarray, axis_name: str = "up"):
    """Which box axis a world direction (COLMAP frame: y down) maps to, and
    its sign."""
    axis_w = {"up": [0, -1, 0], "front": [0, 0, 1], "right": [1, 0, 0]}[
        axis_name]
    axis_c = R @ np.asarray(axis_w, np.float64)
    axis = int(np.argmax(np.abs(axis_c)))
    return axis, float(np.sign(axis_c[axis]) or 1.0)


def look_at_w2c(campos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """COLMAP-convention look-at rotation (rows: world->camera), forward
    = +z toward the target; the up vector switches to x when the view looks
    along y."""
    fwd = target - campos
    fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
    up = np.array([0.0, 1.0, 0.0])
    if abs(fwd @ up) > 0.999:
        up = np.array([1.0, 0.0, 0.0])
    right = np.cross(fwd, up)
    right /= max(np.linalg.norm(right), 1e-12)
    up = np.cross(right, fwd)
    return np.stack([right, up, fwd])


def _face_positions(n: int, up_axis: int, up_sign: float, up: bool,
                    around: bool, sample_mode: str, rng,
                    boundary: float = 0.9) -> np.ndarray:
    """Positions in normalized box coordinates [-1,1]^3 on the top face
    (n // 3 of them when both are on) and on the four side faces. In random
    mode every face draws a (k, 3) uniform block and overwrites one column,
    in the fixed face order, so the generator's stream is the JAX one."""
    side_axes = [a for a in range(3) if a != up_axis]
    pts = []
    n_up = n // 3 if (up and around) else (n if up else 0)
    n_around = n - n_up if around else 0
    if up and n_up > 0:
        if sample_mode == "random":
            q = rng.uniform(-1, 1, (n_up, 3))
        else:
            k = max(int(math.sqrt(n_up)), 1)
            g = np.linspace(-1, 1, k)
            gx, gy = np.meshgrid(g, g, indexing="xy")
            q = np.zeros((k * k, 3))
            q[:, side_axes[0]] = gx.ravel()
            q[:, side_axes[1]] = gy.ravel()
        q[:, up_axis] = up_sign
        pts.append(q)
    if around and n_around > 0:
        per_face = max(n_around // 4, 1)
        for face_axis, sign in ((side_axes[0], 1), (side_axes[0], -1),
                                (side_axes[1], 1), (side_axes[1], -1)):
            other = [a for a in range(3) if a != face_axis and a != up_axis]
            if sample_mode == "random":
                q = rng.uniform(-1, 1, (per_face, 3))
            else:
                k = max(int(math.sqrt(per_face)), 1)
                g = np.linspace(-1, 1, k)
                gx, gy = np.meshgrid(g, g, indexing="xy")
                q = np.zeros((k * k, 3))
                q[:, other[0]] = gx.ravel()
                q[:, up_axis] = gy.ravel()
            q[:, face_axis] = sign
            # pull the side cameras toward the top
            q[:, up_axis] = q[:, up_axis] * boundary + (1 - boundary) * up_sign
            pts.append(q)
    return np.concatenate(pts, 0) if pts else np.zeros((0, 3))


def sample_box_cameras(
    n: int, trans, scale, up: bool = True, around: bool = True,
    sample_mode: str = "grid", fov: float = 2.5, size: int = 512,
    seed: int = 0, device: str | torch.device = "cuda",
) -> list[CameraArrays]:
    """About ``n`` cameras of ``size`` x ``size`` pixels and field of view
    ``fov`` on the box surface, looking into the scene, as CameraArrays on
    ``device``. ``trans`` is the box's 3-vector offset or its 4x4 oriented
    transform. The consumer reads geometry only, so image, normal, depth
    and mask are 1x1 placeholders, as ``Camera.arrays(pixels=False)``
    gives."""
    dev = resolve_device(device)
    trans = np.asarray(trans, np.float64)
    scale = np.broadcast_to(np.asarray(scale, np.float64), (3,)).copy()
    rng = np.random.default_rng(seed)
    R_box = trans[:3, :3] if trans.ndim == 2 else np.eye(3)
    up_axis, up_sign = find_axis(R_box, "up")

    q = _face_positions(n, up_axis, up_sign, up, around, sample_mode, rng)
    # target: the centre, one unit below the top in box coordinates
    tgt_box = np.zeros(3)
    tgt_box[up_axis] = -up_sign

    def to_world(p):
        if trans.ndim == 2:
            return (p * scale - trans[:3, 3]) @ trans[:3, :3]
        return p * scale + trans

    target_w = to_world(tgt_box)
    proj = G.projection_matrix(0.01, 100.0, fov, fov).T
    tanf = math.tan(fov / 2)
    f = size / (2 * tanf)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    intr = t(np.array([f, f, size / 2, size / 2], np.float32))
    tanfov = t(np.array([tanf, tanf], np.float32))
    zeros3 = torch.zeros((3, 1, 1), dtype=torch.float32, device=dev)
    zeros1 = torch.zeros((1, 1), dtype=torch.float32, device=dev)
    mask = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    no = torch.tensor(False, device=dev)
    idx0 = torch.tensor(0, dtype=torch.int32, device=dev)
    cams = []
    for p in q:
        pos = to_world(p)
        R = look_at_w2c(pos, target_w)
        view = np.eye(4, dtype=np.float32)
        view[:3, :3] = R
        view[:3, 3] = -R @ pos
        viewm = view.T                              # row-vector convention
        cams.append(CameraArrays(
            viewmatrix=t(viewm), projmatrix=t((viewm @ proj).astype(
                np.float32)),
            cam_center=t(pos.astype(np.float32)), intr=intr, tanfov=tanfov,
            image=zeros3, normal=zeros3, depth=zeros1, mask=mask,
            has_normal=no, has_depth=no, has_mask=no, idx=idx0))
    return cams
