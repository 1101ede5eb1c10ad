"""DTU mesh culling by image masks and camera frusta
(vcr_gaus_tpu/evaluation/dtu_cull.py), without OpenCV.

A vertex survives if, in EVERY view, it projects inside the view's object
mask dilated by a 49x49 ellipse or outside the frustum; the projections
and the dilation run on the given device. The survivors are rescaled to
the ground truth's world by scale_mat and reduced to the largest connected
component on the host.

OpenCV's two calls have numpy counterparts here: ``decompose_projection``
is ``cv2.decomposeProjectionMatrix`` (OpenCV's Givens RQ, its sign
convention included), and ``ellipse_element`` is
``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, ...)``. A mask's first
channel as OpenCV reads it (BGR) is the blue one.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..utils.device import resolve_device

_DBL_EPSILON = np.finfo(np.float64).eps


def _givens(s: float, c: float) -> tuple[float, float]:
    z = 1.0 / np.sqrt(c * c + s * s + _DBL_EPSILON)
    return s * z, c * z


def rq_decomp3x3(M: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's RQDecomp3x3: M = R Q with R upper triangular, its first two
    diagonal entries non-negative, and Q a product of Givens rotations."""
    M = np.asarray(M, np.float64)
    s, c = _givens(M[2, 1], M[2, 2])
    Qx = np.array([[1, 0, 0], [0, c, s], [0, -s, c]])
    R = M @ Qx
    R[2, 1] = 0
    s, c = _givens(-R[2, 0], R[2, 2])
    Qy = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    M = R @ Qy
    M[2, 0] = 0
    s, c = _givens(M[1, 0], M[1, 1])
    Qz = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    R = M @ Qz
    R[1, 0] = 0
    # the decomposition's ambiguity: R[1,1] = (m10^2 + m11^2) / |.| >= 0 by
    # construction, so of OpenCV's three 180-degree turns only the one
    # about y, for R[0,0] < 0, can apply
    if R[0, 0] < 0:
        R[0, 0] *= -1
        R[0, 2] *= -1
        R[1, 2] *= -1
        R[2, 2] *= -1
        Qz = Qz.T.copy()
        Qy[0, 0] *= -1
        Qy[0, 2] *= -1
        Qy[2, 0] *= -1
        Qy[2, 2] *= -1
    return R, (Qz.T @ Qy.T) @ Qx.T


def decompose_projection(P: np.ndarray):
    """cv2.decomposeProjectionMatrix's first three outputs: (K (3,3),
    rotation (3,3), camera centre (4,1) homogeneous)."""
    P = np.asarray(P, np.float64)
    square = np.zeros((4, 4))
    square[:3] = P
    center = np.linalg.svd(square)[2][3].reshape(4, 1)
    K, R = rq_decomp3x3(P[:, :3])
    return K, R, center


def load_k_rt_from_p(P: np.ndarray):
    """Decompose a 3x4 projection into (K (4,4), c2w pose (4,4) float32)."""
    K, R, t = decompose_projection(P)
    K = K / K[2, 2]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.transpose()
    pose[:3, 3] = (t[:3] / t[3])[:, 0]
    return intrinsics, pose


def ellipse_element(radius: int) -> np.ndarray:
    """OpenCV's MORPH_ELLIPSE structuring element of size 2r+1: row i spans
    the columns within round(r sqrt(1 - (i-r)^2 / r^2)) of the centre."""
    size = 2 * radius + 1
    el = np.zeros((size, size), np.uint8)
    inv_r2 = 1.0 / (radius * radius) if radius else 0.0
    for i in range(size):
        dy = i - radius
        dx = int(np.rint(radius * np.sqrt((radius * radius - dy * dy)
                                          * inv_r2)))
        el[i, max(radius - dx, 0):min(radius + dx + 1, size)] = 1
    return el


def dilate(mask: torch.Tensor, element: torch.Tensor) -> torch.Tensor:
    """Binary dilation of an (H,W) bool mask by a centred structuring
    element, pixels beyond the border counting as background."""
    r = element.shape[0] // 2
    hits = torch.nn.functional.conv2d(
        mask.to(torch.float32)[None, None],
        element.to(torch.float32, copy=False)[None, None], padding=r)
    return hits[0, 0] > 0


def read_mask(path: str) -> np.ndarray:
    """The (H,W) bool object mask of a DTU mask image: its blue channel
    above 127."""
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))[:, :, 2] > 127


def cull_mesh_dtu(verts: np.ndarray, faces: np.ndarray, instance_dir: str,
                  width: int = 1600, height: int = 1200,
                  dilate_radius: int = 24,
                  device: str | torch.device = "cuda"):
    """Returns (culled verts in GT world units, culled faces)."""
    dev = resolve_device(device)
    cam = np.load(os.path.join(instance_dir, "cameras.npz"))
    mask_paths = sorted(glob.glob(os.path.join(instance_dir, "mask",
                                               "*.png")))
    element = torch.from_numpy(ellipse_element(dilate_radius)).to(dev)
    hom = torch.from_numpy(np.concatenate(
        [verts, np.ones((len(verts), 1))], 1)).to(dev)
    keep = torch.ones(len(verts), dtype=torch.bool, device=dev)
    for i, path in enumerate(mask_paths):
        P = (cam[f"world_mat_{i}"] @ cam[f"scale_mat_{i}"])[:3, :4]
        intr, pose = load_k_rt_from_p(P)
        w2c = np.linalg.inv(pose)
        proj = torch.from_numpy(intr[:3, :3] @ w2c[:3]).to(dev)
        pts_cam = hom @ proj.T                              # (V, 3) f64
        z = pts_cam[:, 2:3] + 1e-6
        uv = pts_cam[:, :2] / z
        in_frustum = ((uv[:, 0] >= 0) & (uv[:, 0] <= width - 1)
                      & (uv[:, 1] >= 0) & (uv[:, 1] <= height - 1)
                      & (z[:, 0] > 0))
        m = read_mask(path)
        if m.shape != (height, width):
            raise ValueError(f"{path} is {m.shape[1]}x{m.shape[0]}, the "
                             f"cull expects {width}x{height}")
        m = dilate(torch.from_numpy(m).to(dev), element)
        # in-range pixels for every vertex (NaN included); only those in
        # the frustum are read
        ui = torch.nan_to_num(torch.round(uv[:, 0])).clamp(0, width - 1)
        vi = torch.nan_to_num(torch.round(uv[:, 1])).clamp(0, height - 1)
        in_mask = m[vi.long(), ui.long()]
        # survive this view if inside its dilated mask OR outside its frustum
        keep &= in_mask | ~in_frustum

    vmask = keep.cpu().numpy()
    fmask = vmask[faces].all(axis=1)
    remap = np.full(len(verts), -1, np.int64)
    remap[vmask] = np.arange(vmask.sum())
    verts_c = verts[vmask]
    faces_c = remap[faces[fmask]].astype(np.int32)

    # to GT world units
    s = cam["scale_mat_0"]
    verts_c = verts_c * s[0, 0] + s[:3, 3][None]

    from ..meshing.marching import keep_largest_components
    return keep_largest_components(verts_c, faces_c, n_keep=1)
