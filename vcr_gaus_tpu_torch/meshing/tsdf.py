"""TSDF fusion of rendered depth maps into a dense voxel grid
(vcr_gaus_tpu/meshing/tsdf.py), as torch ops on the grid's device.

The grid holds the box (or the mip-360 contracted ball) at the voxel size
asked for: at the DTU protocol about 501^3 voxels, two float32 volumes of
0.5 GB each. ``integrate`` walks it in slabs of the X axis
(``SLAB_VOXELS``), so a view's temporaries hold one slab, with the JAX
package's arithmetic per voxel. The 4x4 products are elementwise
(``utils.graphics.transform_points``), never a TF32 matmul.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import graphics as G
from ..utils.device import resolve_device

SLAB_VOXELS = 1 << 24       # voxels per slab of integrate


class TSDFGrid(NamedTuple):
    tsdf: torch.Tensor      # (X,Y,Z) f32 in [-1,1] (truncated, normalized)
    weight: torch.Tensor    # (X,Y,Z) f32
    origin: np.ndarray      # (3,) box coords of voxel (0,0,0)
    spacing: np.ndarray     # (3,)
    trans: np.ndarray       # meta.json box transform ((3,) or (4,4))
    scale: np.ndarray       # box scale
    contracted: bool = False  # grid lives in mip-360 contracted coords


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x[..., 0:1] * x[..., 0:1] + x[..., 1:2] * x[..., 1:2])
                      + x[..., 2:3] * x[..., 2:3])


def contract(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """mip-NeRF 360 contraction: identity inside the unit ball,
    (2 - 1/|x|) x/|x| outside, into the radius-2 ball."""
    norm = _norm(x)
    safe = torch.clamp_min(norm, eps)
    return torch.where(norm <= 1.0, x, (2.0 - 1.0 / safe) * (x / safe))


def inv_contract(y: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Inverse contraction: the radius-2 ball -> world."""
    norm = _norm(y)
    safe = torch.clamp_min(norm, eps)
    return torch.where(norm <= 1.0, y,
                       (y / safe) / torch.clamp_min(2.0 - safe, eps))


def create_grid(trans, scale, voxel_size: float, bound: float = 1.0,
                device: str | torch.device = "cuda") -> TSDFGrid:
    """Dense grid over the normalized box [-bound, bound]^3, the voxel size
    in world units. The dims are the JAX package's numpy float32 ones."""
    dev = resolve_device(device)
    trans = np.asarray(trans, np.float32)
    scale = np.broadcast_to(np.asarray(scale, np.float32), (3,))
    world_extent = 2.0 * bound * scale
    dims = np.maximum((world_extent / voxel_size).astype(int) + 1, 2)
    spacing = world_extent / (dims - 1)
    origin = -bound * scale
    shape = tuple(int(d) for d in dims)
    return TSDFGrid(
        tsdf=torch.ones(shape, dtype=torch.float32, device=dev),
        weight=torch.zeros(shape, dtype=torch.float32, device=dev),
        origin=origin.astype(np.float32), spacing=spacing.astype(np.float32),
        trans=trans, scale=scale)


def create_contracted_grid(center, radius, resolution: int = 320,
                           device: str | torch.device = "cuda") -> TSDFGrid:
    """Dense grid over the contracted ball [-2, 2]^3 for unbounded scenes;
    ``center``/``radius`` map the cameras' region into the unit ball."""
    dev = resolve_device(device)
    dims = (resolution,) * 3
    return TSDFGrid(
        tsdf=torch.ones(dims, dtype=torch.float32, device=dev),
        weight=torch.zeros(dims, dtype=torch.float32, device=dev),
        origin=np.full(3, -2.0, np.float32),
        spacing=np.full(3, 4.0 / (resolution - 1), np.float32),
        trans=np.asarray(center, np.float32),
        scale=np.asarray(radius, np.float32), contracted=True)


def _box_coords(grid: TSDFGrid, x0: int, x1: int) -> torch.Tensor:
    """Grid coordinates of the voxels of X planes [x0, x1), (n, 3)."""
    dev = grid.tsdf.device
    dims = grid.tsdf.shape
    axes = [torch.tensor(grid.origin[a], device=dev)
            + torch.tensor(grid.spacing[a], device=dev)
            * torch.arange(dims[a], dtype=torch.float32, device=dev)
            for a in range(3)]
    axes[0] = axes[0][x0:x1]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def _to_world(grid: TSDFGrid, pts_box: torch.Tensor) -> torch.Tensor:
    """Grid coordinates -> world."""
    trans = torch.as_tensor(grid.trans, device=pts_box.device)
    if grid.contracted:
        scale = torch.tensor(np.array(grid.scale), device=pts_box.device)
        return inv_contract(pts_box) * scale + trans
    if trans.ndim == 2:
        # inverse of normalize (x_box = R x + t)
        q = pts_box - trans[:3, 3]
        R = trans[:3, :3]
        return (q[:, 0:1] * R[0] + q[:, 1:2] * R[1]) + q[:, 2:3] * R[2]
    return pts_box + trans


def _voxel_world_coords(grid: TSDFGrid) -> torch.Tensor:
    """World coordinates of all voxel centers, (X,Y,Z,3)."""
    return _to_world(grid, _box_coords(grid, 0, grid.tsdf.shape[0])).reshape(
        grid.tsdf.shape + (3,))


@torch.no_grad()
def integrate(grid: TSDFGrid, depth: torch.Tensor, viewmatrix: torch.Tensor,
              intr: torch.Tensor, sdf_trunc_vox: int = 4) -> TSDFGrid:
    """Integrate one masked depth map (H,W), invalid pixels <= 0: the
    projective TSDF with a running weighted average. Updates the grid's
    tensors in place, slab by slab, and returns the grid."""
    h, w = depth.shape
    dims = grid.tsdf.shape
    dev = grid.tsdf.device
    trunc = torch.tensor(np.float32(sdf_trunc_vox) * grid.spacing.min(),
                         device=dev)
    scale = torch.tensor(np.array(grid.scale), device=dev)
    planes = max(1, SLAB_VOXELS // (dims[1] * dims[2]))
    for x0 in range(0, dims[0], planes):
        x1 = min(x0 + planes, dims[0])
        pts_box = _box_coords(grid, x0, x1)
        cam = G.transform_points(_to_world(grid, pts_box), viewmatrix)
        x, y, z = cam[:, 0], cam[:, 1], cam[:, 2]
        u = intr[0] * x / z + intr[2]
        v = intr[1] * y / z + intr[3]
        # the pixel of a voxel that passes the bounds test below; the clamp
        # keeps every other index (NaN and inf included) inside the image
        ui = torch.nan_to_num(torch.round(u - 0.5)).clamp(0, w - 1).long()
        vi = torch.nan_to_num(torch.round(v - 0.5)).clamp(0, h - 1).long()
        d = depth[vi, ui]
        valid = ((z > 1e-4) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
                 & (d > 0))
        t = trunc
        if grid.contracted:
            # the world-space voxel grows with the contraction's Jacobian
            # 1/(2-|y|)^2 outside the unit ball; truncation follows it
            ynorm = _norm(pts_box)[:, 0]
            jac = torch.where(ynorm <= 1.0, 1.0,
                              1.0 / torch.clamp_min(2.0 - ynorm, 0.05) ** 2)
            t = trunc * jac * scale
        sdf = (d - z) / t
        valid = valid & (sdf > -1.0)
        sdf = sdf.clamp(-1.0, 1.0)
        w_old = grid.weight[x0:x1].reshape(-1)
        t_old = grid.tsdf[x0:x1].reshape(-1)
        w_new = w_old + valid.to(torch.float32)
        t_new = torch.where(valid, (t_old * w_old + sdf)
                            / torch.clamp_min(w_new, 1.0), t_old)
        grid.weight[x0:x1] = w_new.reshape(grid.weight[x0:x1].shape)
        grid.tsdf[x0:x1] = t_new.reshape(grid.tsdf[x0:x1].shape)
    return grid


def extract_mesh(grid: TSDFGrid, min_weight: float = 1.0,
                 n_clusters: int = 1):
    """Marching tetrahedra over the fused grid (unobserved voxels -> NaN),
    vertices mapped back to world space, then the largest-component
    cleanup. The grid comes to the host once. Returns (verts (V,3) f32,
    faces (F,3) i32)."""
    from .marching import keep_largest_components, marching_tets

    sdf = torch.where(grid.weight >= min_weight, grid.tsdf,
                      float("nan")).cpu().numpy()
    verts, faces = marching_tets(sdf, 0.0, origin=grid.origin,
                                 spacing=grid.spacing)
    trans = np.asarray(grid.trans)
    if grid.contracted:
        verts = inv_contract(torch.from_numpy(verts)).numpy() * np.asarray(
            grid.scale) + trans
    elif trans.ndim == 2:
        verts = (verts - trans[:3, 3]) @ trans[:3, :3]
    else:
        verts = verts + trans
    if n_clusters > 0 and len(faces):
        verts, faces = keep_largest_components(verts, faces, n_clusters)
    return verts, faces


def mask_depth(depth: torch.Tensor, alpha: torch.Tensor, alpha_thr: float,
               inside_mask: torch.Tensor | None = None,
               sem_fg: torch.Tensor | None = None) -> torch.Tensor:
    """Pre-integration depth masking: zero where alpha <= thr, outside the
    box, or semantic background."""
    d = torch.where(alpha > alpha_thr, depth, 0.0)
    if inside_mask is not None:
        d = torch.where(inside_mask, d, 0.0)
    if sem_fg is not None:
        d = torch.where(sem_fg, d, 0.0)
    return d
