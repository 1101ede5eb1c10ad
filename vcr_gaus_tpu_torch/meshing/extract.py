"""Mesh extraction (vcr_gaus_tpu/meshing/extract.py): a depth sweep through
the renderer (the forward compositing kernel once per view), the masks,
TSDF fusion on the card, marching tetrahedra and the cleanup on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.cameras import Camera
from ..models.gaussians import GaussianState
from ..render.renderer import RenderConfig, render
from ..utils import graphics as G
from ..utils import math as M
from . import tsdf as T


def _view_arrays(cam, device):
    return cam.arrays(device, pixels=False) if isinstance(cam, Camera) else cam


@torch.no_grad()
def _view_depth(state, arr, rcfg, bg, sh_degree, scene_extent, alpha_thr,
                normalize_depth, classifier=None):
    """(A view's depth, alpha-normalized (depth / max(alpha, 1e-6)) or raw,
    zero where alpha <= alpha_thr; the render's outputs)."""
    out = render(state, arr, rcfg, bg, sh_degree, scene_extent=scene_extent,
                 classifier=classifier)
    alpha = out["alpha"]
    depth = (out["depth"] / torch.clamp_min(alpha, 1e-6) if normalize_depth
             else out["depth"])
    return T.mask_depth(depth, alpha, alpha_thr), out


def _foreground(cam, rcfg, device) -> torch.Tensor | None:
    """The camera's stored mask > 0 at the render's size, or None when it
    has none (only the mask is decoded)."""
    m = (cam._component("mask") if isinstance(cam, Camera)
         else getattr(cam, "mask", None))
    if m is None:
        return None
    m = torch.as_tensor(np.asarray(m.cpu() if torch.is_tensor(m) else m))
    if tuple(m.shape) != (rcfg.height, rcfg.width):
        return None
    return (m > 0).to(device)


def _background(bg_color, device) -> torch.Tensor:
    return (torch.as_tensor(np.asarray(bg_color, np.float32), device=device)
            if bg_color is not None
            else torch.zeros(3, dtype=torch.float32, device=device))


def extract_mesh_from_state(
    state: GaussianState,
    cameras: list,
    rcfg: RenderConfig,
    trans,
    scale,
    voxel_size: float = 0.004,
    alpha_thr: float = 0.5,
    stride: int = 1,
    max_depth: float | None = None,
    sem_classifier=None,
    background_cls: int = 0,
    min_weight: float = 1.0,
    n_clusters: int = 1,
    sh_degree: int = 3,
    scene_extent: float = 1e9,
    bg_color=None,
    progress=None,
    normalize_depth: bool = True,
    mask_cut: bool = False,
):
    """Fuse the depth renders of every ``stride``-th camera into the box's
    grid and extract the isosurface; runs on the state's device. Returns
    (verts (V,3), faces (F,3)).

    Per view: alpha <= alpha_thr -> 0, with ``mask_cut`` a pixel the
    camera's stored mask marks as background (<= 0) -> 0 (a camera without
    a mask of the render's size is not cut), depth >= max_depth -> 0, a
    back-projected point outside the meta box -> 0, and with
    ``sem_classifier`` (a callable (S,H,W) -> (num_cls,H,W)) a pixel whose
    argmax class is ``background_cls`` -> 0. ``normalize_depth`` fuses
    depth / alpha (the expected depth) in place of the raw alpha-weighted
    render."""
    dev = state.params.xyz.device
    grid = T.create_grid(trans, scale, voxel_size, device=dev)
    bg = _background(bg_color, dev)
    for idx, cam in enumerate(cameras[::stride]):
        arr = _view_arrays(cam, dev)
        depth, out = _view_depth(state, arr, rcfg, bg, sh_degree,
                                 scene_extent, alpha_thr, normalize_depth,
                                 sem_classifier)
        fg = _foreground(cam, rcfg, dev) if mask_cut else None
        if fg is not None:
            depth = torch.where(fg, depth, 0.0)
        if max_depth is not None:
            depth = torch.where(depth < max_depth, depth, 0.0)
        K = torch.eye(3, device=dev)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = arr.intr
        _, world = G.depth_to_points_world(depth, K, arr.viewmatrix)
        inside, _ = M.get_inside_normalized(world.reshape(-1, 3), trans,
                                            scale)
        depth = torch.where(inside.reshape(depth.shape), depth, 0.0)
        if sem_classifier is not None and "render_sem" in out:
            labels = torch.argmax(out["render_sem"], dim=0)
            depth = torch.where(labels != background_cls, depth, 0.0)
        T.integrate(grid, depth, arr.viewmatrix, arr.intr)
        if progress is not None:
            progress(idx)
    return T.extract_mesh(grid, min_weight=min_weight, n_clusters=n_clusters)


def extract_mesh_unbounded_from_state(
    state: GaussianState,
    cameras: list,
    rcfg: RenderConfig,
    resolution: int = 320,
    alpha_thr: float = 0.5,
    stride: int = 1,
    sh_degree: int = 3,
    scene_extent: float = 1e9,
    bg_color=None,
    n_clusters: int = 1,
    progress=None,
    normalize_depth: bool = True,
):
    """Unbounded-scene meshing through the mip-360 contraction: the world
    normalized by the cameras' bounding sphere, depth fused into a dense
    contracted grid, marching tetrahedra, vertices inverse-contracted."""
    centers = np.stack([
        (c.camera_center if isinstance(c, Camera) else
         c.cam_center.cpu().numpy()) for c in cameras])
    center = centers.mean(0)
    radius = float(np.linalg.norm(centers - center, axis=1).max()) * 1.1
    dev = state.params.xyz.device
    grid = T.create_contracted_grid(center, radius, resolution, device=dev)
    bg = _background(bg_color, dev)
    for idx, cam in enumerate(cameras[::stride]):
        arr = _view_arrays(cam, dev)
        depth, _ = _view_depth(state, arr, rcfg, bg, sh_degree,
                               scene_extent, alpha_thr, normalize_depth)
        T.integrate(grid, depth, arr.viewmatrix, arr.intr)
        if progress is not None:
            progress(idx)
    return T.extract_mesh(grid, min_weight=1.0, n_clusters=n_clusters)


def save_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    from ..utils.ply import write_ply
    write_ply(path, {"x": verts[:, 0].astype(np.float32),
                     "y": verts[:, 1].astype(np.float32),
                     "z": verts[:, 2].astype(np.float32)}, faces=faces)


def load_mesh_ply(path: str):
    from ..utils.ply import read_ply
    d = read_ply(path)
    verts = np.stack([d["x"], d["y"], d["z"]], 1)
    return verts, d.get("__faces__", np.zeros((0, 3), np.int64))
