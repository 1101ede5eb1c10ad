"""The renderer (vcr_gaus_tpu/render/renderer.py): activations -> SH->RGB
-> shortest-axis normals flipped along the view -> EWA projection -> tile
binning -> the compositing kernel -> channel post-processing (normalized
normal, depth mask, depth->normal estimate, depth_var/distortion from the
moments). ``render_stats`` projects and bins the same way and runs the
stats kernel instead: per-Gaussian pixel hits and importance."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.profiler import record_function

from ..data.cameras import CameraArrays
from ..models.gaussians import GaussianState
from ..ops import projection as PF
from ..ops import rasterize as R
from ..train import losses as L
from ..utils import graphics as G
from ..utils import sh as SH
from ..utils.math import safe_normalize


class RenderConfig(NamedTuple):
    width: int
    height: int
    ch_sem: int = 0                   # semantic feature channels (0 = off)
    depth_mode: str = "intersection"  # 'traditional' | 'intersection'
    scale_modifier: float = 1.0
    mask_depth_thr: float = 0.8       # cfg.optim.mask_depth_thr
    return_normal: bool = True


def render(state: GaussianState, cam: CameraArrays, cfg: RenderConfig,
           bg_color: torch.Tensor, sh_degree: int,
           scene_extent: float = 1.0,
           densify_dummy: torch.Tensor | None = None,
           classifier=None) -> dict[str, Any]:
    """The JAX package's output dict: render (3,H,W), depth (H,W), normal
    (H,W,3), est_normal (H,W,3), alpha (H,W), mask (H,W) bool, radii (C,),
    visibility_filter (C,), densify_dummy (C,2), num_entries, overflow
    (always False), depth_var, distortion, and render_sem when ch_sem > 0:
    the (S,H,W) semantic features, or ``classifier`` of them, (num_cls,H,W)
    logits, when one is given.
    Runs on the device of the state's tensors and is differentiable in the
    state's parameters through torch.autograd; differentiate with respect
    to ``densify_dummy`` (zeros) for the |d mean2d| stream."""
    # spans read by torch.profiler (chip_smoke.py's phase "profile"); a
    # record_function costs nothing measurable when no profiler runs
    with record_function("render.project"):
        p = state.params
        xyz = p.xyz
        opacity = state.opacity[:, 0]

        proj = PF.project_gaussians(
            xyz, state.scaling, p.quat, cam.viewmatrix, cam.projmatrix,
            cam.tanfov[0], cam.tanfov[1], cfg.width, cfg.height,
            cfg.scale_modifier, opacity=opacity)
        radius = torch.where(state.active, proj.radius, 0)

        shs = torch.cat([p.f_dc, p.f_rest], dim=1).transpose(1, 2)
        dir_pp = safe_normalize(xyz - cam.cam_center[None])
        rgb = torch.clamp_min(SH.eval_sh(sh_degree, shs, dir_pp) + 0.5, 0.0)

        normal_cam = None
        if cfg.return_normal:
            normal = state.shortest_axis_normal()
            view_dir = xyz - cam.cam_center[None]
            sign = torch.where(torch.sum(view_dir * normal, -1) > 0,
                               1.0, -1.0)
            normal_cam = (normal * sign[:, None]) @ cam.viewmatrix[:3, :3]

        sem = p.obj_dc[:, 0, :] if cfg.ch_sem else None
        feats = PF.pack_features(proj, opacity, rgb, normal_cam, sem,
                                 cfg.ch_sem)
        cam_vec = torch.cat([cam.intr, bg_color.to(cam.intr),
                             cam.intr.new_zeros(1)]).contiguous()
        dummy = (densify_dummy if densify_dummy is not None
                 else xyz.new_zeros((xyz.shape[0], 2)))
    img, binn = R.rasterize_image(feats, dummy, proj.mean2d, radius,
                                  proj.depth_z, cam_vec, cfg.width, cfg.height,
                                  cfg.ch_sem, cfg.depth_mode, extents=proj.ext)

    with record_function("render.post"):
        wd_sum, wd2_sum, alpha = img[6], img[7], img[8]
        depth = wd_sum                      # alpha-weighted depth
        # camera foreground mask AND depth-threshold mask; a camera without a
        # mask counts as all foreground, mask_depth_thr <= 0 disables the cut
        if cfg.mask_depth_thr > 0:
            mask = depth < scene_extent * cfg.mask_depth_thr
        else:
            mask = torch.ones_like(depth, dtype=torch.bool)
        mask = mask & (~cam.has_mask | (cam.mask > 0))
        K = torch.eye(3, device=depth.device)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = cam.intr

        out = {
            "render": img[0:3],
            "depth": depth,
            "normal": safe_normalize(img[3:6].permute(1, 2, 0)),
            "est_normal": G.compute_normals_from_depth(depth, K),
            "alpha": alpha,
            "mask": mask,
            "radii": radius,
            "visibility_filter": radius > 0,
            "densify_dummy": dummy,
            "overflow": binn.overflow,
            "num_entries": binn.num_entries,
            "depth_var": L.depth_var_from_moments(alpha, wd_sum, wd2_sum),
            "distortion": L.distortion_from_moments(alpha, wd_sum, wd2_sum),
        }
        if cfg.ch_sem:
            sem_feat = img[9:9 + cfg.ch_sem]
            out["render_sem"] = (classifier(sem_feat) if classifier is not None
                                 else sem_feat)
    return out


@torch.no_grad()
def render_stats(state: GaussianState, cam: CameraArrays, cfg: RenderConfig):
    """Per-Gaussian (pixel hit count (C,), blending-weight importance (C,))
    over one view: projection with zero colour and no normal, inactive slots
    culled, binning, the stats kernel."""
    with record_function("render.project"):
        p = state.params
        opacity = state.opacity[:, 0]
        proj = PF.project_gaussians(
            p.xyz, state.scaling, p.quat, cam.viewmatrix, cam.projmatrix,
            cam.tanfov[0], cam.tanfov[1], cfg.width, cfg.height,
            cfg.scale_modifier, opacity=opacity)
        radius = torch.where(state.active, proj.radius, 0)
        rgb = torch.zeros_like(p.xyz)
        feats = PF.pack_features(proj, opacity, rgb, None, None, 0)
    return R.rasterize_entry_stats(feats, proj.mean2d, radius, proj.depth_z,
                                   cfg.width, cfg.height, extents=proj.ext)
