"""The renderer (vcr_gaus_tpu/render/renderer.py): activations -> SH->RGB
-> shortest-axis normals flipped along the view -> EWA projection -> tile
binning -> the compositing kernel -> channel post-processing (normalized
normal, depth mask, depth->normal estimate, depth_var/distortion from the
moments). ``render_stats`` projects and bins the same way and runs the
stats kernel instead: per-Gaussian pixel hits and importance."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..data.cameras import CameraArrays
from ..models.gaussians import GaussianState
from ..ops import projection as PF
from ..ops import rasterize as R
from ..train import losses as L
from ..utils import graphics as G
from ..utils import tracing
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
    # spans read by torch.profiler (the benchmark's readers, chip_smoke.py's
    # phase "profile"); with no profiler a span is one check (utils/tracing)
    with tracing.span("render.project"):
        var = PF.Variant(cfg.width, cfg.height, sh_degree, cfg.ch_sem,
                         cfg.return_normal, cfg.scale_modifier)
        pre = PF.preprocess(state.params, state.active,
                            PF.camera_vector(cam), var)
        feats, radius = pre.feats, pre.radius
        cam_vec = torch.cat([cam.intr, bg_color.to(cam.intr),
                             cam.intr.new_zeros(1)]).contiguous()
        dummy = (densify_dummy if densify_dummy is not None
                 else feats.new_zeros((feats.shape[0], 2)))
    img, binn = R.rasterize_image(feats, dummy, pre.mean2d, radius,
                                  pre.depth_z, cam_vec, cfg.width, cfg.height,
                                  cfg.ch_sem, cfg.depth_mode, extents=pre.ext)

    with tracing.span("render.post"):
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
    with tracing.span("render.project"):
        var = PF.Variant(cfg.width, cfg.height, None, 0, False,
                         cfg.scale_modifier)
        pre = PF.preprocess(state.params, state.active,
                            PF.camera_vector(cam), var)
    return R.rasterize_entry_stats(pre.feats, pre.mean2d, pre.radius,
                                   pre.depth_z, cfg.width, cfg.height,
                                   extents=pre.ext)
