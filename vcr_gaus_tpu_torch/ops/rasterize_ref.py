"""Brute-force reference compositor, the oracle of the tests
(vcr_gaus_tpu/ops/rasterize_ref.py).

O(N * H * W) front-to-back alpha compositing over depth-sorted Gaussians.
Output channel layout (C-major, (C_out, H, W)):
  0:3  rgb (background-blended)
  3:6  composited camera-space normal (no bg)
  6    depth  (sum w * d)
  7    depth^2 (sum w * d^2)
  8    alpha  (sum w == 1 - T_final)
  9:   semantic features (S channels)
"""

from __future__ import annotations

import torch

from . import projection as P

ALPHA_EPS = 1.0 / 255.0
ALPHA_CAP = 0.99


def out_channels(ch_sem: int) -> int:
    return 9 + ch_sem


def composite_reference(
    feats: torch.Tensor,            # (N, F) packed per-Gaussian features
    order: torch.Tensor,            # (N,) depth order (front first); N = pad
    height: int,
    width: int,
    bg: torch.Tensor,               # (3,)
    ch_sem: int,
    depth_mode: str = "traditional",   # or "intersection"
    cam_k: torch.Tensor | None = None,  # (4,) fx, fy, cx, cy
) -> torch.Tensor:
    n, F = feats.shape
    feats_pad = torch.cat([feats, feats.new_zeros((1, F))], dim=0)
    f = feats_pad[order]

    # alpha is sampled at integer pixel coordinates; ray directions use
    # half-pixel centers
    ys = torch.arange(height, dtype=torch.float32, device=feats.device)
    xs = torch.arange(width, dtype=torch.float32, device=feats.device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    pxf, pyf = px.reshape(-1), py.reshape(-1)

    dx = pxf[:, None] - f[None, :, P.F_MEAN_X]
    dy = pyf[:, None] - f[None, :, P.F_MEAN_Y]
    A, B, C = f[:, P.F_CONIC_A], f[:, P.F_CONIC_B], f[:, P.F_CONIC_C]
    power = -0.5 * (A[None] * dx * dx + C[None] * dy * dy) - B[None] * dx * dy
    alpha = f[None, :, P.F_OPACITY] * torch.exp(power)
    alpha = torch.where(power > 0, 0.0, alpha)
    alpha = torch.where(alpha < ALPHA_EPS, 0.0,
                        torch.clamp_max(alpha, ALPHA_CAP))

    one_minus = 1.0 - alpha
    cum = torch.cumprod(one_minus, dim=1)
    trans_excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    w = alpha * trans_excl
    t_final = torch.prod(one_minus, dim=1)

    if depth_mode == "intersection":
        fx, fy, cx, cy = cam_k[0], cam_k[1], cam_k[2], cam_k[3]
        dirx = (pxf + 0.5 - cx) / fx
        diry = (pyf + 0.5 - cy) / fy
        inv_norm = 1.0 / torch.sqrt(dirx * dirx + diry * diry + 1.0)
        dirx, diry, dirz = dirx * inv_norm, diry * inv_norm, inv_norm
        nx, ny, nz = f[:, P.F_NORMAL], f[:, P.F_NORMAL + 1], f[:, P.F_NORMAL + 2]
        denom = (dirx[:, None] * nx[None] + diry[:, None] * ny[None]
                 + dirz[:, None] * nz[None])
        denom = torch.where(torch.abs(denom) < 1e-2,
                            torch.where(denom < 0, -1e-2, 1e-2), denom)
        d = f[None, :, P.F_PLANE_D] / denom
    else:
        d = f[None, :, P.F_DEPTH_Z].expand_as(w)

    rgb = w @ f[:, P.F_RGB:P.F_RGB + 3] + t_final[:, None] * bg[None, :]
    nrm = w @ f[:, P.F_NORMAL:P.F_NORMAL + 3]
    chans = [rgb.T.reshape(3, height, width),
             nrm.T.reshape(3, height, width),
             torch.sum(w * d, dim=1).reshape(1, height, width),
             torch.sum(w * d * d, dim=1).reshape(1, height, width),
             torch.sum(w, dim=1).reshape(1, height, width)]
    if ch_sem:
        sem = w @ f[:, P.F_SEM:P.F_SEM + ch_sem]
        chans.append(sem.T.reshape(ch_sem, height, width))
    return torch.cat(chans, dim=0)


def depth_order(depth_z: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """Front-to-back order of visible Gaussians; culled ones sort to the end
    and index the zero pad row."""
    n = depth_z.shape[0]
    key = torch.where(radius > 0, depth_z, torch.inf)
    order = torch.argsort(key, stable=True)
    return torch.where(torch.isinf(key[order]), n, order)
