"""3D Gaussian -> screen projection (EWA splatting) and feature packing
(vcr_gaus_tpu/ops/projection.py).

The arithmetic is the JAX package's, written out component by component in
the same order, so the two agree to float32 rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.math import safe_normalize

# Packed per-Gaussian feature layout (columns of the (N, F) feature matrix).
F_MEAN_X = 0
F_MEAN_Y = 1
F_CONIC_A = 2
F_CONIC_B = 3
F_CONIC_C = 4
F_OPACITY = 5
F_DEPTH_Z = 6    # camera-space z of the mean
F_PLANE_D = 7    # dot(normal_cam, mean_cam) for ray-plane intersection depth
F_NORMAL = 8     # 8,9,10: camera-space normal (also the splat plane normal)
F_RGB = 11       # 11,12,13
F_SEM = 14       # 14 .. 14+S-1 semantic features
N_FIXED = 14


def feature_dim(ch_sem: int) -> int:
    return N_FIXED + ch_sem


class Projected(NamedTuple):
    mean2d: torch.Tensor     # (N,2) pixel coords
    conic: torch.Tensor      # (N,3) inverse 2D covariance (a,b,c)
    depth_z: torch.Tensor    # (N,) camera z
    radius: torch.Tensor     # (N,) int32 pixel radius (0 = culled)
    mean_cam: torch.Tensor   # (N,3) camera-space means
    ext: torch.Tensor        # (N,2) per-axis binning extents (pixels): the
                             # AABB of the alpha >= 1/255 level ellipse


def project_gaussians(
    means3d: torch.Tensor,       # (N,3)
    scales: torch.Tensor,        # (N,3) activated (positive) scales
    quats: torch.Tensor,         # (N,4) unnormalized quaternions
    viewmatrix: torch.Tensor,    # (4,4) world->cam, row-vector convention
    projmatrix: torch.Tensor,    # (4,4) full world->clip, row-vector convention
    tanfovx,
    tanfovy,
    width: int,
    height: int,
    scale_modifier: float = 1.0,
    opacity: torch.Tensor | None = None,
) -> Projected:
    """Near-plane cull at z <= 0.2, EWA Jacobian with the +-1.3 tanfov
    clamp, +0.3 px dilation, radius = ceil(3 sqrt(lambda_max)). With
    ``opacity`` the per-axis extents are the AABB of the alpha = 1/255 level
    set; without it, the 3-sigma AABB."""
    x, y, z3 = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    V = viewmatrix

    # camera-space position: [x y z 1] @ V (row-vector convention)
    tx = x * V[0, 0] + y * V[1, 0] + z3 * V[2, 0] + V[3, 0]
    ty = x * V[0, 1] + y * V[1, 1] + z3 * V[2, 1] + V[3, 1]
    tz = x * V[0, 2] + y * V[1, 2] + z3 * V[2, 2] + V[3, 2]
    p_view = torch.stack([tx, ty, tz], dim=-1)

    Pm = projmatrix
    cx = x * Pm[0, 0] + y * Pm[1, 0] + z3 * Pm[2, 0] + Pm[3, 0]
    cy = x * Pm[0, 1] + y * Pm[1, 1] + z3 * Pm[2, 1] + Pm[3, 1]
    cw = x * Pm[0, 3] + y * Pm[1, 3] + z3 * Pm[2, 3] + Pm[3, 3]
    p_w = 1.0 / (cw + 1e-7)

    q = safe_normalize(quats)
    qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    s0 = scales[:, 0] * scale_modifier
    s1 = scales[:, 1] * scale_modifier
    s2 = scales[:, 2] * scale_modifier

    fx = width / (2.0 * tanfovx)
    fy = height / (2.0 * tanfovy)
    tz_safe = torch.where(torch.abs(tz) < 1e-6, 1e-6, tz)
    lim_x, lim_y = 1.3 * tanfovx, 1.3 * tanfovy
    txtz = torch.clamp(tx / tz_safe, -lim_x, lim_x) * tz
    tytz = torch.clamp(ty / tz_safe, -lim_y, lim_y) * tz

    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    # J rows: [fx/z, 0, -fx*tx/z^2], [0, fy/z, -fy*ty/z^2]; T = J @ W^T with
    # W = V[:3,:3] the world->cam rotation (W[i,j] = V[j,i])
    j00 = fx * inv_z
    j02 = -fx * txtz * inv_z2
    j11 = fy * inv_z
    j12 = -fy * tytz * inv_z2
    t00 = j00 * V[0, 0] + j02 * V[0, 2]
    t01 = j00 * V[1, 0] + j02 * V[1, 2]
    t02 = j00 * V[2, 0] + j02 * V[2, 2]
    t10 = j11 * V[0, 1] + j12 * V[0, 2]
    t11 = j11 * V[1, 1] + j12 * V[1, 2]
    t12 = j11 * V[2, 1] + j12 * V[2, 2]

    # U = T @ (R diag(s)); cov2d = U U^T
    m00 = t00 * r00 + t01 * r10 + t02 * r20
    m01 = t00 * r01 + t01 * r11 + t02 * r21
    m02 = t00 * r02 + t01 * r12 + t02 * r22
    m10 = t10 * r00 + t11 * r10 + t12 * r20
    m11 = t10 * r01 + t11 * r11 + t12 * r21
    m12 = t10 * r02 + t11 * r12 + t12 * r22
    u00, u01, u02 = m00 * s0, m01 * s1, m02 * s2
    u10, u11, u12 = m10 * s0, m11 * s1, m12 * s2

    a = u00 * u00 + u01 * u01 + u02 * u02 + 0.3
    b = u00 * u10 + u01 * u11 + u02 * u12
    c = u10 * u10 + u11 * u11 + u12 * u12 + 0.3

    det = a * c - b * b
    det_safe = torch.where(det == 0, 1.0, det)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam1))

    # per-axis extents: the AABB of {0.5 x^T Sigma2d^-1 x = L} is
    # (sqrt(2 L Sigma_xx), sqrt(2 L Sigma_yy)); L = ln(255 op) is where alpha
    # crosses the 1/255 cutoff (L = 4.5 reproduces 3 sigma)
    if opacity is None:
        lvl = 4.5
    else:
        lvl = torch.clamp(torch.log(255.0 * torch.clamp_min(opacity, 1e-12)),
                          0.0, 4.5)
    ext_x = torch.ceil(torch.sqrt(2.0 * lvl * a))
    ext_y = torch.ceil(torch.sqrt(2.0 * lvl * c))
    if opacity is not None:
        dead = opacity * 255.0 <= 1.0
        ext_x = torch.where(dead, 0.0, ext_x)
        ext_y = torch.where(dead, 0.0, ext_y)

    mean2d = torch.stack(
        [((cx * p_w + 1.0) * width - 1.0) * 0.5,
         ((cy * p_w + 1.0) * height - 1.0) * 0.5], dim=-1)

    visible = (tz > 0.2) & (det > 0)
    # cull splats whose extent cannot touch the image
    in_image = ((mean2d[:, 0] + radius_f > 0) & (mean2d[:, 0] - radius_f < width)
                & (mean2d[:, 1] + radius_f > 0)
                & (mean2d[:, 1] - radius_f < height))
    keep = visible & in_image
    radius = torch.where(keep, radius_f, 0.0).detach().to(torch.int32)
    ext = torch.where(keep[:, None], torch.stack([ext_x, ext_y], dim=-1),
                      0.0).detach()
    return Projected(mean2d=mean2d, conic=conic, depth_z=p_view[:, 2],
                     radius=radius, mean_cam=p_view, ext=ext)


def pack_features(
    proj: Projected,
    opacity: torch.Tensor,             # (N,) activated
    rgb: torch.Tensor,                 # (N,3)
    normal_cam: torch.Tensor | None,   # (N,3) camera-space (may be None)
    sem: torch.Tensor | None,          # (N,S) or None
    ch_sem: int,
) -> torch.Tensor:
    """The packed (N, 14+S) feature matrix the compositor consumes."""
    if normal_cam is None:
        normal_cam = torch.zeros_like(proj.mean_cam)
    plane_d = torch.sum(normal_cam * proj.mean_cam, dim=-1)
    cols = [
        proj.mean2d[:, 0], proj.mean2d[:, 1],
        proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
        opacity, proj.depth_z, plane_d,
        normal_cam[:, 0], normal_cam[:, 1], normal_cam[:, 2],
        rgb[:, 0], rgb[:, 1], rgb[:, 2],
    ]
    if ch_sem:
        if sem is None or sem.shape[1] != ch_sem:
            raise ValueError(f"expected (N, {ch_sem}) semantic features")
        cols.extend(sem[:, i] for i in range(ch_sem))
    return torch.stack(cols, dim=-1)
