"""3D Gaussian -> screen projection (EWA splatting) and feature packing
(vcr_gaus_tpu/ops/projection.py), and the renderer's per-slot preprocess.

The arithmetic is the JAX package's, written out component by component in
the same order, so the two agree to float32 rounding.

``preprocess`` is the renderer's whole per-slot chain in one
``torch.autograd.Function``: activations, projection, SH -> RGB, the
shortest-axis normal flipped along the view, and the packing, from the
state's leaves in their own layouts to the packed (C, 14+S) features and
binning's inputs: the radius (masked by ``active``), the extents, and the
mean2d and depth columns again, contiguous. On a CUDA tensor its
forward launches the hand-written kernel ``csrc/preprocess.cu``
(``vcr_preprocess_fwd``) and its backward the kernel ``vcr_preprocess_bwd``,
or raises. Only tensors on the CPU take the plain versions:
``preprocess_torch``, the eager chain as the renderer ran it, and
``preprocess_backward_torch``, its closed-form gradient, which recomputes
the forward's terms and mirrors the backward kernel. The JAX package has no
such kernel: there XLA fuses the chain.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..models.gaussians import GaussianParams
from ..utils import math as M
from ..utils import sh as SH
from ..utils import tracing
from . import cuda_build
from .cuda_build import LAUNCHES

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

MAX_CH_SEM = 8       # the preprocess kernel writes 0..8 semantic columns
# the packed camera of ``camera_vector``: viewmatrix (16, row-major),
# projmatrix (16), cam_center (3), tanfov (2)
CAM_VIEW, CAM_PROJ, CAM_CENTER, CAM_TANFOV, CAM_FLOATS = 0, 16, 32, 35, 37


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


class _Terms(NamedTuple):
    """The projection's intermediate columns, shared by the forward and the
    closed-form backward."""
    tx: torch.Tensor         # camera-space mean
    ty: torch.Tensor
    tz: torch.Tensor
    cx: torch.Tensor         # clip-space x, y and 1 / (w + 1e-7)
    cy: torch.Tensor
    p_w: torch.Tensor
    q: list                  # normalized quaternion (w, x, y, z)
    R: list                  # R[i][j], rotation of the normalized quaternion
    s: list                  # modified scales
    fx: torch.Tensor
    fy: torch.Tensor
    tz_safe: torch.Tensor
    ux: torch.Tensor         # tx / tz_safe, ty / tz_safe before the clamp
    uy: torch.Tensor
    lim_x: torch.Tensor
    lim_y: torch.Tensor
    txtz: torch.Tensor
    tytz: torch.Tensor
    inv_z: torch.Tensor
    inv_z2: torch.Tensor
    T: list                  # T[r][j] = (J W^T)[r][j]
    Mx: list                 # Mx[r][k] = (T R)[r][k]
    U: list                  # U[r][k] = Mx[r][k] s[k]
    a: torch.Tensor          # 2D covariance (a, b; b, c), dilated
    b: torch.Tensor
    c: torch.Tensor
    det: torch.Tensor
    det_safe: torch.Tensor


def _terms(means3d, scales, quats, V, Pm, tanfovx, tanfovy, width, height,
           scale_modifier) -> _Terms:
    x, y, z3 = means3d[:, 0], means3d[:, 1], means3d[:, 2]

    # camera-space position: [x y z 1] @ V (row-vector convention)
    tx = x * V[0, 0] + y * V[1, 0] + z3 * V[2, 0] + V[3, 0]
    ty = x * V[0, 1] + y * V[1, 1] + z3 * V[2, 1] + V[3, 1]
    tz = x * V[0, 2] + y * V[1, 2] + z3 * V[2, 2] + V[3, 2]

    cx = x * Pm[0, 0] + y * Pm[1, 0] + z3 * Pm[2, 0] + Pm[3, 0]
    cy = x * Pm[0, 1] + y * Pm[1, 1] + z3 * Pm[2, 1] + Pm[3, 1]
    cw = x * Pm[0, 3] + y * Pm[1, 3] + z3 * Pm[2, 3] + Pm[3, 3]
    p_w = 1.0 / (cw + 1e-7)

    qn = M.safe_normalize(quats)
    q = [qn[:, i] for i in range(4)]
    qw, qx, qy, qz = q
    R = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
          2 * (qx * qz + qw * qy)],
         [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
          2 * (qy * qz - qw * qx)],
         [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
          1 - 2 * (qx * qx + qy * qy)]]
    s = [scales[:, k] * scale_modifier for k in range(3)]

    fx = width / (2.0 * tanfovx)
    fy = height / (2.0 * tanfovy)
    tz_safe = torch.where(torch.abs(tz) < 1e-6, 1e-6, tz)
    lim_x, lim_y = 1.3 * tanfovx, 1.3 * tanfovy
    ux, uy = tx / tz_safe, ty / tz_safe
    txtz = torch.clamp(ux, -lim_x, lim_x) * tz
    tytz = torch.clamp(uy, -lim_y, lim_y) * tz

    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    # J rows: [fx/z, 0, -fx*tx/z^2], [0, fy/z, -fy*ty/z^2]; T = J @ W^T with
    # W = V[:3,:3] the world->cam rotation (W[i,j] = V[j,i])
    j00 = fx * inv_z
    j02 = -fx * txtz * inv_z2
    j11 = fy * inv_z
    j12 = -fy * tytz * inv_z2
    T = [[j00 * V[j, 0] + j02 * V[j, 2] for j in range(3)],
         [j11 * V[j, 1] + j12 * V[j, 2] for j in range(3)]]

    # U = T @ (R diag(s)); cov2d = U U^T
    Mx = [[T[r][0] * R[0][k] + T[r][1] * R[1][k] + T[r][2] * R[2][k]
           for k in range(3)] for r in range(2)]
    U = [[Mx[r][k] * s[k] for k in range(3)] for r in range(2)]
    (u00, u01, u02), (u10, u11, u12) = U

    a = u00 * u00 + u01 * u01 + u02 * u02 + 0.3
    b = u00 * u10 + u01 * u11 + u02 * u12
    c = u10 * u10 + u11 * u11 + u12 * u12 + 0.3
    det = a * c - b * b
    det_safe = torch.where(det == 0, 1.0, det)
    return _Terms(tx, ty, tz, cx, cy, p_w, q, R, s, fx, fy, tz_safe,
                  ux, uy, lim_x, lim_y, txtz, tytz, inv_z, inv_z2, T, Mx, U,
                  a, b, c, det, det_safe)


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
    t = _terms(means3d, scales, quats, viewmatrix, projmatrix, tanfovx,
               tanfovy, width, height, scale_modifier)
    a, b, c, det, det_safe = t.a, t.b, t.c, t.det, t.det_safe
    p_view = torch.stack([t.tx, t.ty, t.tz], dim=-1)
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
        [((t.cx * t.p_w + 1.0) * width - 1.0) * 0.5,
         ((t.cy * t.p_w + 1.0) * height - 1.0) * 0.5], dim=-1)

    visible = (t.tz > 0.2) & (det > 0)
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


# --- the renderer's per-slot preprocess -------------------------------------

class Preprocessed(NamedTuple):
    """What the preprocess gives: the packed features, differentiable, and
    binning's inputs, which carry no gradient."""
    feats: torch.Tensor          # (C, 14+S) f32
    radius: torch.Tensor         # (C,) int32, 0 where culled or inactive
    ext: torch.Tensor            # (C, 2) f32 binning extents
    mean2d: torch.Tensor         # (C, 2) f32, feats' columns 0-1
    depth_z: torch.Tensor        # (C,) f32, feats' column 6


class Variant(NamedTuple):
    """What one preprocess call computes, beyond its tensors."""
    width: int
    height: int
    sh_degree: int | None        # 0..3; None: zero colour (no SH)
    ch_sem: int                  # semantic columns packed (obj_dc's, 0..8)
    with_normal: bool            # the normal and plane columns, else zeros
    scale_modifier: float = 1.0


def camera_vector(cam) -> torch.Tensor:
    """The (37,) f32 camera the preprocess reads, on the camera's device:
    viewmatrix and projmatrix (row-major), cam_center, tanfov."""
    return torch.cat([cam.viewmatrix.reshape(16), cam.projmatrix.reshape(16),
                      cam.cam_center.reshape(3), cam.tanfov.reshape(2)]
                     ).to(torch.float32)


def _camera(cam: torch.Tensor):
    """(V (4,4), P (4,4), centre (3,), tanfovx, tanfovy) of ``cam``."""
    return (cam[CAM_VIEW:CAM_VIEW + 16].reshape(4, 4),
            cam[CAM_PROJ:CAM_PROJ + 16].reshape(4, 4),
            cam[CAM_CENTER:CAM_CENTER + 3], cam[CAM_TANFOV],
            cam[CAM_TANFOV + 1])


def preprocess_torch(lv: GaussianParams, active: torch.Tensor,
                     cam: torch.Tensor, var: Variant) -> Preprocessed:
    """The plain version: the renderer's eager chain. Differentiable in the
    leaves through autograd."""
    V, Pm, center, tfx, tfy = _camera(cam)
    scaling = torch.exp(lv.log_scale)
    opacity = torch.sigmoid(lv.logit_opacity)[:, 0]
    proj = project_gaussians(lv.xyz, scaling, lv.quat, V, Pm, tfx, tfy,
                             var.width, var.height, var.scale_modifier,
                             opacity=opacity)
    radius = torch.where(active, proj.radius, 0)
    if var.sh_degree is None:
        rgb = torch.zeros_like(lv.xyz)
    else:
        shs = torch.cat([lv.f_dc, lv.f_rest], dim=1).transpose(1, 2)
        dir_pp = M.safe_normalize(lv.xyz - center[None])
        rgb = torch.clamp_min(SH.eval_sh(var.sh_degree, shs, dir_pp) + 0.5,
                              0.0)
    normal_cam = None
    if var.with_normal:
        normal = M.shortest_axis_normal(scaling, lv.quat)
        view_dir = lv.xyz - center[None]
        sign = torch.where(torch.sum(view_dir * normal, -1) > 0, 1.0, -1.0)
        normal_cam = (normal * sign[:, None]) @ V[:3, :3]
    sem = lv.obj_dc[:, 0, :] if var.ch_sem else None
    feats = pack_features(proj, opacity, rgb, normal_cam, sem, var.ch_sem)
    return Preprocessed(feats, radius, proj.ext, proj.mean2d.detach(),
                        proj.depth_z.detach())


def _rsqrt_norm_backward(g, v, rs):
    """Gradient through n = v * rsqrt(|v|^2 + eps) (``safe_normalize``):
    rs g - rs^3 (g . v) v, per column lists ``g`` and ``v``."""
    gv = sum(gi * vi for gi, vi in zip(g, v))
    rs3 = rs * rs * rs
    return [rs * gi - rs3 * gv * vi for gi, vi in zip(g, v)]


def preprocess_backward_torch(g: torch.Tensor, lv: GaussianParams,
                              cam: torch.Tensor,
                              var: Variant) -> GaussianParams:
    """The plain version of the backward kernel: the gradient of
    sum(g * feats) over the leaves, for ``g`` (C, 14+S), with the forward's
    terms recomputed from the leaves and the camera. What autograd of
    ``preprocess_torch`` differentiates, in closed form: the tanfov clamp's
    zero gradient outside the clamp, the tz_safe and det_safe branches,
    safe_normalize's eps inside the rsqrt, the SH direction's gradient into
    the mean, the colour's clamp_min mask, the shortest axis's gather with
    its detached sign, plane_d into both the normal and the mean. Radius and
    extents carry no gradient. obj_dc's gradient is None when no semantic
    column is packed."""
    V, Pm, center, tfx, tfy = _camera(cam)
    s_raw = torch.exp(lv.log_scale)
    t = _terms(lv.xyz, s_raw, lv.quat, V, Pm, tfx, tfy, var.width,
               var.height, var.scale_modifier)
    col = [g[:, i] for i in range(g.shape[1])]
    R, T, Mx, U = t.R, t.T, t.Mx, t.U

    # conic (c, -b, a) / det_safe; det_safe = det unless det == 0
    ds = t.det_safe
    g_a = col[F_CONIC_C] / ds
    g_b = -col[F_CONIC_B] / ds
    g_c = col[F_CONIC_A] / ds
    g_ds = -(col[F_CONIC_A] * t.c - col[F_CONIC_B] * t.b
             + col[F_CONIC_C] * t.a) / (ds * ds)
    g_ds = torch.where(t.det == 0, 0.0, g_ds)
    g_a = g_a + g_ds * t.c
    g_c = g_c + g_ds * t.a
    g_b = g_b - 2.0 * t.b * g_ds

    # a = sum U0k^2 + 0.3, b = sum U0k U1k, c = sum U1k^2 + 0.3
    gU = [[2.0 * U[0][k] * g_a + U[1][k] * g_b for k in range(3)],
          [2.0 * U[1][k] * g_c + U[0][k] * g_b for k in range(3)]]
    g_s = [gU[0][k] * Mx[0][k] + gU[1][k] * Mx[1][k] for k in range(3)]
    gM = [[gU[r][k] * t.s[k] for k in range(3)] for r in range(2)]
    gT = [[sum(gM[r][k] * R[j][k] for k in range(3)) for j in range(3)]
          for r in range(2)]
    gR = [[sum(gM[r][k] * T[r][j] for r in range(2)) for k in range(3)]
          for j in range(3)]

    # T0j = j00 V[j,0] + j02 V[j,2], T1j = j11 V[j,1] + j12 V[j,2]
    g_j00 = sum(gT[0][j] * V[j, 0] for j in range(3))
    g_j02 = sum(gT[0][j] * V[j, 2] for j in range(3))
    g_j11 = sum(gT[1][j] * V[j, 1] for j in range(3))
    g_j12 = sum(gT[1][j] * V[j, 2] for j in range(3))
    g_inv_z2 = -(t.fx * t.txtz * g_j02 + t.fy * t.tytz * g_j12)
    g_inv_z = t.fx * g_j00 + t.fy * g_j11 + 2.0 * t.inv_z * g_inv_z2
    g_txtz = -t.fx * t.inv_z2 * g_j02
    g_tytz = -t.fy * t.inv_z2 * g_j12
    # txtz = clamp(ux, -lim, lim) * tz: the clamp passes inside its bounds
    g_tz = (torch.clamp(t.ux, -t.lim_x, t.lim_x) * g_txtz
            + torch.clamp(t.uy, -t.lim_y, t.lim_y) * g_tytz)
    g_ux = torch.where((t.ux >= -t.lim_x) & (t.ux <= t.lim_x),
                       t.tz * g_txtz, 0.0)
    g_uy = torch.where((t.uy >= -t.lim_y) & (t.uy <= t.lim_y),
                       t.tz * g_tytz, 0.0)
    g_tx = g_ux / t.tz_safe
    g_ty = g_uy / t.tz_safe
    g_tzs = (-(g_ux * t.ux + g_uy * t.uy) / t.tz_safe
             - g_inv_z * t.inv_z2)
    g_tz = g_tz + torch.where(torch.abs(t.tz) < 1e-6, 0.0, g_tzs)
    g_tz = g_tz + col[F_DEPTH_Z]

    # mean2d = ((c p_w + 1) size - 1) / 2, p_w = 1 / (cw + 1e-7)
    hw, hh = 0.5 * var.width, 0.5 * var.height
    g_cx = col[F_MEAN_X] * hw * t.p_w
    g_cy = col[F_MEAN_Y] * hh * t.p_w
    g_pw = col[F_MEAN_X] * hw * t.cx + col[F_MEAN_Y] * hh * t.cy
    g_cw = -g_pw * t.p_w * t.p_w

    d = [lv.xyz[:, i] - center[i] for i in range(3)]
    if var.with_normal:
        # normal = R[:, axis], sign detached; nc = (sign n) @ V[:3,:3];
        # plane_d = nc . (tx, ty, tz)
        axis = torch.argmin(s_raw, dim=-1)
        n = [torch.stack(R[i], dim=-1).gather(1, axis[:, None])[:, 0]
             for i in range(3)]
        sign = torch.where(sum(di * ni for di, ni in zip(d, n)) > 0, 1.0,
                           -1.0)
        nc = [sum(n[i] * sign * V[i, j] for i in range(3)) for j in range(3)]
        mc = (t.tx, t.ty, t.tz)
        g_pd = col[F_PLANE_D]
        g_nc = [col[F_NORMAL + j] + g_pd * mc[j] for j in range(3)]
        g_tx = g_tx + g_pd * nc[0]
        g_ty = g_ty + g_pd * nc[1]
        g_tz = g_tz + g_pd * nc[2]
        onehot = torch.nn.functional.one_hot(axis, 3).to(g.dtype)
        for i in range(3):
            g_n = sign * sum(V[i, j] * g_nc[j] for j in range(3))
            for k in range(3):
                gR[i][k] = gR[i][k] + onehot[:, k] * g_n

    # R of the normalized quaternion (w, x, y, z)
    qw, qx, qy, qz = t.q
    G = gR
    g_qw = 2.0 * (-qz * G[0][1] + qy * G[0][2] + qz * G[1][0]
                  - qx * G[1][2] - qy * G[2][0] + qx * G[2][1])
    g_qx = 2.0 * (qy * G[0][1] + qz * G[0][2] + qy * G[1][0]
                  - 2.0 * qx * G[1][1] - qw * G[1][2] + qz * G[2][0]
                  + qw * G[2][1] - 2.0 * qx * G[2][2])
    g_qy = 2.0 * (-2.0 * qy * G[0][0] + qx * G[0][1] + qw * G[0][2]
                  + qx * G[1][0] + qz * G[1][2] - qw * G[2][0]
                  + qz * G[2][1] - 2.0 * qy * G[2][2])
    g_qz = 2.0 * (-2.0 * qz * G[0][0] - qw * G[0][1] + qx * G[0][2]
                  + qw * G[1][0] - 2.0 * qz * G[1][1] + qy * G[1][2]
                  + qx * G[2][0] + qy * G[2][1])
    q_raw = [lv.quat[:, i] for i in range(4)]
    rq = torch.rsqrt(sum(v * v for v in q_raw) + 1e-24)
    g_quat = _rsqrt_norm_backward([g_qw, g_qx, g_qy, g_qz], q_raw, rq)

    # the mean: camera space, clip space
    g_xyz = [V[i, 0] * g_tx + V[i, 1] * g_ty + V[i, 2] * g_tz
             + Pm[i, 0] * g_cx + Pm[i, 1] * g_cy + Pm[i, 3] * g_cw
             for i in range(3)]

    g_f_dc = torch.zeros_like(lv.f_dc)
    g_f_rest = torch.zeros_like(lv.f_rest)
    if var.sh_degree is not None:
        deg = var.sh_degree
        rd = torch.rsqrt(sum(di * di for di in d) + 1e-24)
        dirs = [di * rd for di in d]
        basis = SH.basis(deg, *dirs)
        dbasis = SH.basis_grad(deg, *dirs)
        sh = torch.cat([lv.f_dc, lv.f_rest], dim=1)          # (C, 1+K, 3)
        v = sum(sh[:, k, :] * basis[k][:, None] for k in range(len(basis)))
        g_v = torch.where(v + 0.5 >= 0, g[:, F_RGB:F_RGB + 3], 0.0)
        g_f_dc[:, 0, :] = g_v * basis[0][:, None]
        for k in range(1, len(basis)):
            g_f_rest[:, k - 1, :] = g_v * basis[k][:, None]
        # d v / d dir: sum over channels and coefficients
        g_dir = [sum((g_v * sh[:, k, :]).sum(-1) * dbasis[k - 1][i]
                     for k in range(1, len(basis))) if deg > 0
                 else torch.zeros_like(rd) for i in range(3)]
        g_d = _rsqrt_norm_backward(g_dir, d, rd)
        g_xyz = [gx + gd for gx, gd in zip(g_xyz, g_d)]

    op = torch.sigmoid(lv.logit_opacity)
    g_lo = g[:, F_OPACITY:F_OPACITY + 1] * (1 - op) * op
    g_ls = torch.stack([g_s[k] * var.scale_modifier * s_raw[:, k]
                        for k in range(3)], dim=-1)
    g_obj = (g[:, F_SEM:F_SEM + var.ch_sem][:, None, :].clone()
             if var.ch_sem else None)
    return GaussianParams(torch.stack(g_xyz, dim=-1), g_f_dc, g_f_rest, g_ls,
                          torch.stack(g_quat, dim=-1), g_lo, g_obj)


def _check_preprocess(lv: GaussianParams, active: torch.Tensor,
                      cam: torch.Tensor, var: Variant) -> None:
    """Devices, dtypes, shapes and contiguity the preprocess takes."""
    dev = lv.xyz.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    n = lv.xyz.shape[0]
    k = lv.f_rest.shape[1] if lv.f_rest.ndim == 3 else -1
    s = lv.obj_dc.shape[2] if lv.obj_dc.ndim == 3 else -1
    shapes = {"xyz": (n, 3), "f_dc": (n, 1, 3), "f_rest": (n, k, 3),
              "log_scale": (n, 3), "quat": (n, 4), "logit_opacity": (n, 1),
              "obj_dc": (n, 1, s)}
    tensors = {**{name: (getattr(lv, name), torch.float32, shape)
                  for name, shape in shapes.items()},
               "active": (active, torch.bool, (n,)),
               "cam": (cam, torch.float32, (CAM_FLOATS,))}
    for name, (x, dtype, shape) in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, xyz on {dev}")
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor, "
                             f"got {x.dtype} (contiguous="
                             f"{x.is_contiguous()})")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if not 0 <= var.ch_sem <= MAX_CH_SEM:
        raise ValueError(f"ch_sem must be 0..{MAX_CH_SEM}, got {var.ch_sem}")
    if var.ch_sem and s != var.ch_sem:
        raise ValueError(f"expected (N, 1, {var.ch_sem}) semantic features, "
                         f"got {tuple(lv.obj_dc.shape)}")
    if k > 15 or var.sh_degree is not None and not (
            0 <= var.sh_degree <= 3 and (var.sh_degree + 1) ** 2 - 1 <= k):
        raise ValueError(f"SH degree {var.sh_degree} needs 0..3 and at most "
                         f"15 f_rest rows, enough for it; got {k}")
    if dev.type == "cuda" and lv.quat.data_ptr() % 16:
        raise ValueError("quat must be 16-byte aligned (the kernels read a "
                         "row as one float4)")


def _flags(var: Variant) -> tuple[int, int]:
    """(the kernels' SH degree, -1 for zero colour; their normal flag)."""
    deg = -1 if var.sh_degree is None else var.sh_degree
    return deg, int(var.with_normal)


def preprocess_forward(lv: GaussianParams, active: torch.Tensor,
                       cam: torch.Tensor, var: Variant) -> Preprocessed:
    """``preprocess_torch``'s outputs: the forward kernel on a CUDA tensor,
    the plain version on the CPU."""
    _check_preprocess(lv, active, cam, var)
    if lv.xyz.device.type == "cpu":
        return preprocess_torch(lv, active, cam, var)
    n, dev = lv.xyz.shape[0], lv.xyz.device
    feats = torch.empty((n, feature_dim(var.ch_sem)), dtype=torch.float32,
                        device=dev)
    radius = torch.empty(n, dtype=torch.int32, device=dev)
    ext = torch.empty((n, 2), dtype=torch.float32, device=dev)
    mean2d = torch.empty((n, 2), dtype=torch.float32, device=dev)
    depth_z = torch.empty(n, dtype=torch.float32, device=dev)
    deg, normal = _flags(var)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fwd_kernel()(
            *_ptrs(lv), lv.f_rest.shape[1],
            active.data_ptr(), cam.data_ptr(), n, var.width, var.height,
            var.scale_modifier, deg, var.ch_sem, normal, feats.data_ptr(),
            radius.data_ptr(), ext.data_ptr(), mean2d.data_ptr(),
            depth_z.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"preprocess_fwd launch failed: cudaError {err}")
    LAUNCHES["preprocess_fwd"] += 1
    return Preprocessed(feats, radius, ext, mean2d, depth_z)


def preprocess_backward(g: torch.Tensor, lv: GaussianParams,
                        cam: torch.Tensor, var: Variant) -> GaussianParams:
    """The leaves' gradients of ``preprocess_backward_torch``: the backward
    kernel on a CUDA tensor, the plain version on the CPU. ``g`` (C, 14+S)
    may be a column slice of a wider row-major matrix (K2's gradient)."""
    n, nf = lv.xyz.shape[0], feature_dim(var.ch_sem)
    if (g.shape != (n, nf) or g.dtype != torch.float32
            or g.device != lv.xyz.device):
        raise ValueError(f"g must be ({n}, {nf}) f32 on {lv.xyz.device}")
    if lv.xyz.device.type == "cpu":
        return preprocess_backward_torch(g, lv, cam, var)
    if g.stride(1) != 1 or not nf <= g.stride(0) <= nf + 2:
        g = g.contiguous()
    grads = lv.map(torch.empty_like)
    if not var.ch_sem:
        grads.obj_dc = None
    deg, normal = _flags(var)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = _bwd_kernel()(
            *_ptrs(lv), lv.f_rest.shape[1], cam.data_ptr(), n, var.width,
            var.height, var.scale_modifier, deg, var.ch_sem, normal,
            g.data_ptr(), g.stride(0), *_ptrs(grads), stream)
    if err != 0:
        raise RuntimeError(f"preprocess_bwd launch failed: cudaError {err}")
    LAUNCHES["preprocess_bwd"] += 1
    return grads


def _ptrs(params: GaussianParams) -> list[int]:
    """The fields' device pointers in field order, 0 for a missing one."""
    return [0 if x is None else x.data_ptr()
            for x in params.as_dict().values()]


@functools.cache
def _fwd_kernel():
    fn = cuda_build.load("preprocess").vcr_preprocess_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([p] * 7 + [i] + [p] * 2 + [i] * 3 + [ctypes.c_float]
                   + [i] * 3 + [p] * 6)
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = cuda_build.load("preprocess").vcr_preprocess_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([p] * 7 + [i] + [p] + [i] * 3 + [ctypes.c_float]
                   + [i] * 3 + [p, i] + [p] * 8)
    fn.restype = ctypes.c_int
    return fn


class _Preprocess(torch.autograd.Function):
    """Forward = the preprocess kernel, backward = its backward kernel,
    which recomputes the forward's terms from the saved leaves and camera
    (no per-slot intermediate is saved)."""

    @staticmethod
    def forward(ctx, xyz, f_dc, f_rest, log_scale, quat, logit_opacity,
                obj_dc, active, cam, var):
        lv = GaussianParams(xyz, f_dc, f_rest, log_scale, quat,
                            logit_opacity, obj_dc)
        out = preprocess_forward(lv, active, cam, var)
        ctx.save_for_backward(*lv.as_dict().values(), cam)
        ctx.var = var
        ctx.mark_non_differentiable(*out[1:])
        return tuple(out)

    @staticmethod
    def backward(ctx, g_feats, *_):
        *leaves, cam = ctx.saved_tensors
        grads = preprocess_backward(g_feats, GaussianParams(*leaves), cam,
                                    ctx.var)
        return (*grads.as_dict().values(), None, None, None)


def preprocess(lv: GaussianParams, active: torch.Tensor, cam: torch.Tensor,
               var: Variant) -> Preprocessed:
    """The renderer's per-slot chain, its features differentiable in the
    leaves: the kernels on a CUDA tensor, the plain versions on the CPU."""
    tracing.count("render.preprocess.slots", lv.xyz.shape[0])
    return Preprocessed(*_Preprocess.apply(*lv.as_dict().values(), active,
                                           cam, var))
