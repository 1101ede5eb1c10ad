"""Real spherical harmonics, degrees 0..3 (vcr_gaus_tpu/utils/sh.py), and
their basis functions with the basis' gradient along the direction, which
the closed-form preprocess backward (ops/projection.py) reads.

The operation order follows the JAX package term for term, so both give the
same float32 rounding."""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh: (..., C, (max_deg+1)**2), of which the first (deg+1)**2 are read;
    dirs: (..., 3) unit directions. Returns (..., C)."""
    if not 0 <= deg <= 3:
        raise ValueError(f"SH degree must be 0..3, got {deg}")
    result = C0 * sh[..., 0]
    if deg > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - C1 * y * sh[..., 1] + C1 * z * sh[..., 2]
                  - C1 * x * sh[..., 3])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + C2[0] * xy * sh[..., 4]
                      + C2[1] * yz * sh[..., 5]
                      + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                      + C2[3] * xz * sh[..., 7]
                      + C2[4] * (xx - yy) * sh[..., 8])
            if deg > 2:
                result = (result
                          + C3[0] * y * (3 * xx - yy) * sh[..., 9]
                          + C3[1] * xy * z * sh[..., 10]
                          + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                          + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
                          + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                          + C3[5] * z * (xx - yy) * sh[..., 14]
                          + C3[6] * x * (xx - 3 * yy) * sh[..., 15])
    return result


def basis(deg: int, x, y, z) -> list:
    """[basis_0 .. basis_{(deg+1)^2-1}] at the unit directions (x, y, z):
    eval_sh is sum_k sh[..., k] basis_k."""
    out = [torch.full_like(x, C0)]
    if deg > 0:
        out += [-C1 * y, C1 * z, -C1 * x]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        out += [C2[0] * x * y, C2[1] * y * z, C2[2] * (2.0 * zz - xx - yy),
                C2[3] * x * z, C2[4] * (xx - yy)]
    if deg > 2:
        out += [C3[0] * y * (3 * xx - yy), C3[1] * x * y * z,
                C3[2] * y * (4 * zz - xx - yy),
                C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                C3[4] * x * (4 * zz - xx - yy), C3[5] * z * (xx - yy),
                C3[6] * x * (xx - 3 * yy)]
    return out


def basis_grad(deg: int, x, y, z) -> list:
    """[(d/dx, d/dy, d/dz) of basis_k] for k = 1 .. (deg+1)^2-1 (each entry
    0 where the basis does not depend on the coordinate)."""
    zero = torch.zeros_like(x)
    out = []
    if deg > 0:
        c = torch.full_like(x, C1)
        out += [(zero, -c, zero), (zero, zero, c), (-c, zero, zero)]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        out += [(C2[0] * y, C2[0] * x, zero), (zero, C2[1] * z, C2[1] * y),
                (-2.0 * C2[2] * x, -2.0 * C2[2] * y, 4.0 * C2[2] * z),
                (C2[3] * z, zero, C2[3] * x),
                (2.0 * C2[4] * x, -2.0 * C2[4] * y, zero)]
    if deg > 2:
        out += [(6.0 * C3[0] * x * y, C3[0] * (3 * xx - 3 * yy), zero),
                (C3[1] * y * z, C3[1] * x * z, C3[1] * x * y),
                (-2.0 * C3[2] * x * y, C3[2] * (4 * zz - xx - 3 * yy),
                 8.0 * C3[2] * y * z),
                (-6.0 * C3[3] * x * z, -6.0 * C3[3] * y * z,
                 C3[3] * (6 * zz - 3 * xx - 3 * yy)),
                (C3[4] * (4 * zz - 3 * xx - yy), -2.0 * C3[4] * x * y,
                 8.0 * C3[4] * x * z),
                (2.0 * C3[5] * x * z, -2.0 * C3[5] * y * z, C3[5] * (xx - yy)),
                (C3[6] * (3 * xx - 3 * yy), -6.0 * C3[6] * x * y, zero)]
    return out


def rgb_to_sh(rgb):
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    return sh * C0 + 0.5
