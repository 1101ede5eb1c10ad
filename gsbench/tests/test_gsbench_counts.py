"""The reference compositor and the operation counts against hand counts
on tiny scenes."""

from __future__ import annotations

import math

import numpy as np
import torch

from gsbench import counts as CNT
from gsbench.reference import render as RR


def one_tile(feats: torch.Tensor) -> RR.Binning:
    """Every Gaussian in the one tile of a 16x16 image, in index order."""
    n = feats.shape[0]
    return RR.Binning(torch.arange(n), torch.zeros(1, dtype=torch.int64),
                      torch.tensor([n]), 1, 1)


def splat(n, mx, my, sigma, opacity, depth):
    """(n, 14) features of isotropic Gaussians of one size at one place."""
    f = torch.zeros((n, 14), dtype=torch.float64)
    f[:, RR.F_MEAN_X], f[:, RR.F_MEAN_Y] = mx, my
    f[:, RR.F_CONIC_A] = f[:, RR.F_CONIC_C] = 1.0 / sigma ** 2
    f[:, RR.F_OPACITY] = opacity
    f[:, RR.F_DEPTH_Z] = depth
    f[:, RR.F_RGB:RR.F_RGB + 3] = 0.5
    return f


CAM = torch.tensor([20.0, 20.0, 8.0, 8.0, 0.0, 0.0, 0.0, 0.0],
                   dtype=torch.float64)


def test_census_and_k1_of_one_gaussian():
    f = splat(1, 8.0, 8.0, 2.0, 0.5, 1.0)
    c = RR.census(f, one_tile(f))
    y, x = np.mgrid[0:16, 0:16]
    live = int((0.5 * np.exp(-0.5 * ((x - 8.0) ** 2 + (y - 8.0) ** 2) / 4.0)
                >= 1 / 255).sum())
    assert c == {"entries": 1, "pairs": 256, "power_pass": 256,
                 "live": live, "rows": 1, "tiles": 1}
    ops, nbytes = CNT.k1(c, 16, 16, 14, 0, "traditional")
    assert ops == 12 * 256 + 3 * 256 + 20 * live
    assert nbytes == 4 + 4 * 14 + 8 + 16 * 16 * 4 * 9
    ops2, nbytes2 = CNT.k2(c, 16, 16, 14, 0, "intersection")
    assert ops2 == 12 * 256 + 3 * 256 + (83 + 18) * live
    assert nbytes2 == 4 + 4 * 14 + 8 + 2 * 16 * 16 * 4 * 9 + 4 * 16


def test_the_early_stop_ends_a_tile_at_a_batch():
    # 300 opaque Gaussians over the whole tile: T falls below 1e-4 in the
    # first batch, so the second is never composited
    f = splat(300, 8.0, 8.0, 100.0, 0.99, 1.0)
    c = RR.census(f, one_tile(f))
    assert c["entries"] == 256 and c["pairs"] == 256 * 256
    assert c["rows"] == 256


def brute_force(f: torch.Tensor, bg) -> torch.Tensor:
    """(9, 16, 16): front-to-back in index order at every pixel, no early
    stop (these Gaussians never bring T below 1e-4)."""
    out = torch.zeros((9, 16, 16), dtype=f.dtype)
    for py in range(16):
        for px in range(16):
            T, acc = 1.0, torch.zeros(8, dtype=f.dtype)
            for g in f:
                dx, dy = px - g[RR.F_MEAN_X], py - g[RR.F_MEAN_Y]
                power = (-0.5 * (g[RR.F_CONIC_A] * dx * dx
                                 + g[RR.F_CONIC_C] * dy * dy)
                         - g[RR.F_CONIC_B] * dx * dy)
                a = g[RR.F_OPACITY] * torch.exp(power)
                if power > 0 or a < 1 / 255:
                    continue
                a = min(a, 0.99)
                w = a * T
                d = g[RR.F_DEPTH_Z]
                acc += w * torch.cat([g[RR.F_RGB:RR.F_RGB + 3],
                                      g[RR.F_NORMAL:RR.F_NORMAL + 3],
                                      torch.stack([d, d * d])])
                T = T * (1 - a)
            out[0:3, py, px] = acc[0:3] + T * bg
            out[3:8, py, px] = acc[3:8]
            out[8, py, px] = 1 - T
    return out


def random_splats(n, seed):
    g = torch.Generator().manual_seed(seed)
    f = torch.zeros((n, 14), dtype=torch.float64)
    f[:, 0:2] = torch.rand((n, 2), generator=g, dtype=torch.float64) * 16
    f[:, 2] = f[:, 4] = 0.05 + 0.2 * torch.rand(n, generator=g,
                                                dtype=torch.float64)
    f[:, 3] = 0.01 * torch.randn(n, generator=g, dtype=torch.float64)
    f[:, 5] = 0.2 + 0.6 * torch.rand(n, generator=g, dtype=torch.float64)
    f[:, 6] = 1.0 + torch.rand(n, generator=g, dtype=torch.float64)
    f[:, 8:14] = torch.rand((n, 6), generator=g, dtype=torch.float64)
    return f


def test_compositor_matches_a_pixel_loop():
    f = random_splats(12, 0)
    bg = torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64)
    cam = torch.cat([CAM[:4], bg, CAM[7:]])
    img = RR.composite(f, one_tile(f), cam, 16, 16, 0, "traditional")
    torch.testing.assert_close(img, brute_force(f, bg), rtol=1e-9,
                               atol=1e-12)


def test_compositor_gradient_matches_finite_differences():
    f = random_splats(5, 1).requires_grad_(True)
    cam = CAM.clone()

    def fn(x):
        return RR.composite(x, one_tile(x), cam, 16, 16, 0, "intersection")

    assert torch.autograd.gradcheck(fn, (f,), eps=1e-6, atol=1e-5)


def test_appearance_ops_count_each_convolution():
    # 64x32 crop: conv0 at 2x1, the blocks at 4x2 .. 32x16, conv1 and
    # conv2 at 64x32
    want = (2 * 9 * 67 * 256 * 2 + 2 * 9 * 64 * 128 * 8
            + 2 * 9 * 32 * 64 * 32 + 2 * 9 * 16 * 32 * 128
            + 2 * 9 * 8 * 16 * 512 + 2 * 9 * 16 * 16 * 2048
            + 2 * 9 * 16 * 3 * 2048)
    assert CNT.appearance_ops(64, 32) == want
    assert math.isclose(CNT.roofline_s(67_000, 0, CNT.peaks()), 1e-9)
