"""What the card checks of the kernels that share csrc/composite_pair.cuh
rest on, checked on the CPU: the mirror of its pixel-to-thread map in
ops/rasterize.warp_of_pixel (used to count warp steps on the kernels' 16x16
tiles and the microprobe's 32x32 tiles), the scene whose pairs sit at the
dead-pair threshold, and the kernel build's key, which must change with the
shared header."""

import numpy as np
import pytest
import torch

from chip_smoke import threshold_scene
from vcr_gaus_tpu_torch.ops import cuda_build
from vcr_gaus_tpu_torch.ops import microprobe as M
from vcr_gaus_tpu_torch.ops import projection as PF
from vcr_gaus_tpu_torch.ops.rasterize import warp_of_pixel
from vcr_gaus_tpu_torch.ops.rasterize_ref import ALPHA_EPS

DEAD_MARGIN = 1e-3     # csrc/composite_pair.cuh


@pytest.mark.parametrize("patches", [False, True])
def test_microprobe_warp_map_covers_the_tile_in_patches(patches):
    """The microprobe's 32x32 tile, as ops/microprobe.pair_census maps it:
    every pixel in exactly one warp, sixteen 8x8 patches of 64 pixels under
    the kernel's map (2 pixels a thread, 512 threads; warp w's patch at
    column 8 (w % 4), row 8 (w // 4), as TilePixelMap<32>::first lays the
    threads out), thirty-two rows of 32 pixels under a thread per pixel."""
    warp = warp_of_pixel(patches, M.TILE)
    n, size = (16, 64) if patches else (32, 32)
    assert warp.shape == (M.P,)
    assert torch.bincount(warp).tolist() == [size] * n
    pix = torch.arange(M.P)
    x, y = pix % M.TILE, pix // M.TILE
    for w in range(n):
        xs, ys = x[warp == w], y[warp == w]
        x0, y0 = int(xs.min()), int(ys.min())
        if patches:
            assert (x0, y0) == (8 * (w % 4), 8 * (w // 4))
            assert set(zip(xs.tolist(), ys.tolist())) == {
                (x0 + i, y0 + j) for i in range(8) for j in range(8)}
        else:
            assert (x0, int(xs.max()), y0, int(ys.max())) == (0, 31, w, w)


@pytest.mark.parametrize("patches", [False, True])
def test_warp_map_covers_the_tile_in_patches(patches):
    """Every warp holds 32 P pixels forming one rectangle: 8x8 under the
    kernels' map (P = 2), 16x2 under a thread per pixel."""
    warp = warp_of_pixel(patches)
    per = 64 if patches else 32
    assert warp.shape == (256,)
    assert torch.bincount(warp).tolist() == [per] * (256 // per)
    pix = torch.arange(256)
    x, y = pix % 16, pix // 16
    shape = (8, 8) if patches else (16, 2)
    for w in range(256 // per):
        xs, ys = x[warp == w], y[warp == w]
        assert (int(xs.max() - xs.min()) + 1,
                int(ys.max() - ys.min()) + 1) == shape


def test_threshold_scene_spans_the_dead_pair_threshold():
    """The scene's ring pixels (squared distance 5 from a splat's centre)
    fall in all three bands the kernels treat apart: live just above the
    alpha threshold, dead within the margin (the exact test), and dead
    below the margin (skipped), each well clear of alpha's rounding."""
    feats, radius, _ = threshold_scene()
    f = torch.from_numpy(feats)
    dx, dy = torch.tensor(1.0), torch.tensor(2.0)
    power = (-0.5 * (f[:, PF.F_CONIC_A] * dx * dx
                     + f[:, PF.F_CONIC_C] * dy * dy)
             - f[:, PF.F_CONIC_B] * dx * dy)
    op = f[:, PF.F_OPACITY]
    live = op * torch.exp(power) >= ALPHA_EPS
    level = torch.log(torch.tensor(ALPHA_EPS, dtype=torch.float32) / op)
    delta = (power - level).double()
    assert bool((live == (delta > 0)).all())
    bands = [int((delta > 0).sum()),
             int(((delta < 0) & (delta > -DEAD_MARGIN)).sum()),
             int((delta < -DEAD_MARGIN).sum())]
    assert min(bands) >= 30, bands
    assert float(delta.abs().min()) > 1e-5
    ratio = (op.double() * torch.exp(power.double()) / ALPHA_EPS - 1).abs()
    assert float(ratio.min()) > 1e-5
    assert (radius == 4).all() and np.isin(feats[:, 0], np.arange(45)).all()


@pytest.mark.parametrize("name", ["rasterize_fwd", "rasterize_bwd",
                                  "rasterize_stats", "kernel_microprobe"])
def test_kernel_build_key_follows_the_shared_header(tmp_path, monkeypatch,
                                                    name):
    """Every kernel that includes csrc/composite_pair.cuh is rebuilt when
    it changes: the library's name hashes the headers beside the source."""
    assert '#include "composite_pair.cuh"' in (
        cuda_build.CSRC / cuda_build.SOURCES[name]).read_text()
    src = tmp_path / "csrc"
    src.mkdir()
    for f in cuda_build.CSRC.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", src)
    before = cuda_build.library_path(name)
    with open(src / "composite_pair.cuh", "a") as f:
        f.write("// edited\n")
    assert cuda_build.library_path(name) != before
