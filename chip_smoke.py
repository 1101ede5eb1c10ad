#!/usr/bin/env python3
"""Drive the PyTorch port (vcr_gaus_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. build   every CUDA kernel from csrc/ (one nvcc per source, all started
             together, sm_90a), and print the card's name and power limit;
  2. kernel  each kernel's wrapper against its plain PyTorch version on the
             card at small shapes (both depth modes, 0, 2 and 3 semantic
             channels, ragged 40x24 and 45x29 images, an all-culled scene,
             a saturated scene where the early stop fires, a scene whose
             pairs sit at the dead-pair threshold): the forward kernel at
             atol 2e-4 and rtol 1e-3 on every channel and its batch
             counts exactly, the backward kernel's per-Gaussian
             gradients, each column group (mean, conic, opacity, depth,
             plane, normal, rgb, sem, |d mean2d|) at atol 2e-3 times its
             own max|g| and rtol 2e-3 (5e-2 in the saturated scene);
  3. slice   the render path at full width: a synthetic COLMAP scene of 8
             1600x1200 views and a 1M-Gaussian SH-degree-3 PLY, rendered and
             scored by vcr_gaus_tpu_torch.render_eval.main with
             LPIPS_WEIGHTS=placeholder (PSNR, SSIM, LPIPS); the launch
             counts of that run, kernel, LPIPS and render times, the
             kernel held against its plain version on 64 random tiles of
             one full-width view;
  4. train   the training path at full width: a 1M-point COLMAP scene of 8
             1600x1200 views with unit-normal priors, trained for 20
             iterations of configs/dtu/base.yaml through
             vcr_gaus_tpu_torch.train's main; the launch counts and losses
             of that run; then, on the trained state with 4x scales and every
             loss gate open, the step time, a torch.profiler stage table,
             the backward kernel's time, bound and plain time, and the
             kernel held against its plain version on one full-width
             step, with the forward kernel's time and bound on that view;
  5. host_loop  the DTU recipe's host loop at full width: the same kind of
             scene, tpu.capacity 2^21, configs/dtu/base.yaml with its own
             prune schedule compressed (densify after 20, 30 and 40, each
             with the box mask's 30 sampled views; opacity resets at 20 and
             40; the LightGaussian prune at 30; test and save at 40; a
             checkpoint at 20) through the CLI, then resumed from the
             checkpoint through the CLI; the launch counts against the
             schedule's, the population at each host action, the files
             written; then the stats kernel's time, bound and plain time,
             held against its plain version, on the inputs the run gave it
             for the first view of the densifies at 20 and 30 (the kernels
             line reads the one at 20), and on one view of the final state
             as it is and at opacity 0.1, each with the share of its pairs
             that is live, the Gaussians' live areas that explain it and
             the warp steps with a live lane under the kernel's 8x8
             patches and under the 16x2 rows of a thread per pixel; the
             host time of one densify and one prune;
  6. microprobe  the forward-loop microprobe (K4): every variant against its
             plain version at 8 tiles x 6 chunks, each channel at atol 2e-4
             times its own max|value| and rtol 1e-3; `full` again on 64
             random tiles of the protocol shape (1900 tiles x 6 chunks of
             256 entries); then vcr_gaus_tpu_torch.tools.kernel_microprobe's
             main at the protocol shape, every variant, which prints one
             line per variant (us per chunk, live shares, bound, x bound);
             `full`'s warp steps with a live lane under the kernel's 8x8
             patches and under rows of 32 pixels; the plain version's
             time for `full` at the protocol shape;
then the kernel table as one JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Imports nothing of JAX or of vcr_gaus_tpu.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FWD = dict(atol=2e-4, rtol=1e-3)   # forward tolerance of the JAX suite
CHANNELS = ["r", "g", "b", "nx", "ny", "nz", "depth", "depth2", "alpha"]
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations of one (pixel, entry) pair in rasterize_fwd.cu's loop
# body, counting each add, mul, compare, min, abs, divide and expf as one:
# every pair: dx, dy (2), the power (7), the power test (1)
# past the power test: expf, times the opacity, the alpha test (3)
# a live pair: min, w (2), rgb and normal accumulations (12), semantic ones
#   (2 per channel), w*d and depth, depth^2 accumulations (4), T *= 1-alpha
#   (2); in intersection mode the depth ray . n (5), its clamp (2) and the
#   divide (1)
OPS_PAIR, OPS_POWER_PASS = 12, 3
OPS_LIVE, OPS_LIVE_SEM, OPS_LIVE_INTERSECT = 20, 2, 8
# the same count for rasterize_bwd.cu's loop body: every pair and the tests
# as in the forward; a live pair: min, w (2), s over the composited columns
# (12 + 2 per semantic channel) and its depth term (4), the prefix and
# suffix (3), dL/dalpha (5), the cap test and dpower (2), the mean terms
# (8), the conic terms (9), the opacity term (2), the depth term (4), the
# composited-column terms (12 + 2 per channel), the two |.| terms (2),
# T *= 1-alpha (2), and one add per gradient channel (16 + S) for the sum
# over the tile's pixels; in intersection mode the depth ray . n, its clamp
# and divide (8) and the plane-offset and normal terms (10)
OPS_BWD_LIVE, OPS_BWD_LIVE_SEM, OPS_BWD_LIVE_INTERSECT = 83, 5, 18
# the same count for rasterize_stats.cu's loop body, over in-image pixels
# (the others do nothing): every pair and the tests as in the forward; a
# live pair: min, w, 1 - alpha, T *= (4), and its two adds to the tile's
# per-entry sums of hits and weights (2)
OPS_STATS_LIVE = 6
# host_loop: stats launch of the run -> the densify view it is the first of
DENSIFY_CAPTURES = {0: "densify_20", 30: "densify_30"}
# K4 against its plain version, per channel: atol 2e-4 max|value|, rtol
# 1e-3 (the no_exp variants reach ~1e8)
PROBE = dict(atol=2e-4, rtol=1e-3)
BWD = dict(rtol=2e-3)              # and atol 2e-3 max|g| per column group
BWD_SATURATED = dict(rtol=5e-2)    # tests/test_rasterize.py:432
# bench.py's dtu_full weights: the DTU recipe with every gate open
DTU_FULL_WEIGHTS = {"l1": 0.8, "ssim": 0.2, "mono_normal": 0.01,
                    "l1_scale": 0.5, "consistent_normal": 0.05,
                    "distortion": 1000.0}


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def splat_scene(n=60, seed=0, ch_sem=0, width=40, height=24):
    """Random 2D splats in the packed feature layout: (feats (N, 14+S) f32,
    radius (N,) i32, cam (8,) f32), as numpy."""
    rng = np.random.default_rng(seed)
    mean2d = rng.uniform([-4, -4], [width + 4, height + 4], size=(n, 2))
    theta = rng.uniform(0, np.pi, n)
    s1 = rng.uniform(1.5, 6.0, n)
    s2 = rng.uniform(1.5, 6.0, n)
    c, s = np.cos(theta), np.sin(theta)
    xx = c * c * s1 ** 2 + s * s * s2 ** 2
    xy = c * s * (s1 ** 2 - s2 ** 2)
    yy = s * s * s1 ** 2 + c * c * s2 ** 2
    det = xx * yy - xy * xy
    depth = rng.uniform(1.0, 9.0, n)
    normal = rng.normal(size=(n, 3))
    normal[:, 2] = -np.abs(normal[:, 2]) - 0.3
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    mean_cam = np.stack([rng.normal(size=n), rng.normal(size=n), depth], 1)
    feats = np.zeros((n, 14 + ch_sem), np.float32)
    feats[:, 0:2] = mean2d
    feats[:, 2:5] = np.stack([yy / det, -xy / det, xx / det], 1)
    feats[:, 5] = rng.uniform(0.2, 0.95, n)
    feats[:, 6] = depth
    feats[:, 7] = np.sum(normal * mean_cam, axis=1)
    feats[:, 8:11] = normal
    feats[:, 11:14] = rng.uniform(0, 1, (n, 3))
    feats[:, 14:] = rng.uniform(0, 1, (n, ch_sem))
    radius = np.ceil(3.5 * np.maximum(s1, s2)).astype(np.int32)
    radius[rng.uniform(size=n) < 0.1] = 0
    cam = np.array([50.0, 50.0, width / 2, height / 2, 0.1, 0.5, 0.9, 0.0],
                   np.float32)
    return feats, radius, cam


def saturated_scene(n=700, seed=7, width=40, height=24):
    """Large near-opaque splats piled on one tile, sorted front to back: the
    tile's transmittance falls below 1e-4 within the first batch."""
    rng = np.random.default_rng(seed)
    feats = np.zeros((n, 14), np.float32)
    feats[:, 0:2] = rng.uniform(2, 14, (n, 2))
    feats[:, 2] = feats[:, 4] = 0.02
    feats[:, 5] = 0.95
    feats[:, 6] = np.sort(rng.uniform(1.0, 9.0, n))
    feats[:, 7] = -feats[:, 6]
    feats[:, 10] = -1.0
    feats[:, 11:14] = rng.uniform(0, 1, (n, 3))
    cam = np.array([50.0, 50.0, width / 2, height / 2, 0.1, 0.5, 0.9, 0.0],
                   np.float32)
    return feats, np.full(n, 30, np.int32), cam


def threshold_scene(n=300, seed=11, width=45, height=29):
    """Isotropic splats centred on pixels, each with its power at the 8
    pixels at squared distance 5 from its centre within 4e-3 of its alpha
    threshold ln((1/255) / opacity), and at least 2e-5 from it (far above
    alpha's rounding): pairs on both sides of the alpha test and of the
    kernels' dead-pair threshold 1e-3 below it. On a ragged 45x29 image.
    A pair the threshold skipped wrongly would move a weight by T/255."""
    rng = np.random.default_rng(seed)
    op = rng.uniform(0.05, 0.9, n).astype(np.float32)
    level = np.log(np.float64(np.float32(1.0 / 255.0)) / op)
    delta = rng.uniform(2e-5, 4e-3, n) * rng.choice([-1.0, 1.0], n)
    depth = rng.uniform(1.0, 9.0, n)
    normal = rng.normal(size=(n, 3))
    normal[:, 2] = -np.abs(normal[:, 2]) - 0.3
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    feats = np.zeros((n, 14), np.float32)
    feats[:, 0] = rng.integers(0, width, n)
    feats[:, 1] = rng.integers(0, height, n)
    feats[:, 2] = feats[:, 4] = -2.0 * (level + delta) / 5.0
    feats[:, 5] = op
    feats[:, 6] = depth
    feats[:, 7] = -depth * np.abs(normal[:, 2])
    feats[:, 8:11] = normal
    feats[:, 11:14] = rng.uniform(0, 1, (n, 3))
    cam = np.array([50.0, 50.0, width / 2, height / 2, 0.1, 0.5, 0.9, 0.0],
                   np.float32)
    return feats, np.full(n, 4, np.int32), cam


def compare_kernel(feats, radius, cam, width, height, ch_sem, depth_mode,
                   device):
    """Kernel wrapper vs plain version on the same inputs on ``device``;
    returns (max abs error per channel, batches composited per tile,
    batches held per tile)."""
    import torch

    from vcr_gaus_tpu_torch.ops import binning as B
    from vcr_gaus_tpu_torch.ops import rasterize as R

    f = torch.tensor(feats, device=device)
    cam_t = torch.tensor(cam, device=device)
    binn = B.bin_gaussians(f[:, :2], torch.tensor(radius, device=device),
                           f[:, 6], width, height)
    n_tx, n_ty = B.tile_grid(width, height)
    got, batches = R.rasterize_forward(f, binn, cam_t, width, height, ch_sem,
                                       depth_mode)
    tiles, want_b = R.composite_tiles_torch(
        f, binn.sorted_gid, binn.tile_starts, binn.tile_counts, cam_t, n_tx,
        ch_sem, depth_mode)
    want = R.tiles_to_image(tiles, n_tx, n_ty, width, height)
    torch.testing.assert_close(got, want, **FWD)
    if not torch.equal(batches, want_b):
        raise AssertionError("batches composited differ from the plain version")
    err = (got - want).abs().flatten(1).amax(dim=1).tolist()
    names = CHANNELS + [f"sem{i}" for i in range(ch_sem)]
    held = (binn.tile_counts + R.BATCH - 1) // R.BATCH
    return dict(zip(names, err)), batches, held


def grad_groups(ch_sem) -> dict[str, slice]:
    """Column groups of the backward kernel's (N, 16+S) gradient: the packed
    feature layout, then the |d mean2d| stream."""
    from vcr_gaus_tpu_torch.ops import projection as PF
    f = PF.feature_dim(ch_sem)
    return {"mean": slice(PF.F_MEAN_X, PF.F_CONIC_A),
            "conic": slice(PF.F_CONIC_A, PF.F_OPACITY),
            "opacity": slice(PF.F_OPACITY, PF.F_DEPTH_Z),
            "depth_z": slice(PF.F_DEPTH_Z, PF.F_PLANE_D),
            "plane_d": slice(PF.F_PLANE_D, PF.F_NORMAL),
            "normal": slice(PF.F_NORMAL, PF.F_RGB),
            "rgb": slice(PF.F_RGB, PF.F_SEM), "sem": slice(PF.F_SEM, f),
            "abs_dmean2d": slice(f, f + 2)}


def assert_grads_close(got, want, ch_sem, rtol) -> dict[str, list[float]]:
    """Per-Gaussian gradients, each column group at atol 2e-3 times its own
    max|want| and ``rtol``: the groups differ by orders of magnitude (a
    clamped plane denominator makes the plane and normal columns huge), so
    one scale for all would let the small groups through unchecked. Returns
    {group: [largest absolute error, max|want|]}."""
    import torch
    groups = grad_groups(ch_sem)
    if got.shape != want.shape or want.shape[1] != groups["abs_dmean2d"].stop:
        raise AssertionError(f"gradient shapes {tuple(got.shape)}, "
                             f"{tuple(want.shape)}, ch_sem {ch_sem}")
    out = {}
    for name, cols in groups.items():
        g, w = got[:, cols], want[:, cols]
        if w.numel() == 0:
            continue
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, atol=2e-3 * scale, rtol=rtol,
                                   msg=lambda m, name=name: f"{name}: {m}")
        out[name] = [float((g - w).abs().max()), scale]
    return out


def compare_backward(feats, radius, cam, width, height, ch_sem, depth_mode,
                     device, tol=BWD, seed=0) -> dict[str, list[float]]:
    """Backward kernel wrapper vs its plain version on the forward kernel's
    image and batch counts and a seeded random image gradient; returns
    assert_grads_close's per-group errors and scales."""
    import torch

    from vcr_gaus_tpu_torch.ops import binning as B
    from vcr_gaus_tpu_torch.ops import rasterize as R

    f = torch.tensor(feats, device=device)
    cam_t = torch.tensor(cam, device=device)
    binn = B.bin_gaussians(f[:, :2], torch.tensor(radius, device=device),
                           f[:, 6], width, height)
    img, batches = R.rasterize_forward(f, binn, cam_t, width, height, ch_sem,
                                       depth_mode)
    g = torch.randn(img.shape, generator=torch.Generator().manual_seed(seed)
                    ).to(device)
    got = R.rasterize_backward(f, binn, cam_t, img, g, batches, width, height,
                               ch_sem, depth_mode)
    want = R.composite_tiles_backward_torch(
        f, binn.sorted_gid, binn.tile_starts, binn.tile_counts, batches,
        cam_t, img, g, ch_sem, depth_mode)
    return assert_grads_close(got, want, ch_sem, tol["rtol"])


def compare_stats(feats, radius, width, height, device):
    """Stats kernel wrapper vs its plain version on the same inputs on
    ``device``: the hit counts exactly equal, the importance at the forward
    tolerance. Returns (max abs importance error, batches walked per tile,
    batches held per tile)."""
    import torch

    from vcr_gaus_tpu_torch.ops import binning as B
    from vcr_gaus_tpu_torch.ops import rasterize as R

    f = torch.tensor(feats, device=device)
    binn = B.bin_gaussians(f[:, :2], torch.tensor(radius, device=device),
                           f[:, 6], width, height)
    n_tx, _ = B.tile_grid(width, height)
    got = R.rasterize_stats(f, binn, width, height)
    want, batches = R.composite_tiles_stats_torch(
        f, binn.sorted_gid, binn.tile_starts, binn.tile_counts, n_tx, width,
        height)
    if not torch.equal(got[:, 0], want[:, 0]):
        raise AssertionError("stats kernel hit counts differ from the plain "
                             "version")
    torch.testing.assert_close(got[:, 1], want[:, 1], **FWD)
    held = (binn.tile_counts + R.BATCH - 1) // R.BATCH
    return float((got[:, 1] - want[:, 1]).abs().max()), batches, held


def worst_error(groups) -> float:
    return max((err for err, _ in groups.values()), default=0.0)


def phase_kernel(device) -> tuple[float, float, float]:
    """Phase 2; returns the largest forward, backward and stats errors."""
    cases = [("", "traditional", 0, 40, 24, splat_scene(seed=0)),
             ("", "intersection", 0, 40, 24, splat_scene(seed=1)),
             ("", "traditional", 2, 40, 24, splat_scene(seed=6, ch_sem=2)),
             ("", "intersection", 2, 40, 24, splat_scene(seed=7, ch_sem=2)),
             ("", "traditional", 3, 40, 24, splat_scene(seed=2, ch_sem=3)),
             ("", "intersection", 3, 40, 24, splat_scene(seed=3, ch_sem=3)),
             ("", "traditional", 0, 45, 29,
              splat_scene(n=200, seed=8, width=45, height=29)),
             ("", "intersection", 3, 45, 29,
              splat_scene(n=200, seed=9, ch_sem=3, width=45, height=29)),
             ("threshold_", "traditional", 0, 45, 29, threshold_scene()),
             ("threshold_", "intersection", 0, 45, 29,
              threshold_scene(seed=12)),
             ("", "intersection", 3, 200, 150,
              splat_scene(n=3000, seed=4, ch_sem=3, width=200, height=150))]
    worst = worst_bwd = worst_stats = 0.0
    for name, mode, ch_sem, w, h, (feats, radius, cam) in cases:
        err, _, _ = compare_kernel(feats, radius, cam, w, h, ch_sem, mode,
                                   device)
        bwd = compare_backward(feats, radius, cam, w, h, ch_sem, mode, device)
        # the stats kernel reads no depth: the same check in both modes
        st_err, _, _ = compare_stats(feats, radius, w, h, device)
        worst = max(worst, *err.values())
        worst_bwd = max(worst_bwd, worst_error(bwd))
        worst_stats = max(worst_stats, st_err)
        emit(phase="kernel", case=f"{name}{mode}_sem{ch_sem}_{w}x{h}",
             max_abs_err=err, bwd_err_and_max_grad=bwd,
             stats_imp_max_abs_err=st_err)
    feats, radius, cam = splat_scene(seed=5)
    err, _, _ = compare_kernel(feats, radius * 0, cam, 40, 24, 0,
                               "traditional", device)
    bwd = compare_backward(feats, radius * 0, cam, 40, 24, 0, "traditional",
                           device)
    st_err, _, _ = compare_stats(feats, radius * 0, 40, 24, device)
    worst = max(worst, *err.values())
    worst_bwd = max(worst_bwd, worst_error(bwd))
    worst_stats = max(worst_stats, st_err)
    emit(phase="kernel", case="all_culled_40x24", max_abs_err=err,
         bwd_err_and_max_grad=bwd, stats_imp_max_abs_err=st_err)
    feats, radius, cam = saturated_scene()
    err, batches, held = compare_kernel(feats, radius, cam, 40, 24, 0,
                                        "traditional", device)
    if not bool((batches < held).any()):
        raise AssertionError("the early stop did not fire")
    bwd = compare_backward(feats, radius, cam, 40, 24, 0, "traditional",
                           device, tol=BWD_SATURATED)
    st_err, st_batches, st_held = compare_stats(feats, radius, 40, 24, device)
    if not bool((st_batches.cpu() < st_held.cpu()).any()):
        raise AssertionError("the stats walk did not stop early")
    # the same splats on the ragged bottom row: the forward kernel stops
    # the tile, the stats walk (out-of-image pixels keep T = 1) does not
    ragged = feats.copy()
    ragged[:, 1] += 16.0
    r_err, r_batches, r_held = compare_kernel(ragged, radius, cam, 40, 24, 0,
                                              "traditional", device)
    r_bwd = compare_backward(ragged, radius, cam, 40, 24, 0, "traditional",
                             device, tol=BWD_SATURATED)
    rs_err, rs_batches, _ = compare_stats(ragged, radius, 40, 24, device)
    t = -(-40 // 16)                        # first tile of the ragged row
    if not (int(r_batches[t]) < int(r_held[t]) == int(rs_batches[t])):
        raise AssertionError("ragged tile: forward batches "
                             f"{r_batches.tolist()}, stats batches "
                             f"{rs_batches.tolist()}, held {r_held.tolist()}")
    worst = max(worst, *err.values(), *r_err.values())
    worst_bwd = max(worst_bwd, worst_error(bwd), worst_error(r_bwd))
    worst_stats = max(worst_stats, st_err, rs_err)
    emit(phase="kernel", case="saturated_40x24", max_abs_err=err,
         bwd_err_and_max_grad=bwd,
         batches_done=batches.tolist(),
         batches_held=held.tolist(), stats_imp_max_abs_err=st_err,
         stats_batches=st_batches.tolist(),
         ragged_row_max_abs_err=r_err,
         ragged_row_bwd_err_and_max_grad=r_bwd,
         ragged_row_stats_imp_max_abs_err=rs_err,
         ragged_row_fwd_batches=r_batches.tolist(),
         ragged_row_stats_batches=rs_batches.tolist())
    return worst, worst_bwd, worst_stats


def write_colmap_views(scene, width, height, n_views, image_fn):
    """COLMAP cameras of ``n_views`` ring views (bench.py's poses: identity
    rotation, centers on a 0.3 ring, fovx 0.9, fovy 0.7) under ``scene``,
    each with the (H, W, 3) uint8 image ``image_fn(i)``."""
    from PIL import Image

    from vcr_gaus_tpu_torch.utils import colmap as CM
    from vcr_gaus_tpu_torch.utils import graphics as G

    os.makedirs(os.path.join(scene, "sparse", "0"))
    os.makedirs(os.path.join(scene, "images"))
    fovx, fovy = 0.9, 0.7
    CM.write_cameras_binary(
        {1: CM.ColmapCamera(1, "PINHOLE", width, height, np.array(
            [G.fov2focal(fovx, width), G.fov2focal(fovy, height),
             width / 2, height / 2]))},
        os.path.join(scene, "sparse", "0", "cameras.bin"))
    images = {}
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        name = f"view_{i:03d}.png"
        Image.fromarray(image_fn(i)).save(os.path.join(scene, "images", name))
        images[i + 1] = CM.ColmapImage(
            i + 1, np.array([1.0, 0.0, 0.0, 0.0]),
            np.array([0.3 * np.cos(ang), 0.3 * np.sin(ang), 0.0]), 1, name)
    CM.write_images_binary(images, os.path.join(scene, "sparse", "0",
                                                "images.bin"))


def sphere_shell(rng, n):
    """bench.py's population: n points on a sphere shell of radius 1.5 at
    z = 4 and their random colors."""
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-1, 1, n)
    r = np.sqrt(1 - z ** 2)
    pts = (np.stack([r * np.cos(theta), r * np.sin(theta), z], 1) * 1.5
           + np.array([0, 0, 4.0])).astype(np.float32)
    return pts, rng.uniform(0, 1, (n, 3)).astype(np.float32)


def write_scene(root, n_gauss, width, height, n_views, seed=0):
    """A COLMAP scene of ``n_views`` ring cameras with random images looking
    at a sphere shell, and a config + PLY of ``n_gauss`` SH-degree-3
    gaussians on that shell, each of isotropic scale 4x the mean point
    spacing."""
    import yaml

    from vcr_gaus_tpu_torch.models.convert import state_from_numpy
    from vcr_gaus_tpu_torch.models.ply_io import save_gaussian_ply
    from vcr_gaus_tpu_torch.utils import colmap as CM

    rng = np.random.default_rng(seed)
    scene = os.path.join(root, "scene")
    write_colmap_views(scene, width, height, n_views, lambda i: rng.integers(
        0, 256, (height, width, 3), dtype=np.uint8))
    pts, cols = sphere_shell(rng, n_gauss)
    sub = rng.choice(n_gauss, min(n_gauss, 2000), replace=False)
    CM.write_points3d_binary(pts[sub], cols[sub] * 255,
                             os.path.join(scene, "sparse", "0", "points3D.bin"))

    spacing = math.sqrt(4 * math.pi * 1.5 ** 2 / n_gauss)
    c0 = 0.28209479177387814
    params = {
        "xyz": pts,
        "f_dc": ((cols - 0.5) / c0)[:, None, :],
        "f_rest": (0.1 * rng.normal(size=(n_gauss, 15, 3))).astype(np.float32),
        "log_scale": np.full((n_gauss, 3), math.log(4 * spacing), np.float32),
        "quat": np.tile(np.array([1, 0, 0, 0], np.float32), (n_gauss, 1)),
        "logit_opacity": np.full((n_gauss, 1), math.log(0.1 / 0.9),
                                 np.float32),
        "obj_dc": np.zeros((n_gauss, 1, 0), np.float32),
    }
    logdir = os.path.join(root, "run")
    state = state_from_numpy(params, np.ones(n_gauss, bool), "cpu")
    save_gaussian_ply(state, os.path.join(logdir, "point_cloud",
                                          "iteration_30000",
                                          "point_cloud.ply"))
    cfg_path = os.path.join(logdir, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"_parent_": os.path.join(REPO, "configs",
                                            "config_base.yaml"),
                   "model": {"source_path": scene,
                             "depth_type": "intersection"}}, f)
    return cfg_path


def cuda_ms(fn, warmup=3, iters=20) -> float:
    """Median of per-call CUDA-event timings after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_render(render_view, cams, top=10, spans=("render.",)) -> dict:
    """torch.profiler over one call of ``render_view`` per camera: device ms
    per call of each stage and of the largest kernels, and the device's busy
    share of the window's wall time (profiling overhead included, so the
    idle share it implies is an upper bound). A stage is a record_function
    span whose name starts with one of ``spans``, and its time is that of
    the kernels launched inside it; "autograd" is that of the kernels the
    autograd engine's nodes launch (the whole backward, the backward
    kernel's own span included)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for arr in cams:
            render_view(arr)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    n = len(cams)
    # the span's own device-side range would also count the queued work of
    # earlier stages that runs while it is open: sum its kernels instead
    stages = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name.startswith(spans):
            stages[e.name] += e.device_time_total / 1e3 / n
        elif e.name.startswith("autograd::engine::evaluate_function"):
            stages["autograd"] += e.device_time_total / 1e3 / n
    events = prof.key_averages()
    # the spans also appear as device-side ranges: keep kernels only
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / n)
                      for e in events if e.device_type == DeviceType.CUDA
                      and not e.key.startswith(spans)),
                     key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in kernels)
    return dict(views=n, wall_ms_per_view=wall_ms / n,
                device_ms_per_view=busy_ms,
                device_busy_share=busy_ms * n / wall_ms,
                stage_device_ms=dict(stages),
                port_kernel_ms={k[:80]: ms for k, ms in kernels
                                if "rasterize_" in k},
                top_kernels=[[k[:80], ms] for k, ms in kernels[:top]])


def composited_census(binn, batches) -> tuple[int, int]:
    """(entries the kernel walks: those of each tile's composited batches,
    distinct Gaussians among them) on one view."""
    import torch

    from vcr_gaus_tpu_torch.ops import rasterize as R

    counts = binn.tile_counts.to(torch.int64)
    dev = counts.device
    tile_of = torch.repeat_interleave(torch.arange(counts.numel(), device=dev),
                                      counts)
    pos = (torch.arange(tile_of.numel(), device=dev)
           - binn.tile_starts.to(torch.int64)[tile_of])
    used = pos < batches.to(torch.int64)[tile_of] * R.BATCH
    return int(used.sum()), int(torch.unique(binn.sorted_gid[used]).numel())


def fwd_bound(feats, binn, composited, rows, pairs, power_pass, live,
              width, height, ch_sem, mode) -> tuple[int, float, float]:
    """The forward kernel's least time on one view, from its data: (ops,
    seconds at the FP32 peak, seconds at the HBM peak). The operations are
    those of the pairs of the entries each tile composited before its stop,
    256 pixels each, at what their outcome needs; the bytes, their gids,
    each Gaussian's feature row read once, the tile ranges, and the image
    written once."""
    ops = (OPS_PAIR * pairs + OPS_POWER_PASS * power_pass
           + (OPS_LIVE + OPS_LIVE_SEM * ch_sem
              + OPS_LIVE_INTERSECT * (mode == "intersection")) * live)
    nbytes = (4 * composited + 4 * feats.shape[1] * rows
              + 8 * binn.tile_counts.numel()
              + height * width * 4 * (9 + ch_sem))
    return ops, ops / PEAK_FP32, nbytes / PEAK_BYTES


def pair_census(feats, binn, batches, n_tx, width=None,
                height=None) -> tuple[int, int, int, dict]:
    """Counts of the (pixel, entry) pairs the kernel evaluates on one view:
    all of them (every entry of each batch a tile composited, for all of
    the tile's pixels, or only those inside a ``width`` x ``height`` image),
    those past the power test, and the live ones; and per pixel-to-warp map
    (``rasterize.warp_of_pixel``: the kernels' 8x8 patches, the
    thread-per-pixel rows before) [(warp, entry) steps with a live lane,
    all (warp, entry) steps, their ratio]: the steps on which a warp runs
    the live body, and the backward kernel its warp reduction."""
    import torch

    from vcr_gaus_tpu_torch.ops import projection as PF
    from vcr_gaus_tpu_torch.ops import rasterize as R
    from vcr_gaus_tpu_torch.ops.rasterize_ref import ALPHA_EPS

    dev = feats.device
    pix = torch.arange(R.TILE * R.TILE, device=dev)
    lane = torch.arange(R.BATCH, device=dev)
    gid = binn.sorted_gid.to(torch.int64)
    starts = binn.tile_starts.to(torch.int64)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    maps = {"rows16x2_P1": R.warp_of_pixel(False).to(dev),
            "patch8x8_P2": R.warp_of_pixel(True).to(dev)}
    steps = {k: torch.zeros(2, dtype=torch.int64, device=dev) for k in maps}
    for k in range(int(batches.max())):
        busy = torch.nonzero(batches > k).squeeze(1)
        for g0 in range(0, busy.numel(), 128):
            ids = busy[g0:g0 + 128]
            pos = k * R.BATCH + lane[None]
            valid = pos < binn.tile_counts[ids, None]
            f = feats[gid[torch.where(valid, starts[ids, None] + pos, 0)]]
            px = ((ids % n_tx) * R.TILE)[:, None] + pix[None] % R.TILE
            py = ((ids // n_tx) * R.TILE)[:, None] + pix[None] // R.TILE
            dx = px[:, :, None].float() - f[:, None, :, PF.F_MEAN_X]
            dy = py[:, :, None].float() - f[:, None, :, PF.F_MEAN_Y]
            power = (-0.5 * (f[:, None, :, PF.F_CONIC_A] * dx * dx
                             + f[:, None, :, PF.F_CONIC_C] * dy * dy)
                     - f[:, None, :, PF.F_CONIC_B] * dx * dy)
            pairs = valid[:, None, :].expand(-1, pix.numel(), -1)
            if width is not None:
                pairs = pairs & ((px < width) & (py < height))[:, :, None]
            passed = (power <= 0.0) & pairs
            live = passed & (f[:, None, :, PF.F_OPACITY] * torch.exp(power)
                             >= ALPHA_EPS)
            counts += torch.stack([pairs.sum(), passed.sum(), live.sum()])
            for name, m in maps.items():
                n_warps = int(m.max()) + 1
                per_warp = torch.zeros((ids.numel(), n_warps, R.BATCH),
                                       device=dev)
                per_warp.index_add_(1, m, live.float())
                steps[name] += torch.stack([(per_warp > 0).sum(),
                                            valid.sum() * n_warps])
    warp_steps = {}
    for name, (lv, total) in steps.items():
        warp_steps[name] = [int(lv), int(total), int(lv) / max(int(total), 1)]
    pairs, passed, live = counts.tolist()
    return pairs, passed, live, warp_steps


def phase_slice(device, n_gauss=1_000_000, width=1600, height=1200,
                n_views=8, n_check_tiles=64, timing_iters=20) -> dict:
    """Phase 3: the full-width render path through render_eval.main."""
    import torch

    from PIL import Image

    from vcr_gaus_tpu_torch import render_eval
    from vcr_gaus_tpu_torch.data.scene import load_scene_info
    from vcr_gaus_tpu_torch.evaluation import lpips as L
    from vcr_gaus_tpu_torch.models.ply_io import load_gaussian_ply
    from vcr_gaus_tpu_torch.ops import binning as B
    from vcr_gaus_tpu_torch.ops import rasterize as R
    from vcr_gaus_tpu_torch.render.renderer import RenderConfig, render

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        t0 = time.perf_counter()
        cfg_path = write_scene(root, n_gauss, width, height, n_views)
        setup_s = time.perf_counter() - t0

        # record every kernel call the render path makes (its inputs and
        # outputs), for the timings and the tile check below
        calls = []
        wrapped = R.rasterize_forward

        def spy(*args, **kw):
            out = wrapped(*args, **kw)
            calls.append((args, kw, out))
            return out

        # LPIPS from the generated placeholder weights, written under root
        lp_path = L.placeholder_path
        L.placeholder_path = lambda: os.path.join(root, "lpips.npz")
        os.environ["LPIPS_WEIGHTS"] = "placeholder"
        R.rasterize_forward = spy
        R.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            results = render_eval.main(["--cfg_path", cfg_path,
                                        "--device", str(device)])
        finally:
            del os.environ["LPIPS_WEIGHTS"]
            R.rasterize_forward = wrapped
        eval_s = time.perf_counter() - t0
        launches = dict(R.LAUNCHES)

        train = results["train"]
        if len(calls) != n_views or not all(map(math.isfinite,
                                                train.values())):
            raise AssertionError(f"render_eval: {len(calls)} views, {train}")
        if train.get("LPIPS_placeholder") is not True or "LPIPS" not in train:
            raise AssertionError(f"no placeholder LPIPS column: {train}")
        out_dir = os.path.join(os.path.dirname(cfg_path), "train",
                               "ours_30000")
        rendered = os.listdir(os.path.join(out_dir, "renders"))
        if len(rendered) != n_views:
            raise AssertionError(f"{len(rendered)} renders written")
        entries = [c[0][1].num_entries for c in calls]

        # LPIPS per view at full width, as evaluate_dir calls it: the two
        # u8 images read, uploaded and scored
        lp = L.LPIPS(L.placeholder_path(), device=device)
        L.placeholder_path = lp_path
        pair = [np.asarray(Image.open(os.path.join(out_dir, sub, rendered[0])),
                           np.float32).transpose(2, 0, 1) / 255.0
                for sub in ("renders", "gt")]
        lpips_ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(lp(*pair))
            lpips_ms.append(1e3 * (time.perf_counter() - t0))
        del lp

        # view 0: image sanity, kernel and plain timings, the tile check
        (feats, binn, cam, w, h, ch_sem, mode), _, (img, batches) = calls[0]
        if img.shape != (9 + ch_sem, height, width):
            raise AssertionError(f"image shape {tuple(img.shape)}")
        alpha = img[8]
        if not (bool(torch.isfinite(img).all()) and float(alpha.min()) >= 0.0
                and float(alpha.max()) <= 1.0):
            raise AssertionError("non-finite image or alpha outside [0, 1]")

        n_tx, _ = B.tile_grid(w, h)

        def kernel():
            R.rasterize_forward(feats, binn, cam, w, h, ch_sem, mode)

        def plain():
            R.composite_tiles_torch(feats, binn.sorted_gid, binn.tile_starts,
                                    binn.tile_counts, cam, n_tx, ch_sem, mode)

        kernel_ms = cuda_ms(kernel, iters=timing_iters)
        plain_ms = cuda_ms(plain, warmup=1, iters=3)

        gen = torch.Generator().manual_seed(0)
        busy = torch.nonzero(binn.tile_counts > 0).squeeze(1).cpu()
        ids = busy[torch.randperm(busy.numel(), generator=gen)[:n_check_tiles]]
        tiles, want_b = R.composite_tiles_torch(
            feats, binn.sorted_gid, binn.tile_starts, binn.tile_counts, cam,
            n_tx, ch_sem, mode, tile_ids=ids)
        err = 0.0
        for k, t in enumerate(ids.tolist()):
            y0, x0 = (t // n_tx) * R.TILE, (t % n_tx) * R.TILE
            got = img[:, y0:y0 + R.TILE, x0:x0 + R.TILE]
            want = tiles[k].reshape(-1, R.TILE, R.TILE)[:, :got.shape[1],
                                                        :got.shape[2]]
            torch.testing.assert_close(got, want, **FWD)
            err = max(err, float((got - want).abs().max()))
        if not torch.equal(batches[ids.to(batches.device)], want_b):
            raise AssertionError("batches composited differ on the full view")

        # the least time for the same work, from this run's data
        composited, rows = composited_census(binn, batches)
        pairs, power_pass, live, warp_steps = pair_census(feats, binn,
                                                          batches, n_tx)
        ops, flop_s, byte_s = fwd_bound(feats, binn, composited, rows,
                                        pairs, power_pass, live, w, h,
                                        ch_sem, mode)
        bound_ms = 1e3 * max(flop_s, byte_s)

        # end-to-end render time per view on the loaded model
        state = load_gaussian_ply(os.path.join(
            os.path.dirname(cfg_path), "point_cloud", "iteration_30000",
            "point_cloud.ply"), device=device)
        info = load_scene_info(os.path.join(root, "scene"))
        cams = [c.arrays(device) for c in info.train_cameras]
        rcfg = RenderConfig(width=width, height=height,
                            depth_mode="intersection", mask_depth_thr=1e9)
        bg = torch.zeros(3, device=device)
        render(state, cams[0], rcfg, bg, 3)
        render_ms = []
        for arr in cams:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(state, arr, rcfg, bg, 3)
            torch.cuda.synchronize()
            render_ms.append(1e3 * (time.perf_counter() - t0))
        profile = profile_render(lambda arr: render(state, arr, rcfg, bg, 3),
                                 cams[:3])

    emit(phase="slice", gaussians=n_gauss, width=width, height=height,
         views=n_views, setup_s=setup_s, render_eval_s=eval_s,
         psnr=train["PSNR"], ssim=train["SSIM"], lpips=train["LPIPS"],
         lpips_placeholder=train["LPIPS_placeholder"],
         lpips_ms_per_view=statistics.median(lpips_ms[1:]),
         entries_per_view=entries, launches=launches,
         kernel_ms=kernel_ms, plain_ms=plain_ms,
         render_ms_per_view=statistics.median(render_ms),
         render_ms_all=render_ms, composited_entries=composited,
         pairs=pairs, pairs_past_power_test=power_pass, live_pairs=live,
         warp_steps_live=warp_steps, bound_ops=ops,
         bound_ms=bound_ms, bound_flop_ms=1e3 * flop_s,
         bound_byte_ms=1e3 * byte_s, feature_rows_read=rows,
         tile_check_max_abs_err=err, library_ms=None)
    emit(phase="profile", **profile)
    return dict(launches=launches.get("rasterize_fwd", 0),
                kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if flop_s >= byte_s else "bytes",
                max_abs_err=err)


def write_train_scene(root, n_gauss, width, height, n_views, seed=0):
    """A COLMAP scene for training: ``n_views`` ring views of a smooth gray
    pattern, a unit-normal prior per view as float16 .npz in the DTU
    recipe's ``normal_npz_indoor`` folder, ``n_gauss`` points on bench.py's
    sphere shell as the init cloud (points3D.ply) and meta.json holding the
    box bench.py's cloud implies. Returns the scene directory."""
    from vcr_gaus_tpu_torch.data.scene import bound_by_points
    from vcr_gaus_tpu_torch.utils.ply import write_points_ply

    rng = np.random.default_rng(seed)
    scene = os.path.join(root, "scene")
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    pattern = np.stack([0.5 + 0.2 * np.sin(xx / 230.0 + c) * np.cos(yy / 170.0)
                        for c in range(3)], -1)
    gt = (255 * pattern).astype(np.uint8)
    write_colmap_views(scene, width, height, n_views, lambda i: gt)
    nrm_dir = os.path.join(scene, "normal_npz_indoor")
    os.makedirs(nrm_dir)
    for i in range(n_views):
        nrm = rng.normal(size=(3, height, width)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
        np.savez(os.path.join(nrm_dir, f"view_{i:03d}.npz"),
                 nrm.astype(np.float16))
    pts, cols = sphere_shell(rng, n_gauss)
    write_points_ply(os.path.join(scene, "sparse", "0", "points3D.ply"), pts,
                     cols * 255)
    trans, scale = bound_by_points(pts)
    with open(os.path.join(scene, "meta.json"), "w") as f:
        json.dump({"trans": trans.tolist(), "scale": scale.tolist()}, f)
    return scene


def phase_train(device, n_gauss=1_000_000, width=1600, height=1200,
                n_views=8, iters=20, timed_steps=10, profiled_steps=3,
                scale_mult=4.0) -> dict:
    """Phase 4: the training path at full width through the train CLI, then
    the timed step, the profile and the backward kernel's numbers."""
    import dataclasses

    import torch

    from vcr_gaus_tpu_torch.ops import binning as B
    from vcr_gaus_tpu_torch.ops import rasterize as R
    from vcr_gaus_tpu_torch.train import trainer as T
    from vcr_gaus_tpu_torch.train.__main__ import main as train_main

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        t0 = time.perf_counter()
        scene = write_train_scene(root, n_gauss, width, height, n_views)
        setup_s = time.perf_counter() - t0
        logdir = os.path.join(root, "run")

        R.reset_launch_counts()
        t0 = time.perf_counter()
        # 20 iterations of the DTU recipe without its prune schedule, so
        # that the run launches the two compositing kernels alone; phase
        # host_loop runs the prune and the importance dump
        trainer = train_main([
            "--config", os.path.join(REPO, "configs", "dtu", "base.yaml"),
            "--device", str(device), f"--logdir={logdir}",
            f"--model.source_path={scene}", f"--optim.iterations={iters}",
            "--optim.prune.iterations=[]", f"--tpu.capacity={1 << 20}"])
        train_s = time.perf_counter() - t0
        launches = dict(R.LAUNCHES)
        # one forward and one backward launch per step, one forward per
        # view in each of the two final sweeps (the last iteration's test
        # sweep and the CLI's evaluation), and one for the test sweep's
        # panel
        want = {"rasterize_fwd": iters + 2 * n_views + 1,
                "rasterize_bwd": iters}
        if launches != want:
            raise AssertionError(f"launches {launches}, expected {want}")
        hist = trainer.history
        l1 = [h["l1"] for h in hist]
        if len(hist) != iters or not all(
                math.isfinite(v) for h in hist for k, v in h.items()
                if isinstance(v, float)):
            raise AssertionError(f"training history: {hist}")
        if statistics.mean(l1[-5:]) > statistics.mean(l1[:5]):
            raise AssertionError(f"l1 rose over the run: {l1}")
        ply = os.path.join(logdir, "point_cloud", f"iteration_{iters}",
                           "point_cloud.ply")
        if not os.path.exists(ply):
            raise AssertionError("no PLY saved")
        emit(phase="train", gaussians=trainer.state.num_active,
             capacity=trainer.state.capacity, width=width, height=height,
             views=n_views, iterations=iters, setup_s=setup_s,
             train_main_s=train_s, launches=launches,
             losses=[{k: v for k, v in h.items() if k != "n_active"}
                     for h in hist])

        # the timed step: the trained state with bench.py's 4x scales, its
        # dtu_full weights, every gate open, SH degree 3; each step uploads
        # its view's image and normal prior, as Trainer.train_step does
        st = trainer.state
        state = st.replace(params=dataclasses.replace(
            st.params, log_scale=st.params.log_scale + math.log(scale_mult)))
        step = T.make_train_step(trainer.cfg, trainer.rcfg, DTU_FULL_WEIGHTS,
                                 trainer.extent, trainer.trans, trainer.scale)
        gates = T.Gates(*(True,) * len(T.Gates._fields))
        views = trainer.scene.train_cameras
        staged = [c.arrays(device) for c in views]
        bg = torch.zeros(3, device=device)
        lr = trainer._lr_xyz(iters)

        def one(i, st, cams=None):
            cam = (views[i % n_views].arrays(device) if cams is None
                   else cams[i % n_views])
            return step(st, cam, bg, lr, 3, gates)

        for i in range(2):
            state, _, _ = one(i, state)
        torch.cuda.synchronize()
        R.reset_launch_counts()
        state, _, aux = one(2, state)
        torch.cuda.synchronize()
        per_step = dict(R.LAUNCHES)
        if per_step != {"rasterize_fwd": 1, "rasterize_bwd": 1}:
            raise AssertionError(f"launches per step {per_step}")
        step_ms, step_losses = [], []
        for i in range(timed_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, losses, aux = one(3 + i, state)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            step_losses.append({k: float(v) for k, v in losses.items()})
        # the same steps with every view already on the card: the difference
        # is the per-step upload of the image and the normal prior
        staged_ms = []
        for i in range(timed_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _, _ = one(3 + i, state, staged)
            torch.cuda.synchronize()
            staged_ms.append(1e3 * (time.perf_counter() - t0))
        if not all(math.isfinite(v) for ls in step_losses for v in ls.values()):
            raise AssertionError(f"non-finite losses: {step_losses}")
        box = [state]

        def profiled(i):
            box[0], _, _ = one(i, box[0])

        profile = profile_render(profiled, list(range(profiled_steps)),
                                 spans=("render.", "train."))
        state = box[0]
        st_ms = profile["stage_device_ms"]
        # the profiler files the backward kernel's launch (ctypes, on the
        # autograd engine's thread) under the engine's node, not under the
        # span opened inside it, so it is taken by name; the rest of
        # "autograd" is the backward of projection, SH, post-processing and
        # the losses
        k2_ms = sum(ms for k, ms in profile["port_kernel_ms"].items()
                    if "rasterize_bwd" in k)
        profile["backward_kernel_device_ms"] = k2_ms
        profile["backward_other_device_ms"] = (
            st_ms.get("autograd", 0.0) - k2_ms
            - st_ms.get("render.composite_backward", 0.0))

        # the two kernels on one full-width step's inputs
        captured = {}
        wrapped = R.rasterize_forward, R.rasterize_backward

        def spy(name, fn):
            def call(*args):
                captured[name] = args
                return fn(*args)
            return call

        R.rasterize_forward = spy("fwd", wrapped[0])
        R.rasterize_backward = spy("bwd", wrapped[1])
        try:
            state, _, aux = one(3 + timed_steps, state)
        finally:
            R.rasterize_forward, R.rasterize_backward = wrapped
        # detached: the saved features still require grad, and the plain
        # version would record a graph through its batches
        args, fwd_args = (tuple(a.detach() if isinstance(a, torch.Tensor)
                                else a for a in captured[k])
                          for k in ("bwd", "fwd"))
        feats, binn, cam, img, g_img, batches, w, h, ch_sem, mode = args

        def kernel():
            return R.rasterize_backward(*args)

        def plain():
            return R.composite_tiles_backward_torch(
                feats, binn.sorted_gid, binn.tile_starts, binn.tile_counts,
                batches, cam, img, g_img, ch_sem, mode)

        kernel_ms = cuda_ms(kernel)
        fwd_kernel_ms = cuda_ms(lambda: R.rasterize_forward(*fwd_args))
        plain_ms = cuda_ms(plain, warmup=1, iters=2)
        groups = assert_grads_close(kernel(), plain(), ch_sem, BWD["rtol"])

        n_tx, _ = B.tile_grid(w, h)
        composited, rows = composited_census(binn, batches)
        pairs, power_pass, live, warp_steps = pair_census(feats, binn,
                                                          batches, n_tx)
        ops = (OPS_PAIR * pairs + OPS_POWER_PASS * power_pass
               + (OPS_BWD_LIVE + OPS_BWD_LIVE_SEM * ch_sem
                  + OPS_BWD_LIVE_INTERSECT * (mode == "intersection")) * live)
        flop_s = ops / PEAK_FP32
        # gids and feature rows read once, the image and its gradient read
        # once, the (N, 16+S) gradient written once
        nbytes = (4 * composited + 4 * feats.shape[1] * rows
                  + 8 * binn.tile_counts.numel() + 2 * h * w * 4 * (9 + ch_sem)
                  + 4 * feats.shape[0] * (feats.shape[1] + 2))
        byte_s = nbytes / PEAK_BYTES
        bound_ms = 1e3 * max(flop_s, byte_s)
        # the forward kernel's bound on the same view
        fwd_ops, fwd_flop_s, fwd_byte_s = fwd_bound(
            feats, binn, composited, rows, pairs, power_pass, live, w, h,
            ch_sem, mode)

    emit(phase="train_step", gaussians=state.num_active, width=width,
         height=height, scale_mult=scale_mult, weights=DTU_FULL_WEIGHTS,
         step_ms=statistics.median(step_ms), step_ms_all=step_ms,
         step_ms_views_on_card=statistics.median(staged_ms),
         step_losses=step_losses, launches_per_step=per_step,
         entries=aux["num_entries"], composited_entries=composited,
         pairs=pairs, pairs_past_power_test=power_pass, live_pairs=live,
         bwd_kernel_ms=kernel_ms, fwd_kernel_ms=fwd_kernel_ms,
         fwd_bound_ops=fwd_ops,
         fwd_bound_ms=1e3 * max(fwd_flop_s, fwd_byte_s),
         fwd_bound_flop_ms=1e3 * fwd_flop_s,
         fwd_bound_byte_ms=1e3 * fwd_byte_s,
         warp_steps_live=warp_steps,
         bwd_plain_ms=plain_ms, bwd_bound_ops=ops,
         bwd_bound_ms=bound_ms, bwd_bound_flop_ms=1e3 * flop_s,
         bwd_bound_byte_ms=1e3 * byte_s, feature_rows_read=rows,
         bwd_full_width_err_and_max_grad=groups,
         library_ms=None)
    emit(phase="train_profile", **profile)
    return dict(launches=launches, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="operations" if flop_s >= byte_s else "bytes",
                max_abs_err=worst_error(groups))


def schedule_launches(trainer, first: int, last: int,
                      n_full: int) -> dict[str, int]:
    """The stats, forward and backward launches the schedule implies for
    iterations first..last of ``trainer``'s recipe: one forward and one
    backward per step; per densify the box mask's sampled views, per prune
    and for the final importance dump one stats launch per view of the
    ``n_full`` train and test views; per test sweep one forward per train
    view and one for the panel."""
    sc = trainer.cfg.optim.densify_large.sample_cams
    n_train = len(trainer.scene.train_cameras)
    want = {"rasterize_fwd": 0, "rasterize_bwd": 0, "rasterize_stats": 0}
    for j in range(first, last + 1):
        want["rasterize_fwd"] += 1
        want["rasterize_bwd"] += 1
        for act in trainer.host_actions(j):
            if act == "densify":
                want["rasterize_stats"] += int(sc.num)
            elif act in ("prune", "dump importance"):
                want["rasterize_stats"] += n_full
            elif act == "test":
                want["rasterize_fwd"] += n_train + 1
    return want


def host_loop_args(scene, device, iters, capacity) -> list[str]:
    """The train CLI's arguments of phase host_loop's run: the DTU recipe
    with its schedule compressed (densify after 20, 30 and 40, opacity
    resets at 20 and 40, the prune at 30, a checkpoint at 20, test and
    save at the last iteration)."""
    return ["--config", os.path.join(REPO, "configs", "dtu", "base.yaml"),
            "--device", str(device), f"--model.source_path={scene}",
            f"--optim.iterations={iters}", "--optim.densify_from_iter=10",
            "--optim.densification_interval=10",
            "--optim.opacity_reset_interval=20",
            "--optim.prune.iterations=[30]",
            f"--train.test_iterations=[{iters}]",
            f"--train.save_iterations=[{iters}]",
            "--train.checkpoint_iterations=[20]",
            f"--tpu.capacity={capacity}"]


def phase_host_loop(device, n_gauss=1_000_000, width=1600, height=1200,
                    n_views=8, iters=40, resume_iters=4, capacity=1 << 21,
                    timing_iters=20) -> dict:
    """Phase 5: the DTU recipe's host loop at full width through the CLI,
    the resume, and the stats kernel's numbers."""
    import dataclasses

    import torch

    from vcr_gaus_tpu_torch.models import gaussians as GM
    from vcr_gaus_tpu_torch.ops import binning as B
    from vcr_gaus_tpu_torch.ops import rasterize as R
    from vcr_gaus_tpu_torch.train.__main__ import main as train_main

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        t0 = time.perf_counter()
        scene = write_train_scene(root, n_gauss, width, height, n_views)
        setup_s = time.perf_counter() - t0
        logdir = os.path.join(root, "run")
        args = host_loop_args(scene, device, iters, capacity)

        # the largest active opacity right after each opacity reset
        resets = []
        reset_opacity = GM.reset_opacity

        def spy(state):
            out = reset_opacity(state)
            resets.append(float(out.opacity[out.active].max()))
            return out

        # the stats kernel's inputs of the first view of the densifies at
        # 20 (20 steps from the init opacity 0.1) and at 30 (10 steps after
        # the reset at 20): launches 0 and 30 of the run, 30 views each
        captured = {}
        wrapped = R.rasterize_stats

        def stats_spy(feats, binn, w, h):
            if R.LAUNCHES["rasterize_stats"] in DENSIFY_CAPTURES:
                captured[DENSIFY_CAPTURES[R.LAUNCHES["rasterize_stats"]]] = (
                    feats.clone(), B.Binning(*(
                        t.clone() if torch.is_tensor(t) else t
                        for t in binn)), w, h)
            return wrapped(feats, binn, w, h)

        GM.reset_opacity = spy
        R.rasterize_stats = stats_spy
        R.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            trainer = train_main(args + [f"--logdir={logdir}"])
        finally:
            GM.reset_opacity = reset_opacity
            R.rasterize_stats = wrapped
        train_s = time.perf_counter() - t0
        launches = dict(R.LAUNCHES)
        if (int(trainer.cfg.optim.densify_large.sample_cams.num) != 30
                or sorted(captured) != sorted(DENSIFY_CAPTURES.values())):
            raise AssertionError(f"densify inputs captured: {list(captured)}")
        n_full = (len(trainer.scene.train_cameras)
                  + len(trainer.scene.test_cameras))
        want = schedule_launches(trainer, 1, iters, n_full)
        # the CLI's final evaluation renders every train view
        want["rasterize_fwd"] += len(trainer.scene.train_cameras)
        if launches != want:
            raise AssertionError(f"launches {launches}, expected {want}")
        hist = trainer.history
        if len(hist) != iters or not all(
                math.isfinite(v) for h in hist for v in h.values()):
            raise AssertionError(f"training history: {hist}")
        log = trainer.host_log
        acts = [(r["iter"], r["action"]) for r in log]
        expected = [(20, "densify"), (20, "reset opacity"), (30, "densify"),
                    (30, "prune"), (40, "densify"), (40, "reset opacity")]
        if acts != expected:
            raise AssertionError(f"host actions {acts}, expected {expected}")
        for r in log:
            if r["action"] == "densify" and r["n_after"] == r["n_before"]:
                raise AssertionError(f"densify left the population: {r}")
            if r["action"] == "prune":
                k = int(np.float32(trainer.cfg.optim.prune.percent)
                        * np.float32(r["n_before"] - 1))
                if r["n_after"] != r["n_before"] - k:
                    raise AssertionError(f"prune: {r}, expected k = {k}")
        if len(resets) != 2 or max(resets) > 0.01:
            raise AssertionError(f"max opacity after the resets: {resets}")
        out = os.path.join(logdir, "point_cloud", f"iteration_{iters}")
        files = ["cameras.json", "cfg_args", f"vis/iter_{iters:06d}.png",
                 f"{out}/point_cloud.ply", f"{out}/point_cloud_inside.ply",
                 "imp_score.npz", "chkpnt20.npz"]
        missing = [f for f in files
                   if not os.path.exists(os.path.join(logdir, f))]
        if missing:
            raise AssertionError(f"not written: {missing}")
        emit(phase="host_loop", gaussians_init=n_gauss, width=width,
             height=height, views=n_views, iterations=iters,
             setup_s=setup_s, train_main_s=train_s, launches=launches,
             host_log=log, max_opacity_after_reset=resets,
             capacity=trainer.state.capacity,
             gaussians=trainer.state.num_active,
             test=trainer.test_history,
             losses_first_last=[hist[0], hist[-1]])

        # resume from the checkpoint at 20 through the CLI
        R.reset_launch_counts()
        t0 = time.perf_counter()
        # (a later override of a key replaces an earlier one)
        resumed = train_main(args + [
            f"--logdir={os.path.join(root, 'resume')}",
            f"--optim.iterations={20 + resume_iters}",
            f"--train.test_iterations=[{20 + resume_iters}]",
            f"--train.save_iterations=[{20 + resume_iters}]",
            f"--train.start_checkpoint={logdir}/chkpnt20.npz"])
        resume_s = time.perf_counter() - t0
        r_launches = dict(R.LAUNCHES)
        r_want = schedule_launches(resumed, 21, 20 + resume_iters, n_full)
        r_want["rasterize_fwd"] += len(resumed.scene.train_cameras)
        got_iters = [h["iter"] for h in resumed.history]
        if (got_iters != list(range(21, 21 + resume_iters))
                or r_launches != r_want):
            raise AssertionError(f"resume: iterations {got_iters}, launches "
                                 f"{r_launches}, expected {r_want}")
        emit(phase="host_loop_resume", from_iteration=20,
             iterations=got_iters, train_main_s=resume_s,
             launches=r_launches, gaussians=resumed.state.num_active)
        del resumed

        # the stats kernel on the captured densify views, on one full-width
        # view of the final state (its opacities at most 0.01 after the
        # reset at 40), and of that state with every opacity at 0.1
        k3 = {name: stats_kernel_numbers(*captured.pop(name), timing_iters)
              for name in DENSIFY_CAPTURES.values()}
        cam = trainer.scene.train_cameras[0].arrays(device, pixels=False)
        state = trainer.state
        k3["final_after_reset"] = stats_kernel_numbers(
            *stats_inputs(state, cam, trainer.rcfg), timing_iters)
        opaque = state.replace(params=dataclasses.replace(
            state.params, logit_opacity=torch.where(
                state.active[:, None], math.log(0.1 / 0.9),
                state.params.logit_opacity)))
        k3["final_at_opacity_0.1"] = stats_kernel_numbers(
            *stats_inputs(opaque, cam, trainer.rcfg), timing_iters)
        del opaque

        # host time of one densify (its 30-view stats sweep included) and
        # of one prune, after two steps that refill the densify statistics
        for _ in range(2):
            trainer.train_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.densify(20)
        torch.cuda.synchronize()
        densify_ms = 1e3 * (time.perf_counter() - t0)
        sweep_views = [trainer.scene.train_cameras[i % n_views].arrays(
            device, pixels=False) for i in range(30)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._stats_sweep(sweep_views)
        torch.cuda.synchronize()
        sweep_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        trainer.light_gaussian_prune(1)
        torch.cuda.synchronize()
        prune_ms = 1e3 * (time.perf_counter() - t0)

    emit(phase="host_loop_stats", gaussians=state.num_active, **k3,
         densify_host_ms=densify_ms, stats_sweep_30_views_host_ms=sweep_ms,
         prune_host_ms=prune_ms, library_ms=None)
    main_view = k3["densify_20"]
    return dict(launches=launches, kernel_ms=main_view["kernel_ms"],
                plain_ms=main_view["plain_ms"],
                bound_ms=main_view["bound_ms"],
                bound_by=main_view["bound_by"],
                max_abs_err=max(v["imp_max_abs_err"] for v in k3.values()))


def stats_inputs(state, cam, rcfg):
    """The (feats, binning, width, height) ``render_stats`` gives the stats
    kernel for one view."""
    from vcr_gaus_tpu_torch.ops import rasterize as R
    from vcr_gaus_tpu_torch.render.renderer import render_stats

    captured = []
    wrapped = R.rasterize_stats

    def spy(*a):
        captured.append(a)
        return wrapped(*a)

    R.rasterize_stats = spy
    try:
        render_stats(state, cam, rcfg)
    finally:
        R.rasterize_stats = wrapped
    return captured[0]


def live_area_census(feats, binn) -> dict:
    """Why a view's pairs are live or not: over the Gaussians it bins, the
    area in pixels where a Gaussian's alpha reaches 1/255 (the ellipse
    0.5 d^T conic d <= ln(255 opacity), 2 pi ln(255 opacity) / sqrt(det
    conic)), against the 256 pixels of each tile it is binned to. Their
    sum estimates the live pairs (no early stop, no image edge)."""
    import torch

    from vcr_gaus_tpu_torch.ops import projection as PF

    f = feats[torch.unique(binn.sorted_gid.to(torch.int64))].double()
    a, b, c = (f[:, k] for k in (PF.F_CONIC_A, PF.F_CONIC_B, PF.F_CONIC_C))
    lvl = torch.log(255.0 * f[:, PF.F_OPACITY]).clamp_min(0.0)
    area = 2.0 * math.pi * lvl / torch.sqrt(a * c - b * b)
    n = f.shape[0]
    return dict(binned_gaussians=n,
                tiles_per_gaussian=binn.num_entries / max(n, 1),
                median_opacity=float(f[:, PF.F_OPACITY].median()) if n else 0,
                median_live_area_px=float(area.median()) if n else 0,
                live_pairs_ellipse_estimate=float(area.sum()))


def stats_kernel_numbers(feats, binn, w, h, timing_iters) -> dict:
    """The stats kernel on one view's inputs: its time (CUDA events,
    median), the plain version's, the two held against each other, the
    bound from this view's pairs, and what makes its pairs live."""
    import torch

    from vcr_gaus_tpu_torch.ops import binning as B
    from vcr_gaus_tpu_torch.ops import rasterize as R

    n_tx, _ = B.tile_grid(w, h)

    def kernel():
        return R.rasterize_stats(feats, binn, w, h)

    def plain():
        return R.composite_tiles_stats_torch(
            feats, binn.sorted_gid, binn.tile_starts, binn.tile_counts, n_tx,
            w, h)

    kernel_ms = cuda_ms(kernel, iters=timing_iters)
    plain_ms = cuda_ms(plain, warmup=1, iters=3)
    got = kernel()
    want, batches = plain()
    if not torch.equal(got[:, 0], want[:, 0]):
        raise AssertionError("full-width stats: hit counts differ")
    torch.testing.assert_close(got[:, 1], want[:, 1], **FWD)
    walked, rows = composited_census(binn, batches)
    pairs, power_pass, live, warp_steps = pair_census(feats, binn, batches,
                                                      n_tx, w, h)
    ops = (OPS_PAIR * pairs + OPS_POWER_PASS * power_pass
           + OPS_STATS_LIVE * live)
    flop_s = ops / PEAK_FP32
    # gids read once, six feature columns of each Gaussian read once, the
    # tile ranges, the (N, 2) stats written once
    nbytes = (4 * walked + 4 * 6 * rows + 8 * binn.tile_counts.numel()
              + 8 * feats.shape[0])
    byte_s = nbytes / PEAK_BYTES
    return dict(entries=binn.num_entries, walked_entries=walked,
                pairs=pairs, pairs_past_power_test=power_pass,
                live_pairs=live, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ops=ops, bound_ms=1e3 * max(flop_s, byte_s),
                bound_flop_ms=1e3 * flop_s, bound_byte_ms=1e3 * byte_s,
                bound_by="operations" if flop_s >= byte_s else "bytes",
                feature_rows_read=rows, live_share=live / max(pairs, 1),
                warp_steps_live=warp_steps, **live_area_census(feats, binn),
                imp_max_abs_err=float((got[:, 1] - want[:, 1]).abs().max()))


def compare_probe(got, want) -> list[list[float]]:
    """K4's (tiles, 1024, 10) output against its plain version's, each
    channel at atol 2e-4 times its own max|want| and rtol 1e-3: the
    channels differ by orders of magnitude (a clamped depth denominator
    makes channels 2 and 3 large). Returns [largest absolute error,
    max|want|] per channel."""
    import torch
    if got.shape != want.shape or want.shape[-1] != 10:
        raise AssertionError(f"probe shapes {tuple(got.shape)}, "
                             f"{tuple(want.shape)}")
    out = []
    for c in range(want.shape[-1]):
        g, w = got[..., c], want[..., c]
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, atol=PROBE["atol"] * scale,
                                   rtol=PROBE["rtol"],
                                   msg=lambda m, c=c: f"channel {c}: {m}")
        out.append([float((g - w).abs().max()), scale])
    return out


def phase_microprobe(device, protocol=None, small_tiles=8,
                     check_tiles=64) -> dict:
    """Phase 6; returns K4's numbers for the kernel table. ``protocol``
    (tiles, chunks) defaults to the script's protocol shape."""
    import torch

    from vcr_gaus_tpu_torch.ops import microprobe as M
    from vcr_gaus_tpu_torch.ops import rasterize as R
    from vcr_gaus_tpu_torch.tools import kernel_microprobe as KM

    n_tiles, chunks = protocol or (M.N_TILES, M.CHUNKS)
    torch.cuda.empty_cache()
    small = [torch.from_numpy(a).to(device)
             for a in M.probe_inputs(small_tiles, M.CHUNKS)]
    small_err = {name: compare_probe(
        M.microprobe(*small, **M.VARIANTS[name]),
        M.microprobe_torch(*small, **M.toggles_of(name)))
        for name in M.VARIANTS}
    emit(phase="microprobe_kernel",
         shape=f"{small_tiles} tiles x {M.CHUNKS} chunks",
         err_and_max_per_channel=small_err)

    # `full` on random tiles of the protocol shape, then the plain version's
    # time over all of it
    feats, starts, counts = (torch.from_numpy(a).to(device)
                             for a in M.probe_inputs(n_tiles, chunks))
    sel = torch.from_numpy(np.random.default_rng(1).choice(
        n_tiles, check_tiles, replace=False)).to(device)
    s_sel, c_sel = starts[sel].contiguous(), counts[sel].contiguous()
    full = M.toggles_of("full")
    check_err = compare_probe(M.microprobe(feats, s_sel, c_sel, **full),
                              M.microprobe_torch(feats, s_sel, c_sel, **full))
    plain_ms = cuda_ms(lambda: M.microprobe_torch(feats, starts, counts,
                                                  **full), warmup=1, iters=1)
    del feats, starts, counts

    # the main path: the entry point at the protocol shape, every variant;
    # it prints one line per variant (us per chunk, live shares, bound)
    R.reset_launch_counts()
    t0 = time.perf_counter()
    res = KM.main(["--device", str(device), "--n-tiles", str(n_tiles),
                   "--chunks", str(chunks)])
    main_s = time.perf_counter() - t0
    launches = dict(R.LAUNCHES)
    want = {"kernel_microprobe": len(M.VARIANTS) * (1 + KM.REPS)}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    f = res["summary"]["full"]
    max_err = max(err for err, _ in small_err["full"] + check_err)
    emit(phase="microprobe", shape=res["shape"], pairs=res["pairs"],
         main_s=main_s, launches=launches, reps=res["reps"],
         full_ms=f["ms"], full_bound_ms=f["bound_ms"], plain_ms=plain_ms,
         full_census={k: f[k] for k in (
             "live_share", "warp_live_share", "busiest_warp_live_share",
             "rows_warp_live_share", "rows_busiest_warp_live_share")},
         check_tiles=check_tiles, check_err_and_max_per_channel=check_err,
         library_ms=None)
    return dict(launches=launches["kernel_microprobe"], kernel_ms=f["ms"],
                plain_ms=plain_ms, bound_ms=f["bound_ms"],
                bound_by=f["bound_by"], max_abs_err=max_err)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "vcr_gaus_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from vcr_gaus_tpu_torch.ops import cuda_build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    emit(phase="build", seconds=time.perf_counter() - t0, card=smi,
         ptxas={k: [ln for ln in v.splitlines() if "Used" in ln
                    or "spill" in ln or "entry function" in ln]
                for k, v in reports.items()})

    worst, worst_bwd, worst_stats = phase_kernel(device)
    sl = phase_slice(device)
    if sl["launches"] != 8:
        raise AssertionError(f"rasterize_fwd launched {sl['launches']} times "
                             "on the render path, expected one per view")
    tr = phase_train(device)
    hl = phase_host_loop(device)
    mp = phase_microprobe(device)
    # launches: each kernel's count on the main path of the slice that
    # brought it (the training run for K1 and K2, the host loop's run for
    # K3, the microprobe's entry point for K4); the forward kernel's times
    # are those of the render path's view, the stats kernel's those of the
    # host loop's first densify view, the probe's those of `full` at the
    # protocol shape
    emit(kernels=[{
        "name": "rasterize_fwd", "route": "cuda",
        "source": "vcr_gaus_tpu_torch/csrc/rasterize_fwd.cu",
        "replaces": "vcr_gaus_tpu/ops/rasterize_tpu.py:532",
        "launches": tr["launches"]["rasterize_fwd"],
        "max_abs_err": max(worst, sl["max_abs_err"]),
        "ms": sl["kernel_ms"], "plain_ms": sl["plain_ms"],
        "bound_ms": sl["bound_ms"], "bound_by": sl["bound_by"],
        "library_ms": None}, {
        "name": "rasterize_bwd", "route": "cuda",
        "source": "vcr_gaus_tpu_torch/csrc/rasterize_bwd.cu",
        "replaces": "vcr_gaus_tpu/ops/rasterize_tpu.py:800",
        "launches": tr["launches"]["rasterize_bwd"],
        "max_abs_err": max(worst_bwd, tr["max_abs_err"]),
        "ms": tr["kernel_ms"], "plain_ms": tr["plain_ms"],
        "bound_ms": tr["bound_ms"], "bound_by": tr["bound_by"],
        "library_ms": None}, {
        "name": "rasterize_stats", "route": "cuda",
        "source": "vcr_gaus_tpu_torch/csrc/rasterize_stats.cu",
        "replaces": "vcr_gaus_tpu/ops/rasterize_tpu.py:923",
        "launches": hl["launches"]["rasterize_stats"],
        "max_abs_err": max(worst_stats, hl["max_abs_err"]),
        "ms": hl["kernel_ms"], "plain_ms": hl["plain_ms"],
        "bound_ms": hl["bound_ms"], "bound_by": hl["bound_by"],
        "library_ms": None}, {
        "name": "kernel_microprobe", "route": "cuda",
        "source": "vcr_gaus_tpu_torch/csrc/kernel_microprobe.cu",
        "replaces": "scripts/kernel_microprobe.py:60",
        "launches": mp["launches"], "max_abs_err": mp["max_abs_err"],
        "ms": mp["kernel_ms"], "plain_ms": mp["plain_ms"],
        "bound_ms": mp["bound_ms"], "bound_by": mp["bound_by"],
        "library_ms": None}])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
