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
             then the camera batch (train_k2): the two-view step's time
             and launches (2 of each kernel) on the trained state, the
             camera-DP step over one NCCL rank equal exactly to the plain
             two-view step from the same state and cameras (the backward
             kernel's outputs replayed), the CLI with
             --tpu.camera_batch=2 --train.debug_from=3 (its launches and
             debug notice), run_scannetpp --dry over two scenes and
             parallel.dp.scene_dispatch training two small scenes in
             threads over cuda:0;
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
  7. mesh    the DTU protocol's meshing and scoring (scripts/run_dtu.py's
             flags): a run of 1M flat opaque Gaussians tangent to the sphere
             shell, 49 1600x1200 views on a cap around it, meta.json's box
             1.1x the shell, through vcr_gaus_tpu_torch.depth2mesh's main
             (outlier prune, the depth sweep through the forward kernel, a
             501^3 TSDF grid on the card, marching tetrahedra and the
             cleanup on the host), then a DTU instance (cameras.npz at 200
             mm per unit, full-frame masks, an STL stand-in of 2M points on
             the shell, an all-ones ObsMask, a ground plane) through
             vcr_gaus_tpu_torch.eval_geometry's dtu path (cull, sampler,
             downsample, Chamfer on the card); one forward launch per view,
             the mesh's median radius within 2 voxels of the shell, the
             Chamfer below 2 voxels in mm, the card's nearest neighbours on
             200k x 200k points equal to scipy's cKDTree at rtol 1e-12, the
             forward kernel on the sweep's first view against its plain
             version on 64 tiles, and each stage's time;
  8. train_tnt  the Tanks and Temples recipe at its width: a 1M-point
             scene of 8 1600x900 views with f16 normal, f32 depth and RGB
             mask priors (the label in blue), configs/tnt/base.yaml with its
             schedule compressed (densify after 20, 30 and 40, each with
             200 random box cameras: 198 views of 512^2 through the stats
             kernel; resets at 20 and 40; a checkpoint at 20; test and save
             at 40 over 2 views; capacity 2^21) through the CLI, then
             resumed from the checkpoint; the launches against the
             schedule's, the priors as written, finite losses, non-empty box
             masks, the side networks changed, model.pkl plain numpy, the
             resume's networks equal to the checkpoint's, mIoU in [0, 1];
             then on the trained state the step's time (S = 2, the
             appearance network), a profile, one step with mono_depth,
             entropy and curv on (loss and gradients finite), K1 on 64
             tiles and K2 whole of one step's view against their plain
             versions with their times and bounds, the appearance network's
             forward and backward, the box sweep per view, K3 on a box view
             against its plain version with its bound, the mIoU sweep and a
             densify's host time;
  9. eval_tnt  scoring a Tanks and Temples run (the stages of
             vcr_gaus_tpu_torch.tools.run_tnt after training, in process,
             with its argv functions): a run of 1M flat opaque Gaussians
             tangent to the shell under configs/tnt/base.yaml, 60 1600x900
             views on a Fibonacci sphere around it; depth2mesh over a
             two-rung voxel ladder (the first rung's 1001^3 grid above
             --max_voxels exits 3, the second meshes a 501^3 grid from 20
             fused views, traditional depth: the TSDF reads the recipe's
             intersection depth as z-depth), tools.crop_mesh,
             eval_geometry tnt --icp against a 5M-point GT stand-in at tau
             = 2 voxels (F1 >= 0.9), the official protocol
             (evaluate_tnt_scene: the GT in a frame 1.3x scaled, rotated and
             shifted, trajectories with 3 outlier cameras, the scene's
             pre-alignment and crop json; F1 >= 0.9 and the similarity
             recovered within 1e-3); the recipe's intersection depth meshed
             once more (its F1 and offset reported); a 120-frame fly-through
             (render_paths.render_flythrough), one forward launch a frame;
             the card's nearest neighbours, voxel downsample and ICP against
             cKDTree, the CPU and a cKDTree loop on 200k-point subsamples,
             the forward kernel on the first frame against its plain
             version, its time and bound;
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


def write_colmap_views(scene, width, height, n_views, image_fn,
                       poses=None):
    """COLMAP cameras of ``n_views`` views under ``scene`` (fovx 0.9, fovy
    0.7), each with the (H, W, 3) uint8 image ``image_fn(i)``: bench.py's
    ring (identity rotation, centers on a 0.3 ring) or ``poses``, a list of
    (qvec, tvec) world-to-camera poses."""
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
        qvec, tvec = (poses[i] if poses is not None else (
            np.array([1.0, 0.0, 0.0, 0.0]),
            np.array([0.3 * np.cos(ang), 0.3 * np.sin(ang), 0.0])))
        images[i + 1] = CM.ColmapImage(i + 1, qvec, tvec, 1, name)
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


def bwd_bound(feats, binn, composited, rows, pairs, power_pass, live,
              width, height, ch_sem, mode) -> tuple[int, float, float]:
    """The backward kernel's least time on one view, as ``fwd_bound``: the
    operations of its pairs at what their outcome needs; the bytes, the
    gids and feature rows read once, the image and its gradient read once,
    the (N, 16+S) gradient written once."""
    ops = (OPS_PAIR * pairs + OPS_POWER_PASS * power_pass
           + (OPS_BWD_LIVE + OPS_BWD_LIVE_SEM * ch_sem
              + OPS_BWD_LIVE_INTERSECT * (mode == "intersection")) * live)
    nbytes = (4 * composited + 4 * feats.shape[1] * rows
              + 8 * binn.tile_counts.numel()
              + 2 * height * width * 4 * (9 + ch_sem)
              + 4 * feats.shape[0] * (feats.shape[1] + 2))
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


def fwd_tile_check(call, n_tiles) -> float:
    """The forward kernel's output of one recorded call, ``((feats, binn,
    cam, w, h, ch_sem, mode), kw, (img, batches))``, against its plain
    version on ``n_tiles`` random busy tiles: every channel at FWD and the
    batch counts exactly. Returns the largest absolute error."""
    import torch

    from vcr_gaus_tpu_torch.ops import binning as B
    from vcr_gaus_tpu_torch.ops import rasterize as R

    (feats, binn, cam, w, h, ch_sem, mode), _, (img, batches) = call
    n_tx, _ = B.tile_grid(w, h)
    gen = torch.Generator().manual_seed(0)
    busy = torch.nonzero(binn.tile_counts > 0).squeeze(1).cpu()
    ids = busy[torch.randperm(busy.numel(), generator=gen)[:n_tiles]]
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
    return err


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

        err = fwd_tile_check(calls[0], n_check_tiles)

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


def write_train_scene(root, n_gauss, width, height, n_views, seed=0,
                      normal_folder="normal_npz_indoor"):
    """A COLMAP scene for training: ``n_views`` ring views of a smooth gray
    pattern, a unit-normal prior per view as float16 .npz in
    ``normal_folder`` (default: the DTU recipe's), ``n_gauss`` points on
    bench.py's sphere shell as the init cloud (points3D.ply) and meta.json
    holding the box bench.py's cloud implies. Returns the scene
    directory."""
    from vcr_gaus_tpu_torch.data.scene import bound_by_points
    from vcr_gaus_tpu_torch.utils.ply import write_points_ply

    rng = np.random.default_rng(seed)
    scene = os.path.join(root, "scene")
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    pattern = np.stack([0.5 + 0.2 * np.sin(xx / 230.0 + c) * np.cos(yy / 170.0)
                        for c in range(3)], -1)
    gt = (255 * pattern).astype(np.uint8)
    write_colmap_views(scene, width, height, n_views, lambda i: gt)
    nrm_dir = os.path.join(scene, normal_folder)
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
        ops, flop_s, byte_s = bwd_bound(feats, binn, composited, rows, pairs,
                                        power_pass, live, w, h, ch_sem, mode)
        bound_ms = 1e3 * max(flop_s, byte_s)
        # the forward kernel's bound on the same view
        fwd_ops, fwd_flop_s, fwd_byte_s = fwd_bound(
            feats, binn, composited, rows, pairs, power_pass, live, w, h,
            ch_sem, mode)
        del captured, args, fwd_args, feats, binn, cam, img, g_img, batches
        k2 = camera_batch_checks(device, trainer, state, scene, root, lr,
                                 timed_steps=timed_steps)

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
                max_abs_err=worst_error(groups), launches_k2=k2["launches"])


def same(a, b) -> bool:
    """Exact equality of tensors, or of tuples, lists and dicts of them and
    of plain values."""
    import torch
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and a.dtype == b.dtype and bool(torch.equal(a, b)))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return a == b


def step_result(out) -> list:
    """A train step's (state, losses, aux) as a flat list, for ``same``."""
    from vcr_gaus_tpu_torch.parallel import dp
    state, losses, aux = out
    return [dp.leaves(state), state.adam.step, losses, aux]


def camera_batch_checks(device, trainer, state, scene, root, lr,
                        timed_steps=10, cli_iters=6, debug_from=3,
                        eval_cams=2) -> dict:
    """Phase train's camera batch (``tpu.camera_batch`` 2) on the trained
    state at full width: the two-view step's time and launches; the
    camera-DP step at world size 1 (one NCCL rank) against the plain
    two-view step from the same state and cameras, exactly, with the
    backward kernel's output of the plain step replayed into the DP step
    (its float atomics vary the last bits from one launch to the next;
    ``repeat_bitwise_equal`` says whether they did here); the train CLI
    with ``--tpu.camera_batch=2 --train.debug_from=N``, its launches
    counted from 0 (this slice's main path) and its debug notice; the
    ScanNet++ runner's dry run over two scenes and scene_dispatch
    (parallel) over [cuda:0] training two small scenes."""
    import contextlib
    import io

    import torch

    from vcr_gaus_tpu_torch.config import Config
    from vcr_gaus_tpu_torch.ops import rasterize as R
    from vcr_gaus_tpu_torch.parallel import dp
    from vcr_gaus_tpu_torch.tools import run_scannetpp
    from vcr_gaus_tpu_torch.train import trainer as T
    from vcr_gaus_tpu_torch.train.__main__ import main as train_main

    views = trainer.scene.train_cameras
    n_views = len(views)
    gates = T.Gates(*(True,) * len(T.Gates._fields))
    bg = torch.zeros(3, device=device)
    args = (trainer.cfg, trainer.rcfg, DTU_FULL_WEIGHTS, trainer.extent,
            trainer.trans, trainer.scale)
    step = T.make_train_step(*args)

    def pair(i):
        """Views 2i and 2i + 1, uploaded as Trainer.train_step does."""
        return [views[(2 * i + j) % n_views].arrays(device) for j in (0, 1)]

    for i in range(2):
        state, _, _ = step(state, pair(i), bg, lr, 3, gates)
    torch.cuda.synchronize()
    R.reset_launch_counts()
    state, _, _ = step(state, pair(2), bg, lr, 3, gates)
    torch.cuda.synchronize()
    per_step = dict(R.LAUNCHES)
    if per_step != {"rasterize_fwd": 2, "rasterize_bwd": 2}:
        raise AssertionError(f"two-view step launches {per_step}")
    step_ms, step_losses = [], []
    for i in range(timed_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, losses, _ = step(state, pair(3 + i), bg, lr, 3, gates)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        step_losses.append({k: float(v) for k, v in losses.items()})
    if not all(math.isfinite(v) for ls in step_losses for v in ls.values()):
        raise AssertionError(f"non-finite two-view losses: {step_losses}")

    # the plain two-view step, recording the backward kernel's outputs;
    # again without the recording, to see whether the kernel repeats
    cams = pair(0)
    real_bwd = R.rasterize_backward
    recorded = []

    def record(*a):
        out = real_bwd(*a)
        recorded.append((a, out.clone()))
        return out

    R.rasterize_backward = record
    try:
        plain = step_result(step(state, cams, bg, lr, 3, gates))
    finally:
        R.rasterize_backward = real_bwd
    again = step_result(step(state, cams, bg, lr, 3, gates))
    repeat_equal = same(plain, again)
    repeat_diff = max(float((x - y).abs().max()) for x, y in zip(
        plain[0], again[0]) if x.dtype == torch.float32 and x.numel())

    # the camera-DP step over one NCCL rank, the plain step's backward
    # outputs replayed for inputs equal to the plain step's
    t0 = time.perf_counter()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device.type == "cuda" else device)
    dp.init_process_group(0, 1, "file://" + os.path.join(root, "nccl_store"),
                          dev)
    try:
        dstep = T.make_train_step(*args, distributed=True)
        replay = iter(recorded)

        def replayed(*a):
            want, out = next(replay)
            if not same(list(a), list(want)):
                raise AssertionError("the DP step's backward inputs differ "
                                     "from the plain step's")
            return out.clone()

        R.rasterize_backward = replayed
        try:
            dp_out = step_result(dstep(state, cams, bg, lr, 3, gates))
        finally:
            R.rasterize_backward = real_bwd
        if not same(dp_out, plain):
            raise AssertionError("the camera-DP step at world size 1 differs "
                                 "from the plain two-view step")
    finally:
        torch.distributed.destroy_process_group()
    dp_s = time.perf_counter() - t0
    del recorded, plain, again, dp_out

    # the train CLI with a camera batch of 2 and the debug hooks: this
    # slice's main path, its launches counted from 0
    logdir = os.path.join(root, "run_k2")
    R.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            tr = train_main([
                "--config", os.path.join(REPO, "configs", "dtu", "base.yaml"),
                "--device", str(device), f"--logdir={logdir}",
                f"--model.source_path={scene}",
                f"--optim.iterations={cli_iters}",
                "--optim.prune.iterations=[]", f"--tpu.capacity={1 << 20}",
                "--tpu.camera_batch=2", f"--train.debug_from={debug_from}",
                f"--tpu.eval_max_cams={eval_cams}"])
    finally:
        torch.autograd.set_detect_anomaly(False)
    cli_s = time.perf_counter() - t0
    cli_launches = dict(R.LAUNCHES)
    text = buf.getvalue()
    n_eval = eval_views(tr)
    # two forward and two backward launches a step; the last iteration's
    # test sweep (its views and the panel) and the CLI's evaluation
    want = {"rasterize_fwd": 2 * cli_iters + 2 * n_eval + 1,
            "rasterize_bwd": 2 * cli_iters}
    if cli_launches != want:
        raise AssertionError(f"CLI launches {cli_launches}, expected {want}")
    notice = [ln for ln in text.splitlines() if ln.startswith("[debug]")]
    if notice != [f"[debug] NaN tracing + per-step finite checks enabled "
                  f"from iteration {debug_from}"]:
        raise AssertionError(f"debug notice: {notice}")
    if not tr._debug_on or len(tr.history) != cli_iters or not all(
            math.isfinite(v) for h in tr.history for v in h.values()
            if isinstance(v, float)):
        raise AssertionError(f"CLI history: {tr.history}")
    del tr

    # scene-DP: the runner's stage list, and two small scenes trained in
    # threads through scene_dispatch over the one card
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_scannetpp.main(["--data_root", os.path.join(root, "spp"),
                            "--out", os.path.join(root, "spp_out"),
                            "--scenes", "sceneA", "sceneB", "--dry",
                            "--device", "cuda"])
    stages = [ln.split(" + ", 1) for ln in buf.getvalue().splitlines()
              if "] + " in ln]
    modules = [(tag, cmd.split()[2]) for tag, cmd in stages]
    if modules != [(f"[{s}]", f"vcr_gaus_tpu_torch.{m}")
                   for s in ("sceneA", "sceneB")
                   for m in ("train", "depth2mesh", "render_eval")]:
        raise AssertionError(f"run_scannetpp --dry stages: {modules}")
    small = [write_train_scene(os.path.join(root, f"sdp{i}"), 20_000, 160,
                               120, 4, seed=i + 1) for i in range(2)]

    def make(i, src):
        def fn(d):
            cfg = Config(os.path.join(REPO, "configs", "dtu", "base.yaml"),
                         overrides=[f"--logdir={root}/sdp_run{i}",
                                    f"--model.source_path={src}",
                                    "--optim.iterations=3",
                                    "--optim.prune.iterations=[]",
                                    f"--tpu.capacity={1 << 16}"])
            t = T.Trainer(cfg, device=d)
            hist = t.train(log_every=1)
            return str(t.state.params.xyz.device), [h["total"] for h in hist]
        return fn

    with contextlib.redirect_stdout(io.StringIO()):
        sdp = dp.scene_dispatch([make(i, s) for i, s in enumerate(small)],
                                [dev], parallel=True)
    if [d for d, _ in sdp] != [str(dev)] * 2 or not all(
            len(h) == 3 and all(map(math.isfinite, h)) for _, h in sdp):
        raise AssertionError(f"scene_dispatch: {sdp}")
    scene_dp_s = time.perf_counter() - t0

    emit(phase="train_k2", camera_batch=2, gaussians=state.num_active,
         step_ms_k2=statistics.median(step_ms), step_ms_k2_all=step_ms,
         launches_per_step_k2=per_step, step_losses_k2=step_losses,
         repeat_bitwise_equal=repeat_equal,
         repeat_max_abs_state_diff=repeat_diff,
         dp_world1_exact=True, dp_world1_s=dp_s,
         cli_iterations=cli_iters, cli_debug_from=debug_from,
         cli_launches=cli_launches, cli_s=cli_s, cli_debug_notice=notice[0],
         scannetpp_dry_stages=len(stages),
         scene_dispatch=[{"device": d, "losses": h} for d, h in sdp],
         scene_dp_s=scene_dp_s)
    return dict(launches=cli_launches, step_ms=statistics.median(step_ms))


def schedule_launches(trainer, first: int, last: int,
                      n_full: int) -> dict[str, int]:
    """The stats, forward and backward launches the schedule implies for
    iterations first..last of ``trainer``'s recipe: one forward and one
    backward per step; per densify the box mask's views (``box_views``),
    per prune and for the final importance dump one stats launch per view
    of the ``n_full`` train and test views; per test sweep one forward per
    train view (at most ``tpu.eval_max_cams``) and one for the panel."""
    n_train = eval_views(trainer)
    want = {"rasterize_fwd": 0, "rasterize_bwd": 0, "rasterize_stats": 0}
    for j in range(first, last + 1):
        want["rasterize_fwd"] += 1
        want["rasterize_bwd"] += 1
        for act in trainer.host_actions(j):
            if act == "densify":
                want["rasterize_stats"] += box_views(trainer)
            elif act in ("prune", "dump importance"):
                want["rasterize_stats"] += n_full
            elif act == "test":
                want["rasterize_fwd"] += n_train + 1
    return want


def eval_views(trainer) -> int:
    """The train views a test sweep renders (``tpu.eval_max_cams``, 0 =
    all)."""
    n = len(trainer.scene.train_cameras)
    cap = int(trainer.cfg.tpu.eval_max_cams or 0)
    return min(n, cap) if cap else n


def box_views(trainer) -> int:
    """The views of one densify's box mask: ``sample_cams.num`` training
    views, or the cameras ``sample_box_cameras`` places on the box for
    it (random mode)."""
    from vcr_gaus_tpu_torch.data import box_cameras as BC
    sc = trainer.cfg.optim.densify_large.sample_cams
    if not sc.random:
        return int(sc.num)
    return len(BC._face_positions(int(sc.num), 1, 1.0, bool(sc.up),
                                  bool(sc.around), "random",
                                  np.random.default_rng(0)))


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
        want["rasterize_fwd"] += eval_views(trainer)
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
        r_want["rasterize_fwd"] += eval_views(resumed)
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


# phase mesh: the DTU protocol's meshing and scoring (scripts/run_dtu.py's
# depth2mesh and eval_geometry flags) on a scene of the protocol's shape
DTU_VIEWS = 49                         # views of a DTU scan
MESH_CENTER = np.array([0.0, 0.0, 4.0])  # bench.py's sphere shell
MESH_RADIUS = 1.5
MESH_BOX = 1.65                        # meta.json half-size: 1.1 x the shell
# 2 x 1.65 / 500: a grid of ~501^3 voxels, the DTU protocol's count (a
# meta box of scale ~1 at --voxel_size 0.004, scripts/run_dtu.py)
MESH_VOXEL = 2 * MESH_BOX / 500
MESH_MAX_DEPTH = 5.0                   # the cameras' distance 4 + 1
MM_PER_UNIT = 200.0                    # scale_mat: normalized -> DTU mm
MM_OFFSET = np.array([30.0, -20.0, 640.0])
OBS_RES = 4.0                          # ObsMask voxel (mm)


def dtu_poses(n_views, dist=4.0, spread=0.5):
    """World-to-camera (R, T) of ``n_views`` cameras on an (azimuth,
    elevation) grid of +-``spread`` radians around the shell's -z side, each
    at ``dist`` from its center and looking at it, in COLMAP's axes (x
    right, y down, z forward)."""
    k = math.ceil(math.sqrt(n_views))
    ang = np.linspace(-spread, spread, k)
    poses = []
    for el in ang:
        for az in ang:
            d = np.array([np.sin(az) * np.cos(el), np.sin(el),
                          -np.cos(az) * np.cos(el)])
            fwd = -d
            right = np.cross([0.0, 1.0, 0.0], fwd)
            right /= np.linalg.norm(right)
            R = np.stack([right, np.cross(fwd, right), fwd])
            poses.append((R, -R @ (MESH_CENTER + dist * d)))
    return poses[:n_views]


def flat_shell_params(rng, n, ch_sem=0):
    """``n`` flat opaque Gaussians tangent to bench.py's sphere shell: the
    shortest axis radial (1% of the tangent ones, which are 1.2x the mean
    spacing), opacity 0.9, random colours, SH degree 3, ``ch_sem`` zero
    semantic channels."""
    pts, cols = sphere_shell(rng, n)
    nrm = (pts - MESH_CENTER) / MESH_RADIUS
    # the rotation taking the local z axis onto the normal
    quat = np.stack([1 + nrm[:, 2], -nrm[:, 1], nrm[:, 0], np.zeros(n)], 1)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    sigma = 1.2 * math.sqrt(4 * math.pi * MESH_RADIUS ** 2 / n)
    c0 = 0.28209479177387814
    return {
        "xyz": pts,
        "f_dc": ((cols - 0.5) / c0)[:, None, :],
        "f_rest": np.zeros((n, 15, 3), np.float32),
        "log_scale": np.log(np.tile([sigma, sigma, 0.01 * sigma],
                                    (n, 1))).astype(np.float32),
        "quat": quat.astype(np.float32),
        "logit_opacity": np.full((n, 1), math.log(0.9 / 0.1), np.float32),
        "obj_dc": np.zeros((n, 1, ch_sem), np.float32),
    }


def write_mesh_scene(root, n_gauss, width, height, poses,
                     parent="config_base.yaml", ch_sem=0, seed=0):
    """A trained run for depth2mesh: a COLMAP scene of the world-to-camera
    ``poses`` ((R, T) pairs; 8x6 stand-in images, since depth2mesh reads
    geometry only and the config loads images lazily), meta.json's box
    around the shell, and a config (whose parent is configs/``parent``)
    and a PLY of ``n_gauss`` flat Gaussians on the shell with ``ch_sem``
    zero semantic channels. The config keeps the parent's depth type.
    Returns the config's path."""
    import yaml
    from scipy.spatial.transform import Rotation

    from vcr_gaus_tpu_torch.models.convert import state_from_numpy
    from vcr_gaus_tpu_torch.models.ply_io import save_gaussian_ply
    from vcr_gaus_tpu_torch.utils import colmap as CM

    rng = np.random.default_rng(seed)
    scene = os.path.join(root, "scene")
    qvecs = [np.roll(Rotation.from_matrix(R).as_quat(), 1) for R, _ in poses]
    stand_in = np.zeros((6, 8, 3), np.uint8)
    write_colmap_views(scene, width, height, len(poses), lambda i: stand_in,
                       poses=[(q, T) for q, (_, T) in zip(qvecs, poses)])
    params = flat_shell_params(rng, n_gauss, ch_sem)
    sub = rng.choice(n_gauss, min(n_gauss, 2000), replace=False)
    CM.write_points3d_binary(params["xyz"][sub],
                             np.full((len(sub), 3), 128.0),
                             os.path.join(scene, "sparse", "0", "points3D.bin"))
    with open(os.path.join(scene, "meta.json"), "w") as f:
        json.dump({"trans": MESH_CENTER.tolist(), "scale": [MESH_BOX] * 3}, f)
    logdir = os.path.join(root, "run")
    save_gaussian_ply(state_from_numpy(params, np.ones(n_gauss, bool), "cpu"),
                      os.path.join(logdir, "point_cloud", "iteration_30000",
                                   "point_cloud.ply"))
    cfg_path = os.path.join(logdir, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"_parent_": os.path.join(REPO, "configs", parent),
                        "model": {"source_path": scene,
                                  "data_device": "lazy"}}, f)
    return cfg_path


def write_dtu_instance(root, poses, width, height, scan=1, n_stl=2_000_000,
                       seed=1):
    """The DTU evaluation's inputs for the mesh scene, in mm at
    MM_PER_UNIT: an instance dir (cameras.npz with world_mat_i and
    scale_mat_i of ``poses``, full-frame masks) and a dataset dir (an STL
    stand-in of ``n_stl`` points on the whole shell, an all-ones ObsMask
    over its box, a ground plane behind the shell as the cameras see it,
    cutting its far cap). Returns (dataset dir, instance dir)."""
    from PIL import Image
    from scipy.io import savemat

    from vcr_gaus_tpu_torch.utils import graphics as G
    from vcr_gaus_tpu_torch.utils.ply import write_points_ply

    inst = os.path.join(root, "instance")
    os.makedirs(os.path.join(inst, "mask"))
    scale_mat = np.eye(4)
    scale_mat[:3, :3] *= MM_PER_UNIT
    scale_mat[:3, 3] = MM_OFFSET
    K = np.array([[G.fov2focal(0.9, width), 0, width / 2],
                  [0, G.fov2focal(0.7, height), height / 2], [0, 0, 1]])
    cams = {}
    full = Image.fromarray(np.full((height, width), 255, np.uint8))
    for i, (R, T) in enumerate(poses):
        P = np.eye(4)
        P[:3] = K @ np.concatenate([R, T[:, None]], 1)
        cams[f"world_mat_{i}"] = P @ np.linalg.inv(scale_mat)
        cams[f"scale_mat_{i}"] = scale_mat
        full.save(os.path.join(inst, "mask", f"{i:03d}.png"))
    np.savez(os.path.join(inst, "cameras.npz"), **cams)

    data = os.path.join(root, "dtu_eval")
    os.makedirs(os.path.join(data, "ObsMask"))
    stl, _ = sphere_shell(np.random.default_rng(seed), n_stl)
    stl = stl.astype(np.float64) * MM_PER_UNIT + MM_OFFSET
    write_points_ply(os.path.join(data, "Points", "stl",
                                  f"stl{scan:03d}_total.ply"), stl)
    bb = np.stack([stl.min(0) - 10, stl.max(0) + 10])
    shape = np.ceil((bb[1] - bb[0]) / OBS_RES).astype(int) + 1
    savemat(os.path.join(data, "ObsMask", f"ObsMask{scan}_10.mat"),
            {"ObsMask": np.ones(shape, np.uint8), "BB": bb,
             "Res": np.array([[OBS_RES]])})
    # keep z < center + 0.2 radius: hom @ P > 0
    z0 = (MESH_CENTER[2] + 0.2 * MESH_RADIUS) * MM_PER_UNIT + MM_OFFSET[2]
    savemat(os.path.join(data, "ObsMask", f"Plane{scan}.mat"),
            {"P": np.array([[0.0], [0.0], [-1.0], [z0]])})
    return data, inst


class StageTimer:
    """Wraps module functions to record each call's seconds, the device
    synchronized before and after, and the calls' arguments where asked.
    Use as a context manager; the wrapped functions are restored on
    exit."""

    def __init__(self, device, targets, keep_args=()):
        self.device, self.targets, self.keep_args = device, targets, keep_args
        self.seconds = {name: [] for _, name in targets}
        self.args = {name: [] for name in keep_args}

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def __enter__(self):
        self.saved = []
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def timed(*a, _fn=fn, _name=name, **kw):
                self._sync()
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                self._sync()
                self.seconds[_name].append(time.perf_counter() - t0)
                if _name in self.args:
                    self.args[_name].append((a, kw))
                return out

            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def phase_mesh(device, n_gauss=1_000_000, width=1600, height=1200,
               n_views=DTU_VIEWS, voxel=MESH_VOXEL, n_stl=2_000_000,
               n_nn_check=200_000, n_check_tiles=64, timing_iters=20) -> dict:
    """Phase 7: mesh and score a DTU-shaped run through the entry points."""
    import torch
    from scipy.spatial import cKDTree

    from vcr_gaus_tpu_torch import depth2mesh, eval_geometry
    from vcr_gaus_tpu_torch.evaluation import dtu_cull
    from vcr_gaus_tpu_torch.evaluation import geometry as GE
    from vcr_gaus_tpu_torch.meshing import extract as X
    from vcr_gaus_tpu_torch.meshing import marching as MC
    from vcr_gaus_tpu_torch.meshing import tsdf as T
    from vcr_gaus_tpu_torch.ops import binning as B
    from vcr_gaus_tpu_torch.ops import rasterize as R

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        t0 = time.perf_counter()
        poses = dtu_poses(n_views)
        cfg_path = write_mesh_scene(root, n_gauss, width, height, poses)
        data_dir, inst_dir = write_dtu_instance(root, poses, width, height,
                                                n_stl=n_stl)
        setup_s = time.perf_counter() - t0

        # the forward kernel's first call on the path, for its timing and
        # the tile check
        calls = []
        wrapped = R.rasterize_forward

        def spy(*args, **kw):
            out = wrapped(*args, **kw)
            if not calls:
                calls.append((args, kw, out))
            return out

        timer = StageTimer(device, [
            (depth2mesh, "prune_outliers"), (X, "_view_depth"),
            (T, "integrate"), (MC, "marching_tets"),
            (MC, "keep_largest_components"), (dtu_cull, "cull_mesh_dtu"),
            (GE, "sample_points_on_mesh"), (GE, "radius_downsample"),
            (GE, "nn_distances")], keep_args=("integrate", "nn_distances"))
        R.rasterize_forward = spy
        try:
            with timer:
                R.reset_launch_counts()
                t0 = time.perf_counter()
                mesh_path = depth2mesh.main([
                    "--cfg_path", cfg_path, "--voxel_size", str(voxel),
                    "--max_depth", str(MESH_MAX_DEPTH), "--prob_thr", "0.15",
                    "--num_cluster", "1", "--device", str(device)])
                torch.cuda.synchronize()
                mesh_s = time.perf_counter() - t0
                launches = dict(R.LAUNCHES)
                t0 = time.perf_counter()
                score = eval_geometry.main([
                    "dtu", "--ply_path", mesh_path, "--dataset_dir", data_dir,
                    "--scan", "1", "--instance_dir", inst_dir,
                    "--device", str(device)])
                torch.cuda.synchronize()
                eval_s = time.perf_counter() - t0
        finally:
            R.rasterize_forward = wrapped
        sec = timer.seconds

        if launches.get("rasterize_fwd", 0) != n_views:
            raise AssertionError(f"rasterize_fwd launched {launches} on the "
                                 f"mesh path, expected once per view")
        verts, faces = X.load_mesh_ply(mesh_path)
        radii = np.linalg.norm(verts - MESH_CENTER, axis=1)
        radius_err = float(np.median(radii)) - MESH_RADIUS
        if len(faces) < 1000 or abs(radius_err) > 2 * voxel:
            raise AssertionError(f"mesh of {len(verts)} verts, median radius "
                                 f"off the shell by {radius_err}")
        score_limit = 2 * voxel * MM_PER_UNIT
        if not (math.isfinite(score["overall"])
                and score["overall"] < score_limit):
            raise AssertionError(f"chamfer {score} above {score_limit} mm")

        # the card's nearest neighbours on a subsample of the data -> STL
        # query, against scipy's cKDTree in float64
        (query, target, *_), _ = timer.args["nn_distances"][0]
        rng = np.random.default_rng(0)
        q = query[rng.choice(len(query), min(n_nn_check, len(query)),
                             replace=False)]
        t = target[rng.choice(len(target), min(n_nn_check, len(target)),
                              replace=False)]
        t0 = time.perf_counter()
        got = GE.nn_distances(q, t, device=device)
        nn_check_s = time.perf_counter() - t0
        want = cKDTree(t).query(q, k=1, workers=-1)[0]
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        nn_rel_err = float(np.max(np.abs(got - want)
                                  / np.maximum(want, 1e-300)))

        # the forward kernel on the first view of the sweep
        (feats, binn, cam, w, h, ch_sem, mode), _, (img, batches) = calls[0]

        def kernel():
            R.rasterize_forward(feats, binn, cam, w, h, ch_sem, mode)

        kernel_ms = cuda_ms(kernel, iters=timing_iters)
        err = fwd_tile_check(calls[0], n_check_tiles)
        composited, rows = composited_census(binn, batches)
        pairs, power_pass, live, _ = pair_census(
            feats, binn, batches, B.tile_grid(w, h)[0])
        _, flop_s, byte_s = fwd_bound(feats, binn, composited, rows, pairs,
                                      power_pass, live, w, h, ch_sem, mode)
        grid_dims = list(timer.args["integrate"][0][0][0].tsdf.shape)

    emit(phase="mesh", gaussians=n_gauss, width=width, height=height,
         views=n_views, voxel=voxel, grid_dims=grid_dims,
         voxels=int(np.prod(grid_dims)), setup_s=setup_s,
         depth2mesh_s=mesh_s, eval_s=eval_s, total_s=mesh_s + eval_s,
         prune_s=sum(sec["prune_outliers"]),
         render_ms_per_view=1e3 * statistics.median(sec["_view_depth"]),
         kernel_ms=kernel_ms, bound_ms=1e3 * max(flop_s, byte_s),
         bound_by="operations" if flop_s >= byte_s else "bytes",
         pairs=pairs, live_pairs=live,
         integrate_ms_per_view=1e3 * statistics.median(sec["integrate"]),
         marching_s=sum(sec["marching_tets"]),
         cleanup_s=sec["keep_largest_components"][0],
         cull_s=sum(sec["cull_mesh_dtu"]),
         cull_cleanup_s=sum(sec["keep_largest_components"][1:]),
         sample_s=sum(sec["sample_points_on_mesh"]),
         downsample_s=sum(sec["radius_downsample"]),
         nn_s=sum(sec["nn_distances"]),
         nn_queries=[len(a[0]) for a, _ in timer.args["nn_distances"]],
         nn_targets=[len(a[1]) for a, _ in timer.args["nn_distances"]],
         mesh_verts=len(verts), mesh_faces=len(faces),
         median_radius_err=radius_err, chamfer=score,
         chamfer_limit_mm=score_limit, nn_check=[len(q), len(t)],
         nn_check_s=nn_check_s, nn_check_max_rel_err=nn_rel_err,
         tile_check_max_abs_err=err, launches=launches)
    return dict(launches=launches.get("rasterize_fwd", 0), max_abs_err=err)


# the Tanks and Temples cell: 1600x900 views (a TNT image at resolution -1)
TNT_WIDTH, TNT_HEIGHT = 1600, 900
SHELL_CENTER, SHELL_RADIUS = np.array([0.0, 0.0, 4.0]), 1.5
# the losses of the port no TNT recipe sets, on one more step:
# ScanNet++'s curv (with its mask_depth_thr 0: the depth cut off) and 0.01
# of mono_depth and entropy
EXTRA_LOSSES = {"mono_depth": 0.01, "entropy": 0.01, "curv": 0.05}


def shell_views(width, height, n_views):
    """Per ring view of ``write_colmap_views`` (identity rotation, centre
    on the 0.3 ring, fovx 0.9, fovy 0.7): the sphere shell's silhouette
    (H, W) bool through the pixel centres, and the z-depth of its front
    surface there (0 elsewhere), float32."""
    from vcr_gaus_tpu_torch.utils import graphics as G

    fx, fy = G.fov2focal(0.9, width), G.fov2focal(0.7, height)
    v, u = np.mgrid[0:height, 0:width] + 0.5
    d = np.stack([(u - width / 2) / fx, (v - height / 2) / fy,
                  np.ones_like(u)], -1)
    a = np.sum(d * d, -1)
    out = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        c = SHELL_CENTER + np.array([0.3 * np.cos(ang), 0.3 * np.sin(ang),
                                     0.0])
        b = d @ c
        disc = b * b - a * (c @ c - SHELL_RADIUS ** 2)
        hit = disc >= 0
        z = (b - np.sqrt(np.maximum(disc, 0.0))) / a
        out.append((hit, np.where(hit, z, 0.0).astype(np.float32)))
    return out


def write_tnt_scene(root, n_gauss, width, height, n_views, seed=0):
    """``write_train_scene``'s layout with the TNT recipe's priors: f16
    normals under ``normals/``, f32 depth (the shell's z-depth) under
    ``depths/`` and mask PNGs written as RGB under ``masks/``, the label
    (1 on the shell's silhouette, 0 elsewhere) in the blue channel and
    other values in red and green, as OpenCV reads channel 0 of BGR.
    Returns (scene directory, the labels per view)."""
    from PIL import Image

    scene = write_train_scene(root, n_gauss, width, height, n_views, seed,
                              normal_folder="normals")
    os.makedirs(os.path.join(scene, "masks"))
    os.makedirs(os.path.join(scene, "depths"))
    labels = []
    for i, (hit, z) in enumerate(shell_views(width, height, n_views)):
        rgb = np.empty((height, width, 3), np.uint8)
        rgb[..., 0], rgb[..., 1], rgb[..., 2] = 7, 3, hit
        Image.fromarray(rgb, "RGB").save(os.path.join(
            scene, "masks", f"view_{i:03d}.png"))
        np.savez(os.path.join(scene, "depths", f"view_{i:03d}.npz"), z)
        labels.append(hit.astype(np.int32))
    return scene, labels


def tnt_args(scene, device, iters, capacity, eval_cams) -> list[str]:
    """The train CLI's arguments of phase train_tnt's run: the TNT recipe
    (200 random box cameras a densify, the appearance network, the
    semantic head) with its schedule compressed: densify after 20, 30 and
    40, opacity resets at 20 and 40, a checkpoint at 20, test and save at
    the last iteration, the test sweeps capped at ``eval_cams`` views."""
    return ["--config", os.path.join(REPO, "configs", "tnt", "base.yaml"),
            "--device", str(device), f"--model.source_path={scene}",
            f"--optim.iterations={iters}", "--optim.densify_from_iter=10",
            "--optim.densification_interval=10",
            "--optim.opacity_reset_interval=20",
            f"--train.test_iterations=[{iters}]",
            f"--train.save_iterations=[{iters}]",
            "--train.checkpoint_iterations=[20]",
            f"--tpu.capacity={capacity}", f"--tpu.eval_max_cams={eval_cams}"]


def numpy_tree(x) -> bool:
    """Whether ``x`` holds only dicts, tuples and numpy arrays."""
    if isinstance(x, dict):
        return all(isinstance(k, str) and numpy_tree(v) for k, v in x.items())
    if isinstance(x, tuple):
        return all(numpy_tree(v) for v in x)
    return isinstance(x, np.ndarray)


def trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(trees_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(trees_equal, a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def phase_train_tnt(device, n_gauss=1_000_000, width=TNT_WIDTH,
                    height=TNT_HEIGHT, n_views=8, iters=40, resume_iters=4,
                    capacity=1 << 21, eval_cams=2, timed_steps=10,
                    profiled_steps=3, timing_iters=20,
                    n_check_tiles=64) -> dict:
    """Phase 8: the TNT recipe at full width through the train CLI (random
    box cameras, the appearance network, the semantic head, the priors),
    the resume, the kernels on this path against their plain versions, one
    step with the remaining losses, and the path's times."""
    import dataclasses
    import pickle

    import torch

    from vcr_gaus_tpu_torch.data import scene as SC
    from vcr_gaus_tpu_torch.models import appearance as APP
    from vcr_gaus_tpu_torch.models import ply_io
    from vcr_gaus_tpu_torch.ops import binning as B
    from vcr_gaus_tpu_torch.ops import rasterize as R
    from vcr_gaus_tpu_torch.train import side_nets as SN
    from vcr_gaus_tpu_torch.train import trainer as T
    from vcr_gaus_tpu_torch.train.__main__ import main as train_main

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        t0 = time.perf_counter()
        scene, labels = write_tnt_scene(root, n_gauss, width, height,
                                        n_views)
        setup_s = time.perf_counter() - t0
        logdir = os.path.join(root, "run")
        args = tnt_args(scene, device, iters, capacity, eval_cams)

        # each densify's box mask (visible, inside, large) and the side
        # networks right after a restore
        masks, restored = [], []
        box_mask, restore = (T.Trainer._box_densify_mask,
                             T.Trainer.restore_checkpoint)

        def mask_spy(self):
            m = box_mask(self)
            masks.append(int(m.sum()))
            return m

        def restore_spy(self, path):
            restore(self, path)
            restored.append(self.nets.state_dict())

        T.Trainer._box_densify_mask = mask_spy
        T.Trainer.restore_checkpoint = restore_spy
        try:
            R.reset_launch_counts()
            t0 = time.perf_counter()
            trainer = train_main(args + [f"--logdir={logdir}"])
            train_s = time.perf_counter() - t0
            launches = dict(R.LAUNCHES)

            # resume from the checkpoint at 20 through the CLI
            R.reset_launch_counts()
            t0 = time.perf_counter()
            resumed = train_main(args + [
                f"--logdir={os.path.join(root, 'resume')}",
                f"--optim.iterations={20 + resume_iters}",
                f"--train.test_iterations=[{20 + resume_iters}]",
                f"--train.save_iterations=[{20 + resume_iters}]",
                f"--train.start_checkpoint={logdir}/chkpnt20.npz"])
            resume_s = time.perf_counter() - t0
            r_launches = dict(R.LAUNCHES)
        finally:
            T.Trainer._box_densify_mask = box_mask
            T.Trainer.restore_checkpoint = restore
        cfg = trainer.cfg
        n_box = box_views(trainer)
        n_full = len(trainer.scene.train_cameras)
        want = schedule_launches(trainer, 1, iters, n_full)
        want["rasterize_fwd"] += eval_views(trainer)
        if n_box != 198 or launches != want:
            raise AssertionError(f"launches {launches}, expected {want} "
                                 f"({n_box} box views a densify)")
        if trainer.ch_sem != 2 or trainer.nets.app is None:
            raise AssertionError("the TNT recipe runs without its networks")
        for cam, lab in zip(trainer.scene.train_cameras, labels):
            if not np.array_equal(cam.mask, lab):
                raise AssertionError(f"mask of {cam.image_name} not read "
                                     "as written")
        hist = trainer.history
        if len(hist) != iters or not all(
                math.isfinite(v) for h in hist for v in h.values()):
            raise AssertionError(f"training history: {hist}")
        if min(h["semantic"] for h in hist) < 0:
            raise AssertionError("negative semantic loss")
        log = trainer.host_log
        acts = [(r["iter"], r["action"]) for r in log]
        expected = [(20, "densify"), (20, "reset opacity"), (30, "densify"),
                    (40, "densify"), (40, "reset opacity")]
        if acts != expected:
            raise AssertionError(f"host actions {acts}, expected {expected}")
        if len(masks) < 3 or min(masks[:3]) == 0 or any(
                r["n_after"] == r["n_before"] for r in log
                if r["action"] == "densify"):
            raise AssertionError(f"box masks {masks}, host log {log}")
        init = SN.SideNets(cfg, n_full, trainer.ch_sem, trainer.num_cls,
                           torch.Generator().manual_seed(int(cfg.seed)),
                           device).state_dict()
        final = trainer.nets.state_dict()
        for name in ("app_embeddings", "cls_params", "app_params"):
            if trees_equal(init[name], final[name]):
                raise AssertionError(f"{name} did not change over the run")
        out = os.path.join(logdir, "point_cloud", f"iteration_{iters}")
        with open(os.path.join(out, "model.pkl"), "rb") as f:
            side = pickle.load(f)
        if (sorted(side) != ["appearance", "classifier"]
                or not numpy_tree(side)):
            raise AssertionError("model.pkl is not plain dicts of numpy")
        _, _, extra = ply_io.load_checkpoint(
            os.path.join(logdir, "chkpnt20.npz"), device="cpu")
        got_iters = [h["iter"] for h in resumed.history]
        r_want = schedule_launches(resumed, 21, 20 + resume_iters, n_full)
        r_want["rasterize_fwd"] += eval_views(resumed)
        if (len(restored) != 1 or not trees_equal(restored[0], extra["net"])
                or got_iters != list(range(21, 21 + resume_iters))
                or r_launches != r_want):
            raise AssertionError(f"resume: iterations {got_iters}, launches "
                                 f"{r_launches}, expected {r_want}")
        res = trainer.test_history[-1]["train"]
        if not 0.0 <= res["miou"] <= 1.0:
            raise AssertionError(f"mIoU {res}")
        emit(phase="train_tnt", gaussians_init=n_gauss, width=width,
             height=height, views=n_views, iterations=iters,
             box_views_per_densify=n_box, setup_s=setup_s,
             train_main_s=train_s, resume_s=resume_s, launches=launches,
             resume_launches=r_launches, box_mask_sizes=masks[:3],
             host_log=log, capacity=trainer.state.capacity,
             gaussians=trainer.state.num_active, test=trainer.test_history,
             losses_first_last=[hist[0], hist[-1]])
        del resumed

        # the timed step: the trained state, the recipe's weights with
        # every gate open, SH degree 3, the appearance network and S = 2;
        # each step uploads its view's image and priors
        state, nets = trainer.state, trainer.nets
        rcfg = trainer.rcfg
        step = T.make_train_step(cfg, rcfg, trainer.weights, trainer.extent,
                                 trainer.trans, trainer.scale,
                                 trainer.num_cls)
        gates = T.Gates(*(True,) * len(T.Gates._fields))
        views = trainer.scene.train_cameras
        bg = torch.zeros(3, device=device)
        lr = trainer._lr_xyz(iters)

        def one(i, st, w_step=step):
            return w_step(st, views[i % n_views].arrays(device), bg, lr, 3,
                          gates, nets)

        for i in range(2):
            state, _, _ = one(i, state)
        step_ms, step_losses = [], []
        for i in range(timed_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, losses, aux = one(2 + i, state)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            step_losses.append({k: float(v) for k, v in losses.items()})
        if not all(math.isfinite(v) for ls in step_losses for v in ls.values()):
            raise AssertionError(f"non-finite losses: {step_losses}")
        box = [state]

        def profiled(i):
            box[0], _, _ = one(i, box[0])

        profile = profile_render(profiled, list(range(profiled_steps)),
                                 spans=("render.", "train."))
        state = box[0]
        profile["backward_kernel_device_ms"] = sum(
            ms for k, ms in profile["port_kernel_ms"].items()
            if "rasterize_bwd" in k)

        # the remaining losses on one more step, on view 0 with its depth
        # prior (the recipe loads none), the depth cut off as ScanNet++'s
        # recipe has it (at 0.8 of this scene's small camera extent it
        # masks every pixel of the shell): loss and every gradient finite
        view0 = dataclasses.replace(views[0], depth=SC._load_aux(
            os.path.join(scene, "depths"), "view_000.png", "depth",
            (width, height)))
        grads = []
        autograd_grad = torch.autograd.grad

        def grad_spy(*a, **kw):
            g = autograd_grad(*a, **kw)
            grads.extend(x for x in g if x is not None)
            return g

        extra_step = T.make_train_step(
            cfg, rcfg._replace(mask_depth_thr=0.0),
            {**trainer.weights, **EXTRA_LOSSES}, trainer.extent,
            trainer.trans, trainer.scale, trainer.num_cls)
        torch.autograd.grad = grad_spy
        try:
            _, extra_losses, _ = extra_step(state, view0.arrays(device), bg,
                                            lr, 3, gates, nets)
        finally:
            torch.autograd.grad = autograd_grad
        extra_losses = {k: float(v) for k, v in extra_losses.items()}
        if (not set(EXTRA_LOSSES) <= set(extra_losses)
                or not min(extra_losses[k] for k in EXTRA_LOSSES) > 0
                or not all(map(math.isfinite, extra_losses.values()))
                or not grads or not all(bool(torch.isfinite(g).all())
                                        for g in grads)):
            raise AssertionError(f"extra losses {extra_losses}")

        # K1 and K2 <2, true> on one step's inputs
        captured = {}
        wrapped = R.rasterize_forward, R.rasterize_backward

        def spy(name, fn):
            def call(*a):
                res = fn(*a)
                captured[name] = (a, {}, res)
                return res
            return call

        R.rasterize_forward = spy("fwd", wrapped[0])
        R.rasterize_backward = spy("bwd", wrapped[1])
        try:
            state, _, _ = one(3, state)
        finally:
            R.rasterize_forward, R.rasterize_backward = wrapped
        fwd_call = tuple(tuple(x.detach() if isinstance(x, torch.Tensor)
                               else x for x in part) if isinstance(part, tuple)
                         else part for part in captured["fwd"])
        args_b = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                       for a in captured["bwd"][0])
        feats, binn, cam, img, g_img, batches, w, h, ch_sem, mode = args_b
        if ch_sem != 2 or (w, h) != (width, height):
            raise AssertionError(f"step view {w}x{h}, S = {ch_sem}")
        fwd_err = fwd_tile_check(fwd_call, n_check_tiles)
        groups = assert_grads_close(
            R.rasterize_backward(*args_b),
            R.composite_tiles_backward_torch(
                feats, binn.sorted_gid, binn.tile_starts, binn.tile_counts,
                batches, cam, img, g_img, ch_sem, mode), ch_sem, BWD["rtol"])
        fwd_ms = cuda_ms(lambda: R.rasterize_forward(*fwd_call[0]),
                         iters=timing_iters)
        bwd_ms = cuda_ms(lambda: R.rasterize_backward(*args_b),
                         iters=timing_iters)
        n_tx, _ = B.tile_grid(w, h)
        composited, rows = composited_census(binn, batches)
        pairs, power_pass, live, _ = pair_census(feats, binn, batches, n_tx)
        f_ops, f_flop, f_byte = fwd_bound(feats, binn, composited, rows,
                                          pairs, power_pass, live, w, h,
                                          ch_sem, mode)
        b_ops, b_flop, b_byte = bwd_bound(feats, binn, composited, rows,
                                          pairs, power_pass, live, w, h,
                                          ch_sem, mode)

        # the appearance network on the step's view: forward, and forward
        # with the backward to the embeddings and weights
        img3 = img[:3].contiguous()
        idx = torch.tensor(0, device=device)
        leaves = nets.app_opt.params

        def app_fwd():
            with torch.no_grad():
                APP.appearance_transform(nets.app, nets.emb, img3, idx)

        def app_fwd_bwd():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                out_t, _ = APP.appearance_transform(nets.app, nets.emb,
                                                    img3, idx)
                torch.autograd.grad(out_t.sum(), leaves)

        app_fwd_ms = cuda_ms(app_fwd, iters=timing_iters)
        app_fwd_bwd_ms = cuda_ms(app_fwd_bwd, iters=timing_iters)

        # K3 on the first view of a densify's box sweep
        trainer.state = state
        sc = cfg.optim.densify_large.sample_cams
        size = int(getattr(cfg.tpu, "visi_resolution", 512))
        box_cam = T.sample_box_cameras(
            int(sc.num), trainer.trans, trainer.scale, up=bool(sc.up),
            around=bool(sc.around), sample_mode="random", size=size,
            seed=trainer.iteration, device=device)[0]
        k3 = stats_kernel_numbers(*stats_inputs(
            state, box_cam, rcfg._replace(width=size, height=size, ch_sem=0)),
            timing_iters)

        # the mIoU sweep over every train view; one densify's host time and
        # its box sweep's (the stats of 198 views)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep = trainer.evaluate()
        torch.cuda.synchronize()
        miou_ms = 1e3 * (time.perf_counter() - t0) / n_views
        for _ in range(2):
            trainer.train_step()
        with StageTimer(device, [(trainer, "get_visi_mask_acc")]) as timer:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.densify(20)
            torch.cuda.synchronize()
            densify_ms = 1e3 * (time.perf_counter() - t0)
        sweep_ms = 1e3 * timer.seconds["get_visi_mask_acc"][0]

    emit(phase="train_tnt_step", gaussians=state.num_active, width=width,
         height=height, ch_sem=ch_sem, weights=trainer.weights,
         step_ms=statistics.median(step_ms), step_ms_all=step_ms,
         step_losses=step_losses, extra_step_losses=extra_losses,
         entries=aux["num_entries"], composited_entries=composited,
         pairs=pairs, pairs_past_power_test=power_pass, live_pairs=live,
         fwd_kernel_ms=fwd_ms, fwd_bound_ops=f_ops,
         fwd_bound_ms=1e3 * max(f_flop, f_byte),
         bwd_kernel_ms=bwd_ms, bwd_bound_ops=b_ops,
         bwd_bound_ms=1e3 * max(b_flop, b_byte),
         fwd_tile_check_max_abs_err=fwd_err,
         bwd_err_and_max_grad=groups,
         appearance_fwd_ms=app_fwd_ms, appearance_fwd_bwd_ms=app_fwd_bwd_ms,
         box_views=n_box, box_sweep_ms_per_view=sweep_ms / n_box,
         box_view_stats=k3, densify_host_ms=densify_ms,
         miou_sweep_ms_per_view=miou_ms, miou_sweep=sweep, library_ms=None)
    emit(phase="train_tnt_profile", **profile)
    return dict(launches=launches,
                max_abs_err=max(fwd_err, worst_error(groups),
                                k3["imp_max_abs_err"]))


# phase eval_tnt: run_tnt.py's stages after training, on a run of the
# TNT cell's width (1600x900) meshed at the mesh cell's voxel
TNT_VIEWS = 60
TNT_CAM_DIST = 5.0           # the shell fits the frame (fovy 0.7 rad)
# between the ladder's rungs: MESH_VOXEL / 2 gives a 1001^3 grid (exit 3),
# MESH_VOXEL a 501^3 one
TNT_MAX_VOXELS = 200_000_000
TNT_SCENE = "Shell"
# the GT frame: the run's under a known similarity, 3 estimated cameras
# gross outliers (failed registrations) for the RANSAC to reject
GT_SCALE, GT_ANGLE, GT_SHIFT = 1.3, 0.5, np.array([2.0, -1.0, 0.5])
GT_AXIS = np.array([1.0, 1.0, 1.0]) / math.sqrt(3.0)
N_BAD_CAMERAS = 3


def shell_poses(n_views, dist):
    """World-to-camera (R, T) of ``n_views`` cameras on a Fibonacci sphere
    of radius ``dist`` around the shell, each looking at its centre, in
    COLMAP's axes (as ``dtu_poses``)."""
    i = np.arange(n_views) + 0.5
    y = 1 - 2 * i / n_views
    r = np.sqrt(1 - y * y)
    phi = math.pi * (3 - math.sqrt(5)) * i
    poses = []
    for d in np.stack([r * np.cos(phi), y, r * np.sin(phi)], 1):
        fwd = -d
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        poses.append((R, -R @ (MESH_CENTER + dist * d)))
    return poses


def gt_similarity() -> np.ndarray:
    """The 4x4 similarity from the run's frame to the GT's."""
    from scipy.spatial.transform import Rotation

    S = np.eye(4)
    S[:3, :3] = GT_SCALE * Rotation.from_rotvec(GT_AXIS * GT_ANGLE
                                                ).as_matrix()
    S[:3, 3] = GT_SHIFT
    return S


def write_log(path, mats) -> None:
    """A TNT .log trajectory: per camera 'i i 0' and its 4x4 c2w."""
    with open(path, "w") as f:
        for i, m in enumerate(mats):
            f.write(f"{i} {i} 0\n")
            for row in m:
                f.write(" ".join(repr(float(v)) for v in row) + "\n")


def write_tnt_gt(root, poses, n_gt, seed=2):
    """The TNT evaluation's inputs for the run: a GT stand-in of ``n_gt``
    points on the shell in the run's frame (the lightweight scorer's), and
    for the official protocol, in the GT frame (``gt_similarity``): the
    same cloud, the run's camera trajectory with its first N_BAD_CAMERAS
    centres moved 40 units off, the GT trajectory, the scene's
    pre-alignment (``<scene>_trans.txt``, the similarity's shift) and a
    crop json bounding the shell. Returns (run-frame GT path, official
    inputs as evaluate_tnt_scene's keyword arguments)."""
    from vcr_gaus_tpu_torch.utils.ply import write_points_ply

    rng = np.random.default_rng(seed)
    gt_dir = os.path.join(root, "gt", TNT_SCENE)
    os.makedirs(gt_dir)
    pts, _ = sphere_shell(rng, n_gt)
    run_gt = os.path.join(gt_dir, f"{TNT_SCENE}.ply")
    write_points_ply(run_gt, pts)
    S = gt_similarity()
    official = os.path.join(root, "official")
    os.makedirs(official)
    gt_ply = os.path.join(official, f"{TNT_SCENE}.ply")
    write_points_ply(gt_ply, pts @ S[:3, :3].T + S[:3, 3])
    est, gt = [], []
    for i, (R, T) in enumerate(poses):
        c2w = np.eye(4)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ T
        gt.append(S @ c2w)
        if i < N_BAD_CAMERAS:
            c2w[:3, 3] += rng.normal(size=3) * 40.0
        est.append(c2w)
    write_log(os.path.join(official, "est.log"), est)
    write_log(os.path.join(official, "gt.log"), gt)
    trans = np.eye(4)
    trans[:3, 3] = GT_SHIFT
    np.savetxt(os.path.join(official, f"{TNT_SCENE}_trans.txt"), trans)
    c = S[:3, :3] @ MESH_CENTER + S[:3, 3]
    r = 1.05 * GT_SCALE * MESH_RADIUS
    ang = np.arange(8) * math.pi / 4
    poly = np.stack([c[0] + r / math.cos(math.pi / 8) * np.cos(ang),
                     c[1] + r / math.cos(math.pi / 8) * np.sin(ang),
                     np.zeros(8)], 1)
    with open(os.path.join(official, f"{TNT_SCENE}.json"), "w") as f:
        json.dump({"class_name": "SelectionPolygonVolume",
                   "orthogonal_axis": "Z", "axis_min": c[2] - r,
                   "axis_max": c[2] + r,
                   "bounding_polygon": poly.tolist()}, f)
    return run_gt, dict(
        gt_ply=gt_ply, traj_est_log=os.path.join(official, "est.log"),
        traj_gt_log=os.path.join(official, "gt.log"),
        trans_txt=os.path.join(official, f"{TNT_SCENE}_trans.txt"),
        crop_json=os.path.join(official, f"{TNT_SCENE}.json"))


def icp_ckdtree(src, dst, iters=20, max_corr=None):
    """The host reference of the card's ICP: the JAX package's icp_refine,
    a loop of scipy cKDTree queries and numpy Kabsch updates."""
    from scipy.spatial import cKDTree

    T = np.eye(4)
    cur = src.copy()
    tree = cKDTree(dst)
    for _ in range(iters):
        d, idx = tree.query(cur, k=1, workers=-1)
        if max_corr is not None:
            keep = d < max_corr
            if keep.sum() < 10:
                break
        else:
            keep = np.ones(len(cur), bool)
        a = cur[keep]
        b = dst[idx[keep]]
        ca, cb = a.mean(0), b.mean(0)
        H = (a - ca).T @ (b - cb)
        U, _, Vt = np.linalg.svd(H)
        R = Vt.T @ U.T
        if np.linalg.det(R) < 0:
            Vt[2] *= -1
            R = Vt.T @ U.T
        t = cb - R @ ca
        step = np.eye(4)
        step[:3, :3] = R
        step[:3, 3] = t
        T = step @ T
        cur = cur @ R.T + t
    return T


def phase_eval_tnt(device, n_gauss=1_000_000, width=TNT_WIDTH,
                   height=TNT_HEIGHT, n_views=TNT_VIEWS, voxel=MESH_VOXEL,
                   max_voxels=TNT_MAX_VOXELS, n_gt=5_000_000,
                   n_frames=120, n_check=200_000, n_check_tiles=64,
                   timing_iters=20) -> dict:
    """Phase 9: score a TNT-shaped run through run_tnt.py's stages after
    training (the voxel ladder, crop_mesh, eval_geometry tnt --icp), the
    official protocol, and a fly-through of it through the forward
    kernel."""
    import torch
    from scipy.spatial import cKDTree

    from vcr_gaus_tpu_torch import depth2mesh, eval_geometry
    from vcr_gaus_tpu_torch.config import Config
    from vcr_gaus_tpu_torch.data.scene import load_scene_info
    from vcr_gaus_tpu_torch.evaluation import geometry as GE
    from vcr_gaus_tpu_torch.evaluation import tnt_official as TO
    from vcr_gaus_tpu_torch.meshing import extract as X
    from vcr_gaus_tpu_torch.meshing import marching as MC
    from vcr_gaus_tpu_torch.meshing import tsdf as TS
    from vcr_gaus_tpu_torch.models import ply_io
    from vcr_gaus_tpu_torch.ops import binning as B
    from vcr_gaus_tpu_torch.ops import rasterize as R
    from vcr_gaus_tpu_torch.render.renderer import RenderConfig
    from vcr_gaus_tpu_torch.tools import crop_mesh, run_tnt
    from vcr_gaus_tpu_torch.utils import render_paths as RP

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def offset(path):
        """The mesh's median distance from the shell (+ outside)."""
        verts, _ = X.load_mesh_ply(path)
        return float(np.median(np.linalg.norm(verts - MESH_CENTER, axis=1))
                     - MESH_RADIUS), len(verts)

    phase_t0 = time.perf_counter()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        t0 = time.perf_counter()
        poses = shell_poses(n_views, TNT_CAM_DIST)
        cfg_path = write_mesh_scene(root, n_gauss, width, height, poses,
                                    parent=os.path.join("tnt", "base.yaml"),
                                    ch_sem=2)
        run_gt, official = write_tnt_gt(root, poses, n_gt)
        logdir = os.path.dirname(cfg_path)
        setup_s = time.perf_counter() - t0
        tau = 2 * voxel

        # the ladder: the first rung's grid exceeds --max_voxels (exit 3),
        # the second meshes; traditional depth, since the TSDF reads the
        # recipe's intersection depth (a ray distance) as z-depth
        mesh_stages = [(X, "_view_depth"), (TS, "integrate"),
                       (MC, "marching_tets"),
                       (MC, "keep_largest_components")]
        R.reset_launch_counts()
        rungs, mesh_s = [], 0.0
        with StageTimer(device, mesh_stages) as mesh_timer:
            for vs in (voxel / 2, voxel):
                t0 = time.perf_counter()
                try:
                    mesh_path = depth2mesh.main(run_tnt.mesh_argv(
                        logdir, vs, max_voxels, str(device))
                        + ["--model.depth_type=traditional"])
                    rungs.append(0)
                except SystemExit as e:
                    rungs.append(e.code)
                sync()
                mesh_s = time.perf_counter() - t0
        if rungs != [3, 0]:
            raise AssertionError(f"ladder exits {rungs}, expected [3, 0]")
        mesh_launches = dict(R.LAUNCHES)
        n_fused = len(range(0, n_views, 3))
        if mesh_launches != {"rasterize_fwd": n_fused}:
            raise AssertionError(f"mesh path launched {mesh_launches}, "
                                 f"expected one per fused view")
        mesh_offset, mesh_verts = offset(mesh_path)

        t0 = time.perf_counter()
        crop_path = crop_mesh.main(["--ply_path", mesh_path, "--gt_path",
                                    run_gt, "--device", str(device)])
        sync()
        crop_s = time.perf_counter() - t0
        crop_verts = len(X.load_mesh_ply(crop_path)[0])

        stages = [(GE, "obb_keep"), (GE, "voxel_downsample"),
                  (GE, "icp_refine"), (GE, "nn_distances")]
        with StageTimer(device, stages,
                        keep_args=("icp_refine",)) as f1_timer:
            t0 = time.perf_counter()
            f1 = eval_geometry.main(run_tnt.eval_argv(
                logdir, run_gt, tau, str(device)))
            sync()
            tnt_f1_s = time.perf_counter() - t0
        with open(os.path.join(logdir, "metrics.txt")) as f:
            written = {k: float(v) for k, v in (ln.split(": ") for ln in f)}
        if written != f1:
            raise AssertionError(f"metrics.txt {written} != {f1}")

        recovered = []
        ransac = TO.ransac_umeyama

        def ransac_spy(*a, **kw):
            recovered.append(ransac(*a, **kw))
            return recovered[-1]

        TO.ransac_umeyama = ransac_spy
        try:
            with StageTimer(device, stages[1:] + [
                    (TO, "crop_polygon_volume")]) as off_timer:
                t0 = time.perf_counter()
                off = TO.evaluate_tnt_scene(mesh_path, tau=GT_SCALE * tau,
                                            device=device, **official)
                sync()
                official_s = time.perf_counter() - t0
        finally:
            TO.ransac_umeyama = ransac
        T_total = recovered[0] @ np.loadtxt(official["trans_txt"])
        sim_err = float(np.abs(T_total - gt_similarity()).max())
        if not (f1["F-score"] >= 0.9 and off["f1"] >= 0.9
                and sim_err < 1e-3):
            raise AssertionError(f"F1 {f1}, official {off}, similarity "
                                 f"off by {sim_err}")

        # the recipe's own intersection depth at the second rung: reported,
        # not asserted (ROADMAP: the TSDF reads it as z-depth)
        with StageTimer(device, mesh_stages) as inter_timer:
            t0 = time.perf_counter()
            inter_path = depth2mesh.main(run_tnt.mesh_argv(
                logdir, voxel, max_voxels, str(device))
                + ["--mesh_name=ours_intersection"])
            sync()
            inter_s = time.perf_counter() - t0
        inter_offset, inter_verts = offset(inter_path)
        iv, ifc = X.load_mesh_ply(inter_path)
        inter_f1 = GE.tnt_f1(iv, ifc, X.load_mesh_ply(run_gt)[0],
                             threshold=tau, run_icp=True, device=device)
        inter_launches = R.LAUNCHES["rasterize_fwd"] - n_fused

        # the fly-through over the run's cameras, one forward launch a frame
        cfg = Config(cfg_path)
        info = load_scene_info(cfg.model.source_path,
                               images_dir=cfg.model.images,
                               resolution=cfg.model.resolution,
                               data_device="lazy")
        state = ply_io.load_gaussian_ply(
            os.path.join(logdir, "point_cloud", "iteration_30000",
                         "point_cloud.ply"),
            max_sh_degree=cfg.model.sh_degree, device=device)
        rcfg = RenderConfig(width=width, height=height,
                            depth_mode=cfg.model.depth_type)
        calls = []
        wrapped = R.rasterize_forward

        def spy(*args, **kw):
            out = wrapped(*args, **kw)
            if not calls:
                calls.append((args, kw, out))
            return out

        R.rasterize_forward = spy
        before = R.LAUNCHES["rasterize_fwd"]
        try:
            with StageTimer(device, [(RP, "write_video")]) as fly_timer:
                t0 = time.perf_counter()
                video = RP.render_flythrough(
                    state, info.train_cameras, rcfg,
                    os.path.join(root, "flythrough.mp4"), n_frames=n_frames,
                    sh_degree=cfg.model.sh_degree,
                    scene_extent=info.radius)
                sync()
                fly_s = time.perf_counter() - t0
        finally:
            R.rasterize_forward = wrapped
        fly_launches = R.LAUNCHES["rasterize_fwd"] - before
        launches = dict(R.LAUNCHES)
        if fly_launches != n_frames or inter_launches != n_fused:
            raise AssertionError(f"fly-through launched {fly_launches}, "
                                 f"intersection mesh {inter_launches}")
        write_s = fly_timer.seconds["write_video"][0]

        # the card against the host on subsamples of the mesh and the GT:
        # the nearest neighbours against cKDTree, the voxel downsample
        # against the port's CPU result, ICP against a cKDTree loop
        rng = np.random.default_rng(0)
        mesh_v = X.load_mesh_ply(crop_path)[0]
        gt_v = X.load_mesh_ply(run_gt)[0]
        q = mesh_v[rng.choice(len(mesh_v), min(n_check, len(mesh_v)),
                              replace=False)]
        t = gt_v[rng.choice(len(gt_v), min(n_check, len(gt_v)),
                            replace=False)]
        dist, idx = GE.nearest_neighbours(q, t, device=device)
        want_d, want_i = cKDTree(t).query(q, k=2, workers=-1)
        np.testing.assert_allclose(dist, want_d[:, 0], rtol=1e-12, atol=0)
        unique = want_d[:, 1] > want_d[:, 0]
        np.testing.assert_array_equal(idx[unique], want_i[unique, 0])
        down = GE.voxel_downsample(t, tau / 2, device)
        down_cpu = GE.voxel_downsample(t, tau / 2, "cpu")
        if down.shape != down_cpu.shape:
            raise AssertionError(f"voxels {down.shape} on the card, "
                                 f"{down_cpu.shape} on the CPU")
        np.testing.assert_allclose(down, down_cpu, rtol=1e-12, atol=0)
        (src, dst), icp_kw = f1_timer.args["icp_refine"][0]
        icp_card = GE.icp_refine(src, dst, device=device, **{
            k: v for k, v in icp_kw.items() if k != "device"})
        icp_host = icp_ckdtree(src, dst, max_corr=icp_kw["max_corr"])
        np.testing.assert_allclose(icp_card, icp_host, rtol=0, atol=1e-9)

        # the forward kernel on the fly-through's first frame
        (feats, binn, cam, w, h, ch_sem, mode), _, (img, batches) = calls[0]

        def kernel():
            R.rasterize_forward(feats, binn, cam, w, h, ch_sem, mode)

        kernel_ms = cuda_ms(kernel, iters=timing_iters)
        err = fwd_tile_check(calls[0], n_check_tiles)
        composited, rows = composited_census(binn, batches)
        pairs, power_pass, live, _ = pair_census(
            feats, binn, batches, B.tile_grid(w, h)[0])
        _, flop_s, byte_s = fwd_bound(feats, binn, composited, rows, pairs,
                                      power_pass, live, w, h, ch_sem, mode)

    def stage_s(timer):
        return {k: sum(v) for k, v in timer.seconds.items()}

    emit(phase="eval_tnt", phase_s=time.perf_counter() - phase_t0,
         gaussians=n_gauss, width=width, height=height,
         views=n_views, fused_views=n_fused, voxel=voxel, tau=tau,
         gt_points=n_gt, setup_s=setup_s, ladder_exits=rungs,
         max_voxels=max_voxels, depth2mesh_s=mesh_s,
         depth2mesh_stages_s=stage_s(mesh_timer),
         mesh_verts=mesh_verts, mesh_median_offset=mesh_offset,
         crop_s=crop_s, crop_verts=crop_verts, tnt_f1_s=tnt_f1_s,
         tnt_f1_stages_s=stage_s(f1_timer), tnt_f1=f1,
         official_s=official_s, official_stages_s=stage_s(off_timer),
         official=off, similarity_max_err=sim_err,
         intersection_depth2mesh_s=inter_s,
         intersection_stages_s=stage_s(inter_timer),
         intersection_mesh_verts=inter_verts,
         intersection_median_offset=inter_offset,
         intersection_tnt_f1=inter_f1,
         flythrough_frames=n_frames,
         flythrough_ms_per_frame=1e3 * (fly_s - write_s) / n_frames,
         flythrough_write_s=write_s, video=os.path.relpath(video, root),
         kernel_ms=kernel_ms, bound_ms=1e3 * max(flop_s, byte_s),
         bound_by="operations" if flop_s >= byte_s else "bytes",
         entries=int(binn.sorted_gid.numel()), pairs=pairs,
         live_pairs=live, tile_check_max_abs_err=err,
         nn_check=[len(q), len(t)], nn_unique_share=float(unique.mean()),
         downsample_check_voxels=len(down),
         icp_check_points=[len(src), len(dst)],
         icp_check_max_abs_err=float(np.abs(icp_card - icp_host).max()),
         launches_mesh=mesh_launches, launches_intersection=inter_launches,
         launches_flythrough=fly_launches, launches=launches)
    return dict(launches=launches.get("rasterize_fwd", 0), max_abs_err=err)


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
    ms = phase_mesh(device)
    tnt = phase_train_tnt(device)
    ev = phase_eval_tnt(device)
    # launches: each kernel's count on the main path of the slice that
    # brought it (the training run for K1 and K2, the host loop's run for
    # K3, the microprobe's entry point for K4), and K1's on the mesh path
    # (``launches_mesh``, one per fused view); the forward kernel's times
    # are those of the render path's view, the stats kernel's those of the
    # host loop's first densify view, the probe's those of `full` at the
    # protocol shape; ``launches_train_tnt`` counts each kernel's launches
    # on the TNT recipe's run (phase train_tnt), ``launches_eval_tnt`` K1's
    # on the TNT scoring path (phase eval_tnt: both meshes' fused views
    # and the fly-through's frames), ``launches_k2`` K1's and K2's on the
    # train CLI's run with a camera batch of 2 (phase train_k2)
    tnt_launches = tnt["launches"]
    emit(kernels=[{
        "name": "rasterize_fwd", "route": "cuda",
        "source": "vcr_gaus_tpu_torch/csrc/rasterize_fwd.cu",
        "replaces": "vcr_gaus_tpu/ops/rasterize_tpu.py:532",
        "launches": tr["launches"]["rasterize_fwd"],
        "launches_k2": tr["launches_k2"]["rasterize_fwd"],
        "launches_mesh": ms["launches"],
        "launches_train_tnt": tnt_launches["rasterize_fwd"],
        "launches_eval_tnt": ev["launches"],
        "max_abs_err": max(worst, sl["max_abs_err"], ms["max_abs_err"],
                           tnt["max_abs_err"], ev["max_abs_err"]),
        "ms": sl["kernel_ms"], "plain_ms": sl["plain_ms"],
        "bound_ms": sl["bound_ms"], "bound_by": sl["bound_by"],
        "library_ms": None}, {
        "name": "rasterize_bwd", "route": "cuda",
        "source": "vcr_gaus_tpu_torch/csrc/rasterize_bwd.cu",
        "replaces": "vcr_gaus_tpu/ops/rasterize_tpu.py:800",
        "launches": tr["launches"]["rasterize_bwd"],
        "launches_k2": tr["launches_k2"]["rasterize_bwd"],
        "launches_train_tnt": tnt_launches["rasterize_bwd"],
        "max_abs_err": max(worst_bwd, tr["max_abs_err"], tnt["max_abs_err"]),
        "ms": tr["kernel_ms"], "plain_ms": tr["plain_ms"],
        "bound_ms": tr["bound_ms"], "bound_by": tr["bound_by"],
        "library_ms": None}, {
        "name": "rasterize_stats", "route": "cuda",
        "source": "vcr_gaus_tpu_torch/csrc/rasterize_stats.cu",
        "replaces": "vcr_gaus_tpu/ops/rasterize_tpu.py:923",
        "launches": hl["launches"]["rasterize_stats"],
        "launches_train_tnt": tnt_launches["rasterize_stats"],
        "max_abs_err": max(worst_stats, hl["max_abs_err"],
                           tnt["max_abs_err"]),
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
