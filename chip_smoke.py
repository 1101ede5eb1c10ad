#!/usr/bin/env python3
"""Drive the PyTorch port (vcr_gaus_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. build   every CUDA kernel of the render path from csrc/ (nvcc, sm_90a),
             and print the card's name and power limit;
  2. kernel  each kernel's wrapper against its plain PyTorch version on the
             card at small shapes (both depth modes, 0 and 3 semantic
             channels, a ragged 40x24 image, an all-culled scene, a
             saturated scene where the early stop fires), atol 2e-4 and
             rtol 1e-3 on every channel;
  3. slice   the render path at full width: a synthetic COLMAP scene of 8
             1600x1200 views and a 1M-Gaussian SH-degree-3 PLY, rendered and
             scored by vcr_gaus_tpu_torch.render_eval.main; the launch counts
             of that run, kernel and render times, the kernel held against
             its plain version on 64 random tiles of one full-width view;
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


def phase_kernel(device) -> float:
    """Phase 2; returns the largest error seen."""
    cases = [("traditional", 0, 40, 24, splat_scene(seed=0)),
             ("intersection", 0, 40, 24, splat_scene(seed=1)),
             ("traditional", 3, 40, 24, splat_scene(seed=2, ch_sem=3)),
             ("intersection", 3, 40, 24, splat_scene(seed=3, ch_sem=3)),
             ("intersection", 3, 200, 150,
              splat_scene(n=3000, seed=4, ch_sem=3, width=200, height=150))]
    worst = 0.0
    for mode, ch_sem, w, h, (feats, radius, cam) in cases:
        err, _, _ = compare_kernel(feats, radius, cam, w, h, ch_sem, mode,
                                   device)
        worst = max(worst, *err.values())
        emit(phase="kernel", case=f"{mode}_sem{ch_sem}_{w}x{h}",
             max_abs_err=err)
    feats, radius, cam = splat_scene(seed=5)
    err, _, _ = compare_kernel(feats, radius * 0, cam, 40, 24, 0,
                               "traditional", device)
    worst = max(worst, *err.values())
    emit(phase="kernel", case="all_culled_40x24", max_abs_err=err)
    feats, radius, cam = saturated_scene()
    err, batches, held = compare_kernel(feats, radius, cam, 40, 24, 0,
                                        "traditional", device)
    if not bool((batches < held).any()):
        raise AssertionError("the early stop did not fire")
    worst = max(worst, *err.values())
    emit(phase="kernel", case="saturated_40x24", max_abs_err=err,
         batches_done=batches.tolist(), batches_held=held.tolist())
    return worst


def write_scene(root, n_gauss, width, height, n_views, seed=0):
    """A COLMAP scene of ``n_views`` ring cameras (bench.py's poses: identity
    rotation, centers on a 0.3 ring) looking at a sphere shell of radius
    1.5 at z = 4, and a config + PLY of ``n_gauss`` SH-degree-3 gaussians on
    that shell, each of isotropic scale 4x the mean point spacing."""
    import yaml
    from PIL import Image

    from vcr_gaus_tpu_torch.models.convert import state_from_numpy
    from vcr_gaus_tpu_torch.models.ply_io import save_gaussian_ply
    from vcr_gaus_tpu_torch.utils import colmap as CM
    from vcr_gaus_tpu_torch.utils import graphics as G

    rng = np.random.default_rng(seed)
    scene = os.path.join(root, "scene")
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
        img = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(scene, "images", name))
        images[i + 1] = CM.ColmapImage(
            i + 1, np.array([1.0, 0.0, 0.0, 0.0]),
            np.array([0.3 * np.cos(ang), 0.3 * np.sin(ang), 0.0]), 1, name)
    CM.write_images_binary(images, os.path.join(scene, "sparse", "0",
                                                "images.bin"))

    theta = rng.uniform(0, 2 * np.pi, n_gauss)
    z = rng.uniform(-1, 1, n_gauss)
    r = np.sqrt(1 - z ** 2)
    pts = (np.stack([r * np.cos(theta), r * np.sin(theta), z], 1) * 1.5
           + np.array([0, 0, 4.0])).astype(np.float32)
    cols = rng.uniform(0, 1, (n_gauss, 3)).astype(np.float32)
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


def profile_render(render_view, cams, top=10) -> dict:
    """torch.profiler over one render of each camera: device ms per view of
    each render stage (the record_function spans of the render path) and of
    the largest kernels, and the device's busy share of the window's wall
    time (profiling overhead included, so the idle share it implies is an
    upper bound)."""
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
    events = prof.key_averages()
    n = len(cams)
    stages = {e.key: e.device_time_total / 1e3 / n for e in events
              if e.key.startswith("render.")}
    # the spans also appear as device-side ranges: keep kernels only
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / n)
                      for e in events if e.device_type == DeviceType.CUDA
                      and e.key not in stages),
                     key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in kernels)
    return dict(views=n, wall_ms_per_view=wall_ms / n,
                device_ms_per_view=busy_ms,
                device_busy_share=busy_ms * n / wall_ms,
                stage_device_ms=stages,
                top_kernels=[[k[:80], ms] for k, ms in kernels[:top]])


def pair_census(feats, binn, batches, n_tx) -> list[int]:
    """Counts of the (pixel, entry) pairs the kernel evaluates on one view:
    all of them (every entry of each batch a tile composited, for all of
    the tile's pixels), those past the power test, and the live ones."""
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
            passed = (power <= 0.0) & valid[:, None, :]
            live = passed & (f[:, None, :, PF.F_OPACITY] * torch.exp(power)
                             >= ALPHA_EPS)
            counts += torch.stack([valid.sum() * pix.numel(), passed.sum(),
                                   live.sum()])
    return counts.tolist()


def phase_slice(device, n_gauss=1_000_000, width=1600, height=1200,
                n_views=8, n_check_tiles=64, timing_iters=20) -> dict:
    """Phase 3: the full-width render path through render_eval.main."""
    import torch

    from vcr_gaus_tpu_torch import render_eval
    from vcr_gaus_tpu_torch.data.scene import load_scene_info
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

        R.rasterize_forward = spy
        R.reset_launch_counts()
        t0 = time.perf_counter()
        results = render_eval.main(["--cfg_path", cfg_path,
                                    "--device", str(device)])
        eval_s = time.perf_counter() - t0
        launches = dict(R.LAUNCHES)
        R.rasterize_forward = wrapped

        train = results["train"]
        if len(calls) != n_views or not all(map(math.isfinite,
                                                train.values())):
            raise AssertionError(f"render_eval: {len(calls)} views, {train}")
        rendered = os.listdir(os.path.join(os.path.dirname(cfg_path), "train",
                                           "ours_30000", "renders"))
        if len(rendered) != n_views:
            raise AssertionError(f"{len(rendered)} renders written")
        entries = [c[0][1].num_entries for c in calls]

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

        # the least time for the same work, from this run's data: the pairs
        # of the entries each tile composited before its stop, 256 pixels
        # each, at the operations their outcome needs; bytes: their gids,
        # each gaussian's feature row read once, the tile ranges, and the
        # image written once
        counts = binn.tile_counts.to(torch.int64)
        tile_of = torch.repeat_interleave(torch.arange(counts.numel(),
                                                       device=device), counts)
        pos = (torch.arange(tile_of.numel(), device=device)
               - binn.tile_starts.to(torch.int64)[tile_of])
        used = pos < batches.to(torch.int64)[tile_of] * R.BATCH
        composited = int(used.sum())
        rows = int(torch.unique(binn.sorted_gid[used]).numel())
        pairs, power_pass, live = pair_census(feats, binn, batches, n_tx)
        ops = (OPS_PAIR * pairs + OPS_POWER_PASS * power_pass
               + (OPS_LIVE + OPS_LIVE_SEM * ch_sem
                  + OPS_LIVE_INTERSECT * (mode == "intersection")) * live)
        flop_s = ops / PEAK_FP32
        nbytes = (4 * composited + 4 * feats.shape[1] * rows
                  + 8 * counts.numel() + h * w * 4 * (9 + ch_sem))
        byte_s = nbytes / PEAK_BYTES
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
         psnr=train["PSNR"], ssim=train["SSIM"], entries_per_view=entries,
         launches=launches, kernel_ms=kernel_ms, plain_ms=plain_ms,
         render_ms_per_view=statistics.median(render_ms),
         render_ms_all=render_ms, composited_entries=composited,
         pairs=pairs, pairs_past_power_test=power_pass, live_pairs=live,
         bound_ops=ops,
         bound_ms=bound_ms, bound_flop_ms=1e3 * flop_s,
         bound_byte_ms=1e3 * byte_s, feature_rows_read=rows,
         tile_check_max_abs_err=err, library_ms=None)
    emit(phase="profile", **profile)
    return dict(launches=launches.get("rasterize_fwd", 0),
                kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if flop_s >= byte_s else "bytes",
                max_abs_err=err)


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
         ptxas={k: [ln for ln in v.splitlines() if "Used" in ln or "spill" in ln]
                for k, v in reports.items()})

    worst = phase_kernel(device)
    sl = phase_slice(device)
    if sl["launches"] != 8:
        raise AssertionError(f"rasterize_fwd launched {sl['launches']} times "
                             "on the main path, expected one per view")
    emit(kernels=[{
        "name": "rasterize_fwd", "route": "cuda",
        "source": "vcr_gaus_tpu_torch/csrc/rasterize_fwd.cu",
        "replaces": "vcr_gaus_tpu/ops/rasterize_tpu.py:532",
        "launches": sl["launches"],
        "max_abs_err": max(worst, sl["max_abs_err"]),
        "ms": sl["kernel_ms"], "plain_ms": sl["plain_ms"],
        "bound_ms": sl["bound_ms"], "bound_by": sl["bound_by"],
        "library_ms": None}])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
