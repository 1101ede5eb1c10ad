"""Entry census of a Gaussian population: per-camera entry counts (peak and
mean), entries per pixel, per-tile occupancy percentiles and projected
screen-radius percentiles, the statistics that set the cost of every
per-entry stage (the binning's sort, K1-K3's walks). The port's counterpart
of scripts/entry_stats.py (same flags, the same JSON keys), through the
port's projection and binning on the device:

  # a trained run's population over its training views:
  python -m vcr_gaus_tpu_torch.tools.entry_stats --cfg_path <run>/config.yaml
  # the bench's synthetic population (bench.py's dtu_full generator):
  python -m vcr_gaus_tpu_torch.tools.entry_stats --synthetic --n 1000000 \
      --cap 1048576 --w 1600 --h 1200 --scale_mult 4.0 [--device cuda|cpu]

The port bins at one tile size, ``ops.binning.TILE`` (16 pixels): ``--tile``
is accepted at that size and refused at any other. It sizes the entry list
per frame, so no entry budget applies: ``--budget`` is read and reported
as not applicable. No kernel runs; the census is the binning's arithmetic.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch


def pcts(x, qs=(50, 90, 99, 100)):
    x = np.asarray(x)
    if x.size == 0:
        return {}
    return {f"p{q}": round(float(np.percentile(x, q)), 2) for q in qs}


@torch.no_grad()
def camera_census(state, cam, width: int, height: int):
    """One view's (entry count, per-tile entry counts (T,), per-Gaussian
    pixel radius (0 where culled or inactive), visible count)."""
    from ..ops import binning as B
    from ..ops import projection as PF
    pre = PF.preprocess(state.params, state.active, PF.camera_vector(cam),
                        PF.Variant(width, height, None, 0, False))
    radius = pre.radius
    binn = B.bin_gaussians(pre.mean2d, radius, pre.depth_z, width, height,
                           extents=pre.ext)
    return (binn.num_entries, binn.tile_counts.cpu().numpy(),
            radius.cpu().numpy(), int((radius > 0).sum()))


def population_stats(state, cams, width: int, height: int) -> dict:
    from ..ops import binning as B
    entries, tile_p, radii_p, visible = [], [], [], []
    for cam in cams:
        ne, tc, rad, vis = camera_census(state, cam, width, height)
        entries.append(ne)
        tile_p.append(tc)
        radii_p.append(rad)
        visible.append(vis)
    tc = np.concatenate(tile_p)
    rad = np.concatenate(radii_p)
    rad = rad[rad > 0]
    n_tx, n_ty = B.tile_grid(width, height)
    return {
        "n_cams": len(cams),
        "active": int(state.active.sum()),
        "visible_per_cam_mean": int(np.mean(visible)),
        "entries_peak": max(entries),
        "entries_mean": int(np.mean(entries)),
        "entries_per_pixel_peak": round(max(entries) / (width * height), 2),
        "entries_per_pixel_mean": round(
            float(np.mean(entries)) / (width * height), 2),
        "tile_grid": [n_tx, n_ty],
        "tile_occupancy": pcts(tc),
        "screen_radius_px": pcts(rad),
        "dup_factor": round(max(entries) / max(np.mean(visible), 1), 2),
    }


def synthetic_cameras(width: int, height: int, device) -> list:
    """bench.py's dtu_full views: 8 cameras on a ring of radius 0.3 looking
    down +z."""
    from ..data.cameras import Camera
    cams = []
    for i in range(8):
        ang = 2 * np.pi * i / 8
        cams.append(Camera(
            colmap_id=i, idx=i, image_name=f"b{i}", R=np.eye(3),
            T=np.array([0.3 * np.cos(ang), 0.3 * np.sin(ang), 0.0]),
            fovx=0.9, fovy=0.7, width=width, height=height).arrays(
                device, pixels=False))
    return cams


def synthetic_population(n: int, cap: int, scale_mult: float, width: int,
                         height: int, device):
    """bench.py's dtu_full generator: n points on a sphere of radius 1.5
    at z = 4 with kNN-initialised scales times ``scale_mult``, and its 8
    views (``synthetic_cameras``)."""
    from ..models import gaussians as GM
    rng = np.random.default_rng(0)
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-1, 1, n)
    r = np.sqrt(1 - z ** 2)
    pts = (np.stack([r * np.cos(theta), r * np.sin(theta), z], 1) * 1.5
           + np.array([0, 0, 4.0])).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    state = GM.create_from_pcd(pts, cols, cap, sh_degree=3, device=device)
    if scale_mult != 1.0:
        state = state.replace(params=dataclasses.replace(
            state.params, log_scale=state.params.log_scale
            + np.float32(np.log(scale_mult))))
    return state, synthetic_cameras(width, height, device)


def trained_population(cfg_path: str, iteration: int, device):
    """(state, training cameras, label, (width, height)) of a trained
    run's saved PLY and its scene."""
    from ..config import Config
    from ..data.scene import load_scene_info
    from ..depth2mesh import latest_iteration
    from ..models import ply_io
    cfg = Config(cfg_path)
    logdir = os.path.dirname(os.path.abspath(cfg_path))
    it = iteration if iteration > 0 else latest_iteration(logdir)
    state = ply_io.load_gaussian_ply(
        os.path.join(logdir, "point_cloud", f"iteration_{it}",
                     "point_cloud.ply"),
        max_sh_degree=cfg.model.sh_degree, device=device)
    info = load_scene_info(cfg.model.source_path,
                           images_dir=cfg.model.images,
                           eval_split=cfg.model.eval,
                           llffhold=cfg.model.llffhold,
                           ratio=cfg.model.ratio,
                           use_meta_split=cfg.model.split,
                           resolution=cfg.model.resolution)
    cam0 = info.train_cameras[0]
    cams = [c.arrays(device, pixels=False) for c in info.train_cameras]
    return state, cams, f"trained {logdir} iter {it}", (cam0.width,
                                                        cam0.height)


def main(argv: list[str] | None = None) -> dict:
    """Prints the census as JSON and returns it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg_path", default=None)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--cap", type=int, default=1 << 20)
    ap.add_argument("--w", type=int, default=None)
    ap.add_argument("--h", type=int, default=None)
    ap.add_argument("--scale_mult", type=float, default=4.0)
    ap.add_argument("--tile", type=int, default=None)
    ap.add_argument("--budget", type=int, default=1 << 23)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..ops.binning import TILE
    from ..utils.device import resolve_device
    if args.tile is not None and args.tile != TILE:
        raise SystemExit(f"--tile {args.tile}: the port bins at its one "
                         f"tile size, {TILE} pixels")
    device = resolve_device(args.device)
    if args.synthetic:
        width, height = args.w or 1600, args.h or 1200
        state, cams = synthetic_population(args.n, args.cap,
                                           args.scale_mult, width, height,
                                           device)
        label = (f"synthetic n={args.n} scale_mult={args.scale_mult} "
                 f"{width}x{height}")
    else:
        if not args.cfg_path:
            raise SystemExit("--cfg_path or --synthetic required")
        state, cams, label, (w0, h0) = trained_population(
            args.cfg_path, args.iteration, device)
        width, height = args.w or w0, args.h or h0
        label += f" {width}x{height}"

    out = population_stats(state, cams, width, height)
    out["population"] = label
    out["tile"] = TILE
    out["entry_budget"] = (f"not applicable: the port sizes the entry list "
                           f"per frame (--budget {args.budget} not used)")
    out["device"] = str(device)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
