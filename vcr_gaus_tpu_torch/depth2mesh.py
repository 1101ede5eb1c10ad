"""Mesh extraction CLI, the port's counterpart of the root ``depth2mesh.py``
(same flags, plus ``--device``): load a trained run, render a depth sweep,
TSDF-fuse it, run marching tetrahedra and write ``<mesh_name>.ply`` beside
the config.

  python -m vcr_gaus_tpu_torch.depth2mesh --cfg_path output/scan24/config.yaml \
      [--voxel_size 0.004] [--split 1] [--max_depth 3] [--prob_thr 0.5] \
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np


def latest_iteration(logdir: str) -> int:
    dirs = glob.glob(os.path.join(logdir, "point_cloud", "iteration_*"))
    if not dirs:
        raise SystemExit(f"no point_cloud/iteration_* under {logdir}")
    return max(int(os.path.basename(d).split("_")[1]) for d in dirs)


def prune_outliers(state, trans, scale, radius: float):
    """The inside-box splats with >= 5 neighbours within 0.01 * radius, the
    neighbour pool being the inside-box subset only; when the radius filter
    would remove every splat, the inside-box crop alone."""
    import torch

    from .models.gaussians import prune
    from .ops.knn import remove_radius_outlier
    from .utils.math import get_inside_normalized

    inside, _ = get_inside_normalized(state.params.xyz, trans, scale)
    pool = state.active & inside
    keep = torch.zeros_like(pool)
    if bool(pool.any()):
        keep[pool] = remove_radius_outlier(state.params.xyz[pool],
                                           nb_points=5, radius=0.01 * radius)
    if not bool(keep.any()) and bool(pool.any()):
        # degenerate cloud (too sparse for the radius filter at this
        # extent, e.g. a barely-trained tiny model): fuse the crop rather
        # than an empty model
        print("prune_outliers: radius filter would remove every splat; "
              "keeping the inside-box crop instead", flush=True)
        keep = pool
    n_outside = int(state.active.sum()) - int(pool.sum())
    n_outlier = int(pool.sum()) - int(keep.sum())
    state = prune(state, state.active & ~keep)
    print(f"prune_outliers: kept {int(keep.sum())} (removed "
          f"{n_outlier} outliers, {n_outside} outside-box)", flush=True)
    return state


def main(argv: list[str] | None = None) -> str:
    """Returns the path of the mesh written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg_path", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--voxel_size", type=float, default=None)
    ap.add_argument("--split", type=int, default=1,
                    help="use every Nth camera")
    ap.add_argument("--max_depth", type=float, default=None)
    ap.add_argument("--prob_thr", type=float, default=0.5)
    ap.add_argument("--num_cluster", type=int, default=1)
    ap.add_argument("--mesh_name", default="ours")
    ap.add_argument("--prune_outliers", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="denoise + crop-to-box the loaded model before "
                         "fusion; --no-prune_outliers opts out")
    ap.add_argument("--normalize_depth", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fuse alpha-normalized expected depth (default); "
                         "--no-normalize_depth fuses the raw alpha-weighted "
                         "render")
    ap.add_argument("--mask_cut", action="store_true",
                    help="zero depth where the camera's stored foreground "
                         "mask is background before fusing (the scene is "
                         "loaded without masks, as by the root "
                         "depth2mesh.py, so this cuts nothing here)")
    ap.add_argument("--unbounded", action="store_true",
                    help="mip-360 contraction meshing for unbounded scenes "
                         "instead of the bounded box grid")
    ap.add_argument("--resolution", type=int, default=320,
                    help="contracted-grid resolution (unbounded mode)")
    ap.add_argument("--max_voxels", type=int, default=1 << 31,
                    help="abort (exit 3) if the dense TSDF grid would "
                         "exceed this many voxels")
    ap.add_argument("--device", default="cuda")
    args, overrides = ap.parse_known_args(argv)

    from .config import Config
    from .data.scene import load_scene_info
    from .meshing.extract import (extract_mesh_from_state,
                                  extract_mesh_unbounded_from_state,
                                  save_mesh_ply)
    from .models import ply_io
    from .render.renderer import RenderConfig
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = Config(args.cfg_path, overrides=overrides)
    logdir = os.path.dirname(os.path.abspath(args.cfg_path))
    it = args.iteration if args.iteration > 0 else latest_iteration(logdir)
    ply = os.path.join(logdir, "point_cloud", f"iteration_{it}",
                       "point_cloud.ply")
    print(f"loading {ply}")
    state = ply_io.load_gaussian_ply(ply, max_sh_degree=cfg.model.sh_degree,
                                     device=device)
    info = load_scene_info(cfg.model.source_path,
                           images_dir=cfg.model.images,
                           eval_split=cfg.model.eval,
                           llffhold=cfg.model.llffhold,
                           ratio=cfg.model.ratio,
                           use_meta_split=cfg.model.split,
                           resolution=cfg.model.resolution,
                           data_device=str(getattr(cfg.model, "data_device",
                                                   "host")))
    if args.prune_outliers:
        state = prune_outliers(state, info.trans, info.scale, info.radius)

    cam0 = info.train_cameras[0]
    rcfg = RenderConfig(width=cam0.width, height=cam0.height,
                        depth_mode=cfg.model.depth_type, mask_depth_thr=1e9)
    progress = lambda i: print(f"  fused view {i}", end="\r")  # noqa: E731
    if args.unbounded:
        if args.resolution ** 3 > args.max_voxels:
            print(f"contracted grid {args.resolution}^3 exceeds "
                  f"--max_voxels={args.max_voxels:,}; lower --resolution",
                  file=sys.stderr)
            raise SystemExit(3)
        verts, faces = extract_mesh_unbounded_from_state(
            state, info.train_cameras, rcfg, resolution=args.resolution,
            alpha_thr=args.prob_thr, stride=args.split,
            n_clusters=args.num_cluster, sh_degree=cfg.model.sh_degree,
            scene_extent=info.radius, normalize_depth=args.normalize_depth,
            progress=progress)
    else:
        voxel = args.voxel_size or float(cfg.model.mesh.voxel_size)
        dims = np.maximum((2.0 * np.broadcast_to(np.asarray(info.scale),
                                                 (3,))
                           / voxel).astype(np.int64) + 1, 2)
        if int(dims.prod()) > args.max_voxels:
            print(f"TSDF grid {dims.tolist()} = {int(dims.prod()):,} voxels "
                  f"exceeds --max_voxels={args.max_voxels:,}; "
                  "retry with a larger --voxel_size", file=sys.stderr)
            raise SystemExit(3)
        verts, faces = extract_mesh_from_state(
            state, info.train_cameras, rcfg, info.trans, info.scale,
            voxel_size=voxel, alpha_thr=args.prob_thr, stride=args.split,
            max_depth=args.max_depth, n_clusters=args.num_cluster,
            sh_degree=cfg.model.sh_degree, scene_extent=info.radius,
            normalize_depth=args.normalize_depth, mask_cut=args.mask_cut,
            progress=progress)
    out = os.path.join(logdir, f"{args.mesh_name}.ply")
    save_mesh_ply(out, verts, faces)
    print(f"\nwrote {out}: {len(verts)} verts, {len(faces)} faces")
    return out


if __name__ == "__main__":
    main()
