"""Geometry metric CLI, the port's counterpart of
``scripts/eval_geometry.py`` (same flags, plus ``--device``).

TNT F1 (the GT's PCA-box crop, optional ICP, precision/recall/F1 at the
threshold); writes ``metrics.txt`` beside the mesh, one ``key: value`` a
line:
  python -m vcr_gaus_tpu_torch.eval_geometry tnt --ply_path out/Barn/ours.ply \
      --gt_path data/tnt/Barn/Barn.ply --threshold 0.01 [--icp] \
      [--device cuda|cpu]

DTU Chamfer:
  python -m vcr_gaus_tpu_torch.eval_geometry dtu --ply_path out/scan24/ours.ply \
      --scan 24 --dataset_dir data/dtu_eval [--instance_dir data/dtu/scan24] \
      [--device cuda|cpu]

``dataset_dir`` holds ``Points/stl/stl<scan:03d>_total.ply`` and, where
available, ``ObsMask/ObsMask<scan>_10.mat`` and ``ObsMask/Plane<scan>.mat``;
``instance_dir`` (``cameras.npz`` and ``mask/*.png``) culls the mesh first.
Writes ``results.json`` beside the mesh.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def cmd_tnt(args) -> dict:
    from .evaluation.geometry import tnt_f1
    from .meshing.extract import load_mesh_ply
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    verts, faces = load_mesh_ply(args.ply_path)
    gt_verts, _ = load_mesh_ply(args.gt_path)
    m = tnt_f1(verts, faces, gt_verts, threshold=args.threshold,
               down_sample=args.down_sample, run_icp=args.icp, device=device)
    out = os.path.join(os.path.dirname(args.ply_path), "metrics.txt")
    with open(out, "w") as f:
        for k, v in m.items():
            f.write(f"{k}: {v}\n")
    print(json.dumps(m))
    return m


def cmd_dtu(args) -> dict:
    from scipy.io import loadmat

    from .evaluation.geometry import dtu_chamfer, sample_points_on_mesh
    from .meshing.extract import load_mesh_ply
    from .utils.device import resolve_device
    from .utils.ply import read_points_ply

    device = resolve_device(args.device)
    verts, faces = load_mesh_ply(args.ply_path)
    if args.instance_dir:
        # cull by image masks + frusta
        from .evaluation.dtu_cull import cull_mesh_dtu
        verts, faces = cull_mesh_dtu(verts, faces, args.instance_dir,
                                     device=device)
    pts = sample_points_on_mesh(verts, faces, args.downsample_density,
                                device=device)
    stl, _, _ = read_points_ply(os.path.join(
        args.dataset_dir, "Points", "stl", f"stl{args.scan:03d}_total.ply"))
    obs = bb = res = plane = None
    mat = os.path.join(args.dataset_dir, "ObsMask",
                       f"ObsMask{args.scan}_10.mat")
    if os.path.exists(mat):
        m = loadmat(mat)
        obs, bb, res = m["ObsMask"], m["BB"], m["Res"]
        plane = loadmat(os.path.join(args.dataset_dir, "ObsMask",
                                     f"Plane{args.scan}.mat"))["P"]
    else:
        print("WARNING: ObsMask assets missing; unmasked chamfer",
              file=sys.stderr)
    m = dtu_chamfer(pts, stl, downsample_density=args.downsample_density,
                    max_dist=args.max_dist, patch_size=args.patch_size,
                    obs_mask=obs, bb=bb, res=res, ground_plane=plane,
                    device=device)
    out = os.path.join(os.path.dirname(args.ply_path), "results.json")
    with open(out, "w") as f:
        json.dump(m, f, indent=2)
    print(json.dumps(m))
    return m


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("tnt")
    t.add_argument("--ply_path", required=True)
    t.add_argument("--gt_path", required=True)
    t.add_argument("--threshold", type=float, default=0.05)
    t.add_argument("--down_sample", type=float, default=0.02)
    t.add_argument("--icp", action="store_true")
    t.add_argument("--device", default="cuda")
    t.set_defaults(fn=cmd_tnt)
    d = sub.add_parser("dtu")
    d.add_argument("--ply_path", required=True)
    d.add_argument("--dataset_dir", required=True)
    d.add_argument("--scan", type=int, required=True)
    d.add_argument("--downsample_density", type=float, default=0.2)
    d.add_argument("--patch_size", type=float, default=60)
    d.add_argument("--max_dist", type=float, default=20)
    d.add_argument("--instance_dir", default=None,
                   help="DTU instance dir (cameras.npz + mask/) for culling")
    d.add_argument("--device", default="cuda")
    d.set_defaults(fn=cmd_dtu)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
