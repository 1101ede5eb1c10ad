"""Scene bounds for a COLMAP scene: write ``meta.json`` {trans, scale}, the
port's counterpart of scripts/make_meta.py (same flags and the same
``meta.json`` keys and layout, plus ``--device``):

  python -m vcr_gaus_tpu_torch.tools.make_meta --source data/scene \
      [--mode points|pose|obb] [--split_ratio 0.9] [--device cuda|cpu]

Modes:
  points  centroid + 1.1 max|xyz| per axis of the sparse points
  pose    centre of the cameras' optical rays and their mean distance
          (numpy on the host)
  obb     PCA oriented box of the sparse points as a 4x4 transform and a
          per-axis scale (``evaluation.geometry.pca_obb`` on the device)

``--split_ratio`` > 0 also writes ``train`` and ``test`` name lists.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def bound_by_pose(images):
    """Centre = mean pairwise closest point of the cameras' optical rays;
    radius = mean camera distance."""
    from ..utils.colmap import qvec_to_rotmat
    poses = []
    for img in images.values():
        w2c = np.eye(4)
        w2c[:3, :3] = qvec_to_rotmat(img.qvec)
        w2c[:3, 3] = img.tvec
        poses.append(np.linalg.inv(w2c))

    def closest_point(p1, d1, p2, d2):
        n = np.cross(d1, d2)
        if np.linalg.norm(n) < 1e-9:
            return (p1 + p2) / 2
        t1 = np.dot(np.cross(p2 - p1, d2), n) / np.dot(n, n)
        t2 = np.dot(np.cross(p2 - p1, d1), n) / np.dot(n, n)
        return ((p1 + t1 * d1) + (p2 + t2 * d2)) / 2

    center = np.zeros(3)
    for f in poses:
        for g in poses:
            center += closest_point(f[:3, 3], f[:3, 2], g[:3, 3], g[:3, 2])
    center /= len(poses) ** 2
    radius = np.mean([np.linalg.norm(f[:3, 3]) for f in poses])
    return center, np.full(3, radius)


def box_meta(pts: np.ndarray, device) -> tuple[np.ndarray, np.ndarray]:
    """(4x4 transform into the points' PCA box, per-axis half-extents
    times 1.2); the box by ``evaluation.geometry.pca_obb`` on ``device``."""
    from ..evaluation.geometry import pca_obb
    R, t = pca_obb(pts, device)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T, np.abs(pts @ R.T + t).max(0) * 1.2


def main(argv: list[str] | None = None) -> dict:
    """Writes ``<source>/meta.json`` and returns its contents."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True)
    ap.add_argument("--mode", choices=["points", "pose", "obb"],
                    default="points")
    ap.add_argument("--split_ratio", type=float, default=0.0,
                    help="also write train/test name lists into meta.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..data.scene import bound_by_points
    from ..utils import colmap as CM
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    colmap_dir = os.path.join(args.source, "sparse/0")
    if not os.path.exists(colmap_dir):
        colmap_dir = os.path.join(args.source, "sparse")
    meta = {}
    if args.mode == "pose":
        images = CM.read_images_binary(os.path.join(colmap_dir, "images.bin"))
        trans, scale = bound_by_pose(images)
        meta["trans"] = trans.tolist()
        meta["scale"] = scale.tolist()
    else:
        bin_path = os.path.join(colmap_dir, "points3D.bin")
        xyz, _, _ = (CM.read_points3d_binary(bin_path)
                     if os.path.exists(bin_path) else CM.read_points3d_text(
                         os.path.join(colmap_dir, "points3D.txt")))
        if args.mode == "points":
            trans, scale = bound_by_points(xyz)
            meta["trans"] = trans.tolist()
            meta["scale"] = scale.tolist()
        else:
            T, scale = box_meta(xyz, device)
            meta["trans"] = T.tolist()
            meta["scale"] = scale.tolist()

    if args.split_ratio > 0:
        images = CM.read_images_binary(os.path.join(colmap_dir, "images.bin"))
        names = sorted(os.path.splitext(os.path.basename(i.name))[0]
                       for i in images.values())
        n_train = int(len(names) * args.split_ratio)
        hold = max(len(names) // max(len(names) - n_train, 1), 2)
        test = names[::hold][:len(names) - n_train]
        meta["train"] = [n for n in names if n not in set(test)]
        meta["test"] = test

    out = os.path.join(args.source, "meta.json")
    with open(out, "w") as f:
        json.dump(meta, f, indent=4)
    print(f"wrote {out}")
    return meta


if __name__ == "__main__":
    main()
