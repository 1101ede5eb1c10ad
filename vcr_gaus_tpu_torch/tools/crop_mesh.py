"""Crop a reconstructed mesh to the GT's PCA box and write ``*_crop.ply``,
the port's counterpart of scripts/crop_mesh.py (same flags, plus
``--device``):

  python -m vcr_gaus_tpu_torch.tools.crop_mesh --ply_path out/Barn/ours.ply \
      --gt_path data/tnt_gt/Barn/Barn.ply [--margin 0] [--device cuda|cpu]

A vertex is kept strictly inside the box grown by ``--margin``; a face is
kept when its three vertices are.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv: list[str] | None = None) -> str:
    """Returns the path of the cropped mesh."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ply_path", required=True)
    ap.add_argument("--gt_path", required=True)
    ap.add_argument("--margin", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..evaluation.geometry import obb_keep
    from ..meshing.extract import load_mesh_ply, save_mesh_ply
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    verts, faces = load_mesh_ply(args.ply_path)
    gt_verts, _ = load_mesh_ply(args.gt_path)
    keep = obb_keep(verts, gt_verts, args.margin, device)
    fkeep = keep[faces].all(axis=1)
    remap = np.full(len(verts), -1, np.int64)
    remap[keep] = np.arange(keep.sum())
    out = args.ply_path.replace(".ply", "_crop.ply")
    save_mesh_ply(out, verts[keep], remap[faces[fkeep]].astype(np.int32))
    print(f"wrote {out}: {int(keep.sum())}/{len(verts)} verts kept")
    return out


if __name__ == "__main__":
    main()
