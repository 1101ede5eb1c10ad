"""DTU preprocessing: each scan's ``meta.json`` from the ground-truth STL
points (their PCA box) and the fixed DTU train/test split, the port's
counterpart of scripts/convert_dtu.py (same flags, outputs and messages,
plus ``--device``):

  python -m vcr_gaus_tpu_torch.tools.convert_dtu --dtu_path data/dtu \
      [--no_split] [--subsample 10] [--device cuda|cpu]

Layout: <dtu_path>/scanNN/images/*.png and
        <dtu_path>/Points/stl/stlNNN_total.ply (official GT points).
The box is make_meta's ``obb`` box (``evaluation.geometry.pca_obb`` on the
device).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

# held-out view indices of the standard DTU evaluation protocol
TEST_INDEXES = [8, 13, 16, 21, 26, 31, 34, 56]


def scan_meta(stl_ply: str, subsample: int = 1, device="cuda"):
    """The STL points' PCA box (``make_meta.box_meta``)."""
    from ..utils.ply import read_points_ply
    from .make_meta import box_meta
    return box_meta(read_points_ply(stl_ply)[0][::subsample], device)


def main(argv: list[str] | None = None) -> dict:
    """Writes each scan's meta.json; returns {scan: meta}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtu_path", required=True)
    ap.add_argument("--no_split", action="store_true")
    ap.add_argument("--subsample", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device
    device = resolve_device(args.device)
    metas = {}
    for scene in sorted(os.listdir(args.dtu_path)):
        scene_path = os.path.join(args.dtu_path, scene)
        if not os.path.isdir(scene_path) or "scan" not in scene:
            continue
        sid = int(scene[4:])
        stl = os.path.join(args.dtu_path, "Points", "stl",
                           f"stl{sid:03}_total.ply")
        if not os.path.exists(stl):
            print(f"[skip] {scene}: no GT points at {stl}")
            continue
        T, scale = scan_meta(stl, args.subsample, device)
        out = {"trans": T.tolist(), "scale": scale.tolist()}

        if not args.no_split:
            names = sorted(n for n in
                           os.listdir(os.path.join(scene_path, "images"))
                           if n.endswith("png"))
            stems = [n.split(".")[0] for n in names]
            out["train"] = sorted(s for s in stems
                                  if int(s) not in TEST_INDEXES)
            out["test"] = sorted(s for s in stems if int(s) in TEST_INDEXES)

        with open(os.path.join(scene_path, "meta.json"), "w") as fp:
            json.dump(out, fp, indent=4)
        print(f"[meta] {scene}: scale {np.round(scale, 3).tolist()}")
        metas[scene] = out
    return metas


if __name__ == "__main__":
    main()
