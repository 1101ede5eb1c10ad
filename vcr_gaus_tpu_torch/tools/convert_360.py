"""Mip-NeRF 360 preprocessing: write ``meta.json`` {trans, scale} for every
scene under a dataset root from its camera poses, the port's counterpart
of scripts/convert_360.py (same flag, outputs and messages):

  python -m vcr_gaus_tpu_torch.tools.convert_360 --data_path data/360_v2

Per-scene layout: <data_path>/<scene>/sparse/0/{cameras,images}.bin (the
Mip-NeRF 360 release layout). The bounds are ``tools.make_meta.
bound_by_pose`` (numpy on the host). The known-pose COLMAP
re-triangulation runs the external ``colmap`` binary: ``tools.
convert_colmap``.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv: list[str] | None = None) -> dict:
    """Writes each scene's meta.json; returns {scene: meta}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_path", required=True,
                    help="root holding one sub-directory per 360 scene")
    args = ap.parse_args(argv)

    from ..utils import colmap as CM
    from .make_meta import bound_by_pose

    metas = {}
    for scene in sorted(os.listdir(args.data_path)):
        scene_path = os.path.join(args.data_path, scene)
        if not os.path.isdir(scene_path):
            continue
        colmap_dir = os.path.join(scene_path, "sparse/0")
        if not os.path.isdir(colmap_dir):
            colmap_dir = os.path.join(scene_path, "sparse")
        images_bin = os.path.join(colmap_dir, "images.bin")
        if not os.path.exists(images_bin):
            print(f"skip {scene}: no COLMAP model at {colmap_dir}")
            continue
        trans, scale = bound_by_pose(CM.read_images_binary(images_bin))
        meta = {"trans": trans.tolist(), "scale": scale.tolist()}
        out = os.path.join(scene_path, "meta.json")
        with open(out, "w") as f:
            json.dump(meta, f, indent=4)
        print(f"wrote {out}")
        metas[scene] = meta
    return metas


if __name__ == "__main__":
    main()
