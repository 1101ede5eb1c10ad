"""COLMAP structure from motion for a custom dataset: feature extraction,
matching, mapping, undistortion; the port's counterpart of
scripts/convert_colmap.py (same flags, outputs and messages, plus
``--device`` for ``--make_meta``). It runs the external ``colmap`` binary
and stops with the script's message where there is none:

  python -m vcr_gaus_tpu_torch.tools.convert_colmap --source data/myscene \
      [--no_gpu] [--make_meta] [--device cuda|cpu]

``--make_meta`` then writes ``meta.json`` through the port's
``tools.make_meta``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess


def run(cmd: list[str]) -> None:
    print("+", " ".join(cmd), flush=True)
    rc = subprocess.run(cmd).returncode
    if rc != 0:
        raise SystemExit(f"colmap step failed ({rc}): {' '.join(cmd)}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True,
                    help="dir with input/ images")
    ap.add_argument("--camera", default="OPENCV")
    ap.add_argument("--colmap_executable", default="colmap")
    ap.add_argument("--no_gpu", action="store_true")
    ap.add_argument("--make_meta", action="store_true",
                    help="also derive meta.json from the sparse points")
    ap.add_argument("--device", default="cuda",
                    help="the device of --make_meta")
    args = ap.parse_args(argv)

    if shutil.which(args.colmap_executable) is None:
        raise SystemExit(
            "colmap binary not found — install COLMAP or pass "
            "--colmap_executable (preprocessing is an offline external step)")

    src = args.source
    use_gpu = "0" if args.no_gpu else "1"
    os.makedirs(os.path.join(src, "distorted/sparse"), exist_ok=True)
    run([args.colmap_executable, "feature_extractor",
         "--database_path", f"{src}/distorted/database.db",
         "--image_path", f"{src}/input",
         "--ImageReader.single_camera", "1",
         "--ImageReader.camera_model", args.camera,
         "--SiftExtraction.use_gpu", use_gpu])
    run([args.colmap_executable, "exhaustive_matcher",
         "--database_path", f"{src}/distorted/database.db",
         "--SiftMatching.use_gpu", use_gpu])
    run([args.colmap_executable, "mapper",
         "--database_path", f"{src}/distorted/database.db",
         "--image_path", f"{src}/input",
         "--output_path", f"{src}/distorted/sparse",
         "--Mapper.ba_global_function_tolerance", "0.000001"])
    run([args.colmap_executable, "image_undistorter",
         "--image_path", f"{src}/input",
         "--input_path", f"{src}/distorted/sparse/0",
         "--output_path", src, "--output_type", "COLMAP"])
    # the sparse model into sparse/0
    os.makedirs(f"{src}/sparse/0", exist_ok=True)
    for f in os.listdir(f"{src}/sparse"):
        if f != "0":
            shutil.move(os.path.join(src, "sparse", f),
                        os.path.join(src, "sparse", "0", f))
    if args.make_meta:
        from .make_meta import main as make_meta
        make_meta(["--source", src, "--device", args.device])
    print("done")


if __name__ == "__main__":
    main()
