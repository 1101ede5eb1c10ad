"""Tanks and Temples preprocessing: triangulate a COLMAP sparse model with
the dataset's known camera poses, then derive the oriented-box
``meta.json`` from the ground-truth point cloud; the port's counterpart of
scripts/convert_tnt.py (same flags, outputs and messages, plus
``--device``):

  python -m vcr_gaus_tpu_torch.tools.convert_tnt --source data/tnt/Barn \
      --scene Barn [--run_colmap] [--export_json] [--device cuda|cpu]

Inputs under --source (the official TNT training-data layout):
  images_raw/                      raw video frames
  <scene>_COLMAP_SfM.log           per-image 4x4 camera-to-world trajectory
  <scene>_trans.txt                GT-to-trajectory alignment (4x4)
  <scene>.ply                      ground-truth point cloud

--run_colmap needs the external ``colmap`` binary (feature extraction,
sequential matching, point_triangulator with the fixed known poses, BA
with frozen extrinsics, undistortion); --export_json reads the files
above and computes the box (``evaluation.geometry.pca_obb`` on the
device).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sqlite3
import subprocess

import numpy as np


def load_sfm_log(cam_file: str, names: list[str]) -> dict[str, np.ndarray]:
    """Parse a TNT *_COLMAP_SfM.log trajectory: blocks of 5 lines (header
    'idx valid ?' and the 4 rows of the camera-to-world matrix). Returns
    {image_name: world-to-camera 4x4}."""
    with open(cam_file) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    w2c = {}
    for b in range(len(lines) // 5):
        head = lines[5 * b].split()
        idx, valid = int(head[0]), head[1]
        if valid == "-1":
            continue
        c2w = np.array([[float(v) for v in lines[5 * b + 1 + r].split()]
                        for r in range(4)])
        w2c[names[idx]] = np.linalg.inv(c2w)
    return w2c


def load_transformation(trans_file: str) -> np.ndarray:
    """4x4 alignment matrix, one row per line."""
    rows = []
    with open(trans_file) as f:
        for ln in f:
            if ln.strip():
                rows.append([float(v) for v in ln.split()])
    return np.array(rows).reshape(4, 4)


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> COLMAP (w, x, y, z) quaternion."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def write_init_model(w2c: dict[str, np.ndarray], db_file: str, out_dir: str,
                     width: int = 1920, height: int = 1080) -> None:
    """A COLMAP text model with the known poses, for point_triangulator:
    one shared RADIAL camera with f = 0.6 w and the principal point
    centred (the TNT video prior); image ids from the matcher's database,
    so that its features line up."""
    os.makedirs(out_dir, exist_ok=True)
    db = sqlite3.connect(db_file)
    name2id = dict(db.execute("SELECT name, image_id FROM images"))
    db.close()

    f = 0.6 * width
    with open(os.path.join(out_dir, "cameras.txt"), "w") as fp:
        fp.write(f"1 RADIAL {width} {height} {f} {width / 2.0} "
                 f"{height / 2.0} 0 0\n")
    with open(os.path.join(out_dir, "images.txt"), "w") as fp:
        for name, img_id in sorted(name2id.items()):
            if name not in w2c:
                continue
            m = w2c[name]
            q = rotmat_to_qvec(m[:3, :3])
            t = m[:3, 3]
            fp.write(f"{img_id} {q[0]} {q[1]} {q[2]} {q[3]} "
                     f"{t[0]} {t[1]} {t[2]} 1 {name}\n\n")
    open(os.path.join(out_dir, "points3D.txt"), "w").close()


def compute_meta(gt_ply: str, trans_file: str, subsample: int = 100,
                 device="cuda"):
    """The PCA box of the GT points aligned into the camera frame:
    (4x4 transform into the box, per-axis half-extents times 1.2)."""
    from ..utils.ply import read_points_ply
    from .make_meta import box_meta

    pts = read_points_ply(gt_ply)[0]
    inv = np.linalg.inv(load_transformation(trans_file))
    pts = pts @ inv[:3, :3].T + inv[:3, 3]
    return box_meta(pts[::subsample], device)


def run(cmd: list[str]) -> None:
    print("+", " ".join(cmd), flush=True)
    rc = subprocess.run(cmd).returncode
    if rc != 0:
        raise SystemExit(f"colmap step failed ({rc}): {' '.join(cmd)}")


def main(argv: list[str] | None = None) -> dict | None:
    """Returns the meta.json written by --export_json, else None."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True)
    ap.add_argument("--scene", required=True,
                    help="scene name prefix of the .log/.ply/_trans.txt")
    ap.add_argument("--run_colmap", action="store_true")
    ap.add_argument("--export_json", action="store_true")
    ap.add_argument("--colmap_executable", default="colmap")
    ap.add_argument("--max_image_size", type=int, default=1500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    src, scene = args.source, args.scene

    if args.run_colmap:
        if shutil.which(args.colmap_executable) is None:
            raise SystemExit("colmap binary not found — preprocessing is an "
                             "offline external step")
        img_dir = os.path.join(src, "images_raw")
        if not os.path.isdir(img_dir):
            raise SystemExit(f"{img_dir} not found (official TNT layout)")
        db = os.path.join(src, "database.db")
        cm = args.colmap_executable
        run([cm, "feature_extractor", "--database_path", db,
             "--image_path", img_dir,
             "--ImageReader.camera_model=RADIAL",
             "--ImageReader.single_camera=true"])
        run([cm, "sequential_matcher", "--database_path", db])

        names = sorted(os.listdir(img_dir))
        w2c = load_sfm_log(os.path.join(src, f"{scene}_COLMAP_SfM.log"),
                           names)
        sfm_dir = os.path.join(src, "sparse")
        write_init_model(w2c, db, sfm_dir)
        run([cm, "point_triangulator", "--database_path", db,
             "--image_path", img_dir, "--input_path", sfm_dir,
             "--output_path", sfm_dir,
             "--Mapper.tri_ignore_two_view_tracks=true"])
        run([cm, "bundle_adjuster", "--input_path", sfm_dir,
             "--output_path", sfm_dir,
             "--BundleAdjustment.refine_extrinsics=false"])
        run([cm, "image_undistorter", "--image_path", img_dir,
             "--input_path", sfm_dir, "--output_path", src,
             "--output_type", "COLMAP",
             f"--max_image_size={args.max_image_size}"])

    if not args.export_json:
        return None
    from ..utils.device import resolve_device
    T, scale = compute_meta(os.path.join(src, f"{scene}.ply"),
                            os.path.join(src, f"{scene}_trans.txt"),
                            device=resolve_device(args.device))
    meta = {"trans": T.tolist(), "scale": scale.tolist()}
    with open(os.path.join(src, "meta.json"), "w") as fp:
        json.dump(meta, fp, indent=4)
    print("wrote meta.json:", meta["scale"])
    return meta


if __name__ == "__main__":
    main()
