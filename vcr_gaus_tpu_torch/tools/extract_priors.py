"""Monocular priors for a scene, the port's counterpart of
scripts/extract_priors.py (same kinds, backends, output contract and
messages, plus ``--device``):

  normals/<stem>.npz   float16 arr_0, (3,H,W) camera-space normals in [-1,1]
  masks/<stem>.png     uint8 label map, 0 = background, 1 = foreground

Backends:
  normals --backend dsine   the external DSINE checkout (``DSINE_PATH``);
                            exits non-zero: not wired in
          --backend depth   normals from ``depths/<stem>.npz`` and the
                            COLMAP intrinsics: the cross product of the
                            back-projected depth gradients
                            (``utils.graphics.compute_normals_from_depth``,
                            on ``--device``)
  masks   --backend gsam    the external Grounded-SAM checkout
                            (``GSAM_PATH``); exits non-zero: not wired in
          --backend all-fg  constant foreground masks

  python -m vcr_gaus_tpu_torch.tools.extract_priors normals \
      --source data/scene --backend depth [--device cuda|cpu]
  python -m vcr_gaus_tpu_torch.tools.extract_priors masks \
      --source data/scene --backend all-fg
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def _image_stems(src):
    img_dir = os.path.join(src, "images")
    if not os.path.isdir(img_dir):
        raise SystemExit(f"{img_dir} not found")
    names = sorted(n for n in os.listdir(img_dir)
                   if n.lower().endswith((".jpg", ".jpeg", ".png")))
    return img_dir, names


def _intrinsics(src):
    """fx, fy, cx, cy of the first camera of the COLMAP sparse model."""
    from ..utils import colmap as CM
    for sub in ("sparse/0", "sparse"):
        d = os.path.join(src, sub)
        if os.path.exists(os.path.join(d, "cameras.bin")):
            cams = CM.read_cameras_binary(os.path.join(d, "cameras.bin"))
            break
        if os.path.exists(os.path.join(d, "cameras.txt")):
            cams = CM.read_cameras_text(os.path.join(d, "cameras.txt"))
            break
    else:
        return None
    cam = next(iter(cams.values()))
    p = cam.params
    if cam.model == "PINHOLE":
        return p[0], p[1], p[2], p[3]
    return p[0], p[0], p[1], p[2]           # SIMPLE_PINHOLE / RADIAL


def normals_from_depth(src, out_dir, device):
    """Normals of each view's depth map, written as f16 (3,H,W). The
    intrinsics are scaled to the depth map's size, the principal point at
    its centre. Returns the stems written."""
    from ..utils.graphics import compute_normals_from_depth

    depth_dir = os.path.join(src, "depths")
    if not os.path.isdir(depth_dir):
        raise SystemExit(f"--backend depth needs {depth_dir}/<stem>.npz maps")
    intr = _intrinsics(src)
    if intr is None:
        raise SystemExit("no COLMAP sparse model found for intrinsics")
    fx, fy, cx, cy = intr
    os.makedirs(out_dir, exist_ok=True)
    _, names = _image_stems(src)
    done = []
    for name in names:
        stem = os.path.splitext(name)[0]
        dpath = os.path.join(depth_dir, stem + ".npz")
        if not os.path.exists(dpath):
            print(f"[skip] no depth for {stem}")
            continue
        depth = np.load(dpath)["arr_0"].astype(np.float32)
        h, w = depth.shape[-2:]
        sx, sy = w / (2 * cx), h / (2 * cy)
        K = torch.tensor([[fx * sx, 0, w / 2], [0, fy * sy, h / 2],
                          [0, 0, 1]], dtype=torch.float32, device=device)
        n = compute_normals_from_depth(
            torch.from_numpy(depth).to(device), K)
        n16 = n.permute(2, 0, 1).to(torch.float16).cpu().numpy()
        np.savez_compressed(os.path.join(out_dir, stem + ".npz"), n16)
        print(f"[normal] {stem}")
        done.append(stem)
    return done


def normals_dsine(src, out_dir, device):
    dsine = os.environ.get("DSINE_PATH")
    if not dsine or not os.path.isdir(dsine):
        raise SystemExit(
            "DSINE not available: clone github.com/baegwangbin/DSINE, "
            "download its checkpoint, and set DSINE_PATH. The framework only "
            "consumes the npz outputs (SURVEY.md §2.4) — any monocular "
            "normal estimator with the same output contract works.")
    sys.path.insert(0, dsine)
    raise SystemExit("wire DSINE's test_samples() here against your "
                     "checkout; see reference extract_normal.py:208-252")


def masks_all_fg(src, out_dir, device):
    """A mask of ones the size of each image. Returns the stems written."""
    from PIL import Image
    img_dir, names = _image_stems(src)
    os.makedirs(out_dir, exist_ok=True)
    done = []
    for name in names:
        stem = os.path.splitext(name)[0]
        with Image.open(os.path.join(img_dir, name)) as im:
            w, h = im.size
        Image.fromarray(np.ones((h, w), np.uint8)).save(
            os.path.join(out_dir, stem + ".png"))
        print(f"[mask] {stem} (all-foreground)")
        done.append(stem)
    return done


def masks_gsam(src, out_dir, device):
    gsam = os.environ.get("GSAM_PATH")
    if not gsam or not os.path.isdir(gsam):
        raise SystemExit(
            "Grounded-SAM not available: set GSAM_PATH to a checkout with "
            "checkpoints. Prompts: 'sky.' (outdoor) / 'window.floor.' "
            "(indoor); background pixels get label 0 "
            "(vcr_gaus_tpu_torch/data/semantic_ids.py).")
    raise SystemExit("wire Grounded-SAM inference here; see reference "
                     "extract_mask.py:27-30,116-130")


BACKENDS = {"normals": ("dsine", {"dsine": normals_dsine,
                                  "depth": normals_from_depth}),
            "masks": ("gsam", {"gsam": masks_gsam, "all-fg": masks_all_fg})}


def main(argv: list[str] | None = None) -> list[str]:
    """Returns the stems written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=["normals", "masks"])
    ap.add_argument("--source", required=True)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    default, fns = BACKENDS[args.kind]
    out = args.out or os.path.join(args.source, args.kind)
    return fns[args.backend or default](args.source, out, device)


if __name__ == "__main__":
    main()
