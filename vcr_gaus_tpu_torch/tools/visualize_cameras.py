"""Camera poses and scene layout to a PNG: camera frusta, the sparse point
cloud and the ``meta.json`` box, drawn with matplotlib; the port's
counterpart of scripts/visualize_cameras.py (same flags, output and
messages):

  python -m vcr_gaus_tpu_torch.tools.visualize_cameras --source data/scene \
      [--out poses.png] [--max_points 20000]

matplotlib is imported when the tool runs. Where it is not installed the
tool exits non-zero with a message saying so, and draws nothing.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def frustum_lines(c2w: np.ndarray, scale: float = 0.3):
    """5 corner points of a pyramid frustum in world space -> line
    segments."""
    corners = np.array([
        [0, 0, 0], [-0.5, -0.375, 1], [0.5, -0.375, 1],
        [0.5, 0.375, 1], [-0.5, 0.375, 1]]) * scale
    pts = corners @ c2w[:3, :3].T + c2w[:3, 3]
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return [(pts[a], pts[b]) for a, b in edges]


def box_lines(trans: np.ndarray, scale: np.ndarray):
    """Edges of the meta.json box (|p_box| <= scale): a 4x4 transform into
    the box, or a translation alone."""
    T = np.asarray(trans)
    s = np.asarray(scale)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)]) * s
    if T.ndim == 1:
        world = corners + T
    else:
        # box -> world: p_world = R^-1 (p_box - t)
        R, t = T[:3, :3], T[:3, 3]
        world = (corners - t) @ np.linalg.inv(R).T
    edges = [(a, b) for a in range(8) for b in range(a + 1, 8)
             if bin(a ^ b).count("1") == 1]
    return [(world[a], world[b]) for a, b in edges]


def read_model(source: str):
    """(images, xyz, rgb) of the scene's sparse model: the binary model
    with its points, else the text model's images without points."""
    from ..utils import colmap as CM
    for sub in ("sparse/0", "sparse"):
        d = os.path.join(source, sub)
        if os.path.exists(os.path.join(d, "images.bin")):
            images = CM.read_images_binary(os.path.join(d, "images.bin"))
            xyz, rgb, _ = CM.read_points3d_binary(
                os.path.join(d, "points3D.bin"))
            return images, xyz, rgb
        if os.path.exists(os.path.join(d, "images.txt")):
            images = CM.read_images_text(os.path.join(d, "images.txt"))
            return images, np.zeros((0, 3)), np.zeros((0, 3))
    raise SystemExit("no COLMAP sparse model found")


def main(argv: list[str] | None = None) -> str:
    """Returns the path of the PNG written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--max_points", type=int, default=20000)
    args = ap.parse_args(argv)

    try:
        import matplotlib
    except ImportError:
        raise SystemExit("visualize_cameras needs matplotlib, which is not "
                         "installed here; nothing was drawn") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils.colmap import qvec_to_rotmat

    images, xyz, rgb = read_model(args.source)
    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(projection="3d")
    if len(xyz):
        sel = np.random.default_rng(0).choice(
            len(xyz), min(args.max_points, len(xyz)), replace=False)
        ax.scatter(*xyz[sel].T, s=0.3, c=np.clip(rgb[sel] / 255.0, 0, 1))

    centers = []
    for img in images.values():
        R = qvec_to_rotmat(img.qvec)
        c2w = np.eye(4)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ img.tvec
        centers.append(c2w[:3, 3])
        for a, b in frustum_lines(c2w):
            ax.plot(*zip(a, b), color="tab:blue", lw=0.6)
    centers = np.array(centers)

    meta_path = os.path.join(args.source, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        for a, b in box_lines(np.asarray(meta["trans"]),
                              np.asarray(meta["scale"])):
            ax.plot(*zip(a, b), color="tab:red", lw=1.0)

    ax.set_title(f"{os.path.basename(args.source)}: "
                 f"{len(images)} cams, {len(xyz)} points")
    lim = np.abs(centers).max() * 1.2 if len(centers) else 1.0
    for setter in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
        setter(-lim, lim)
    out = args.out or os.path.join(args.source, "poses.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
