"""The views of a run, drawn from the seed, and the scene directory the
program reads them from.

Views are chip_smoke.py's, rewritten without the program: a ``ring``
(identity rotation, centres on a circle of ``ring_radius`` in the z = 0
plane, looking down +z at the shell, DTU's layout) or an ``orbit``
(centres at ``orbit_distance`` from the shell's centre around it, at
elevations alternating +-0.2 rad, each looking at the centre, so that the
camera extent is about 1.1 x the distance and a recipe's depth cut keeps
the shell's front). Each view has a smooth colour pattern as its image
(u8), a random unit normal prior (float16), and, where the recipe trains
the semantic head, a label map: 1 on the shell's silhouette, 0 elsewhere.
The scene is written in COLMAP's binary layout with PNG images, ``.npz``
priors, mask PNGs (the label in the blue channel), a small init cloud and
``meta.json``'s box. The arrays are kept in memory for the reference.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import NamedTuple

import numpy as np
import torch

from .population import generator
from .reference.camera import qvec_to_rotmat


class View(NamedTuple):
    name: str
    qvec: np.ndarray             # (4,) world-to-camera rotation (w, x, y, z)
    tvec: np.ndarray             # (3,) world-to-camera translation
    image: np.ndarray            # (3, H, W) uint8
    normal: np.ndarray | None    # (3, H, W) float16
    labels: np.ndarray | None    # (H, W) int32


class Scene(NamedTuple):
    root: str
    views: list
    width: int
    height: int
    fovx: float
    fovy: float
    trans: list
    scale: list


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix (COLMAP's conversion)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def poses(views: dict, center) -> list:
    """(qvec, tvec) world-to-camera of each view."""
    n = int(views["count"])
    center = np.asarray(center, np.float64)
    out = []
    if views["layout"] == "ring":
        rad = float(views["ring_radius"])
        for i in range(n):
            ang = 2 * np.pi * i / n
            out.append((np.array([1.0, 0, 0, 0]),
                        np.array([rad * np.cos(ang), rad * np.sin(ang), 0.0])))
        return out
    dist = float(views["orbit_distance"])
    for i in range(n):
        phi = 2 * np.pi * i / n
        el = 0.2 if i % 2 else -0.2
        d = np.array([np.cos(el) * np.cos(phi), np.sin(el),
                      np.cos(el) * np.sin(phi)])
        fwd = -d
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        out.append((rotmat_to_qvec(R), -R @ (center + dist * d)))
    return out


def _silhouette(qvec, tvec, center, radius, width, height, fx, fy, device):
    """(H, W) bool: pixels whose centre ray meets the shell's sphere."""
    R = qvec_to_rotmat(qvec)
    c = torch.tensor(R @ np.asarray(center) + tvec, dtype=torch.float64,
                     device=device)
    v, u = torch.meshgrid(torch.arange(height, device=device) + 0.5,
                          torch.arange(width, device=device) + 0.5,
                          indexing="ij")
    d = torch.stack([(u - width / 2) / fx, (v - height / 2) / fy,
                     torch.ones_like(u)], -1).to(torch.float64)
    a = (d * d).sum(-1)
    b = d @ c
    return b * b - a * (c @ c - radius * radius) >= 0


def make_views(views: dict, pop: dict, want_normal: bool, want_labels: bool,
               seed: int, device) -> tuple[list, float, float]:
    """(views, fovx, fovy): each view's pose and arrays."""
    w, h = int(views["width"]), int(views["height"])
    fovx, fovy = float(views["fovx"]), float(views["fovy"])
    fx, fy = w / (2 * math.tan(fovx / 2)), h / (2 * math.tan(fovy / 2))
    gen = generator(seed, 2, device)
    f32 = torch.float32
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=f32),
                            torch.arange(w, device=device, dtype=f32),
                            indexing="ij")
    out = []
    for i, (q, t) in enumerate(poses(views, pop["shell_center"])):
        ph = torch.rand(6, generator=gen, device=device) * (2 * math.pi)
        img = torch.stack([0.5 + 0.2 * torch.sin(xx / 230.0 + ph[c])
                           * torch.cos(yy / 170.0 + ph[3 + c])
                           for c in range(3)])
        image = (255 * img).to(torch.uint8).cpu().numpy()
        normal = labels = None
        if want_normal:
            nrm = torch.randn((3, h, w), generator=gen, device=device)
            nrm = nrm / torch.linalg.vector_norm(nrm, dim=0, keepdim=True)
            normal = nrm.to(torch.float16).cpu().numpy()
        if want_labels:
            labels = _silhouette(q, t, pop["shell_center"],
                                 float(pop["shell_radius"]), w, h, fx, fy,
                                 device).to(torch.int32).cpu().numpy()
        out.append(View(f"view_{i:03d}", q, t, image, normal, labels))
    return out, fovx, fovy


def _write_colmap(sparse: str, views: list, width: int, height: int,
                  fovx: float, fovy: float) -> None:
    fx = width / (2 * math.tan(fovx / 2))
    fy = height / (2 * math.tan(fovy / 2))
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, width, height))      # PINHOLE
        f.write(struct.pack("<4d", fx, fy, width / 2, height / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(views)))
        for i, v in enumerate(views):
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *v.qvec))
            f.write(struct.pack("<3d", *v.tvec))
            f.write(struct.pack("<i", 1))
            f.write((v.name + ".png").encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def _write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """A binary PLY of x, y, z, nx, ny, nz (float) and red, green, blue
    (uchar)."""
    n = xyz.shape[0]
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
                             ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    for i, k in enumerate("xyz"):
        rec[k] = xyz[:, i]
    for i, k in enumerate(("red", "green", "blue")):
        rec[k] = rgb[:, i]
    head = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    head += [f"property float {k}" for k in ("x", "y", "z", "nx", "ny", "nz")]
    head += [f"property uchar {k}" for k in ("red", "green", "blue")]
    head += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        f.write(rec.tobytes())


def write_scene(root: str, views: list, width: int, height: int, fovx: float,
                fovy: float, pop: dict, normal_folder: str,
                init_points: int, seed: int) -> Scene:
    """Write the views under ``root``: the COLMAP model, the images, the
    priors, an init cloud of ``init_points`` shell points and meta.json's
    box (centred on the shell, 1.1 x its radius)."""
    from PIL import Image

    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    for sub in ("images", normal_folder, "masks"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    _write_colmap(sparse, views, width, height, fovx, fovy)
    for v in views:
        Image.fromarray(v.image.transpose(1, 2, 0)).save(
            os.path.join(root, "images", v.name + ".png"), compress_level=1)
        if v.normal is not None:
            np.savez(os.path.join(root, normal_folder, v.name + ".npz"),
                     v.normal)
        if v.labels is not None:
            rgb = np.empty(v.labels.shape + (3,), np.uint8)
            rgb[..., 0], rgb[..., 1], rgb[..., 2] = 7, 3, v.labels
            Image.fromarray(rgb, "RGB").save(
                os.path.join(root, "masks", v.name + ".png"),
                compress_level=1)
    rng = np.random.default_rng(seed % (1 << 63))
    theta = rng.uniform(0, 2 * np.pi, init_points)
    z = rng.uniform(-1, 1, init_points)
    rho = np.sqrt(1 - z * z)
    r = float(pop["shell_radius"])
    c = np.asarray(pop["shell_center"], np.float64)
    pts = np.stack([rho * np.cos(theta), rho * np.sin(theta), z], 1) * r + c
    _write_ply(os.path.join(sparse, "points3D.ply"), pts.astype(np.float32),
               rng.integers(0, 256, (init_points, 3)).astype(np.uint8))
    trans, scale = c.tolist(), [1.1 * r] * 3
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump({"trans": trans, "scale": scale}, f)
    return Scene(root, views, width, height, fovx, fovy, trans, scale)
