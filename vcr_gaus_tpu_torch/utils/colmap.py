"""COLMAP sparse-model parsers and writers (cameras/images/points3D);
the port's own copy of vcr_gaus_tpu/utils/colmap.py.

The binary format is COLMAP's public serialization; this is a fresh numpy
implementation of it (the reference vendors its own copy in
scene/colmap_loader.py).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

# camera_model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (w,x,y,z) world->cam rotation
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{np_}d"))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read(f, "<Q")
            f.seek(24 * n2d, os.SEEK_CUR)  # xy (2d) + point3D id (q) per feature
            imgs[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode())
    return imgs


def read_points3d_binary(path: str):
    """-> xyz (N,3) f64, rgb (N,3) u8, err (N,) f64."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        for i in range(n):
            data = _read(f, "<Q3d3Bd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return xyz, rgb, err


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = ColmapCamera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array([float(v) for v in el[4:]]))
    return cams


def read_images_text(path: str) -> dict[int, ColmapImage]:
    imgs = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    # each image is a meta line followed by a 2D-feature line that COLMAP
    # leaves EMPTY for images without triangulated points — so alternate
    # state rather than slicing every other non-blank line
    expect_meta = True
    for ln in lines:
        if expect_meta:
            if not ln:
                continue
            el = ln.split()
            imgs[int(el[0])] = ColmapImage(
                int(el[0]), np.array([float(v) for v in el[1:5]]),
                np.array([float(v) for v in el[5:8]]), int(el[8]), el[9])
            expect_meta = False
        else:
            expect_meta = True
    return imgs


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xyz.append([float(v) for v in el[1:4]])
            rgb.append([int(v) for v in el[4:7]])
            err.append(float(el[7]))
    return (np.asarray(xyz), np.asarray(rgb, np.uint8), np.asarray(err))


def write_images_binary(images: dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for img in images.values():
            f.write(struct.pack("<i", img.id))
            f.write(struct.pack("<4d", *img.qvec))
            f.write(struct.pack("<3d", *img.tvec))
            f.write(struct.pack("<i", img.camera_id))
            f.write(img.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(xyz: np.ndarray, rgb: np.ndarray,
                          path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<Q3d3Bd", i + 1, *xyz[i],
                                *rgb[i].astype(np.uint8), 1.0))
            f.write(struct.pack("<Q", 0))


def write_cameras_binary(cams: dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            f.write(struct.pack("<iiQQ", cam.id, CAMERA_MODEL_IDS[cam.model],
                                cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))
