"""Minimal binary-little-endian PLY reader/writer (no plyfile dependency);
the port's own copy of vcr_gaus_tpu/utils/ply.py.

Writes the exact 3DGS vertex layout the reference produces
(scene/gaussian_model.py:272-311):
  x,y,z, nx,ny,nz, f_dc_0..2, f_rest_0..K, opacity, scale_0..2, rot_0..3
  [, obj_dc_0..S]  — all float32.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}
_INV_DTYPES = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int",
               "u4": "uint", "i1": "char", "i2": "short", "u2": "ushort"}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the 'vertex' element of a PLY file into {property: 1-D array}.

    Supports binary_little_endian and ascii; list properties (faces) of the
    first non-vertex element are returned under '__faces__' when present."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements: list[tuple[str, int, list[tuple[str, str]]]] = []
        cur_props: list[tuple[str, str]] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "comment":
                continue
            elif tok[0] == "element":
                cur_props = []
                elements.append((tok[1], int(tok[2]), cur_props))
            elif tok[0] == "property":
                if tok[1] == "list":
                    cur_props.append((tok[-1], f"list:{tok[2]}:{tok[3]}"))
                else:
                    cur_props.append((tok[2], _PLY_DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break
        out: dict[str, np.ndarray] = {}
        if fmt == "ascii":
            body = f.read().decode("ascii").split("\n")
            row = 0
            for name, count, props in elements:
                if any(p[1].startswith("list") for p in props):
                    faces = []
                    for i in range(count):
                        vals = body[row + i].split()
                        n = int(vals[0])
                        faces.append([int(v) for v in vals[1:1 + n]])
                    out.setdefault("__faces__", np.asarray(faces, np.int64))
                    row += count
                    continue
                data = np.array(
                    [body[row + i].split() for i in range(count)], dtype=np.float64
                )
                for j, (pname, dt) in enumerate(props):
                    key = pname if name == "vertex" else f"{name}.{pname}"
                    out[key] = data[:, j].astype(dt)
                row += count
            return out
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format: {fmt}")
        for name, count, props in elements:
            if any(p[1].startswith("list") for p in props):
                # assume homogeneous list length (triangle faces)
                cnt_dt = _PLY_DTYPES[props[0][1].split(":")[1]]
                idx_dt = _PLY_DTYPES[props[0][1].split(":")[2]]
                if count == 0:
                    out.setdefault("__faces__", np.zeros((0, 3), np.int64))
                    continue
                first_raw = f.read(np.dtype(cnt_dt).itemsize)
                first = int(np.frombuffer(first_raw, cnt_dt)[0])
                row_bytes = (np.dtype(cnt_dt).itemsize
                             + first * np.dtype(idx_dt).itemsize)
                rest = f.read(row_bytes * count - np.dtype(cnt_dt).itemsize)
                buf = np.frombuffer(
                    first_raw + rest,
                    dtype=[("n", cnt_dt), ("v", idx_dt, (first,))],
                    count=count)
                out["__faces__"] = buf["v"].astype(np.int64)
                continue
            dt = np.dtype([(p, d) for p, d in props])
            data = np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
            for pname, _ in props:
                key = pname if name == "vertex" else f"{name}.{pname}"
                out[key] = np.ascontiguousarray(data[pname])
        return out


def write_ply(path: str, props: Mapping[str, np.ndarray],
              faces: np.ndarray | None = None) -> None:
    """Write vertex properties (each 1-D, same length) + optional (F,3) faces
    as binary_little_endian, preserving the given property order."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    names = list(props.keys())
    n = len(next(iter(props.values())))
    dt = np.dtype([(k, np.asarray(props[k]).dtype.str.lstrip("<>=|")) for k in names])
    rec = np.empty(n, dtype=dt)
    for k in names:
        rec[k] = np.asarray(props[k]).reshape(n)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for k in names:
            f.write(f"property {_INV_DTYPES[rec.dtype[k].str.lstrip('<>=|')]} {k}\n"
                    .encode())
        if faces is not None:
            f.write(f"element face {len(faces)}\n".encode())
            f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        f.write(rec.tobytes())
        if faces is not None:
            fdt = np.dtype([("n", "u1"), ("v", "i4", (3,))])
            frec = np.empty(len(faces), dtype=fdt)
            frec["n"] = 3
            frec["v"] = np.asarray(faces, np.int32)
            f.write(frec.tobytes())


def read_points_ply(path: str):
    """Read an x/y/z[,red/green/blue][,nx/ny/nz] point cloud PLY ->
    (points (N,3) f64, colors (N,3) f64 in [0,1], normals (N,3) f64)."""
    d = read_ply(path)
    pts = np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float64)
    if "red" in d:
        colors = np.stack([d["red"], d["green"], d["blue"]], 1).astype(np.float64)
        if colors.max() > 1.0:
            colors = colors / 255.0
    else:
        colors = np.full_like(pts, 0.5)
    if "nx" in d:
        normals = np.stack([d["nx"], d["ny"], d["nz"]], 1).astype(np.float64)
    else:
        normals = np.zeros_like(pts)
    return pts, colors, normals


def write_points_ply(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None,
                     normals: np.ndarray | None = None) -> None:
    """Store a colored point cloud in the reference's storePly layout
    (scene/dataset_readers.py:157-172)."""
    xyz = np.asarray(xyz, np.float32)
    normals = np.zeros_like(xyz) if normals is None else np.asarray(normals, np.float32)
    props = {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": normals[:, 0], "ny": normals[:, 1], "nz": normals[:, 2],
    }
    if rgb is not None:
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb * 255.0 if rgb.max() <= 1.0 else rgb, 0, 255
                          ).astype(np.uint8)
        props.update(red=rgb[:, 0], green=rgb[:, 1], blue=rgb[:, 2])
    write_ply(path, props)
