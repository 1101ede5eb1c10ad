"""Isosurface extraction (vcr_gaus_tpu/meshing/marching.py): a ctypes binding
to marching tetrahedra in C++ (``csrc/marching_tets.cc``), its pure-numpy
oracle, and the connected-component cleanup.

This is host code, as in the JAX package: the fused grid comes to the host
once. The library is built with ``g++`` at first use into the git-ignored
``build/host_kernels/`` of the checkout, keyed by a hash of the source and
the flags, as ``ops/cuda_build.py`` builds the CUDA kernels. A failed build
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

from ..ops.cuda_build import BUILD_DIR, CSRC

SOURCE = CSRC / "marching_tets.cc"
HOST_BUILD_DIR = BUILD_DIR.parent / "host_kernels"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return HOST_BUILD_DIR / f"libmarching_tets-{digest[:16]}.so"


@functools.cache
def _lib() -> ctypes.CDLL:
    so = library_path()
    if not so.exists():
        HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {SOURCE}:\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.marching_tets.restype = ctypes.c_int
    lib.marching_tets.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    return lib


def marching_tets(sdf: np.ndarray, iso: float = 0.0,
                  origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)):
    """The iso-surface of a dense (X,Y,Z) SDF grid; NaN cells mark
    unobserved space and are skipped. Returns (verts (V,3) f32 in world
    units, faces (F,3) i32)."""
    sdf = np.ascontiguousarray(sdf, np.float32)
    nx, ny, nz = sdf.shape
    origin = np.asarray(origin, np.float32)
    spacing = np.asarray(spacing, np.float32)
    lib = _lib()
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)

    vcap, fcap = 1 << 16, 1 << 17
    for _ in range(8):
        verts = np.empty((vcap, 3), np.float32)
        faces = np.empty((fcap, 3), np.int32)
        nv = ctypes.c_int64()
        nf = ctypes.c_int64()
        rc = lib.marching_tets(
            sdf.ctypes.data_as(fp), nx, ny, nz, float(iso),
            origin.ctypes.data_as(fp), spacing.ctypes.data_as(fp),
            verts.ctypes.data_as(fp), vcap,
            faces.ctypes.data_as(ip), fcap,
            ctypes.byref(nv), ctypes.byref(nf))
        if rc == 0:
            return verts[:nv.value].copy(), faces[:nf.value].copy()
        vcap = max(vcap, int(nv.value) + 1)
        fcap = max(fcap, int(nf.value) + 1)
    raise RuntimeError("marching_tets capacity loop failed to converge")


def marching_tets_numpy(sdf: np.ndarray, iso: float = 0.0,
                        origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)):
    """Pure-numpy reference (slow; the test oracle): the C++ kernel's cases
    and decomposition, without vertex dedup."""
    nx, ny, nz = sdf.shape
    origin = np.asarray(origin, np.float64)
    spacing = np.asarray(spacing, np.float64)
    tets = [(0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
            (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6)]
    tris = []

    def corner(i, j, k, c):
        return (i + (c & 1), j + ((c >> 1) & 1), k + ((c >> 2) & 1))

    def interp(pa, sa, pb, sb):
        t = np.clip((iso - sa) / (sb - sa), 0, 1)
        pa = origin + spacing * np.asarray(pa)
        pb = origin + spacing * np.asarray(pb)
        return pa + t * (pb - pa)

    for i in range(nx - 1):
        for j in range(ny - 1):
            for k in range(nz - 1):
                cs = [corner(i, j, k, c) for c in range(8)]
                ss = [sdf[c] for c in cs]
                if any(np.isnan(v) for v in ss):
                    continue
                for T in tets:
                    lo = [c for c in T if ss[c] < iso]
                    hi = [c for c in T if ss[c] >= iso]
                    if not lo or not hi:
                        continue
                    if len(lo) == 1:
                        a = lo[0]
                        tris.append([interp(cs[a], ss[a], cs[b], ss[b])
                                     for b in hi])
                    elif len(lo) == 3:
                        a = hi[0]
                        tris.append([interp(cs[a], ss[a], cs[b], ss[b])
                                     for b in lo])
                    else:
                        a, b = lo
                        c, d = hi
                        vac = interp(cs[a], ss[a], cs[c], ss[c])
                        vad = interp(cs[a], ss[a], cs[d], ss[d])
                        vbc = interp(cs[b], ss[b], cs[c], ss[c])
                        vbd = interp(cs[b], ss[b], cs[d], ss[d])
                        tris.append([vac, vad, vbd])
                        tris.append([vac, vbd, vbc])
    if not tris:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    verts = np.asarray(tris, np.float64).reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return verts, faces


def keep_largest_components(verts: np.ndarray, faces: np.ndarray,
                            n_keep: int = 1, min_faces: int = 0):
    """Keep the n_keep largest face-connected components (or all with >=
    min_faces faces when n_keep <= 0), in the JAX package's order of
    ties."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    if len(faces) == 0:
        return verts, faces
    nv = len(verts)
    # vertices sharing a face are connected
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(nv, nv))
    n_comp, labels = connected_components(adj, directed=False)
    face_lab = labels[faces[:, 0]]
    counts = np.bincount(face_lab, minlength=n_comp)
    if n_keep > 0:
        keep_labels = np.argsort(-counts)[:n_keep]
        keep = np.isin(face_lab, keep_labels)
    else:
        keep = counts[face_lab] >= min_faces
    faces = faces[keep]
    used = np.unique(faces)
    remap = np.full(nv, -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces].astype(np.int32)
