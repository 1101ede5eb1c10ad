"""Tile binning: (Gaussian, tile) entry expansion + depth ordering
(vcr_gaus_tpu/ops/binning.py).

The sort key and the tie order are the JAX package's: tile id in the high
bits, the top ``db`` bits of the float32 depth pattern below, one stable
sort over entries laid out in expansion order (gaussian index, then
row-major within its tile rect). So each tile's gid sequence equals the JAX
one exactly. The port sizes the entry list per frame: there is no entry
budget, no 128-aligned tile region and no overflow.

On CUDA tensors ``bin_gaussians`` runs the hand-written passes of
``csrc/binning.cu`` over 32-bit keys and int32 gids, with one host wait (the
entry count) and one launch count ``LAUNCHES["binning"]`` a view; on CPU
tensors it runs the plain chain ``bin_gaussians_torch``. Both give the same
``Binning`` bit for bit, and each counts ``render.binning.kernel`` a view:
1 the kernels, 0 the plain chain.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils import tracing
from . import cuda_build

TILE = 16


class Binning(NamedTuple):
    sorted_gid: torch.Tensor     # (E,) int32 gaussian index per entry
    tile_starts: torch.Tensor    # (T,) int32 first entry of each tile
    tile_counts: torch.Tensor    # (T,) int32 entries of each tile
    num_entries: int             # E
    overflow: bool               # always False: the port has no budget
    num_binned: int = 0          # Gaussians with at least one entry


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_grid(width: int, height: int) -> tuple[int, int]:
    return cdiv(width, TILE), cdiv(height, TILE)


def depth_key_bits(num_tiles: int) -> int:
    """Bits of the sort key holding the quantized depth."""
    return 32 - max(1, num_tiles.bit_length())


def bin_gaussians(mean2d: torch.Tensor, radius: torch.Tensor,
                  depth_z: torch.Tensor, width: int, height: int,
                  extents: torch.Tensor | None = None) -> Binning:
    """Bin gaussians to tiles. ``extents`` (N,2) are per-axis pixel extents;
    without them the circular ``radius`` is used on both axes. On CUDA
    tensors the kernels of ``csrc/binning.cu`` bin (float32 mean2d and
    extents, an int32 radius, or it raises); on CPU tensors the plain
    chain ``bin_gaussians_torch``."""
    if mean2d.device.type == "cuda":
        return _bin_kernels(mean2d, radius, depth_z, width, height, extents)
    return bin_gaussians_torch(mean2d, radius, depth_z, width, height,
                               extents)


def bin_gaussians_torch(mean2d: torch.Tensor, radius: torch.Tensor,
                        depth_z: torch.Tensor, width: int, height: int,
                        extents: torch.Tensor | None = None) -> Binning:
    """The plain chain of ``bin_gaussians``, on any device."""
    tracing.count("render.binning.kernel", 0)
    dev = mean2d.device
    n = mean2d.shape[0]
    n_tx, n_ty = tile_grid(width, height)
    num_tiles = n_tx * n_ty
    db = depth_key_bits(num_tiles)

    mean2d = mean2d.detach()
    if extents is None:
        rx = ry = radius.to(torch.float32)
        alive = radius > 0
    else:
        extents = extents.detach()
        rx, ry = extents[:, 0], extents[:, 1]
        alive = (radius > 0) & (rx > 0) & (ry > 0)

    # CUDA getRect semantics: min inclusive, max exclusive; the float ->
    # int conversion truncates toward zero as in the JAX package
    x0 = ((mean2d[:, 0] - rx) / TILE).to(torch.int32).clamp(0, n_tx)
    y0 = ((mean2d[:, 1] - ry) / TILE).to(torch.int32).clamp(0, n_ty)
    x1 = ((mean2d[:, 0] + rx + TILE - 1) / TILE).to(torch.int32).clamp(0, n_tx)
    y1 = ((mean2d[:, 1] + ry + TILE - 1) / TILE).to(torch.int32).clamp(0, n_ty)
    span_w = (x1 - x0).clamp_min(0)
    span_h = (y1 - y0).clamp_min(0)
    count = torch.where(alive, span_w * span_h, 0).to(torch.int64)
    offsets = torch.cumsum(count, 0) - count

    # expansion in gaussian order, row-major within each rect; the entry
    # count sizes it, read with the binned Gaussians' count in the one wait
    # on the device in binning
    with tracing.span("render.binning.readback"):
        e, binned = torch.stack([count.sum(),
                                 torch.count_nonzero(count)]).tolist()
    gid = torch.repeat_interleave(torch.arange(n, device=dev), count,
                                  output_size=e)
    slot = torch.arange(e, device=dev) - offsets[gid]
    sw = span_w.clamp_min(1).to(torch.int64)[gid]
    sy = torch.div(slot, sw, rounding_mode="floor")
    sx = slot - sy * sw
    tile_id = (y0.to(torch.int64)[gid] + sy) * n_tx + x0.to(torch.int64)[gid] + sx

    # quantized depth: the top db bits of the float32 pattern (monotonic for
    # positive depths; the near-plane cull keeps live depths above 0.2)
    bits = depth_z.detach().to(torch.float32).contiguous().view(torch.int32)
    dq = (bits.to(torch.int64) & 0xFFFFFFFF) >> (32 - db)
    key = (tile_id << db) | dq[gid]
    _, order = torch.sort(key, stable=True)

    tile_counts = torch.bincount(tile_id, minlength=num_tiles)
    tile_starts = torch.cumsum(tile_counts, 0) - tile_counts
    return Binning(
        sorted_gid=gid[order].to(torch.int32),
        tile_starts=tile_starts.to(torch.int32),
        tile_counts=tile_counts.to(torch.int32),
        num_entries=e,
        overflow=False,
        num_binned=binned)


def _check_kernel_inputs(mean2d, radius, depth_z, extents) -> None:
    """Raise on what the kernels do not take."""
    n = mean2d.shape[0] if mean2d.ndim == 2 else -1
    if mean2d.dtype != torch.float32 or mean2d.shape != (n, 2):
        raise ValueError(f"mean2d must be (N, 2) float32, got "
                         f"{tuple(mean2d.shape)} {mean2d.dtype}")
    if radius.dtype != torch.int32 or radius.shape != (n,):
        raise ValueError(f"radius must be ({n},) int32, got "
                         f"{tuple(radius.shape)} {radius.dtype}")
    if depth_z.shape != (n,):
        raise ValueError(f"depth_z must be ({n},), got "
                         f"{tuple(depth_z.shape)}")
    if extents is not None and (extents.dtype != torch.float32
                                or extents.shape != (n, 2)):
        raise ValueError(f"extents must be ({n}, 2) float32, got "
                         f"{tuple(extents.shape)} {extents.dtype}")
    given = [mean2d, radius, depth_z] + ([] if extents is None else [extents])
    if any(t.device != mean2d.device for t in given):
        raise ValueError("binning's inputs must lie on one device")
    if n >= 1 << 31:
        raise ValueError(f"{n} slots: the kernels index slots in int32")


def _scratch(nbytes: int, device) -> torch.Tensor:
    if nbytes < 0:
        raise RuntimeError(f"binning scratch query failed: cudaError "
                           f"{-nbytes}")
    return torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)


def _bin_kernels(mean2d, radius, depth_z, width, height, extents) -> Binning:
    """``bin_gaussians`` on the card: the count and its scan, the one
    readback of [E, binned], then the expansion, the sort and the tile
    ranges."""
    _check_kernel_inputs(mean2d, radius, depth_z, extents)
    dev = mean2d.device
    n = mean2d.shape[0]
    n_tx, n_ty = tile_grid(width, height)
    num_tiles = n_tx * n_ty
    db = depth_key_bits(num_tiles)
    m = mean2d.detach().contiguous()
    ext = None if extents is None else extents.detach().contiguous()
    rad = radius.detach().contiguous()
    depth = depth_z.detach().to(torch.float32).contiguous()
    slots = (m.data_ptr(), rad.data_ptr(),
             0 if ext is None else ext.data_ptr(), n, n_tx, n_ty)
    lib = _binning_lib()
    i32 = dict(dtype=torch.int32, device=dev)
    counts, offsets = torch.empty(n, **i32), torch.empty(n, **i32)
    scan_tmp = _scratch(lib.vcr_binning_scan_bytes(n), dev)
    totals = torch.empty(2, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vcr_binning_count(*slots, counts.data_ptr(),
                                    offsets.data_ptr(), scan_tmp.data_ptr(),
                                    scan_tmp.numel(), totals.data_ptr(),
                                    stream)
        if err != 0:
            raise RuntimeError(f"binning count failed: cudaError {err}")
        # the entry count sizes the entry buffers, read with the binned
        # Gaussians' count in binning's one wait on the device
        with tracing.span("render.binning.readback"):
            e, binned = totals.tolist()
        if e >= 1 << 31:
            raise RuntimeError(f"{e} entries: binning's outputs index "
                               "entries in int32")
        keys = [torch.empty(e, **i32) for _ in range(2)]
        vals = [torch.empty(e, **i32) for _ in range(2)]
        sort_tmp = _scratch(lib.vcr_binning_sort_bytes(e), dev)
        tile_starts = torch.empty(num_tiles, **i32)
        tile_counts = torch.empty(num_tiles, **i32)
        selector = ctypes.c_int(0)
        err = lib.vcr_binning_sort(
            *slots, depth.data_ptr(), db, offsets.data_ptr(), e,
            keys[0].data_ptr(), keys[1].data_ptr(), vals[0].data_ptr(),
            vals[1].data_ptr(), sort_tmp.data_ptr(), sort_tmp.numel(),
            tile_starts.data_ptr(), tile_counts.data_ptr(), num_tiles,
            ctypes.byref(selector), stream)
    if err != 0:
        raise RuntimeError(f"binning sort failed: cudaError {err}")
    cuda_build.LAUNCHES["binning"] += 1
    tracing.count("render.binning.kernel", 1)
    return Binning(
        sorted_gid=vals[selector.value],
        tile_starts=tile_starts,
        tile_counts=tile_counts,
        num_entries=e,
        overflow=False,
        num_binned=binned)


@functools.cache
def _binning_lib() -> ctypes.CDLL:
    lib = cuda_build.load("binning")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    slots = [p, p, p, i, i, i]
    for fn in (lib.vcr_binning_scan_bytes, lib.vcr_binning_sort_bytes):
        fn.argtypes = [i]
        fn.restype = ll
    lib.vcr_binning_count.argtypes = slots + [p, p, p, ll, p, p]
    lib.vcr_binning_count.restype = i
    lib.vcr_binning_sort.argtypes = slots + [
        p, i, p, i, p, p, p, p, p, ll, p, p, i, ctypes.POINTER(i), p]
    lib.vcr_binning_sort.restype = i
    return lib
