"""Tile binning: (Gaussian, tile) entry expansion + depth ordering
(vcr_gaus_tpu/ops/binning.py), as plain tensor code.

The sort key and the tie order are the JAX package's: tile id in the high
bits, the top ``db`` bits of the float32 depth pattern below, one stable
sort over entries laid out in expansion order (gaussian index, then
row-major within its tile rect). So each tile's gid sequence equals the JAX
one exactly. The port sizes the entry list per frame: there is no entry
budget, no 128-aligned tile region and no overflow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import tracing

TILE = 16


class Binning(NamedTuple):
    sorted_gid: torch.Tensor     # (E,) int32 gaussian index per entry
    tile_starts: torch.Tensor    # (T,) int32 first entry of each tile
    tile_counts: torch.Tensor    # (T,) int32 entries of each tile
    num_entries: int             # E
    overflow: bool               # always False: the port has no budget


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
    without them the circular ``radius`` is used on both axes."""
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
    # count sizes it, the one wait on the device in binning
    with tracing.span("render.binning.readback"):
        e = int(count.sum())
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
        overflow=False)
