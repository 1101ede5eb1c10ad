"""Binning + forward tile compositing (vcr_gaus_tpu/ops/rasterize.py).

``rasterize_forward`` is the wrapper of the hand-written CUDA kernel
``csrc/rasterize_fwd.cu``, the port of the TPU kernel ``rasterize_forward``
(vcr_gaus_tpu/ops/rasterize_tpu.py). Given a CUDA tensor it launches the
kernel or raises; only a tensor on the CPU takes the kernel's plain version,
``composite_tiles_torch``, which runs over the same sorted entries and tile
ranges with the same rules (batches of 256 entries per tile, a tile-wide
early stop once no pixel has T >= 1e-4).
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch
from torch.profiler import record_function

from . import binning as B
from . import cuda_build
from . import projection as PF
from .rasterize_ref import ALPHA_CAP, ALPHA_EPS, out_channels

T_EPS = 1e-4
BATCH = 256              # entries per compositing round (the TPU chunk G)
TILE = B.TILE
MAX_CH_SEM = 8           # the kernel is instantiated for 0..8 channels
DEPTH_MODES = ("traditional", "intersection")

# kernel name -> launches since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else
LAUNCHES: Counter = Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def composite_tiles_torch(feats: torch.Tensor, sorted_gid: torch.Tensor,
                          tile_starts: torch.Tensor, tile_counts: torch.Tensor,
                          cam: torch.Tensor, n_tx: int, ch_sem: int,
                          depth_mode: str,
                          tile_ids: torch.Tensor | None = None,
                          group: int = 256):
    """The plain version of the compositing kernel, for the tiles
    ``tile_ids`` (default: all of them). Returns (out (T_sel, 9+S, 256) in
    row-major pixel order within each tile, batches_done (T_sel,) int32).
    Tiles go through ``group`` at a time, one 256-entry batch per round."""
    dev = feats.device
    if tile_ids is None:
        tile_ids = torch.arange(tile_counts.shape[0], device=dev)
    tile_ids = tile_ids.to(dev, torch.int64)
    n_sel = tile_ids.shape[0]
    c_out = out_channels(ch_sem)
    out = torch.zeros((n_sel, c_out, TILE * TILE), dtype=torch.float32,
                      device=dev)
    batches = torch.zeros(n_sel, dtype=torch.int32, device=dev)
    pix = torch.arange(TILE * TILE, device=dev)
    lane = torch.arange(BATCH, device=dev)
    gid_all = sorted_gid.to(torch.int64)
    fx, fy, cx, cy = cam[0], cam[1], cam[2], cam[3]
    bg = cam[4:7]

    for g0 in range(0, n_sel, group):
        ids = tile_ids[g0:g0 + group]
        ng = ids.shape[0]
        px = ((ids % n_tx) * TILE)[:, None] + pix[None] % TILE
        py = ((ids // n_tx) * TILE)[:, None] + pix[None] // TILE
        px, py = px.to(torch.float32), py.to(torch.float32)
        start = tile_starts[ids].to(torch.int64)
        count = tile_counts[ids].to(torch.int64)
        if depth_mode == "intersection":
            dirx = (px + 0.5 - cx) / fx
            diry = (py + 0.5 - cy) / fy
            inv_n = torch.rsqrt(dirx * dirx + diry * diry + 1.0)
            dirx, diry, dirz = dirx * inv_n, diry * inv_n, inv_n
        T = torch.ones((ng, TILE * TILE), dtype=torch.float32, device=dev)
        acc = torch.zeros((ng, TILE * TILE, 6 + ch_sem), dtype=torch.float32,
                          device=dev)
        acc_d = torch.zeros_like(T)
        acc_d2 = torch.zeros_like(T)
        done = torch.zeros(ng, dtype=torch.int32, device=dev)
        nbatch = int((count.max() + BATCH - 1) // BATCH) if ng else 0
        for k in range(nbatch):
            run = (k * BATCH < count) & (T.amax(dim=1) >= T_EPS)
            sel = torch.nonzero(run).squeeze(1)
            if sel.numel() == 0:
                break
            pos = k * BATCH + lane[None]                          # (S, G)
            valid = pos < count[sel, None]
            idx = torch.where(valid, start[sel, None] + pos, 0)
            f = feats[gid_all[idx]]                               # (S, G, F)
            spx, spy = px[sel][:, :, None], py[sel][:, :, None]    # (S, P, 1)
            dx = spx - f[:, None, :, PF.F_MEAN_X]                 # (S, P, G)
            dy = spy - f[:, None, :, PF.F_MEAN_Y]
            A = f[:, None, :, PF.F_CONIC_A]
            Bc = f[:, None, :, PF.F_CONIC_B]
            C = f[:, None, :, PF.F_CONIC_C]
            power = -0.5 * (A * dx * dx + C * dy * dy) - Bc * dx * dy
            alpha_raw = f[:, None, :, PF.F_OPACITY] * torch.exp(power)
            live = (power <= 0.0) & (alpha_raw >= ALPHA_EPS) & valid[:, None, :]
            alpha = torch.where(live, torch.clamp_max(alpha_raw, ALPHA_CAP),
                                0.0)
            one_minus = 1.0 - alpha
            cum = torch.cumprod(one_minus, dim=2)
            t_excl = torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]],
                               dim=2)
            w = alpha * (T[sel][:, :, None] * t_excl)
            if depth_mode == "intersection":
                denom = (dirx[sel][:, :, None] * f[:, None, :, PF.F_NORMAL]
                         + diry[sel][:, :, None] * f[:, None, :, PF.F_NORMAL + 1]
                         + dirz[sel][:, :, None] * f[:, None, :, PF.F_NORMAL + 2])
                denom = torch.where(torch.abs(denom) < 1e-2,
                                    torch.where(denom < 0, -1e-2, 1e-2), denom)
                d = f[:, None, :, PF.F_PLANE_D] / denom
            else:
                d = f[:, None, :, PF.F_DEPTH_Z]
            wd = w * d
            acc_d[sel] += wd.sum(dim=2)
            acc_d2[sel] += (wd * d).sum(dim=2)
            acc[sel] += torch.bmm(w, f[:, :, PF.F_NORMAL:PF.F_NORMAL + 6 + ch_sem])
            T[sel] = T[sel] * cum[..., -1]
            done[sel] += 1
        # acc columns follow the feature rows: normal(3), rgb(3), sem(S)
        cols = [acc[..., 3:6] + T[..., None] * bg, acc[..., 0:3],
                acc_d[..., None], acc_d2[..., None], (1.0 - T)[..., None],
                acc[..., 6:]]
        out[g0:g0 + ng] = torch.cat(cols, dim=2).transpose(1, 2)
        batches[g0:g0 + ng] = done
    return out, batches


def tiles_to_image(tiles: torch.Tensor, n_tx: int, n_ty: int, width: int,
                   height: int) -> torch.Tensor:
    """(T, C, 256) per-tile pixels -> the (C, H, W) image."""
    c = tiles.shape[1]
    img = tiles.reshape(n_ty, n_tx, c, TILE, TILE).permute(2, 0, 3, 1, 4)
    return img.reshape(c, n_ty * TILE, n_tx * TILE)[:, :height, :width]


def _check(name, t, dtype):
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor, got "
                         f"{t.dtype} (contiguous={t.is_contiguous()})")


def rasterize_forward(feats: torch.Tensor, binn: B.Binning, cam: torch.Tensor,
                      width: int, height: int, ch_sem: int, depth_mode: str):
    """Composite the binned entries. feats (N, 14+S) f32; cam (8,) f32
    [fx, fy, cx, cy, bg_r, bg_g, bg_b, 0]. Returns (img (9+S, H, W),
    batches_done (T,) int32: the 256-entry batches each tile composited
    before its early stop)."""
    if depth_mode not in DEPTH_MODES:
        raise ValueError(f"depth_mode must be one of {DEPTH_MODES}")
    if not 0 <= ch_sem <= MAX_CH_SEM:
        raise ValueError(f"ch_sem must be 0..{MAX_CH_SEM}, got {ch_sem}")
    if feats.ndim != 2 or feats.shape[1] != PF.feature_dim(ch_sem):
        raise ValueError(f"feats must be (N, {PF.feature_dim(ch_sem)}), got "
                         f"{tuple(feats.shape)}")
    n_tx, n_ty = B.tile_grid(width, height)
    if binn.tile_counts.shape[0] != n_tx * n_ty or cam.shape != (8,):
        raise ValueError("binning or camera does not match the image size")
    dev = feats.device
    for name, t in (("sorted_gid", binn.sorted_gid),
                    ("tile_starts", binn.tile_starts),
                    ("tile_counts", binn.tile_counts), ("cam", cam)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {dev}")

    _check("feats", feats, torch.float32)
    _check("cam", cam, torch.float32)
    for name in ("sorted_gid", "tile_starts", "tile_counts"):
        _check(name, getattr(binn, name), torch.int32)

    if dev.type == "cpu":
        tiles, batches = composite_tiles_torch(
            feats, binn.sorted_gid, binn.tile_starts, binn.tile_counts, cam,
            n_tx, ch_sem, depth_mode)
        return tiles_to_image(tiles, n_tx, n_ty, width, height), batches
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    out = torch.empty((out_channels(ch_sem), height, width),
                      dtype=torch.float32, device=dev)
    batches = torch.empty(n_tx * n_ty, dtype=torch.int32, device=dev)
    kernel = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernel(
            feats.data_ptr(), binn.sorted_gid.data_ptr(),
            binn.tile_starts.data_ptr(), binn.tile_counts.data_ptr(),
            cam.data_ptr(), n_tx, n_ty, width, height, ch_sem,
            int(depth_mode == "intersection"), out.data_ptr(),
            batches.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rasterize_fwd launch failed: cudaError {err}")
    LAUNCHES["rasterize_fwd"] += 1
    return out, batches


@functools.cache
def _kernel():
    fn = cuda_build.load("rasterize_fwd").vcr_rasterize_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 5 + [i] * 6 + [p] * 3
    fn.restype = ctypes.c_int
    return fn


def rasterize_image(feats: torch.Tensor, mean2d: torch.Tensor,
                    radius: torch.Tensor, depth_z: torch.Tensor,
                    cam: torch.Tensor, width: int, height: int, ch_sem: int,
                    depth_mode: str, extents: torch.Tensor | None = None):
    """Bin + composite. Returns (img (9+S, H, W), Binning): rgb (3,
    bg-blended), normal (3), sum w*d, sum w*d^2, alpha, sem (S)."""
    with record_function("render.binning"):
        binn = B.bin_gaussians(mean2d, radius, depth_z, width, height,
                               extents=extents)
    with record_function("render.composite"):
        img, _ = rasterize_forward(feats, binn, cam, width, height, ch_sem,
                                   depth_mode)
    return img, binn
