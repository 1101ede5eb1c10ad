"""Binning + differentiable tile compositing (vcr_gaus_tpu/ops/rasterize.py).

``rasterize_forward`` wraps the hand-written CUDA kernel
``csrc/rasterize_fwd.cu``, the port of the TPU kernel ``rasterize_forward``
(vcr_gaus_tpu/ops/rasterize_tpu.py); ``rasterize_backward`` wraps
``csrc/rasterize_bwd.cu``, the port of ``rasterize_backward`` fused with the
per-Gaussian reduction. Given a CUDA tensor each launches its kernel or
raises; only a tensor on the CPU takes the kernel's plain version
(``composite_tiles_torch``, ``composite_tiles_backward_torch``), which runs
over the same sorted entries and tile ranges with the same rules (batches
of 256 entries per tile, a tile-wide early stop once no pixel has
T >= 1e-4, and a backward over the batches the forward composited).

``rasterize_image`` joins binning and the two kernels through the
``torch.autograd.Function`` ``_Composite``: gradients reach the packed
features and, as the gradient of the zero ``dummy`` input, the |d mean2d|
densification stream. Binning is not differentiated: mean2d, radius and
depth_z enter it detached, as at the JAX package's custom-VJP boundary.

``rasterize_stats`` wraps ``csrc/rasterize_stats.cu``, the port of the TPU
kernel ``rasterize_stats`` fused with its per-Gaussian scatter: per
Gaussian, the live in-image pixels its entries hit and the sum of their
blending weights. Its plain version is ``composite_tiles_stats_torch``;
``rasterize_entry_stats`` bins and calls it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils import tracing
from . import binning as B
from . import cuda_build
from . import projection as PF
from .cuda_build import LAUNCHES
from .rasterize_ref import ALPHA_CAP, ALPHA_EPS, out_channels

T_EPS = 1e-4
BATCH = 256              # entries per compositing round (the TPU chunk G)
GROUP = 256              # tiles per round of a plain version's loop
TILE = B.TILE
MAX_CH_SEM = 8           # the kernel is instantiated for 0..8 channels
DEPTH_MODES = ("traditional", "intersection")

def reset_launch_counts() -> None:
    LAUNCHES.clear()


def warp_of_pixel(patches: bool, side: int = TILE) -> torch.Tensor:
    """(side^2,) warp of each pixel of a ``side`` x ``side`` tile
    (row-major): under the kernels' pixel-to-thread map for ``patches``
    (csrc/composite_pair.cuh's TilePixelMap: 2 pixels a thread, a warp on
    each 8x8 patch), else under a thread per pixel (32 consecutive pixels a
    warp), the map the kernels had before. Used to count warp steps."""
    pix = torch.arange(side * side)
    x, y = pix % side, pix // side
    return (y // 8) * (side // 8) + x // 8 if patches else pix // 32


def _tile_geometry(ids: torch.Tensor, n_tx: int, cam: torch.Tensor,
                   depth_mode: str):
    """(px, py, rays) of the tiles ``ids``: (T_sel, 256) integer pixel
    coordinates as float32, and in intersection mode the unit rays
    (dirx, diry, dirz) through the half-pixel centres, else None."""
    pix = torch.arange(TILE * TILE, device=ids.device)
    px = (((ids % n_tx) * TILE)[:, None] + pix[None] % TILE).to(torch.float32)
    py = (((ids // n_tx) * TILE)[:, None] + pix[None] // TILE).to(torch.float32)
    if depth_mode != "intersection":
        return px, py, None
    dirx = (px + 0.5 - cam[2]) / cam[0]
    diry = (py + 0.5 - cam[3]) / cam[1]
    inv_n = torch.rsqrt(dirx * dirx + diry * diry + 1.0)
    return px, py, (dirx * inv_n, diry * inv_n, inv_n)


class _Pairs(NamedTuple):
    """One batch's (tile, pixel, entry) terms, (S, P, G) or broadcastable."""
    dx: torch.Tensor
    dy: torch.Tensor
    alpha_raw: torch.Tensor
    live: torch.Tensor
    alpha: torch.Tensor
    cum: torch.Tensor            # inclusive prod of (1 - alpha) in the batch
    t_excl: torch.Tensor         # T before each entry
    w: torch.Tensor              # alpha * t_excl
    d: torch.Tensor              # depth_z, or plane_d / denom
    denom: torch.Tensor | None   # clamped ray . n (intersection mode)
    clamped: torch.Tensor | None


def _batch_pairs(f: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                 T: torch.Tensor, valid: torch.Tensor, rays,
                 pvalid: torch.Tensor | None = None) -> _Pairs:
    """The kernels' per-pair math, in their order, for one batch: f (S, G, F)
    feature rows of the selected tiles' entries, px, py, T (S, P) of their
    pixels, valid (S, G), rays None or the selected tiles' rays, pvalid
    None or the (S, P) mask of the pixels allowed to composite."""
    def col(c):
        return f[:, None, :, c]                                   # (S, 1, G)

    dx = px[:, :, None] - col(PF.F_MEAN_X)                        # (S, P, G)
    dy = py[:, :, None] - col(PF.F_MEAN_Y)
    power = (-0.5 * (col(PF.F_CONIC_A) * dx * dx + col(PF.F_CONIC_C) * dy * dy)
             - col(PF.F_CONIC_B) * dx * dy)
    alpha_raw = col(PF.F_OPACITY) * torch.exp(power)
    live = (power <= 0.0) & (alpha_raw >= ALPHA_EPS) & valid[:, None, :]
    if pvalid is not None:
        live = live & pvalid[:, :, None]
    alpha = torch.where(live, torch.clamp_max(alpha_raw, ALPHA_CAP), 0.0)
    cum = torch.cumprod(1.0 - alpha, dim=2)
    t_excl = T[:, :, None] * torch.cat([torch.ones_like(cum[..., :1]),
                                        cum[..., :-1]], dim=2)
    denom = clamped = None
    if rays is None:
        d = col(PF.F_DEPTH_Z)
    else:
        denom = (rays[0][:, :, None] * col(PF.F_NORMAL)
                 + rays[1][:, :, None] * col(PF.F_NORMAL + 1)
                 + rays[2][:, :, None] * col(PF.F_NORMAL + 2))
        clamped = torch.abs(denom) < 1e-2
        denom = torch.where(clamped, torch.where(denom < 0, -1e-2, 1e-2),
                            denom)
        d = col(PF.F_PLANE_D) / denom
    return _Pairs(dx, dy, alpha_raw, live, alpha, cum, t_excl,
                  alpha * t_excl, d, denom, clamped)


def composite_tiles_torch(feats: torch.Tensor, sorted_gid: torch.Tensor,
                          tile_starts: torch.Tensor, tile_counts: torch.Tensor,
                          cam: torch.Tensor, n_tx: int, ch_sem: int,
                          depth_mode: str,
                          tile_ids: torch.Tensor | None = None,
                          group: int = GROUP):
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
    lane = torch.arange(BATCH, device=dev)
    gid_all = sorted_gid.to(torch.int64)
    bg = cam[4:7]

    for g0 in range(0, n_sel, group):
        ids = tile_ids[g0:g0 + group]
        ng = ids.shape[0]
        px, py, rays = _tile_geometry(ids, n_tx, cam, depth_mode)
        start = tile_starts[ids].to(torch.int64)
        count = tile_counts[ids].to(torch.int64)
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
            p = _batch_pairs(f, px[sel], py[sel], T[sel], valid,
                             None if rays is None else [r[sel] for r in rays])
            wd = p.w * p.d
            acc_d[sel] += wd.sum(dim=2)
            acc_d2[sel] += (wd * p.d).sum(dim=2)
            acc[sel] += torch.bmm(p.w,
                                  f[:, :, PF.F_NORMAL:PF.F_NORMAL + 6 + ch_sem])
            T[sel] = T[sel] * p.cum[..., -1]
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


def image_to_tiles(img: torch.Tensor, n_tx: int, n_ty: int) -> torch.Tensor:
    """(C, H, W) image -> (T, C, 256) per-tile pixels, zero past the image."""
    c, h, w = img.shape
    pad = torch.nn.functional.pad(img, (0, n_tx * TILE - w, 0, n_ty * TILE - h))
    tiles = pad.reshape(c, n_ty, TILE, n_tx, TILE).permute(1, 3, 0, 2, 4)
    return tiles.reshape(n_tx * n_ty, c, TILE * TILE)


def composite_tiles_backward_torch(feats: torch.Tensor,
                                   sorted_gid: torch.Tensor,
                                   tile_starts: torch.Tensor,
                                   tile_counts: torch.Tensor,
                                   batches_done: torch.Tensor,
                                   cam: torch.Tensor, img: torch.Tensor,
                                   g_img: torch.Tensor, ch_sem: int,
                                   depth_mode: str,
                                   tile_ids: torch.Tensor | None = None,
                                   group: int = GROUP) -> torch.Tensor:
    """The plain version of the backward kernel: the (N, 16+S) gradient of
    sum(g_img * img) over the packed features (columns 0..13+S) and the
    |d mean2d| stream (the last two), from the tiles ``tile_ids`` (default:
    all). ``img`` is the forward image, ``batches_done`` the forward's
    batches per tile. Written out batch by batch as the kernel walks them:
    T front to back, the later entries' sum as the pixel's total (read from
    ``img``) minus the running prefix."""
    dev = feats.device
    n, nfeat = feats.shape
    c_acc = 6 + ch_sem
    height, width = img.shape[1:]
    n_tx, n_ty = B.tile_grid(width, height)
    if tile_ids is None:
        tile_ids = torch.arange(n_tx * n_ty, device=dev)
    tile_ids = tile_ids.to(dev, torch.int64)
    img_t = image_to_tiles(img, n_tx, n_ty)[tile_ids].transpose(1, 2)
    g_t = image_to_tiles(g_img, n_tx, n_ty)[tile_ids].transpose(1, 2)
    grad = torch.zeros((n, nfeat + 2), dtype=torch.float32, device=dev)
    lane = torch.arange(BATCH, device=dev)
    gid_all = sorted_gid.to(torch.int64)
    bg = cam[4:7]

    for g0 in range(0, tile_ids.shape[0], group):
        ids = tile_ids[g0:g0 + group]
        ng = ids.shape[0]
        px, py, rays = _tile_geometry(ids, n_tx, cam, depth_mode)
        start = tile_starts[ids].to(torch.int64)
        count = tile_counts[ids].to(torch.int64)
        done = batches_done[ids].to(torch.int64)
        o, g = img_t[g0:g0 + ng], g_t[g0:g0 + ng]            # (ng, P, C)
        g_rgb, g_nrm = g[..., 0:3], g[..., 3:6]
        g_d, g_d2 = g[..., 6], g[..., 7]
        # gradient of the composited columns, in feature order
        g_acc = torch.cat([g_nrm, g_rgb, g[..., 9:]], dim=2)
        t_final = 1.0 - o[..., 8]
        tb = t_final * ((bg * g_rgb).sum(-1) - g[..., 8])
        s_total = ((g_rgb * (o[..., 0:3] - t_final[..., None] * bg)).sum(-1)
                   + (g_nrm * o[..., 3:6]).sum(-1) + g_d * o[..., 6]
                   + g_d2 * o[..., 7] + (g[..., 9:] * o[..., 9:]).sum(-1))
        T = torch.ones((ng, TILE * TILE), dtype=torch.float32, device=dev)
        prefix = torch.zeros_like(T)
        for k in range(int(done.max()) if ng else 0):
            sel = torch.nonzero(k < done).squeeze(1)
            pos = k * BATCH + lane[None]                          # (S, G)
            valid = pos < count[sel, None]
            gid = gid_all[torch.where(valid, start[sel, None] + pos, 0)]
            f = feats[gid]                                        # (S, G, F)
            rsel = None if rays is None else [r[sel] for r in rays]
            p = _batch_pairs(f, px[sel], py[sel], T[sel], valid, rsel)
            A, Bc, C = (f[:, None, :, c] for c in
                        (PF.F_CONIC_A, PF.F_CONIC_B, PF.F_CONIC_C))
            gdd = g_d[sel][:, :, None], g_d2[sel][:, :, None]
            gacc = g_acc[sel]                                      # (S, P, c)
            s = (torch.bmm(gacc, f[:, :, PF.F_NORMAL:PF.F_NORMAL + c_acc]
                           .transpose(1, 2))
                 + p.d * (gdd[0] + p.d * gdd[1]))
            u = p.w * s
            incl = prefix[sel][:, :, None] + torch.cumsum(u, dim=2)
            suffix = s_total[sel][:, :, None] - incl
            dalpha = torch.where(
                p.live, p.t_excl * s - (suffix + tb[sel][:, :, None])
                / (1.0 - p.alpha), 0.0)
            dpw = torch.where(p.alpha_raw > ALPHA_CAP, 0.0, dalpha * p.alpha)
            dx, dy = p.dx, p.dy
            u1 = dpw * (A * dx + Bc * dy)
            u2 = dpw * (C * dy + Bc * dx)
            op = torch.clamp_min(f[:, :, PF.F_OPACITY], 1e-12)
            gd = p.w * (gdd[0] + 2.0 * p.d * gdd[1])
            zero = torch.zeros_like(op)
            cols = [u1.sum(1), u2.sum(1), -0.5 * (dpw * dx * dx).sum(1),
                    -(dpw * dx * dy).sum(1), -0.5 * (dpw * dy * dy).sum(1),
                    dpw.sum(1) / op]
            g_feat = torch.bmm(p.w.transpose(1, 2), gacc)          # (S, G, c)
            if rays is None:
                cols += [gd.sum(1), zero]
            else:
                inv = 1.0 / p.denom
                coef = torch.where(p.clamped, 0.0,
                                   -gd * f[:, None, :, PF.F_PLANE_D] * inv * inv)
                g_n = torch.stack([(coef * r[:, :, None]).sum(1) for r in rsel],
                                  dim=2)
                cols += [zero, (gd * inv).sum(1)]
                g_feat = torch.cat([g_feat[..., :3] + g_n, g_feat[..., 3:]], 2)
            per_entry = torch.cat(
                [torch.stack(cols, dim=2), g_feat,
                 torch.stack([u1.abs().sum(1), u2.abs().sum(1)], dim=2)],
                dim=2)                                             # (S, G, F+2)
            grad.index_add_(0, gid[valid], per_entry[valid])
            T[sel] = T[sel] * p.cum[..., -1]
            prefix[sel] = incl[..., -1]
    return grad


def _check(name, t, dtype):
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor, got "
                         f"{t.dtype} (contiguous={t.is_contiguous()})")


def _check_binned(feats, binn, width, height, **more):
    """The binning's size, and the types, contiguity and devices of feats,
    the binning and ``more`` (further name=(tensor, dtype) pairs)."""
    n_tx, n_ty = B.tile_grid(width, height)
    if binn.tile_counts.shape[0] != n_tx * n_ty:
        raise ValueError("binning does not match the image size")
    tensors = {"feats": (feats, torch.float32),
               **{k: (getattr(binn, k), torch.int32)
                  for k in ("sorted_gid", "tile_starts", "tile_counts")},
               **more}
    for name, (t, dtype) in tensors.items():
        if t.device != feats.device:
            raise ValueError(f"{name} is on {t.device}, feats on "
                             f"{feats.device}")
        _check(name, t, dtype)
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {feats.device}")


def _check_inputs(feats, binn, cam, width, height, ch_sem, depth_mode,
                  **more):
    """Shapes, types, contiguity and devices the compositing kernels take;
    ``more`` names further (tensor, dtype) pairs."""
    if depth_mode not in DEPTH_MODES:
        raise ValueError(f"depth_mode must be one of {DEPTH_MODES}")
    if not 0 <= ch_sem <= MAX_CH_SEM:
        raise ValueError(f"ch_sem must be 0..{MAX_CH_SEM}, got {ch_sem}")
    if feats.ndim != 2 or feats.shape[1] != PF.feature_dim(ch_sem):
        raise ValueError(f"feats must be (N, {PF.feature_dim(ch_sem)}), got "
                         f"{tuple(feats.shape)}")
    if cam.shape != (8,):
        raise ValueError(f"cam must be (8,), got {tuple(cam.shape)}")
    _check_binned(feats, binn, width, height, cam=(cam, torch.float32),
                  **more)


def rasterize_forward(feats: torch.Tensor, binn: B.Binning, cam: torch.Tensor,
                      width: int, height: int, ch_sem: int, depth_mode: str):
    """Composite the binned entries. feats (N, 14+S) f32; cam (8,) f32
    [fx, fy, cx, cy, bg_r, bg_g, bg_b, 0]. Returns (img (9+S, H, W),
    batches_done (T,) int32: the 256-entry batches each tile composited
    before its early stop)."""
    _check_inputs(feats, binn, cam, width, height, ch_sem, depth_mode)
    n_tx, n_ty = B.tile_grid(width, height)
    dev = feats.device
    if dev.type == "cpu":
        tiles, batches = composite_tiles_torch(
            feats, binn.sorted_gid, binn.tile_starts, binn.tile_counts, cam,
            n_tx, ch_sem, depth_mode)
        img = tiles_to_image(tiles, n_tx, n_ty, width, height).contiguous()
        return img, batches

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


def rasterize_backward(feats: torch.Tensor, binn: B.Binning,
                       cam: torch.Tensor, img: torch.Tensor,
                       g_img: torch.Tensor, batches_done: torch.Tensor,
                       width: int, height: int, ch_sem: int,
                       depth_mode: str) -> torch.Tensor:
    """The gradient of sum(g_img * img) for the forward call that gave
    ``img`` and ``batches_done``: (N, 16+S) f32, the packed-feature columns
    then the |d mean2d| x, y stream."""
    c_out = out_channels(ch_sem)
    if img.shape != (c_out, height, width) or g_img.shape != img.shape:
        raise ValueError(f"img and g_img must be ({c_out}, {height}, {width})")
    _check_inputs(feats, binn, cam, width, height, ch_sem, depth_mode,
                  img=(img, torch.float32), g_img=(g_img, torch.float32),
                  batches_done=(batches_done, torch.int32))
    if feats.device.type == "cpu":
        return composite_tiles_backward_torch(
            feats, binn.sorted_gid, binn.tile_starts, binn.tile_counts,
            batches_done, cam, img, g_img, ch_sem, depth_mode)

    n_tx, n_ty = B.tile_grid(width, height)
    grad = torch.zeros((feats.shape[0], feats.shape[1] + 2),
                       dtype=torch.float32, device=feats.device)
    kernel = _bwd_kernel()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = kernel(
            feats.data_ptr(), binn.sorted_gid.data_ptr(),
            binn.tile_starts.data_ptr(), binn.tile_counts.data_ptr(),
            batches_done.data_ptr(), cam.data_ptr(), img.data_ptr(),
            g_img.data_ptr(), n_tx, n_ty, width, height, ch_sem,
            int(depth_mode == "intersection"), grad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rasterize_bwd launch failed: cudaError {err}")
    LAUNCHES["rasterize_bwd"] += 1
    return grad


@functools.cache
def _bwd_kernel():
    fn = cuda_build.load("rasterize_bwd").vcr_rasterize_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [i] * 6 + [p] * 2
    fn.restype = ctypes.c_int
    return fn


class _Composite(torch.autograd.Function):
    """Forward = the compositing kernel, backward = the backward kernel.
    Inputs feats (N, 14+S) and dummy (N, 2); the gradient of dummy is the
    |d mean2d| stream."""

    @staticmethod
    def forward(ctx, feats, dummy, binn, cam, width, height, ch_sem,
                depth_mode):
        img, batches = rasterize_forward(feats, binn, cam, width, height,
                                         ch_sem, depth_mode)
        ctx.save_for_backward(feats, cam, img, batches, binn.sorted_gid,
                              binn.tile_starts, binn.tile_counts)
        ctx.meta = (binn.num_entries, width, height, ch_sem, depth_mode)
        ctx.mark_non_differentiable(batches)
        return img, batches

    @staticmethod
    def backward(ctx, g_img, _):
        feats, cam, img, batches, gid, starts, counts = ctx.saved_tensors
        num_entries, width, height, ch_sem, depth_mode = ctx.meta
        binn = B.Binning(gid, starts, counts, num_entries, False)
        with tracing.span("render.composite_backward"):
            grad = rasterize_backward(feats, binn, cam, img,
                                      g_img.contiguous(), batches, width,
                                      height, ch_sem, depth_mode)
        nfeat = feats.shape[1]
        return (grad[:, :nfeat], grad[:, nfeat:], None, None, None, None,
                None, None)


def rasterize_image(feats: torch.Tensor, dummy: torch.Tensor,
                    mean2d: torch.Tensor, radius: torch.Tensor,
                    depth_z: torch.Tensor, cam: torch.Tensor, width: int,
                    height: int, ch_sem: int, depth_mode: str,
                    extents: torch.Tensor | None = None):
    """Bin + composite, differentiable in ``feats`` and ``dummy`` (N, 2)
    zeros whose gradient is the |d mean2d| stream. Returns (img (9+S, H, W),
    Binning): rgb (3, bg-blended), normal (3), sum w*d, sum w*d^2, alpha,
    sem (S)."""
    with tracing.span("render.binning"):
        binn = B.bin_gaussians(mean2d, radius, depth_z, width, height,
                               extents=extents)
    tracing.count("render.entries", binn.num_entries)
    tracing.count("render.binned", binn.num_binned)
    with tracing.span("render.composite"):
        img, _ = _Composite.apply(feats, dummy, binn, cam, width, height,
                                  ch_sem, depth_mode)
    return img, binn


def composite_tiles_stats_torch(feats: torch.Tensor, sorted_gid: torch.Tensor,
                                tile_starts: torch.Tensor,
                                tile_counts: torch.Tensor, n_tx: int,
                                width: int, height: int):
    """The plain version of the stats kernel, over every tile, ``GROUP``
    tiles at a time. Returns (stats (N, 2): per Gaussian the live in-image
    pairs of its entries and the sum of their blending weights, batches (T,)
    int32: the 256-entry batches each tile walked). Pixels outside the image
    never composite and keep T = 1, so a ragged tile never stops early."""
    dev = feats.device
    n_tiles = tile_counts.shape[0]
    stats = torch.zeros((feats.shape[0], 2), dtype=torch.float32, device=dev)
    batches = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    lane = torch.arange(BATCH, device=dev)
    gid_all = sorted_gid.to(torch.int64)

    for g0 in range(0, n_tiles, GROUP):
        ids = torch.arange(g0, min(g0 + GROUP, n_tiles), device=dev)
        ng = ids.shape[0]
        px, py, _ = _tile_geometry(ids, n_tx, None, "traditional")
        pvalid = (px < width) & (py < height)
        start = tile_starts[ids].to(torch.int64)
        count = tile_counts[ids].to(torch.int64)
        T = torch.ones((ng, TILE * TILE), dtype=torch.float32, device=dev)
        done = torch.zeros(ng, dtype=torch.int32, device=dev)
        nbatch = int((count.max() + BATCH - 1) // BATCH) if ng else 0
        for k in range(nbatch):
            run = (k * BATCH < count) & (T.amax(dim=1) >= T_EPS)
            sel = torch.nonzero(run).squeeze(1)
            if sel.numel() == 0:
                break
            pos = k * BATCH + lane[None]                          # (S, G)
            valid = pos < count[sel, None]
            gid = gid_all[torch.where(valid, start[sel, None] + pos, 0)]
            p = _batch_pairs(feats[gid], px[sel], py[sel], T[sel], valid,
                             None, pvalid[sel])
            per_entry = torch.stack([p.live.sum(1).to(torch.float32),
                                     p.w.sum(1)], dim=2)          # (S, G, 2)
            stats.index_add_(0, gid[valid], per_entry[valid])
            T[sel] = T[sel] * p.cum[..., -1]
            done[sel] += 1
        batches[g0:g0 + ng] = done
    return stats, batches


def rasterize_stats(feats: torch.Tensor, binn: B.Binning, width: int,
                    height: int) -> torch.Tensor:
    """Per-Gaussian (count, importance) of the binned entries over one view:
    (N, 2) f32. feats (N, 14+S) f32 in the packed layout (only the mean,
    conic and opacity columns are read)."""
    if feats.ndim != 2 or feats.shape[1] < PF.F_DEPTH_Z:
        raise ValueError(f"feats must be (N, >= {PF.F_DEPTH_Z}), got "
                         f"{tuple(feats.shape)}")
    _check_binned(feats, binn, width, height)
    n_tx, n_ty = B.tile_grid(width, height)
    dev = feats.device
    if dev.type == "cpu":
        return composite_tiles_stats_torch(
            feats, binn.sorted_gid, binn.tile_starts, binn.tile_counts, n_tx,
            width, height)[0]

    stats = torch.zeros((feats.shape[0], 2), dtype=torch.float32, device=dev)
    kernel = _stats_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernel(feats.data_ptr(), feats.shape[1],
                     binn.sorted_gid.data_ptr(), binn.tile_starts.data_ptr(),
                     binn.tile_counts.data_ptr(), n_tx, n_ty, width, height,
                     stats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rasterize_stats launch failed: cudaError {err}")
    LAUNCHES["rasterize_stats"] += 1
    return stats


@functools.cache
def _stats_kernel():
    fn = cuda_build.load("rasterize_stats").vcr_rasterize_stats
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, i, i, i, i, p, p]
    fn.restype = ctypes.c_int
    return fn


def rasterize_entry_stats(feats: torch.Tensor, mean2d: torch.Tensor,
                          radius: torch.Tensor, depth_z: torch.Tensor,
                          width: int, height: int,
                          extents: torch.Tensor | None = None):
    """Bin, then the stats kernel: per Gaussian (count (N,), importance
    (N,)), the f_count render modes of the reference collapsed into one
    kernel."""
    with tracing.span("render.binning"):
        binn = B.bin_gaussians(mean2d, radius, depth_z, width, height,
                               extents=extents)
    with tracing.span("render.stats"):
        stats = rasterize_stats(feats, binn, width, height)
    return stats[:, 0], stats[:, 1]
