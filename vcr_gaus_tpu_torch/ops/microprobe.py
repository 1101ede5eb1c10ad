"""The forward-loop microprobe (scripts/kernel_microprobe.py), the port's own
copy of what that script defines.

The probe is a timing ablation of the forward compositing loop: one block
per 32x32 tile walks its range of entries in chunks of ``Gc`` columns of a
(24, E) feature matrix, evaluates every (pixel, entry) pair and sums into 10
channels per pixel. Each switch of ``VARIANTS`` removes or replaces one
component of the loop body. The numbers it computes mean nothing; each
variant is still a well-defined function, and this module holds it:

  * pixel coordinates are tile-local and the same in every tile: px = p %
    32, py = p // 32 for p in 0..1023, as float32;
  * use_alpha: power = -0.5 (A dx^2 + C dy^2) - B dx dy with dx = px -
    row 0, dy = py - row 1, (A, B, C, op) = rows 2..5; alpha_raw = op
    e^power (use_exp) or op (1 + 0.01 power); a pair is live iff power <= 0
    and alpha_raw >= 1/255, and then alpha = min(alpha_raw, 0.99), else 0.
    Without use_alpha, alpha = 0.001 op on every pair, with no test;
  * lg = log1p(-alpha) (use_exp and use_alpha) or -alpha; csum is the
    inclusive prefix of lg inside one chunk only (use_tri), else lg itself;
    the weight is w = alpha exp(csum - lg) (use_exp and use_alpha), else
    alpha (csum - lg + 1). The transmittance resets at every chunk;
  * use_depth: d = row 6 / denom along the ray ((p + 0.5 - 16) / 30, 1)
    normalised, denom = ray . rows 7..9 with an unsigned clamp (|denom| <
    1e-2 -> +1e-2); else d = row 6;
  * the 10 channels of a pixel: 0 stays 0, 1 sums each chunk's last csum,
    2 sums w d, 3 sums w d^2, 4..9 sum w times rows 6..11 (use_dacc, else
    0). The script's 16 columns are these and 6 of zero padding.

``depth`` (copies in flight) and ``unroll`` (chunk bodies per loop step)
change how the kernel walks, not what it computes.

``microprobe`` wraps the hand-written CUDA kernel ``csrc/kernel_microprobe.cu``
(K4): given CUDA tensors it launches the kernel or raises; only tensors on
the CPU take the plain version ``microprobe_torch``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build
from .rasterize import LAUNCHES, warp_of_pixel

TILE = 32
P = TILE * TILE           # pixels of a tile
G = 256                   # entries per chunk, the default Gc
F_PAD = 24                # feature rows; the body reads rows 0..11
C_ACC = 6                 # rows 6..11 accumulated by use_dacc
OUT_CH = 4 + C_ACC        # channels per pixel
N_TILES = 1900            # the protocol shape: 50 x 38 tiles
CHUNKS = 6                # of G entries per tile
ALPHA_EPS = 1.0 / 255.0
ALPHA_CAP = 0.99
GROUP = 32                # tiles per round of the plain version

_FULL = dict(use_depth=True, use_tri=True, use_dacc=True, use_exp=True,
             use_alpha=True)
_DMA = dict(use_depth=False, use_tri=False, use_dacc=False, use_exp=False,
            use_alpha=False)
VARIANTS = {
    "full": dict(_FULL),
    "no_depth": dict(_FULL, use_depth=False),
    "no_tri": dict(_FULL, use_tri=False),
    "no_dacc": dict(_FULL, use_dacc=False),
    "no_exp": dict(_FULL, use_exp=False),
    "dma_only": dict(_DMA),
    "full_d4": dict(_FULL, depth=4),
    "full_d6": dict(_FULL, depth=6),
    "full_g512": dict(_FULL, Gc=512),
    "full_g128": dict(_FULL, Gc=128),
    "full_d4_g512": dict(_FULL, depth=4, Gc=512),
    "full_u3": dict(_FULL, unroll=3),
    "full_u6": dict(_FULL, unroll=6),
    "dma_u6": dict(_DMA, unroll=6),
}
_SWITCHES = ("use_depth", "use_tri", "use_dacc", "use_exp", "use_alpha")
_DEFAULTS = {"depth": 2, "Gc": G, "unroll": 1}


def toggles_of(name: str) -> dict:
    """Every toggle of the variant ``name``, the defaults filled in."""
    return {**_DEFAULTS, **VARIANTS[name]}


def probe_inputs(n_tiles: int = N_TILES, chunks: int = CHUNKS, seed: int = 0):
    """The script's arrays, as numpy: (feats (24, E) f32 uniform in [0.01,
    0.9), starts (n_tiles,) i32, counts (n_tiles,) i32), E = n_tiles *
    chunks * 256, each tile ``chunks`` chunks of 256 entries in order."""
    e = n_tiles * chunks * G
    rng = np.random.default_rng(seed)
    feats = rng.uniform(0.01, 0.9, (F_PAD, e)).astype(np.float32)
    starts = (np.arange(n_tiles) * chunks * G).astype(np.int32)
    counts = np.full(n_tiles, chunks * G, np.int32)
    return feats, starts, counts


def _check(feats, starts, counts, Gc):
    """Types, shapes, devices and contiguity the kernel takes, and the only
    ranges the script builds: every start a multiple of 128, every count a
    multiple of Gc, every range inside the feature matrix."""
    for name, t, dtype in (("feats", feats, torch.float32),
                           ("starts", starts, torch.int32),
                           ("counts", counts, torch.int32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor, "
                             f"got {t.dtype} (contiguous={t.is_contiguous()})")
        if t.device != feats.device:
            raise ValueError(f"{name} is on {t.device}, feats on "
                             f"{feats.device}")
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {feats.device}")
    if feats.ndim != 2 or feats.shape[0] != F_PAD or feats.shape[1] % 4:
        raise ValueError(f"feats must be ({F_PAD}, E) with E a multiple of 4,"
                         f" got {tuple(feats.shape)}")
    if starts.ndim != 1 or counts.shape != starts.shape:
        raise ValueError("starts and counts must be (n_tiles,)")
    if Gc not in (128, 256, 512):
        raise ValueError(f"Gc must be 128, 256 or 512, got {Gc}")
    s, c = starts.cpu().to(torch.int64), counts.cpu().to(torch.int64)
    if bool((s % 128 != 0).any()) or bool((s < 0).any()):
        raise ValueError("every start must be a non-negative multiple of 128")
    if bool((c % Gc != 0).any()) or bool((c < 0).any()):
        raise ValueError(f"every count must be a non-negative multiple of "
                         f"Gc = {Gc}")
    if bool((s + c > feats.shape[1]).any()):
        raise ValueError("a tile's range ends past the feature matrix")


def _pixels(dev):
    """(px, py) of a tile's pixels, (1024, 1) float32 each."""
    pix = torch.arange(P, device=dev)
    return ((pix % TILE).to(torch.float32)[:, None],
            (pix // TILE).to(torch.float32)[:, None])


def _chunk_groups(feats, starts, counts, Gc):
    """Yield (g0, ok, f) per round of ``GROUP`` tiles from g0: ok (ng, k) the
    chunks inside each tile's count, f (12, ng, k, 1, Gc) rows 0..11 of
    every chunk's columns (a chunk past a tile's count reads column 0)."""
    dev = feats.device
    nch = (counts.cpu().to(torch.int64) // Gc).tolist()
    for g0 in range(0, len(nch), GROUP):
        k = max(nch[g0:g0 + GROUP])
        if k == 0:
            continue
        chunk = torch.arange(k, device=dev)
        ok = chunk[None] < counts[g0:g0 + GROUP, None] // Gc
        cols = (starts[g0:g0 + GROUP, None, None].to(torch.int64)
                + chunk[None, :, None] * Gc
                + torch.arange(Gc, device=dev)[None, None])
        cols = torch.where(ok[..., None], cols, 0)
        yield g0, ok, feats[:12, cols][:, :, :, None, :]


def _alpha_terms(f, px, py, use_exp):
    """(power, alpha_raw), (ng, k, P, Gc) each."""
    dx = px - f[0]
    dy = py - f[1]
    power = -0.5 * (f[2] * dx * dx + f[4] * dy * dy) - f[3] * dx * dy
    if use_exp:
        return power, f[5] * torch.exp(power)
    return power, f[5] * (1.0 + power * 0.01)


def microprobe_torch(feats: torch.Tensor, starts: torch.Tensor,
                     counts: torch.Tensor, *, use_depth: bool, use_tri: bool,
                     use_dacc: bool, use_exp: bool, use_alpha: bool,
                     depth: int = 2, Gc: int = G,
                     unroll: int = 1) -> torch.Tensor:
    """The plain version of K4: (n_tiles, 1024, 10) f32. Vectorised over
    ``GROUP`` tiles and all their chunks at a time; ``depth`` and
    ``unroll`` do not change the function."""
    _check(feats, starts, counts, Gc)
    dev = feats.device
    out = torch.zeros((starts.shape[0], P, OUT_CH), dtype=torch.float32,
                      device=dev)
    px, py = _pixels(dev)
    if use_depth:
        dirx = (px + 0.5 - 16.0) / 30.0
        diry = (py + 0.5 - 16.0) / 30.0
        inv_n = torch.rsqrt(dirx * dirx + diry * diry + 1.0)
        rx, ry = dirx * inv_n, diry * inv_n
    for g0, ok, f in _chunk_groups(feats, starts, counts, Gc):
        shape = (*ok.shape, P, Gc)                             # (ng, k, P, Gc)
        if use_alpha:
            power, alpha_raw = _alpha_terms(f, px, py, use_exp)
            live = (power <= 0.0) & (alpha_raw >= ALPHA_EPS)
            alpha = torch.where(live, torch.clamp_max(alpha_raw, ALPHA_CAP),
                                0.0)
        else:
            alpha = (f[5] * 0.001).expand(shape)
        lg = torch.log1p(-alpha) if use_exp and use_alpha else -alpha
        csum = torch.cumsum(lg, dim=-1) if use_tri else lg
        if use_exp and use_alpha:
            w = alpha * torch.exp(csum - lg)
        else:
            w = alpha * (csum - lg + 1.0)
        if use_depth:
            denom = rx * f[7] + ry * f[8] + inv_n * f[9]
            denom = torch.where(torch.abs(denom) < 1e-2, 1e-2, denom)
            d = f[6] / denom
        else:
            d = f[6].expand(shape)
        wd = w * d
        sums = [csum[..., -1], wd.sum(-1), (wd * d).sum(-1)]   # (ng, k, P)
        if use_dacc:
            # (ng, k, P, Gc) x (ng, k, Gc, 6)
            dacc = torch.matmul(w, f[6:12, :, :, 0].permute(1, 2, 3, 0))
            sums += list(dacc.unbind(-1))
        chan = torch.stack(sums, dim=-1)                   # (ng, k, P, c)
        chan = torch.where(ok[:, :, None, None], chan, 0.0).sum(1)
        out[g0:g0 + ok.shape[0], :, 1:1 + chan.shape[-1]] = chan
    return out


def pair_census(feats: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, *, use_exp: bool,
                use_alpha: bool) -> dict[str, int]:
    """What a loop that skips dead pairs evaluates on these inputs:
    ``pairs``, ``past_power`` (pairs past the power test), ``live`` (live
    pairs; without use_alpha there is no test and every pair is live), and
    per map of pixels to warps that take one entry a step: ``warp_steps``,
    ``warp_steps_live`` (steps with a live lane, which run the live body)
    and ``busiest_warp_live_steps`` (per tile and chunk of 256 entries,
    those of the warp with the most, summed: what a block that waits at
    every chunk for its slowest warp runs). Those three keys count warps of
    one pixel row (32 pixels, a thread per pixel); the same keys prefixed
    ``patch_`` count the kernel's warps of 8x8 patches (64 pixels, 2 a
    thread): ``rasterize.warp_of_pixel`` on a 32x32 tile."""
    _check(feats, starts, counts, G)
    entries = int(counts.to(torch.int64).sum())
    maps = {"": warp_of_pixel(False, TILE),
            "patch_": warp_of_pixel(True, TILE)}
    n_warps = {pre: int(warp.max()) + 1 for pre, warp in maps.items()}
    out = dict(pairs=entries * P, past_power=entries * P, live=entries * P)
    for pre, warps in n_warps.items():
        out.update({f"{pre}warp_steps": entries * warps,
                    f"{pre}warp_steps_live": entries * warps,
                    f"{pre}busiest_warp_live_steps": entries})
    if not use_alpha:
        return out
    px, py = _pixels(feats.device)
    # pixels ordered by warp, so that a warp's pixels are consecutive
    orders = {pre: torch.argsort(warp, stable=True).to(feats.device)
              for pre, warp in maps.items()}
    past = live = 0
    steps_live = dict.fromkeys(maps, 0)
    busiest = dict.fromkeys(maps, 0)
    for _, ok, f in _chunk_groups(feats, starts, counts, G):
        power, alpha_raw = _alpha_terms(f, px, py, use_exp)
        inside = ok[:, :, None, None]
        past += int(((power <= 0.0) & inside).sum())
        pl = (power <= 0.0) & (alpha_raw >= ALPHA_EPS) & inside
        live += int(pl.sum())
        for pre, order in orders.items():
            per_warp = (pl[:, :, order].unflatten(2, (n_warps[pre], -1))
                        .any(3).sum(-1))                    # (ng, k, warps)
            steps_live[pre] += int(per_warp.sum())
            busiest[pre] += int(per_warp.amax(-1).sum())
    out.update(past_power=past, live=live)
    for pre in maps:
        out[f"{pre}warp_steps_live"] = steps_live[pre]
        out[f"{pre}busiest_warp_live_steps"] = busiest[pre]
    return out


def microprobe(feats: torch.Tensor, starts: torch.Tensor,
               counts: torch.Tensor, **toggles) -> torch.Tensor:
    """K4 for one variant's toggles (those of one entry of ``VARIANTS``, the
    defaults depth 2, Gc 256, unroll 1 filled in): (n_tiles, 1024, 10) f32
    from feats (24, E) f32, starts and counts (n_tiles,) int32."""
    full = {**_DEFAULTS, **toggles}
    if full not in [toggles_of(n) for n in VARIANTS]:
        raise ValueError(f"not the toggles of a variant: {toggles}")
    if feats.device.type == "cpu":
        return microprobe_torch(feats, starts, counts, **full)

    _check(feats, starts, counts, full["Gc"])
    if feats.data_ptr() % 16:
        raise ValueError("feats must be 16-byte aligned: the kernel stages "
                         "it with 16-byte copies")
    n_tiles = starts.shape[0]
    out = torch.empty((n_tiles, P, OUT_CH), dtype=torch.float32,
                      device=feats.device)
    if n_tiles == 0:
        return out
    kernel = _kernel()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = kernel(feats.data_ptr(), feats.shape[1], starts.data_ptr(),
                     counts.data_ptr(), n_tiles,
                     *(int(full[s]) for s in _SWITCHES), full["depth"],
                     full["Gc"], full["unroll"], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"kernel_microprobe launch failed: cudaError {err}")
    LAUNCHES["kernel_microprobe"] += 1
    return out


@functools.cache
def _kernel():
    fn = cuda_build.load("kernel_microprobe").vcr_kernel_microprobe
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.c_longlong, p, p] + [i] * 9 + [p, p]
    fn.restype = ctypes.c_int
    return fn
