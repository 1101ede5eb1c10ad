"""The plain renderer: projection, SH, binning, compositing and the
channel post-processing, in plain PyTorch.

Projection, SH, the normals, the feature packing, the binning and the
post-processing are a frozen copy of the port's plain arithmetic (VCR-GauS
with the 3DGS EWA projection, tile 16, the alpha >= 1/255 level-set
extents, one stable sort on (tile, quantized depth)). The compositor is the
benchmark's own: each chunk of whole tiles is laid out as an
(entries, 256 pixels) matrix, T is the exponential of a float64 running sum
of log(1 - alpha) inside each tile, and the tile-wide early stop (no pixel
of the tile at T >= 1e-4 at the start of a 256-entry batch) is applied per
batch, as the port's kernels define it; the pairs that are live in a
running batch are then composited as a list grouped by (tile, pixel). It is
differentiable: the forward keeps no graph, and the backward recomputes
one chunk at a time under autograd. ``census`` counts the (pixel, entry)
pairs the composited batches hold, for the operation counts. Imports
nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE = 16
BATCH = 256
T_EPS = 1e-4
ALPHA_EPS = 1.0 / 255.0
ALPHA_CAP = 0.99
CHUNK_ENTRIES = 1 << 17      # entries of whole tiles a compositing chunk holds

# packed feature columns
F_MEAN_X, F_MEAN_Y, F_CONIC_A, F_CONIC_B, F_CONIC_C = 0, 1, 2, 3, 4
F_OPACITY, F_DEPTH_Z, F_PLANE_D, F_NORMAL, F_RGB = 5, 6, 7, 8, 11

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def safe_normalize(v: torch.Tensor, eps: float = 1e-24) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = safe_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
         2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
         2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def shortest_axis_normal(scale: torch.Tensor, quat: torch.Tensor):
    """The rotation column of the smallest scale axis (first on ties)."""
    R = quat_to_rotmat(quat)
    axis = torch.argmin(scale, dim=-1)
    return torch.gather(R, 2, axis[:, None, None].expand(-1, 3, 1))[..., 0]


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh (..., C, 16), dirs (..., 3) unit -> (..., C)."""
    result = SH_C0 * sh[..., 0]
    if deg > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - SH_C1 * y * sh[..., 1] + SH_C1 * z * sh[..., 2]
                  - SH_C1 * x * sh[..., 3])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + SH_C2[0] * xy * sh[..., 4]
                      + SH_C2[1] * yz * sh[..., 5]
                      + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                      + SH_C2[3] * xz * sh[..., 7]
                      + SH_C2[4] * (xx - yy) * sh[..., 8])
            if deg > 2:
                result = (result
                          + SH_C3[0] * y * (3 * xx - yy) * sh[..., 9]
                          + SH_C3[1] * xy * z * sh[..., 10]
                          + SH_C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                          + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy)
                          * sh[..., 12]
                          + SH_C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                          + SH_C3[5] * z * (xx - yy) * sh[..., 14]
                          + SH_C3[6] * x * (xx - 3 * yy) * sh[..., 15])
    return result


class Projected(NamedTuple):
    mean2d: torch.Tensor
    conic: torch.Tensor
    depth_z: torch.Tensor
    radius: torch.Tensor
    mean_cam: torch.Tensor
    ext: torch.Tensor


def project(means3d, scales, quats, V, Pm, tanfovx, tanfovy, width: int,
            height: int, opacity) -> Projected:
    """EWA projection: near cull at z <= 0.2, the +-1.3 tanfov clamp, +0.3
    px dilation, radius ceil(3 sqrt(lambda_max)), extents the AABB of the
    alpha = 1/255 level set."""
    x, y, z3 = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    tx = x * V[0, 0] + y * V[1, 0] + z3 * V[2, 0] + V[3, 0]
    ty = x * V[0, 1] + y * V[1, 1] + z3 * V[2, 1] + V[3, 1]
    tz = x * V[0, 2] + y * V[1, 2] + z3 * V[2, 2] + V[3, 2]
    p_view = torch.stack([tx, ty, tz], dim=-1)
    cx = x * Pm[0, 0] + y * Pm[1, 0] + z3 * Pm[2, 0] + Pm[3, 0]
    cy = x * Pm[0, 1] + y * Pm[1, 1] + z3 * Pm[2, 1] + Pm[3, 1]
    cw = x * Pm[0, 3] + y * Pm[1, 3] + z3 * Pm[2, 3] + Pm[3, 3]
    p_w = 1.0 / (cw + 1e-7)

    q = safe_normalize(quats)
    qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    s0, s1, s2 = scales[:, 0], scales[:, 1], scales[:, 2]

    fx = width / (2.0 * tanfovx)
    fy = height / (2.0 * tanfovy)
    tz_safe = torch.where(torch.abs(tz) < 1e-6, 1e-6, tz)
    lim_x, lim_y = 1.3 * tanfovx, 1.3 * tanfovy
    txtz = torch.clamp(tx / tz_safe, -lim_x, lim_x) * tz
    tytz = torch.clamp(ty / tz_safe, -lim_y, lim_y) * tz
    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * txtz * inv_z2
    j11 = fy * inv_z
    j12 = -fy * tytz * inv_z2
    t00 = j00 * V[0, 0] + j02 * V[0, 2]
    t01 = j00 * V[1, 0] + j02 * V[1, 2]
    t02 = j00 * V[2, 0] + j02 * V[2, 2]
    t10 = j11 * V[0, 1] + j12 * V[0, 2]
    t11 = j11 * V[1, 1] + j12 * V[1, 2]
    t12 = j11 * V[2, 1] + j12 * V[2, 2]
    m00 = t00 * r00 + t01 * r10 + t02 * r20
    m01 = t00 * r01 + t01 * r11 + t02 * r21
    m02 = t00 * r02 + t01 * r12 + t02 * r22
    m10 = t10 * r00 + t11 * r10 + t12 * r20
    m11 = t10 * r01 + t11 * r11 + t12 * r21
    m12 = t10 * r02 + t11 * r12 + t12 * r22
    u00, u01, u02 = m00 * s0, m01 * s1, m02 * s2
    u10, u11, u12 = m10 * s0, m11 * s1, m12 * s2
    a = u00 * u00 + u01 * u01 + u02 * u02 + 0.3
    b = u00 * u10 + u01 * u11 + u02 * u12
    c = u10 * u10 + u11 * u11 + u12 * u12 + 0.3
    det = a * c - b * b
    det_safe = torch.where(det == 0, 1.0, det)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam1))
    lvl = torch.clamp(torch.log(255.0 * torch.clamp_min(opacity, 1e-12)),
                      0.0, 4.5)
    dead = opacity * 255.0 <= 1.0
    ext_x = torch.where(dead, 0.0, torch.ceil(torch.sqrt(2.0 * lvl * a)))
    ext_y = torch.where(dead, 0.0, torch.ceil(torch.sqrt(2.0 * lvl * c)))
    mean2d = torch.stack(
        [((cx * p_w + 1.0) * width - 1.0) * 0.5,
         ((cy * p_w + 1.0) * height - 1.0) * 0.5], dim=-1)
    visible = (tz > 0.2) & (det > 0)
    in_image = ((mean2d[:, 0] + radius_f > 0)
                & (mean2d[:, 0] - radius_f < width)
                & (mean2d[:, 1] + radius_f > 0)
                & (mean2d[:, 1] - radius_f < height))
    keep = visible & in_image
    radius = torch.where(keep, radius_f, 0.0).detach().to(torch.int32)
    ext = torch.where(keep[:, None], torch.stack([ext_x, ext_y], dim=-1),
                      0.0).detach()
    return Projected(mean2d, conic, p_view[:, 2], radius, p_view, ext)


def pack_features(proj: Projected, opacity, rgb, normal_cam, sem):
    """The (N, 14+S) feature matrix the compositor reads."""
    if normal_cam is None:
        normal_cam = torch.zeros_like(proj.mean_cam)
    plane_d = torch.sum(normal_cam * proj.mean_cam, dim=-1)
    cols = [proj.mean2d[:, 0], proj.mean2d[:, 1],
            proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
            opacity, proj.depth_z, plane_d,
            normal_cam[:, 0], normal_cam[:, 1], normal_cam[:, 2],
            rgb[:, 0], rgb[:, 1], rgb[:, 2]]
    if sem is not None:
        cols.extend(sem[:, i] for i in range(sem.shape[1]))
    return torch.stack(cols, dim=-1)


class Binning(NamedTuple):
    sorted_gid: torch.Tensor     # (E,) int64
    tile_starts: torch.Tensor    # (T,) int64
    tile_counts: torch.Tensor    # (T,) int64
    n_tx: int
    n_ty: int


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bin_gaussians(mean2d, radius, depth_z, width: int, height: int,
                  extents) -> Binning:
    """(Gaussian, tile) entries over each Gaussian's extent rectangle (min
    inclusive, max exclusive, truncating float->int), ordered by tile, then
    by the top bits of the float32 depth pattern, then by expansion order
    (one stable sort)."""
    dev = mean2d.device
    n = mean2d.shape[0]
    n_tx, n_ty = cdiv(width, TILE), cdiv(height, TILE)
    num_tiles = n_tx * n_ty
    db = 32 - max(1, num_tiles.bit_length())
    mean2d = mean2d.detach().to(torch.float32)
    extents = extents.detach().to(torch.float32)
    rx, ry = extents[:, 0], extents[:, 1]
    alive = (radius > 0) & (rx > 0) & (ry > 0)
    x0 = ((mean2d[:, 0] - rx) / TILE).to(torch.int32).clamp(0, n_tx)
    y0 = ((mean2d[:, 1] - ry) / TILE).to(torch.int32).clamp(0, n_ty)
    x1 = ((mean2d[:, 0] + rx + TILE - 1) / TILE).to(torch.int32).clamp(0, n_tx)
    y1 = ((mean2d[:, 1] + ry + TILE - 1) / TILE).to(torch.int32).clamp(0, n_ty)
    span_w = (x1 - x0).clamp_min(0)
    span_h = (y1 - y0).clamp_min(0)
    count = torch.where(alive, span_w * span_h, 0).to(torch.int64)
    offsets = torch.cumsum(count, 0) - count
    gid = torch.repeat_interleave(torch.arange(n, device=dev), count)
    e = gid.shape[0]
    slot = torch.arange(e, device=dev) - offsets[gid]
    sw = span_w.clamp_min(1).to(torch.int64)[gid]
    sy = torch.div(slot, sw, rounding_mode="floor")
    sx = slot - sy * sw
    tile_id = ((y0.to(torch.int64)[gid] + sy) * n_tx
               + x0.to(torch.int64)[gid] + sx)
    bits = depth_z.detach().to(torch.float32).contiguous().view(torch.int32)
    dq = (bits.to(torch.int64) & 0xFFFFFFFF) >> (32 - db)
    key = (tile_id << db) | dq[gid]
    _, order = torch.sort(key, stable=True)
    counts = torch.bincount(tile_id, minlength=num_tiles)
    return Binning(gid[order], torch.cumsum(counts, 0) - counts, counts,
                   n_tx, n_ty)


def _chunks(binn: Binning):
    """Ranges [t0, t1) of whole tiles holding at most CHUNK_ENTRIES entries
    (or one tile that alone holds more)."""
    ends = torch.cumsum(binn.tile_counts, 0).tolist()
    t0, base, n = 0, 0, len(ends)
    while t0 < n:
        t1 = t0 + 1
        while t1 < n and ends[t1] - base <= CHUNK_ENTRIES:
            t1 += 1
        yield t0, t1, base, ends[t1 - 1]
        base = ends[t1 - 1]
        t0 = t1


def _cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """cumsum along dim 0, scanned along a contiguous dim (a scan along
    dim 0 of a 2-D tensor runs one thread a column on the card)."""
    if x.ndim == 1:
        return torch.cumsum(x, 0)
    return torch.cumsum(x.t().contiguous(), 1).t()


class _SegmentExclusiveCumsum(torch.autograd.Function):
    """Along dim 0, for rows grouped in consecutive segments: each row's sum
    of the rows before it in its segment. The backward is the same sum taken
    from the other end: each row's sum of the gradient rows after it in its
    segment."""

    @staticmethod
    def forward(ctx, x, first, last):
        c = _cumsum_rows(x) - x
        ctx.save_for_backward(first, last)
        return c - c[first]

    @staticmethod
    def backward(ctx, g):
        first, last = ctx.saved_tensors
        r = torch.flip(_cumsum_rows(torch.flip(g, [0])), [0]) - g
        return r - r[last], None, None


class _Chunk(NamedTuple):
    tiles: torch.Tensor          # (n_t,) tile ids of the chunk
    local: torch.Tensor          # (Ec,) chunk-local tile of each entry
    first: torch.Tensor          # (Ec,) chunk index of its tile's first entry
    last: torch.Tensor           # (Ec,) and of its last
    pos: torch.Tensor            # (Ec,) position inside its tile
    gid: torch.Tensor            # (Ec,)


def _chunk(binn: Binning, t0: int, t1: int, e0: int, e1: int) -> _Chunk:
    dev = binn.sorted_gid.device
    counts = binn.tile_counts[t0:t1]
    local = torch.repeat_interleave(torch.arange(t1 - t0, device=dev), counts)
    starts = binn.tile_starts[t0:t1] - e0
    first = starts[local]
    last = (starts + counts - 1)[local]
    pos = torch.arange(e1 - e0, device=dev) - first
    return _Chunk(torch.arange(t0, t1, device=dev), local, first, last, pos,
                  binn.sorted_gid[e0:e1])


def _pixels(tile, pix, n_tx: int, dtype):
    px = (tile % n_tx) * TILE + pix % TILE
    py = (tile // n_tx) * TILE + pix // TILE
    return px.to(dtype), py.to(dtype)


def _power(f, px, py):
    dx = px - f[..., F_MEAN_X]
    dy = py - f[..., F_MEAN_Y]
    return (-0.5 * (f[..., F_CONIC_A] * dx * dx + f[..., F_CONIC_C] * dy * dy)
            - f[..., F_CONIC_B] * dx * dy)


@torch.no_grad()
def _kept(feats, ch: _Chunk, n_tx: int):
    """(power (Ec, 256), live (Ec, 256), run (Ec,)): over every (entry,
    pixel) pair of the chunk, the power, the live pairs (power <= 0 and
    alpha >= 1/255), and the entries of the batches the tile composites:
    a batch runs while some pixel of the tile has T >= 1e-4 at its
    start."""
    dev = feats.device
    f = feats[ch.gid][:, None, :]
    pix = torch.arange(TILE * TILE, device=dev)
    px, py = _pixels(ch.tiles[ch.local][:, None], pix[None], n_tx,
                     feats.dtype)
    power = _power(f, px, py)
    alpha_raw = f[..., F_OPACITY] * torch.exp(power)
    live = (power <= 0.0) & (alpha_raw >= ALPHA_EPS)
    alpha = torch.where(live, torch.clamp_max(alpha_raw, ALPHA_CAP), 0.0)
    lg = torch.log1p(-alpha).to(torch.float64)
    t_excl = torch.exp(_SegmentExclusiveCumsum.apply(lg, ch.first, ch.last))
    n = ch.gid.shape[0]
    at_start = ch.pos % BATCH == 0
    run = torch.zeros(n, dtype=torch.bool, device=dev)
    run[at_start] = t_excl[at_start].amax(1) >= T_EPS
    run = run[torch.arange(n, device=dev) - ch.pos % BATCH]
    return power, live, run


def _kept_pairs(feats, ch: _Chunk, n_tx: int):
    """(entry, pixel, lengths): the chunk's kept pairs (live, in a running
    batch) grouped by (tile, pixel), entries in depth order inside, and the
    number of pairs of each (tile, pixel)."""
    _, live, run = _kept(feats, ch, n_tx)
    e, p = torch.nonzero(live & run[:, None], as_tuple=True)
    key = ch.local[e] * (TILE * TILE) + p
    key, order = torch.sort(key, stable=True)
    lengths = torch.bincount(key, minlength=ch.tiles.shape[0] * TILE * TILE)
    return e[order].to(torch.int32), p[order].to(torch.int32), lengths


def _composite_chunk(feats, ch: _Chunk, pairs, n_tx: int, cam, ch_sem: int,
                     mode: str):
    """(n_t, 9+S, 256) pixels of the chunk's tiles, the port's channel
    order: rgb (with the background), normal, depth, depth^2, alpha,
    semantic, from its kept ``pairs`` (``_kept_pairs``); a pair that is
    not kept adds nothing and leaves T as it is."""
    e, p, lengths = pairs
    e, p = e.long(), p.long()
    n_t = ch.tiles.shape[0]
    seg_start = torch.cumsum(lengths, 0) - lengths
    seg = ch.local[e] * (TILE * TILE) + p
    first = seg_start[seg]
    last = first + lengths[seg] - 1
    f = torch.index_select(feats, 0, ch.gid[e])                 # (L, F)
    px, py = _pixels(ch.tiles[ch.local[e]], p, n_tx, feats.dtype)
    power = _power(f, px, py)
    alpha = torch.clamp_max(f[:, F_OPACITY] * torch.exp(power), ALPHA_CAP)
    lg = torch.log1p(-alpha).to(torch.float64)
    t_excl = torch.exp(_SegmentExclusiveCumsum.apply(lg, first, last)
                       ).to(feats.dtype)
    w = alpha * t_excl
    if mode == "intersection":
        dirx = (px + 0.5 - cam[2]) / cam[0]
        diry = (py + 0.5 - cam[3]) / cam[1]
        inv_n = torch.rsqrt(dirx * dirx + diry * diry + 1.0)
        denom = (dirx * inv_n * f[:, F_NORMAL]
                 + diry * inv_n * f[:, F_NORMAL + 1]
                 + inv_n * f[:, F_NORMAL + 2])
        clamped = torch.abs(denom) < 1e-2
        denom = torch.where(clamped, torch.where(denom < 0, -1e-2, 1e-2),
                            denom)
        d = f[:, F_PLANE_D] / denom
    else:
        d = f[:, F_DEPTH_Z]
    vals = f[:, F_NORMAL:F_NORMAL + 6 + ch_sem]                 # n, rgb, sem
    contrib = torch.cat([w[:, None] * vals, (w * d)[:, None],
                         (w * d * d)[:, None]], 1)
    acc = torch.segment_reduce(contrib, "sum", lengths=lengths, axis=0)
    tot = torch.segment_reduce(lg, "sum", lengths=lengths, axis=0)
    acc = acc.reshape(n_t, TILE * TILE, -1)
    T = torch.exp(tot).to(feats.dtype).reshape(n_t, TILE * TILE)
    bg = cam[4:7].to(feats.dtype)
    cols = [acc[..., 3:6] + T[..., None] * bg, acc[..., 0:3],
            acc[..., 6 + ch_sem:7 + ch_sem], acc[..., 7 + ch_sem:8 + ch_sem],
            (1.0 - T)[..., None], acc[..., 6:6 + ch_sem]]
    return torch.cat(cols, 2).transpose(1, 2)


def tiles_to_image(tiles, n_tx: int, n_ty: int, width: int, height: int):
    c = tiles.shape[1]
    img = tiles.reshape(n_ty, n_tx, c, TILE, TILE).permute(2, 0, 3, 1, 4)
    return img.reshape(c, n_ty * TILE, n_tx * TILE)[:, :height, :width]


def image_to_tiles(img, n_tx: int, n_ty: int):
    c, h, w = img.shape
    pad = torch.nn.functional.pad(img,
                                  (0, n_tx * TILE - w, 0, n_ty * TILE - h))
    tiles = pad.reshape(c, n_ty, TILE, n_tx, TILE).permute(1, 3, 0, 2, 4)
    return tiles.reshape(n_tx * n_ty, c, TILE * TILE)


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, binn, cam, width, height, ch_sem, mode):
        out = feats.new_zeros((binn.n_tx * binn.n_ty, 9 + ch_sem, TILE * TILE))
        kept = {}
        with torch.no_grad():
            for t0, t1, e0, e1 in _chunks(binn):
                if e1 > e0:
                    ch = _chunk(binn, t0, t1, e0, e1)
                    kept[t0] = _kept_pairs(feats, ch, binn.n_tx)
                    out[t0:t1] = _composite_chunk(feats, ch, kept[t0],
                                                  binn.n_tx, cam, ch_sem, mode)
                else:
                    out[t0:t1, 0:3] = cam[4:7, None].to(feats.dtype)
        ctx.save_for_backward(feats, cam)
        ctx.meta = (binn, ch_sem, mode, kept)
        return tiles_to_image(out, binn.n_tx, binn.n_ty, width, height)

    @staticmethod
    def backward(ctx, g_img):
        feats, cam = ctx.saved_tensors
        binn, ch_sem, mode, kept = ctx.meta
        g_tiles = image_to_tiles(g_img.contiguous(), binn.n_tx, binn.n_ty)
        leaf = feats.detach().requires_grad_(True)
        with torch.enable_grad():
            for t0, t1, e0, e1 in _chunks(binn):
                if e1 > e0:
                    out = _composite_chunk(leaf, _chunk(binn, t0, t1, e0, e1),
                                           kept[t0], binn.n_tx, cam, ch_sem,
                                           mode)
                    torch.autograd.backward(out, g_tiles[t0:t1])
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(feats)
        return g, None, None, None, None, None, None


def composite(feats, binn: Binning, cam: torch.Tensor, width: int,
              height: int, ch_sem: int, mode: str) -> torch.Tensor:
    """(9+S, H, W) image of the binned entries; ``cam`` is [fx, fy, cx, cy,
    bg (3), 0]."""
    return _Composite.apply(feats, binn, cam, width, height, ch_sem, mode)


@torch.no_grad()
def census(feats, binn: Binning) -> dict:
    """Counts over the batches each tile composites: entries, distinct
    Gaussians, (pixel, entry) pairs, pairs past the power test, live
    pairs."""
    n = dict(entries=0, pairs=0, power_pass=0, live=0)
    gids = []
    for t0, t1, e0, e1 in _chunks(binn):
        if e1 == e0:
            continue
        ch = _chunk(binn, t0, t1, e0, e1)
        power, live, run = _kept(feats, ch, binn.n_tx)
        n["entries"] += int(run.sum())
        n["pairs"] += int(run.sum()) * TILE * TILE
        n["power_pass"] += int(((power <= 0) & run[:, None]).sum())
        n["live"] += int((live & run[:, None]).sum())
        gids.append(ch.gid[run])
    n["rows"] = int(torch.unique(torch.cat(gids)).numel()) if gids else 0
    n["tiles"] = binn.n_tx * binn.n_ty
    return n


def compute_normals_from_depth(depth: torch.Tensor, K: torch.Tensor):
    H, W = depth.shape
    ys = torch.arange(H, dtype=depth.dtype, device=depth.device) + 0.5
    xs = torch.arange(W, dtype=depth.dtype, device=depth.device) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([(px - K[0, 2]) / K[0, 0] * depth,
                       (py - K[1, 2]) / K[1, 1] * depth, depth], dim=-1)

    def grad_axis(a, dim):
        n = a.shape[dim]
        interior = (a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)) / 2.0
        first = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
        last = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
        return torch.cat([first, interior, last], dim=dim)

    n = torch.linalg.cross(grad_axis(pts, 1), grad_axis(pts, 0), dim=-1)
    return n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-24)


def prepare(params: dict, active, cam, width: int, height: int, sh_degree: int,
            ch_sem: int):
    """Projection, colours, normals and the packed features of one view:
    (feats, binning, radius)."""
    xyz = params["xyz"]
    scaling = torch.exp(params["log_scale"])
    opacity = torch.sigmoid(params["logit_opacity"])[:, 0]
    proj = project(xyz, scaling, params["quat"], cam.viewmatrix,
                   cam.projmatrix, cam.tanfov[0], cam.tanfov[1], width,
                   height, opacity)
    radius = torch.where(active, proj.radius, 0)
    shs = torch.cat([params["f_dc"], params["f_rest"]], dim=1).transpose(1, 2)
    dir_pp = safe_normalize(xyz - cam.cam_center[None])
    rgb = torch.clamp_min(eval_sh(sh_degree, shs, dir_pp) + 0.5, 0.0)
    normal = shortest_axis_normal(scaling, params["quat"])
    view_dir = xyz - cam.cam_center[None]
    sign = torch.where(torch.sum(view_dir * normal, -1) > 0, 1.0, -1.0
                       ).to(normal.dtype)
    normal_cam = (normal * sign[:, None]) @ cam.viewmatrix[:3, :3]
    sem = params["obj_dc"][:, 0, :] if ch_sem else None
    feats = pack_features(proj, opacity, rgb, normal_cam, sem)
    binn = bin_gaussians(proj.mean2d, radius, proj.depth_z, width, height,
                         proj.ext)
    return feats, binn, radius


def render(params: dict, active, cam, width: int, height: int, bg,
           sh_degree: int, ch_sem: int, depth_mode: str, mask_depth_thr: float,
           scene_extent: float, cam_mask=None, classifier=None) -> dict:
    """The renderer's output dict: render, depth, normal, est_normal, alpha,
    mask, depth_var, distortion and, with semantic channels, render_sem
    (the classifier's logits when one is given)."""
    feats, binn, _ = prepare(params, active, cam, width, height, sh_degree,
                             ch_sem)
    cam_vec = torch.cat([cam.intr, bg.to(cam.intr), cam.intr.new_zeros(1)])
    img = composite(feats, binn, cam_vec, width, height, ch_sem, depth_mode)
    wd_sum, wd2_sum, alpha = img[6], img[7], img[8]
    depth = wd_sum
    if mask_depth_thr > 0:
        mask = depth < scene_extent * mask_depth_thr
    else:
        mask = torch.ones_like(depth, dtype=torch.bool)
    if cam_mask is not None:
        mask = mask & (cam_mask > 0)
    K = torch.eye(3, device=depth.device, dtype=depth.dtype)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = cam.intr.to(depth.dtype)
    mean = wd_sum / (alpha + 1e-8)
    mean2 = wd2_sum / (alpha + 1e-8)
    out = {
        "render": img[0:3],
        "depth": depth,
        "normal": safe_normalize(img[3:6].permute(1, 2, 0)),
        "est_normal": compute_normals_from_depth(depth, K),
        "alpha": alpha,
        "mask": mask,
        "depth_var": torch.clamp_min(mean2 - mean * mean, 0.0),
        "distortion": alpha * wd2_sum - wd_sum * wd_sum,
    }
    if ch_sem:
        sem_feat = img[9:9 + ch_sem]
        out["render_sem"] = (classifier(sem_feat) if classifier is not None
                             else sem_feat)
    return out
