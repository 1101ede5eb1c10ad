"""Neighbour queries (vcr_gaus_tpu/ops/knn.py): k-nearest-neighbour squared
distances for the scale init (``knn_sq_dists``, ``mean_sq_dist_to_3nn``)
and the outlier tests of mesh extraction (``radius_neighbor_counts``,
``remove_radius_outlier``, ``remove_statistical_outlier``).

The algorithm is the JAX package's on both sides of ``EXACT_MAX_N``: blocked
brute force below it; above it three passes, each sorting the points along
a Morton curve (in three fixed rotated frames) and searching a window of
+-``WINDOW`` sorted neighbours (``COUNT_WINDOW`` for the radius counts),
merged and deduplicated by neighbour id, or the counts' maximum taken.

Sums of three products are evaluated as chains of fused multiply-adds, in
the order XLA evaluates them on the CPU (emulated through float64, whose
product of two float32 values is exact). The exact path's
|p|^2 + |q|^2 - 2 p.q cancels for near neighbours, so a different rounding
there moves their distances far more than one ulp.
"""

from __future__ import annotations

import numpy as np
import torch

EXACT_MAX_N = 8192          # below this, blocked brute force is cheap
K = 3                       # neighbours of the scale init
WINDOW = 32                 # +- sorted neighbours searched per Morton pass
COUNT_WINDOW = 48           # the same for the radius counts
BLOCK = 4096                # points per block of a Morton pass


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding (the product is exact in
    float64)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k] * b[..., k] over a last axis of 3, as an FMA chain."""
    return _fma(a[..., 2], b[..., 2],
                _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _expand_bits10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v with two zero bits between each."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """(N,3) -> (N,) int64 Z-order codes on a 1024^3 grid over the bbox."""
    lo = points.amin(dim=0)
    hi = points.amax(dim=0)
    q = (points - lo) / torch.clamp_min(hi - lo, 1e-12)
    cell = (q * 1023.0).to(torch.int64).clamp(0, 1023)
    return (_expand_bits10(cell[:, 0]) | (_expand_bits10(cell[:, 1]) << 1)
            | (_expand_bits10(cell[:, 2]) << 2))


def _fixed_rotations() -> list[np.ndarray]:
    """The identity and two fixed rotations that decorrelate the Morton
    curves between passes (rotations keep distances)."""
    mats = [np.eye(3, dtype=np.float32)]
    for seed in (1, 2):
        q = np.random.default_rng(seed).normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        mats.append(np.array(
            [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
             [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
             [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
            np.float32))
    return mats


_ROTS = _fixed_rotations()


def _knn_exact(points: torch.Tensor, k: int, block: int = 1024):
    """Blocked O(N^2) exact kNN squared distances, (N, k)."""
    n = points.shape[0]
    sq = _dot3(points, points)
    out = []
    for s in range(0, n, block):
        p = points[s:s + block]
        dots = _dot3(p[:, None, :], points[None, :, :])
        d2 = sq[s:s + block, None] + sq[None, :] - 2.0 * dots
        d2 = torch.clamp_min(d2, 0.0)
        rows = torch.arange(p.shape[0], device=points.device)
        d2[rows, rows + s] = float("inf")
        out.append(torch.topk(d2, min(k, n), dim=1, largest=False).values)
    d2 = torch.cat(out)
    if d2.shape[1] < k:         # fewer points than k + 1: pad as JAX does
        d2 = torch.cat([d2, d2.new_full((n, k - d2.shape[1]),
                                        float("inf"))], dim=1)
    return d2


def _morton_windows(points: torch.Tensor, window: int, block: int,
                    rot: np.ndarray | None):
    """One Morton pass, optionally in a rotated frame: the sort order, and
    per block of sorted points (their window's sorted indices (B, 2W), its
    validity, the squared distances)."""
    n = points.shape[0]
    dev = points.device
    if rot is not None:
        r = torch.as_tensor(rot, device=dev)
        points = _dot3(points[:, None, :], r[None, :, :])
    order = torch.argsort(morton_codes(points), stable=True)
    sorted_pts = points[order]
    offs = torch.cat([torch.arange(-window, 0, device=dev),
                      torch.arange(1, window + 1, device=dev)])

    def blocks():
        for s in range(0, n, block):
            idx = torch.arange(s, min(s + block, n), device=dev)
            nbr = idx[:, None] + offs[None, :]                   # (B, 2W)
            valid = (nbr >= 0) & (nbr < n)
            nbr = nbr.clamp(0, n - 1)
            diff = sorted_pts[idx][:, None, :] - sorted_pts[nbr]
            yield nbr, valid, _dot3(diff, diff)

    return order, blocks()


def _unsort(order: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Rows of ``values`` in sorted order back to the original numbering."""
    out = torch.empty_like(values)
    out[order] = values
    return out


def _window_pass(points: torch.Tensor, k: int, window: int, block: int,
                 rot: np.ndarray | None = None):
    """One Morton pass; returns ((N,k) sq dists, (N,k) neighbour indices in
    the original numbering)."""
    order, blocks = _morton_windows(points, window, block, rot)
    d2_out, nbr_out = [], []
    for nbr, valid, d2 in blocks:
        d2 = torch.where(valid, d2, float("inf"))
        top = torch.topk(d2, k, dim=1, largest=False)
        d2_out.append(top.values)
        nbr_out.append(torch.gather(order[nbr], 1, top.indices))
    return (_unsort(order, torch.cat(d2_out)),
            _unsort(order, torch.cat(nbr_out)))


def knn_sq_dists(points: torch.Tensor, k: int = K) -> torch.Tensor:
    """Squared distances to the k nearest neighbours, (N, k): exact for
    N <= EXACT_MAX_N, else the three Morton-window passes merged by
    neighbour id."""
    n = points.shape[0]
    if n <= EXACT_MAX_N:
        return _knn_exact(points, k)
    passes = [_window_pass(points, k, WINDOW, BLOCK, r) for r in _ROTS]
    d2 = torch.cat([d for d, _ in passes], dim=1)            # (N, 3K)
    nbr = torch.cat([i for _, i in passes], dim=1)
    # the same neighbour is found by several passes: keep its first
    # (nearest) occurrence only
    ordr = torch.argsort(d2, dim=1, stable=True)
    d2s = torch.gather(d2, 1, ordr)
    nbs = torch.gather(nbr, 1, ordr)
    m = d2.shape[1]
    earlier = torch.triu(torch.ones((m, m), dtype=torch.bool,
                                    device=points.device), diagonal=1)
    dup = torch.any((nbs[:, None, :] == nbs[:, :, None]) & earlier[None],
                    dim=1)
    d2s = torch.where(dup, float("inf"), d2s)
    return torch.topk(d2s, k, dim=1, largest=False).values


def mean_sq_dist_to_3nn(points: torch.Tensor) -> torch.Tensor:
    """Mean of the squared distances to the 3 nearest neighbours, (N,)."""
    d2 = knn_sq_dists(points)
    d2 = torch.where(torch.isfinite(d2), d2, 0.0)
    return d2.mean(dim=-1)


def radius_neighbor_counts(points: torch.Tensor, radius: float
                           ) -> torch.Tensor:
    """Neighbours within ``radius``, (N,) int64: exact for N <= EXACT_MAX_N
    (over the 64 nearest), else the maximum over the three Morton-window
    passes, a lower bound on the true count."""
    n = points.shape[0]
    r2 = torch.tensor(np.float32(radius) * np.float32(radius),
                      device=points.device)
    if n <= EXACT_MAX_N:
        return (_knn_exact(points, min(n - 1, 64)) <= r2).sum(dim=-1)
    counts = []
    for rot in _ROTS:
        order, blocks = _morton_windows(points, COUNT_WINDOW, BLOCK, rot)
        cnt = torch.cat([((d2 <= r2) & valid).sum(dim=-1)
                         for _, valid, d2 in blocks])
        counts.append(_unsort(order, cnt))
    return torch.maximum(torch.maximum(counts[0], counts[1]), counts[2])


def remove_radius_outlier(points: torch.Tensor, nb_points: int = 5,
                          radius: float = 0.01) -> torch.Tensor:
    """Keep-mask of the points with >= nb_points neighbours within
    radius."""
    return radius_neighbor_counts(points, radius) >= nb_points


def remove_statistical_outlier(points: torch.Tensor, nb_neighbors: int = 20,
                               std_ratio: float = 2.0) -> torch.Tensor:
    """Keep-mask of the points whose mean distance to their nb_neighbors
    nearest is within mean + std_ratio * std of the population."""
    d2 = knn_sq_dists(points, nb_neighbors)
    d = torch.sqrt(torch.clamp_min(d2, 0.0)).mean(dim=-1)
    return d <= d.mean() + std_ratio * d.std(correction=0)
