"""Geometry evaluation (vcr_gaus_tpu/evaluation/geometry.py): the DTU part
(the grid sampler, the radius downsample, the Chamfer protocol) and the TNT
part (the voxel downsample, the PCA box crop, ICP, precision/recall/F1 at
tau), over one nearest-neighbour search.

Point work runs on the given device, in the dtype numpy computes it in:
float64 wherever numpy promotes (DTU ground truth is in mm, where float32
would lose the protocol's 0.2 mm scale), the input's float32 where numpy
keeps it (a PLY cloud's voxel keys). Neighbour searches bucket the points
into a uniform grid and compare direct coordinate differences,
((dx^2 + dy^2) + dz^2) as scipy's cKDTree sums them, never the
|a|^2 + |b|^2 - 2ab expansion, which cancels at coordinates of hundreds of
mm. 3x3 algebra (eigh, SVD, determinants) stays in numpy on the host, so
LAPACK's sign choices are the JAX package's. Each function takes and
returns numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

CELL_LIMIT = 1 << 19        # cell index bound per axis of a neighbour grid
QUERY_CHUNK = 1 << 20       # queries whose 27 cells are looked up at once
MAX_CANDIDATES = 1 << 25    # (query, point) pairs compared at once
SAFETY = 1e-9               # relative margin of the grid's coverage tests


def _norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt((x0^2 + x1^2) + x2^2): numpy's norm over a last axis of 3."""
    sq = x * x
    return torch.sqrt((sq[:, 0] + sq[:, 1]) + sq[:, 2])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """numpy's cross product, each term rounded on its own."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    d = d * d
    return (d[:, 0] + d[:, 1]) + d[:, 2]


def sample_points_on_mesh(verts: np.ndarray, faces: np.ndarray,
                          density_thresh: float, seed: int = 0,
                          device: str | torch.device = "cuda") -> np.ndarray:
    """The DTU evaluator's deterministic barycentric grid: per triangle with
    edges v1 = B-A, v2 = C-A (lengths l1, l2, parallelogram area area2), the
    pitch thr = thresh * sqrt(l1 l2 / area2), the cell centres
    ((i+.5)/n1, (j+.5)/n2) with n1 = floor(l1/thr), n2 = floor(l2/thr) and
    u + v < 1, each at A + u v1 + v v2; zero-area triangles dropped; the
    vertices first. ``seed`` is accepted for call-site compatibility."""
    dev = resolve_device(device)
    v = torch.from_numpy(np.ascontiguousarray(verts)).to(dev)
    f = torch.from_numpy(np.asarray(faces, np.int64)).to(dev)
    A = v[f[:, 0]]
    v1 = v[f[:, 1]] - A
    v2 = v[f[:, 2]] - A
    l1, l2 = _norm(v1), _norm(v2)
    area2 = _norm(_cross(v1, v2))
    nz = area2 > 0
    A, v1, v2, l1, l2, area2 = (x[nz] for x in (A, v1, v2, l1, l2, area2))
    if len(A) == 0:
        return verts.copy()
    thr = density_thresh * torch.sqrt(l1 * l2 / area2)
    n1 = torch.floor(l1 / thr)
    n2 = torch.floor(l2 / thr)
    counts = ((n1 + 1) * (n2 + 1)).to(torch.int64)
    tri = torch.repeat_interleave(torch.arange(len(A), device=dev), counts)
    starts = torch.cumsum(counts, 0) - counts
    local = torch.arange(tri.numel(), device=dev) - starts[tri]
    cols = (n2[tri] + 1).to(torch.int64)
    i = torch.div(local, cols, rounding_mode="floor")
    j = local - i * cols
    u = (i.double() + 0.5) / torch.clamp_min(n1[tri], 1e-7)
    w = (j.double() + 0.5) / torch.clamp_min(n2[tri], 1e-7)
    keep = (u + w) < 1
    tri, u, w = tri[keep], u[keep], w[keep]
    pts = A[tri] + u[:, None] * v1[tri] + w[:, None] * v2[tri]
    return np.concatenate([verts, pts.cpu().numpy()], axis=0)


class _CellGrid:
    """Points bucketed into cubic cells of side ``h`` from ``lo``, sorted by
    cell: the cells' keys, their first sorted point and their counts."""

    def __init__(self, pts: torch.Tensor, lo: torch.Tensor, h: float):
        self.lo, self.h = lo, h
        key = self.keys(self.cells(pts))
        self.order = torch.argsort(key, stable=True)
        self.pts = pts[self.order]
        self.uniq, self.counts = torch.unique_consecutive(
            key[self.order], return_counts=True)
        self.starts = torch.cumsum(self.counts, 0) - self.counts

    def cells(self, pts: torch.Tensor) -> torch.Tensor:
        """Integer cells, clamped: a clamped cell lies far beyond every
        cell of the grid's points, whose span is bounded by the callers."""
        c = torch.floor((pts - self.lo) / self.h)
        return c.clamp(-CELL_LIMIT + 2, CELL_LIMIT - 2).to(torch.int64)

    @staticmethod
    def keys(cells: torch.Tensor) -> torch.Tensor:
        c = cells + CELL_LIMIT
        return (c[..., 0] * (2 * CELL_LIMIT) + c[..., 1]) * (2 * CELL_LIMIT) \
            + c[..., 2]

    def pairs(self, qcells: torch.Tensor):
        """(query row, sorted point index) of every point in the 27 cells
        around each query's cell, in chunks of at most MAX_CANDIDATES
        pairs."""
        dev = qcells.device
        r = torch.arange(-1, 2, device=dev)
        offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                           -1).reshape(-1, 3)
        for first in range(0, len(qcells), QUERY_CHUNK):
            key = self.keys(qcells[first:first + QUERY_CHUNK, None, :]
                            + offs[None]).reshape(-1)
            pos = torch.searchsorted(self.uniq, key).clamp(
                max=len(self.uniq) - 1)
            cnt = torch.where(self.uniq[pos] == key, self.counts[pos], 0)
            bounds = torch.cumsum(cnt.reshape(-1, 27).sum(1), 0).cpu()
            q0, nq = 0, len(bounds)
            while q0 < nq:
                base = int(bounds[q0 - 1]) if q0 else 0
                q1 = int(torch.searchsorted(bounds, base + MAX_CANDIDATES,
                                            right=True))
                q1 = min(max(q1, q0 + 1), nq)
                c = cnt[27 * q0:27 * q1]
                rep = torch.repeat_interleave(
                    torch.arange(27 * q0, 27 * q1, device=dev), c)
                within = torch.arange(rep.numel(), device=dev) - (
                    torch.cumsum(c, 0) - c)[rep - 27 * q0]
                yield (torch.div(rep, 27, rounding_mode="floor") + first,
                       self.starts[pos[rep]] + within)
                q0 = q1


def cell_size(pts: torch.Tensor, lo: torch.Tensor, floor_h: float,
              occupancy: float = 4.0) -> float:
    """A cell side for ``pts``: from the bounding box's volume per point,
    halved until the occupied cells hold ``occupancy`` points on average,
    never below ``floor_h``."""
    extent = float((pts.amax(0) - lo).max())
    h = max(extent / len(pts) ** (1 / 3), floor_h)
    while h / 2 >= floor_h:
        n_cells = len(torch.unique(_CellGrid.keys(
            torch.floor((pts - lo) / h).to(torch.int64))))
        if len(pts) / n_cells <= occupancy:
            break
        h /= 2
    return h


class _Nearest:
    """Nearest neighbours in ``target`` by doubling uniform grids: a query
    resolves at the first cell side h (doubling from ``cell_size``) whose
    27-cell block holds a point within h. Each level's grid is built once
    and kept, so repeated searches against one target (ICP) reuse them."""

    def __init__(self, target: torch.Tensor):
        self.t = target
        self.lo, self.hi = target.amin(0), target.amax(0)
        # the target's cells stay below CELL_LIMIT / 2; a query beyond that
        # range clamps to a cell far from them and resolves at a later
        # level. A target of one point has no span: its coordinates' scale
        # bounds the levels instead
        span = max(float((self.hi - self.lo).max()),
                   1e-12 * float(target.abs().max()), 1e-30)
        self.h0 = cell_size(target, self.lo, span / (CELL_LIMIT // 2))
        self.grids: dict[int, _CellGrid] = {}

    def grid(self, level: int) -> _CellGrid:
        if level not in self.grids:
            self.grids[level] = _CellGrid(self.t, self.lo,
                                          self.h0 * 2 ** level)
        return self.grids[level]

    def first_level(self, level: int, q: torch.Tensor) -> int:
        """The first level from ``level`` whose reach may resolve one of
        the queries ``q``: none resolves before its reach covers the
        query's distance to the target's bounding box."""
        gap = torch.clamp_min(torch.maximum(self.lo - q, q - self.hi), 0)
        gap = float(_norm(gap).min())
        while self.h0 * 2.0 ** level * (1 - SAFETY) < gap:
            level += 1
        return level

    def query(self, q: torch.Tensor, max_dist: float | None = None):
        """(squared distance, target index) of each query's nearest point,
        in float64, the lowest index among equally near ones. With
        ``max_dist`` the search stops at the first level beyond it, and a
        query left unresolved (its nearest point lies beyond max_dist)
        gets (inf, -1)."""
        dev = q.device
        n_t = len(self.t)
        best = torch.full((len(q),), float("inf"), dtype=torch.float64,
                          device=dev)
        arg = torch.full((len(q),), -1, dtype=torch.int64, device=dev)
        todo = torch.arange(len(q), device=dev)
        level = 0
        while todo.numel():
            level = self.first_level(level, q[todo])
            grid = self.grid(level)
            qt = q[todo]
            b2 = torch.full((len(todo),), float("inf"), dtype=torch.float64,
                            device=dev)
            bi = torch.full((len(todo),), n_t, dtype=torch.int64, device=dev)
            for qi, ti in grid.pairs(grid.cells(qt)):
                # every candidate of a query lies in one chunk, so its
                # minimum is final before the index pass
                d2 = _sq_dists(qt[qi], grid.pts[ti])
                b2.scatter_reduce_(0, qi, d2, "amin")
                bi.scatter_reduce_(0, qi, torch.where(
                    d2 == b2[qi], grid.order[ti], n_t), "amin")
            # every point within h(1 - SAFETY) of a query lies in its block
            reach = grid.h * (1 - SAFETY)
            done = b2 <= reach * reach
            best[todo[done]] = b2[done]
            arg[todo[done]] = bi[done]
            todo = todo[~done]
            if max_dist is not None and reach >= max_dist:
                break                       # the rest lie beyond max_dist
            level += 1
        return best, arg


def as_tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A numpy array on ``dev``, dtype kept."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def nearest_neighbours(query: np.ndarray, target: np.ndarray,
                       max_dist: float | None = None,
                       device: str | torch.device = "cuda"):
    """(distance, index) of each query point's nearest neighbour in target,
    in float64, as cKDTree.query(k=1) gives them; among equally near points
    the lowest index. With ``max_dist`` the search stops at the first grid
    level beyond it, and a query left unresolved there (its nearest point
    lies beyond max_dist) gets (inf, -1)."""
    if len(query) == 0 or len(target) == 0:
        return np.zeros(0), np.zeros(0, np.int64)
    dev = resolve_device(device)
    q = as_tensor(np.asarray(query, np.float64), dev)
    t = as_tensor(np.asarray(target, np.float64), dev)
    d2, idx = _Nearest(t).query(q, max_dist)
    return torch.sqrt(d2).cpu().numpy(), idx.cpu().numpy()


def nn_distances(query: np.ndarray, target: np.ndarray,
                 max_dist: float | None = None,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """Distance from each query point to its nearest neighbour in target,
    in float64; with ``max_dist``, inf for a query left unresolved (its
    nearest point lies beyond max_dist)."""
    return nearest_neighbours(query, target, max_dist, device)[0]


def _radius_pairs(pts: torch.Tensor, radius: float):
    """Index pairs (i, j), i < j, with ((dx^2 + dy^2) + dz^2) <= r^2."""
    r2 = radius * radius
    lo = pts.amin(0)
    h = radius * (1 + SAFETY)
    if float((pts.amax(0) - lo).max()) / h >= CELL_LIMIT // 2:
        raise ValueError(f"radius {radius} is too small for a cloud of "
                         "this extent")
    grid = _CellGrid(pts, lo, h)
    ei, ej = [], []
    for qi, ti in grid.pairs(grid.cells(pts)):
        tj = grid.order[ti]
        hit = (qi < tj) & (_sq_dists(pts[qi], grid.pts[ti]) <= r2)
        ei.append(qi[hit])
        ej.append(tj[hit])
    return torch.cat(ei), torch.cat(ej)


def _greedy_keep(n: int, ei: torch.Tensor, ej: torch.Tensor) -> torch.Tensor:
    """The greedy pass in index order -- keep a point unless an earlier kept
    point lies within the radius -- in parallel rounds: an undecided point
    with no undecided earlier neighbour is kept, and its neighbours are
    removed. Each round decides at least the earliest undecided point, and
    the result is the sequential one (the lexicographically first maximal
    independent set)."""
    dev = ei.device
    kept = torch.zeros(n, dtype=torch.bool, device=dev)
    undecided = torch.ones(n, dtype=torch.bool, device=dev)
    while True:
        live = undecided[ei] & undecided[ej]
        ei, ej = ei[live], ej[live]
        blocked = torch.zeros(n, dtype=torch.bool, device=dev)
        blocked[ej] = True
        new = undecided & ~blocked
        kept |= new
        undecided &= ~new
        removed = torch.zeros(n, dtype=torch.bool, device=dev)
        removed[ej[new[ei]]] = True
        removed[ei[new[ej]]] = True
        undecided &= ~removed
        if not bool(undecided.any()):
            return kept


def radius_downsample(points: np.ndarray, radius: float, seed: int = 0,
                      device: str | torch.device = "cuda") -> np.ndarray:
    """The DTU evaluator's shuffle and greedy radius suppression: points in
    ``default_rng(seed).permutation`` order, each kept unless an earlier
    kept point lies within ``radius`` (inclusive, float64)."""
    dev = resolve_device(device)
    order = np.random.default_rng(seed).permutation(len(points))
    pts = points[order]
    if len(pts) == 0:
        return pts
    p = torch.from_numpy(np.asarray(pts, np.float64)).to(dev)
    ei, ej = _radius_pairs(p, radius)
    return pts[_greedy_keep(len(pts), ei, ej).cpu().numpy()]


def dtu_chamfer(data_pcd: np.ndarray, stl_points: np.ndarray,
                downsample_density: float = 0.2, max_dist: float = 20.0,
                patch_size: float = 60.0, obs_mask=None, bb=None, res=None,
                ground_plane=None, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """The DTU Chamfer protocol. ``data_pcd`` is the point sample of the
    culled mesh; ObsMask/BB/Res/Plane come from the DTU SampleSet .mat
    files when given."""
    data_down = radius_downsample(data_pcd, downsample_density, seed, device)

    data_in = data_down
    if obs_mask is not None:
        bb = bb.astype(np.float32)
        inbound = np.all((data_down >= bb[:1] - patch_size)
                         & (data_down < bb[1:] + patch_size * 2), axis=-1)
        data_in = data_down[inbound]
        grid = np.around((data_in - bb[:1]) / res).astype(np.int32)
        shape = np.asarray(obs_mask.shape)[None]
        g_in = np.all((grid >= 0) & (grid < shape), axis=-1)
        gi = grid[g_in]
        in_obs = obs_mask[gi[:, 0], gi[:, 1], gi[:, 2]].astype(bool)
        data_in_obs = data_in[g_in][in_obs]
    else:
        data_in_obs = data_in

    d2s = nn_distances(data_in_obs, stl_points, max_dist, device)
    mean_d2s = float(d2s[d2s < max_dist].mean()) if len(d2s) else np.inf

    stl_above = stl_points
    if ground_plane is not None:
        hom = np.concatenate([stl_points,
                              np.ones_like(stl_points[:, :1])], -1)
        stl_above = stl_points[(hom @ ground_plane.reshape(4)) > 0]
    s2d = nn_distances(stl_above, data_in, max_dist, device)
    mean_s2d = float(s2d[s2d < max_dist].mean()) if len(s2d) else np.inf
    return {"mean_d2s": mean_d2s, "mean_s2d": mean_s2d,
            "overall": (mean_d2s + mean_s2d) / 2}


# ---------------------------------------------------------------------------
# TNT: voxel downsample, PCA box, ICP, F1 at tau
# ---------------------------------------------------------------------------

def true_divide(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` rounded as numpy rounds it: a true division by ``s`` in
    x's dtype (CUDA multiplies by the reciprocal of a host scalar)."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def affine(points: np.ndarray, A: np.ndarray, b: np.ndarray,
           dev: torch.device) -> torch.Tensor:
    """``points @ A.T + b`` in float64 on ``dev``."""
    p = as_tensor(points, dev).to(torch.float64)
    return p @ as_tensor(np.asarray(A, np.float64), dev).T \
        + as_tensor(np.asarray(b, np.float64), dev)


def voxel_downsample(points: np.ndarray, voxel: float,
                     device: str | torch.device = "cuda") -> np.ndarray:
    """The centroid of each occupied voxel of side ``voxel`` from the
    cloud's minimum (open3d's voxel_down_sample), in float64, in the
    lexicographic order of the voxels' integer keys, as np.unique gives
    them. The keys are floor((p - min) / voxel) in the input's dtype. Each
    centroid sums its points in input order on the CPU (np.add.at's sums
    exactly); CUDA's float64 atomics add them in any order."""
    if voxel <= 0 or len(points) == 0:
        return points
    dev = resolve_device(device)
    p = as_tensor(points, dev)
    keys = torch.floor(true_divide(p - p.amin(0), voxel)).to(torch.int64)
    ext = [int(e) + 1 for e in keys.amax(0).tolist()]
    if ext[0] * ext[1] * ext[2] >= 1 << 63:
        raise ValueError(f"voxel {voxel} is too small for a cloud of "
                         f"{ext} voxels")
    lin = (keys[:, 0] * ext[1] + keys[:, 1]) * ext[2] + keys[:, 2]
    order = torch.argsort(lin, stable=True)
    _, inv, counts = torch.unique_consecutive(
        lin[order], return_inverse=True, return_counts=True)
    sums = torch.zeros((len(counts), 3), dtype=torch.float64, device=dev)
    sums.index_add_(0, inv, p[order].to(torch.float64))
    return (sums / counts[:, None]).cpu().numpy()


def pca_obb(points: np.ndarray, device: str | torch.device = "cuda"):
    """PCA oriented bounding box: (R (3,3), t (3,)) such that
    ``points @ R.T + t`` is axis-aligned and centred. The mean is numpy's
    (a sequential sum in the input's dtype, which no parallel reduction
    reproduces in float32); the covariance (np.cov, N - 1) and the box
    extents are reduced on the device, eigh runs on the host."""
    dev = resolve_device(device)
    c = points.mean(0)
    x = as_tensor(points, dev) - as_tensor(c, dev)     # in the input's dtype
    X = x.to(torch.float64)
    Xc = X - X.mean(0)
    cov = (Xc.T @ Xc).cpu().numpy() * np.true_divide(1, len(points) - 1)
    _, vecs = np.linalg.eigh(cov)
    R = vecs.T
    if np.linalg.det(R) < 0:
        R[2] *= -1
    aligned = X @ as_tensor(R, dev).T
    mid = (aligned.amax(0).cpu().numpy() + aligned.amin(0).cpu().numpy()) / 2
    t = -(c @ R.T) - mid
    return R, t


def obb_keep(points: np.ndarray, ref: np.ndarray, margin: float = 0.0,
             device: str | torch.device = "cuda") -> np.ndarray:
    """Keep-mask of the points strictly inside ``ref``'s PCA box grown by
    ``margin`` (the TNT crop of eval_tnt.py and crop_mesh.py)."""
    dev = resolve_device(device)
    R, t = pca_obb(ref, dev)
    ref_aligned = affine(ref, R, t, dev)
    lo = ref_aligned.amin(0) - margin
    hi = ref_aligned.amax(0) + margin
    aligned = affine(points, R, t, dev)
    return torch.all((aligned > lo) & (aligned < hi), dim=1).cpu().numpy()


def icp_refine(src: np.ndarray, dst: np.ndarray, iters: int = 20,
               max_corr: float | None = None,
               device: str | torch.device = "cuda") -> np.ndarray:
    """Point-to-point ICP with Kabsch updates: the 4x4 transform mapping
    src -> dst. The target's grids are built once for every iteration; the
    correspondences and their 3x3 cross-covariance are on the device, the
    SVD and its reflection fix on the host."""
    dev = resolve_device(device)
    T = np.eye(4)
    cur = as_tensor(np.asarray(src, np.float64), dev)
    target = as_tensor(np.asarray(dst, np.float64), dev)
    nn = _Nearest(target)
    for _ in range(iters):
        d2, idx = nn.query(cur, max_corr)
        if max_corr is not None:
            keep = torch.sqrt(d2) < max_corr
            if int(keep.sum()) < 10:
                break
            a, b = cur[keep], target[idx[keep]]
        else:
            a, b = cur, target[idx]
        ca, cb = a.mean(0), b.mean(0)
        H = ((a - ca).T @ (b - cb)).cpu().numpy()
        ca, cb = ca.cpu().numpy(), cb.cpu().numpy()
        U, _, Vt = np.linalg.svd(H)
        R = Vt.T @ U.T
        if np.linalg.det(R) < 0:
            Vt[2] *= -1
            R = Vt.T @ U.T
        t = cb - R @ ca
        step = np.eye(4)
        step[:3, :3] = R
        step[:3, 3] = t
        T = step @ T
        cur = cur @ as_tensor(R, dev).T + as_tensor(t, dev)
    return T


def tnt_f1(pred_verts, pred_faces, gt_points, threshold: float = 0.05,
           down_sample: float = 0.02, crop_to_gt_obb: bool = True,
           run_icp: bool = False,
           device: str | torch.device = "cuda") -> dict:
    """The lightweight TNT metric: the crop to the GT's PCA box, optional
    ICP, the voxel downsample, bidirectional distances, and Acc, Comp,
    Prec, Recal and F-score at ``threshold``."""
    dev = resolve_device(device)
    pred = pred_verts
    if crop_to_gt_obb and len(gt_points):
        pred = pred[obb_keep(pred, gt_points, device=dev)]
    if run_icp and len(pred) > 100:
        T = icp_refine(voxel_downsample(pred, down_sample * 2, dev),
                       voxel_downsample(gt_points, down_sample * 2, dev),
                       max_corr=threshold * 5, device=dev)
        pred = affine(pred, T[:3, :3], T[:3, 3], dev).cpu().numpy()
    p = voxel_downsample(pred, down_sample, dev)
    g = voxel_downsample(gt_points, down_sample, dev)
    dist_g2p = nn_distances(g, p, device=dev)      # completeness direction
    dist_p2g = nn_distances(p, g, device=dev)      # accuracy direction
    precision = float((dist_p2g < threshold).mean()) if len(p) else 0.0
    recall = float((dist_g2p < threshold).mean()) if len(g) else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"Acc": float(dist_p2g.mean()) if len(p) else np.inf,
            "Comp": float(dist_g2p.mean()) if len(g) else np.inf,
            "Prec": precision, "Recal": recall, "F-score": f1}
