"""The official Tanks and Temples protocol (vcr_gaus_tpu/evaluation/
tnt_official.py, after the toolbox's run.py, registration.py and
evaluation.py):
  1. read the estimated and the GT camera trajectories (.log),
  2. align: RANSAC over index-matched camera centres (minimal Umeyama
     hypotheses and an inlier refit), composed with the scene's
     ``{scene}_trans.txt``,
  3. crop both clouds to the scene's SelectionPolygonVolume json,
  4. refine with ICP at decreasing correspondence radii (3 stages),
  5. voxel-downsample at tau/2 and score precision/recall/F1 at tau.

The trajectories, Umeyama and the RANSAC draws are host numpy, as in the
JAX package (the same ``default_rng(seed)`` draws, so the same inliers);
the transforms, the crop, ICP, the downsample and the distances run on the
given device (``evaluation/geometry.py``, called through its module so that
a profiler's wrappers see each stage).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..meshing.extract import load_mesh_ply
from ..utils.device import resolve_device
from . import geometry as GE


def read_trajectory_log(path: str) -> np.ndarray:
    """Read a TNT/Redwood .log trajectory: blocks of 'i j k' and a 4x4
    matrix. Returns (N, 4, 4) camera-to-world poses."""
    mats = []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i + 5 <= len(lines):
        rows = [list(map(float, lines[i + 1 + r].split())) for r in range(4)]
        mats.append(np.asarray(rows))
        i += 5
    return np.stack(mats)


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Closed-form similarity transform aligning src -> dst (Umeyama
    1991). Returns 4x4."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var = (sc ** 2).sum() / len(src)
        c = np.trace(np.diag(D) @ S) / var
    else:
        c = 1.0
    t = mu_d - c * R @ mu_s
    T = np.eye(4)
    T[:3, :3] = c * R
    T[:3, 3] = t
    return T


def ransac_umeyama(src: np.ndarray, dst: np.ndarray, thresh: float = 0.2,
                   iters: int = 2000, seed: int = 0) -> np.ndarray:
    """RANSAC-robust similarity alignment over index-matched pairs: minimal
    3-point hypotheses, the inlier count at ``thresh``, an Umeyama refit on
    the best inlier set (the toolbox registers camera centres with the
    identity correspondence list and max distance 0.2, where a camera may
    be a gross outlier). Deterministic for a given seed."""
    n = len(src)
    if n < 4:
        return umeyama(src, dst)
    rng = np.random.default_rng(seed)
    best_inl, best_count = None, -1
    for _ in range(iters):
        idx = rng.choice(n, 3, replace=False)
        try:
            T = umeyama(src[idx], dst[idx])
        except np.linalg.LinAlgError:  # degenerate minimal set
            continue
        res = np.linalg.norm(src @ T[:3, :3].T + T[:3, 3] - dst, axis=1)
        inl = res < thresh
        c = int(inl.sum())
        if c > best_count:
            best_count, best_inl = c, inl
    if best_count < 3:
        return umeyama(src, dst)
    return umeyama(src[best_inl], dst[best_inl])


def crop_polygon_volume(points: np.ndarray, crop: dict,
                        device: str | torch.device = "cuda") -> np.ndarray:
    """Keep-mask for an open3d SelectionPolygonVolume json: a polygon in the
    plane orthogonal to ``orthogonal_axis`` and [axis_min, axis_max] along
    it. The even-odd test runs over the polygon's edges, each one pass
    over the points, with the JAX package's expression order; the polygon
    test is in float64, the axis bounds in the points' dtype, as numpy
    promotes them."""
    dev = resolve_device(device)
    axis = {"X": 0, "Y": 1, "Z": 2}[crop["orthogonal_axis"].upper()]
    lo, hi = float(crop["axis_min"]), float(crop["axis_max"])
    poly = np.asarray(crop["bounding_polygon"])
    other = [a for a in range(3) if a != axis]
    p = GE.as_tensor(points, dev)
    px = p[:, other[0]].to(torch.float64)
    py = p[:, other[1]].to(torch.float64)
    vx, vy = poly[:, other[0]].tolist(), poly[:, other[1]].tolist()
    inside = torch.zeros(len(points), dtype=torch.bool, device=dev)
    j = len(poly) - 1
    for i in range(len(poly)):
        cond = ((vy[i] > py) != (vy[j] > py)) & (
            px < GE.true_divide((vx[j] - vx[i]) * (py - vy[i]),
                                vy[j] - vy[i] + 1e-12) + vx[i])
        inside ^= cond
        j = i
    return (inside & (p[:, axis] >= lo) & (p[:, axis] <= hi)).cpu().numpy()


def _transform(points: np.ndarray, T: np.ndarray,
               dev: torch.device) -> np.ndarray:
    return GE.affine(points, T[:3, :3], T[:3, 3], dev).cpu().numpy()


def evaluate_tnt_scene(
    pred_ply: str,
    gt_ply: str,
    tau: float,
    traj_est_log: str | None = None,
    traj_gt_log: str | None = None,
    trans_txt: str | None = None,
    crop_json: str | None = None,
    icp_stages: int = 3,
    seed: int = 0,
    ransac_thresh: float = 0.2,
    device: str | torch.device = "cuda",
) -> dict:
    """The full protocol; each alignment input is optional (skipped when
    absent, e.g. for reconstructions already in GT coordinates)."""
    dev = resolve_device(device)
    verts, _ = load_mesh_ply(pred_ply)
    gt_pts, _ = load_mesh_ply(gt_ply)

    T = np.eye(4)
    if trans_txt is not None:
        T = np.loadtxt(trans_txt).reshape(4, 4)
    if traj_est_log is not None and traj_gt_log is not None:
        est = read_trajectory_log(traj_est_log)
        gt = read_trajectory_log(traj_gt_log)
        n = min(len(est), len(gt))
        centers_est = est[:n, :3, 3]
        # the dataset's pre-alignment of the estimated centres first
        hom = np.concatenate([centers_est, np.ones((n, 1))], 1)
        centers_est = (hom @ T.T)[:, :3]
        T = ransac_umeyama(centers_est, gt[:n, :3, 3],
                           thresh=ransac_thresh, seed=seed) @ T

    pred = _transform(verts, T, dev)

    if crop_json is not None:
        with open(crop_json) as f:
            crop = json.load(f)
        pred = pred[crop_polygon_volume(pred, crop, dev)]
        gt_pts = gt_pts[crop_polygon_volume(gt_pts, crop, dev)]

    # ICP at decreasing radii (the toolbox's 3-stage refinement)
    if len(pred) > 100 and len(gt_pts) > 100:
        for stage in range(icp_stages):
            radius = tau * (20 / (2 ** stage))
            ds = max(tau, radius / 20)
            T_icp = GE.icp_refine(GE.voxel_downsample(pred, ds, dev),
                                  GE.voxel_downsample(gt_pts, ds, dev),
                                  iters=15, max_corr=radius, device=dev)
            pred = _transform(pred, T_icp, dev)

    p = GE.voxel_downsample(pred, tau / 2, dev)
    g = GE.voxel_downsample(gt_pts, tau / 2, dev)
    d_p2g = GE.nn_distances(p, g, device=dev)
    d_g2p = GE.nn_distances(g, p, device=dev)
    precision = float((d_p2g < tau).mean()) if len(p) else 0.0
    recall = float((d_g2p < tau).mean()) if len(g) else 0.0
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return {"precision": precision, "recall": recall, "f1": f1,
            "tau": tau, "n_pred": len(p), "n_gt": len(g)}
