"""The port's TNT evaluation against the JAX package on the same numpy
inputs: the voxel downsample, the nearest-neighbour index, the PCA box,
ICP, the lightweight F1, the official protocol (trajectories, Umeyama,
RANSAC, the polygon crop, the end-to-end cases of tests/test_tnt_official.py)
and the two entry points, eval_geometry tnt and tools/crop_mesh.

The JAX side is numpy and scipy; the port runs on the CPU here.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from test_evaluation import sphere_mesh
from vcr_gaus_tpu.evaluation import geometry as JGE
from vcr_gaus_tpu.evaluation import tnt_official as JTO
from vcr_gaus_tpu_torch.evaluation import geometry as GE
from vcr_gaus_tpu_torch.evaluation import tnt_official as TO
from vcr_gaus_tpu_torch.meshing.extract import load_mesh_ply, save_mesh_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CENTROID = dict(rtol=1e-12, atol=0)    # voxel centroids, Acc and Comp
OBB = dict(rtol=0, atol=1e-12)         # pca_obb's R and t
ICP = dict(rtol=0, atol=1e-9)          # icp_refine's 4x4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rot_z(ang):
    return np.array([[np.cos(ang), -np.sin(ang), 0],
                     [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])


def cloud(n, dtype, seed=0):
    """An anisotropic cloud off the origin, as a PLY would hold it."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * np.array([3.0, 1.2, 0.4]) + [5, -2, 7]
    return (pts @ rot_z(0.3).T).astype(dtype)


def sphere_shell(n, seed, r=1.0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    return (r * d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("voxel", [0.05, 0.3])
def test_voxel_downsample_matches_jax(dtype, voxel):
    pts = cloud(20_000, dtype)
    got = GE.voxel_downsample(pts, voxel, device="cpu")
    want = JGE.voxel_downsample(pts, voxel)
    assert got.shape == want.shape and got.dtype == want.dtype
    # the same voxels in the same order: each centroid's key is its own
    # voxel's, so the lexicographic order of the keys must hold
    np.testing.assert_allclose(got, want, **CENTROID)
    keys = np.floor((pts - pts.min(0)) / voxel).astype(np.int64)
    uniq = np.unique(keys, axis=0)
    assert len(uniq) == len(got)
    assert GE.voxel_downsample(pts, 0.0, device="cpu") is pts


def test_nearest_neighbours_match_ckdtree():
    rng = np.random.default_rng(1)
    target = rng.normal(size=(5000, 3))
    # queries inside, around and far outside the target's span
    query = np.concatenate([rng.normal(size=(3000, 3)) * 1.5,
                            rng.normal(size=(20, 3)) * 1e3])
    d, idx = GE.nearest_neighbours(query, target, device="cpu")
    want_d, want_i = cKDTree(target).query(query, k=1)
    np.testing.assert_allclose(d, want_d, rtol=1e-12, atol=0)
    # equal where the nearest point is unique
    d2, _ = cKDTree(target).query(query, k=2)
    unique = d2[:, 1] > d2[:, 0]
    assert unique.mean() > 0.99
    np.testing.assert_array_equal(idx[unique], want_i[unique])
    # ties take the lowest index
    dup = np.concatenate([target, target])
    _, idx_dup = GE.nearest_neighbours(query, dup, device="cpu")
    np.testing.assert_array_equal(idx_dup[unique], want_i[unique])
    # max_dist: every query within it resolved, the others either
    # resolved or (inf, -1)
    d_m, i_m = GE.nearest_neighbours(query, target, max_dist=0.1,
                                     device="cpu")
    found = np.isfinite(d_m)
    assert found[want_d < 0.1].all() and not found.all()
    np.testing.assert_array_equal(d_m[found], d[found])
    np.testing.assert_array_equal(i_m[found], idx[found])
    assert np.all(i_m[~found] == -1) and np.all(want_d[~found] > 0.1)
    # a target without extent: one point, queries up to 1e3 away
    one = target[:1]
    d1, i1 = GE.nearest_neighbours(query, one, device="cpu")
    np.testing.assert_allclose(d1, cKDTree(one).query(query)[0], rtol=1e-12,
                               atol=0)
    assert np.all(i1 == 0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pca_obb_matches_jax(dtype):
    pts = cloud(20_000, dtype, seed=2)
    R, t = GE.pca_obb(pts, device="cpu")
    R_want, t_want = JGE.pca_obb(pts)
    np.testing.assert_allclose(R, R_want, **OBB)
    np.testing.assert_allclose(t, t_want, **OBB)
    assert np.linalg.det(R) > 0


@pytest.mark.parametrize("max_corr", [None, 0.5, 1e-6])
def test_icp_refine_matches_jax(max_corr):
    dst = cloud(6000, np.float64, seed=3)
    src = (cloud(6000, np.float64, seed=4) @ rot_z(0.02).T
           + [0.05, -0.03, 0.02])
    got = GE.icp_refine(src, dst, iters=8, max_corr=max_corr, device="cpu")
    want = JGE.icp_refine(src, dst, iters=8, max_corr=max_corr)
    np.testing.assert_allclose(got, want, **ICP)
    if max_corr == 1e-6:                  # fewer than 10 pairs: no step
        np.testing.assert_array_equal(got, np.eye(4))


def tnt_case(seed=5):
    """A GT shell and a mesh of it (f32, as read from PLYs), the mesh
    misaligned by a small rigid motion, with a far outlier cluster the
    crop removes."""
    verts, faces = sphere_mesh(r=1.0, n=40)
    verts = (verts.astype(np.float64) @ rot_z(0.03).T
             + [0.01, -0.02, 0.005]).astype(np.float32)
    outliers = (np.random.default_rng(seed).normal(size=(50, 3)) * 0.1
                + 4.0).astype(np.float32)
    verts = np.concatenate([verts, outliers])
    gt = sphere_shell(40_000, seed)
    return verts, faces, gt


def assert_f1_equal(got, want):
    assert list(got) == list(want)
    for k in ("Prec", "Recal", "F-score"):
        assert got[k] == want[k], (k, got[k], want[k])
    for k in ("Acc", "Comp"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **CENTROID)


@pytest.mark.parametrize("run_icp", [False, True])
def test_tnt_f1_matches_jax(run_icp):
    verts, faces, gt = tnt_case()
    got = GE.tnt_f1(verts, faces, gt, threshold=0.02, down_sample=0.01,
                    run_icp=run_icp, device="cpu")
    want = JGE.tnt_f1(verts, faces, gt, threshold=0.02, down_sample=0.01,
                      run_icp=run_icp)
    assert_f1_equal(got, want)
    assert 0 < got["F-score"] < 1
    if run_icp:
        no_icp = GE.tnt_f1(verts, faces, gt, threshold=0.02,
                           down_sample=0.01, device="cpu")
        assert got["F-score"] > no_icp["F-score"]


def test_tnt_f1_without_crop_matches_jax():
    verts, faces, gt = tnt_case(seed=6)
    got = GE.tnt_f1(verts, faces, gt, threshold=0.05, down_sample=0.02,
                    crop_to_gt_obb=False, device="cpu")
    want = JGE.tnt_f1(verts, faces, gt, threshold=0.05, down_sample=0.02,
                      crop_to_gt_obb=False)
    assert_f1_equal(got, want)


def write_log(path, mats):
    lines = []
    for i, m in enumerate(mats):
        lines.append(f"{i} {i} 0")
        for r in range(4):
            lines.append(" ".join(map(str, m[r])))
    with open(path, "w") as f:
        f.write("\n".join(lines))


def test_trajectory_umeyama_ransac_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    mats = []
    for _ in range(24):
        m = np.eye(4)
        m[:3, :3] = rot_z(rng.uniform(0, 6))
        m[:3, 3] = rng.normal(size=3) * 3
        mats.append(m)
    write_log(tmp_path / "t.log", mats)
    got = TO.read_trajectory_log(str(tmp_path / "t.log"))
    np.testing.assert_array_equal(
        got, JTO.read_trajectory_log(str(tmp_path / "t.log")))
    src = got[:, :3, 3]
    dst = 1.5 * src @ rot_z(0.4).T + [0.5, -1.0, 2.0]
    bad = src.copy()
    bad[:4] += rng.normal(size=(4, 3)) * 25.0
    np.testing.assert_array_equal(TO.umeyama(bad, dst),
                                  JTO.umeyama(bad, dst))
    for seed in (0, 3):
        np.testing.assert_array_equal(
            TO.ransac_umeyama(bad, dst, thresh=0.2, seed=seed),
            JTO.ransac_umeyama(bad, dst, thresh=0.2, seed=seed))
    np.testing.assert_array_equal(TO.ransac_umeyama(src[:3], dst[:3]),
                                  JTO.ransac_umeyama(src[:3], dst[:3]))


CROPS = {
    "z_pentagon": {"orthogonal_axis": "Z", "axis_min": 6.5,
                   "axis_max": 7.5, "bounding_polygon": [
                       [2, -6, 0], [9, -5, 0], [10, 1, 0], [5, 2.5, 0],
                       [1, -1, 0]]},
    "x_square_ints": {"orthogonal_axis": "x", "axis_min": 0,
                      "axis_max": 8, "bounding_polygon": [
                          [0, -4, 6], [0, 0, 6], [0, 0, 8], [0, -4, 8]]},
    "y_triangle": {"orthogonal_axis": "Y", "axis_min": -3.1,
                   "axis_max": 0.2, "bounding_polygon": [
                       [3, 0, 6.6], [8, 0, 7.1], [5, 0, 7.5]]},
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("crop", list(CROPS))
def test_crop_polygon_volume_matches_jax(dtype, crop):
    pts = cloud(30_000, dtype, seed=8)
    # points on the polygon's vertices, and inside it on the axis bounds
    # as the dtype rounds them (numpy compares those in the points' dtype)
    crop = CROPS[crop]
    poly = np.asarray(crop["bounding_polygon"], dtype)
    axis = "XYZ".index(crop["orthogonal_axis"].upper())
    bounds = np.repeat(poly.mean(0, keepdims=True), 2, 0)
    bounds[:, axis] = [crop["axis_min"], crop["axis_max"]]
    pts = np.concatenate([pts, poly, poly + dtype(0.5), bounds])
    got = TO.crop_polygon_volume(pts, crop, device="cpu")
    want = JTO.crop_polygon_volume(pts, crop)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(pts) and got[-2:].all()


def write_pair(tmp_path, pred, gt, faces=None):
    faces = np.zeros((1, 3), np.int32) if faces is None else faces
    save_mesh_ply(str(tmp_path / "pred.ply"), pred, faces)
    save_mesh_ply(str(tmp_path / "gt.ply"), gt, faces)
    return str(tmp_path / "pred.ply"), str(tmp_path / "gt.ply")


def case_golden(tmp_path):
    """tests/test_tnt_official.py's golden 0.75/0.75/0.75 grid."""
    tau = 0.02
    xs = np.arange(8) * 4 * tau
    gx, gy, gz = np.meshgrid(xs, xs, xs[:2], indexing="ij")
    gt = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    pred = gt.copy()
    pred[:len(pred) // 4, 2] += 2 * tau
    pred_ply, gt_ply = write_pair(tmp_path, pred, gt)
    return dict(pred_ply=pred_ply, gt_ply=gt_ply, tau=tau, icp_stages=0)


def trajectories(tmp_path, centers, R, off, n_bad, seed):
    rng = np.random.default_rng(seed)
    gt_m, est_m = [], []
    for i, c in enumerate(centers):
        m_gt = np.eye(4)
        m_gt[:3, 3] = c
        m_est = np.eye(4)
        m_est[:3, 3] = c @ R.T + off
        if i < n_bad:                 # corrupted SfM registrations
            m_est[:3, 3] += rng.normal(size=3) * 40.0
        gt_m.append(m_gt)
        est_m.append(m_est)
    write_log(tmp_path / "gt.log", gt_m)
    write_log(tmp_path / "est.log", est_m)
    return dict(traj_est_log=str(tmp_path / "est.log"),
                traj_gt_log=str(tmp_path / "gt.log"))


def moved_sphere(tmp_path):
    verts, faces = sphere_mesh(r=1.0, n=32)
    R, off = rot_z(0.15), np.array([0.2, -0.1, 0.05])
    pred_ply, gt_ply = write_pair(tmp_path, verts @ R.T + off, verts, faces)
    return pred_ply, gt_ply, R, off


def case_outlier_trajectory(tmp_path):
    """tests/test_tnt_official.py: 3 corrupted estimated cameras."""
    pred_ply, gt_ply, R, off = moved_sphere(tmp_path)
    centers = np.random.default_rng(4).normal(size=(16, 3)) * 3
    return dict(pred_ply=pred_ply, gt_ply=gt_ply, tau=0.02,
                **trajectories(tmp_path, centers, R, off, 3, 4))


def case_alignment(tmp_path):
    """tests/test_tnt_official.py: trajectories related by the mesh's
    misalignment."""
    pred_ply, gt_ply, R, off = moved_sphere(tmp_path)
    centers = np.random.default_rng(2).normal(size=(12, 3)) * 3
    return dict(pred_ply=pred_ply, gt_ply=gt_ply, tau=0.02,
                **trajectories(tmp_path, centers, R, off, 0, 2))


def case_unaligned(tmp_path):
    """tests/test_tnt_official.py: the same mesh without the alignment."""
    pred_ply, gt_ply, _, _ = moved_sphere(tmp_path)
    return dict(pred_ply=pred_ply, gt_ply=gt_ply, tau=0.02, icp_stages=0)


def case_alignment_crop(tmp_path):
    """case_alignment with the scene's pre-alignment and crop json."""
    pred_ply, gt_ply, R, off = moved_sphere(tmp_path)
    centers = np.random.default_rng(2).normal(size=(12, 3)) * 3
    np.savetxt(tmp_path / "trans.txt", np.eye(4))
    with open(tmp_path / "crop.json", "w") as f:
        json.dump({"orthogonal_axis": "Z", "axis_min": -0.8,
                   "axis_max": 1.2, "bounding_polygon": [
                       [-1.3, -1.3, 0], [1.3, -1.3, 0], [1.3, 1.3, 0],
                       [-1.3, 1.3, 0]]}, f)
    return dict(pred_ply=pred_ply, gt_ply=gt_ply, tau=0.02,
                trans_txt=str(tmp_path / "trans.txt"),
                crop_json=str(tmp_path / "crop.json"),
                **trajectories(tmp_path, centers, R, off, 0, 2))


@pytest.mark.parametrize("case", [case_golden, case_outlier_trajectory,
                                  case_alignment, case_unaligned,
                                  case_alignment_crop])
def test_evaluate_tnt_scene_matches_jax(tmp_path, case):
    kw = case(tmp_path)
    got = TO.evaluate_tnt_scene(**kw, device="cpu")
    want = JTO.evaluate_tnt_scene(**kw)
    assert got == want
    if case is case_golden:
        assert got["precision"] == got["recall"] == 0.75
    elif case is case_unaligned:
        assert got["f1"] < 0.9
    else:
        assert got["f1"] > 0.9


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(path):
    with open(path) as f:
        return {k: float(v) for k, v in (ln.split(": ") for ln in f)}


def mesh_dirs(tmp_path):
    verts, faces, gt = tnt_case(seed=9)
    save_mesh_ply(str(tmp_path / "gt.ply"), gt, np.zeros((0, 3), np.int32))
    for side in ("port", "jax"):
        os.makedirs(tmp_path / side)
        save_mesh_ply(str(tmp_path / side / "ours.ply"), verts, faces)
    return str(tmp_path / "gt.ply")


@pytest.mark.parametrize("icp", [False, True])
def test_eval_geometry_tnt_cli_matches_jax(tmp_path, monkeypatch, icp):
    from vcr_gaus_tpu_torch import eval_geometry

    gt = mesh_dirs(tmp_path)
    args = ["--gt_path", gt, "--threshold", "0.02", "--down_sample",
            "0.01"] + (["--icp"] if icp else [])
    got = eval_geometry.main(["tnt", "--ply_path",
                              str(tmp_path / "port" / "ours.ply"),
                              "--device", "cpu"] + args)
    monkeypatch.setattr(sys, "argv", [
        "eval_geometry.py", "tnt", "--ply_path",
        str(tmp_path / "jax" / "ours.ply")] + args)
    jax_script("eval_geometry").main()
    port_txt = read_metrics(tmp_path / "port" / "metrics.txt")
    jax_txt = read_metrics(tmp_path / "jax" / "metrics.txt")
    assert port_txt == got
    assert_f1_equal(port_txt, jax_txt)
    assert 0 < got["F-score"] < 1


@pytest.mark.parametrize("margin", [0.0, 0.05])
def test_crop_mesh_matches_jax(tmp_path, monkeypatch, margin):
    from vcr_gaus_tpu_torch.tools import crop_mesh

    gt = mesh_dirs(tmp_path)
    out = crop_mesh.main(["--ply_path", str(tmp_path / "port" / "ours.ply"),
                          "--gt_path", gt, "--margin", str(margin),
                          "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", [
        "crop_mesh.py", "--ply_path", str(tmp_path / "jax" / "ours.ply"),
        "--gt_path", gt, "--margin", str(margin)])
    jax_script("crop_mesh").main()
    assert out == str(tmp_path / "port" / "ours_crop.ply")
    got_v, got_f = load_mesh_ply(out)
    want_v, want_f = load_mesh_ply(str(tmp_path / "jax" / "ours_crop.ply"))
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)
    verts, _ = load_mesh_ply(str(tmp_path / "port" / "ours.ply"))
    assert 1000 < len(got_v) < len(verts)     # the outliers are cut
