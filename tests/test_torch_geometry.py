"""The port's DTU evaluation against the JAX package on the same numpy
inputs: the grid sampler, the radius downsample, nearest-neighbour
distances, the Chamfer protocol, the mask-and-frustum cull with its two
OpenCV counterparts, and the eval_geometry entry point.

The JAX side is numpy, scipy and OpenCV (which this machine has); the port
runs on the CPU here.
"""

import argparse
import importlib.util
import json
import os
import shutil

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import MESH_CENTER, dtu_poses, write_dtu_instance
from vcr_gaus_tpu.evaluation import dtu_cull as JC
from vcr_gaus_tpu.evaluation import geometry as JGE
from vcr_gaus_tpu.meshing.marching import marching_tets
from vcr_gaus_tpu_torch.evaluation import dtu_cull as C
from vcr_gaus_tpu_torch.evaluation import geometry as GE
from vcr_gaus_tpu_torch.meshing.extract import save_mesh_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NN = dict(rtol=1e-9, atol=0)      # distances and Chamfer numbers


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ellipsoid_mesh(n=30, scale=100.0, offset=(300.0, -200.0, 650.0)):
    """A marching-tetrahedra ellipsoid in mm: (verts f32, faces i32)."""
    ax = np.linspace(-1.5, 1.5, n)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    sdf = (np.sqrt(x ** 2 + y ** 2 + (1.3 * z) ** 2) - 1.0).astype(np.float32)
    sp = ax[1] - ax[0]
    verts, faces = marching_tets(sdf, 0.0, origin=(-1.5,) * 3,
                                 spacing=(sp,) * 3)
    return verts * scale + np.asarray(offset, np.float32), faces


MESHES = {
    "ellipsoid_f32": lambda: ellipsoid_mesh(),
    "ellipsoid_f64": lambda: tuple(
        a.astype(np.float64) if a.dtype == np.float32 else a
        for a in ellipsoid_mesh()),
    # the DTU evaluator's golden right triangle: 8 x 4 cells, 16 samples
    "right_triangle": lambda: (np.array([[0, 0, 0], [2, 0, 0], [0, 1, 0]],
                                        np.float64), np.array([[0, 1, 2]])),
    # a collinear (zero-area) triangle and one with edges below the pitch
    "degenerate_and_tiny": lambda: (
        np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [5, 0, 0], [5.01, 0, 0],
                  [5, 0.01, 0]], np.float64), np.array([[0, 1, 2], [3, 4, 5]])),
}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sample_points_on_mesh_matches_jax(mesh):
    verts, faces = MESHES[mesh]()
    thresh = 2.0 if mesh.startswith("ellipsoid") else 0.25
    got = GE.sample_points_on_mesh(verts, faces, thresh, device="cpu")
    want = JGE.sample_points_on_mesh(verts, faces, thresh)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if mesh == "right_triangle":
        assert len(got) == 3 + 16
    if mesh == "degenerate_and_tiny":
        np.testing.assert_array_equal(got, verts)


CLOUDS = {
    "uniform": lambda rng: rng.random((6000, 3)),
    "sampled_mesh": lambda rng: JGE.sample_points_on_mesh(
        *ellipsoid_mesh(n=24), 3.0),
    # float32 points with duplicates and exact copies at the radius
    "f32_duplicates": lambda rng: np.concatenate(
        [p := rng.random((3000, 3)).astype(np.float32), p[:300],
         p[300:600] + np.float32(0.05)]),
}


@pytest.mark.parametrize("cloud", list(CLOUDS))
@pytest.mark.parametrize("seed", [0, 3])
def test_radius_downsample_matches_jax(cloud, seed):
    pts = CLOUDS[cloud](np.random.default_rng(seed))
    radius = 3.0 if cloud == "sampled_mesh" else 0.05
    got = GE.radius_downsample(pts, radius, seed=seed, device="cpu")
    want = JGE.radius_downsample(pts, radius, seed=seed)
    assert got.dtype == want.dtype and len(want) < len(pts)
    np.testing.assert_array_equal(got, want)


def test_nn_distances_match_jax():
    rng = np.random.default_rng(1)
    d = rng.normal(size=(8000, 3))
    target = 300 * d / np.linalg.norm(d, axis=1, keepdims=True) + 600
    query = np.concatenate([
        target[:3000] + rng.normal(scale=1.5, size=(3000, 3)),
        rng.uniform(0, 1200, (500, 3))])           # near and far queries
    want = JGE.nn_distances(query, target)
    np.testing.assert_allclose(GE.nn_distances(query, target, device="cpu"),
                               want, **NN)
    capped = GE.nn_distances(query, target, max_dist=20.0, device="cpu")
    near = want < 20.0
    assert 0 < near.mean() < 1
    np.testing.assert_allclose(capped[near], want[near], **NN)
    assert (capped[~near] >= 20.0).all()
    assert GE.nn_distances(query[:0], target, device="cpu").shape == (0,)


def synthetic_obs(stl, res=3.0, seed=0):
    """An ObsMask over the cloud's box with holes, its BB and Res, and a
    plane cutting the cloud."""
    rng = np.random.default_rng(seed)
    bb = np.stack([stl.min(0) - 5, stl.max(0) + 5])
    shape = np.ceil((bb[1] - bb[0]) / res).astype(int) + 1
    obs = (rng.random(shape) < 0.8).astype(np.uint8)
    plane = np.array([[0.0], [0.3], [-1.0], [float(np.median(stl[:, 2]))]])
    return obs, bb, np.array([[res]]), plane


@pytest.mark.parametrize("masked", [False, True])
def test_dtu_chamfer_matches_jax(masked):
    verts, faces = ellipsoid_mesh()
    data = JGE.sample_points_on_mesh(verts, faces, 3.0)
    rng = np.random.default_rng(2)
    stl = JGE.sample_points_on_mesh(verts * 1.01 - 3, faces, 4.0)
    stl = stl + rng.normal(scale=0.3, size=stl.shape)
    kw = dict(downsample_density=2.0, max_dist=20.0, patch_size=60.0)
    if masked:
        obs, bb, res, plane = synthetic_obs(stl)
        kw.update(obs_mask=obs, bb=bb, res=res, ground_plane=plane)
    got = GE.dtu_chamfer(data, stl, device="cpu", **kw)
    want = JGE.dtu_chamfer(data, stl, **kw)
    assert set(got) == {"mean_d2s", "mean_s2d", "overall"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **NN)
    assert 0.5 < got["overall"] < 10


def random_projections(n, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        K = np.array([[rng.uniform(200, 2000), rng.uniform(-5, 5),
                       rng.uniform(100, 900)],
                      [0, rng.uniform(200, 2000), rng.uniform(100, 700)],
                      [0, 0, 1]])
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array(
            [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
             [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
             [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        P = K @ np.concatenate([R, rng.normal(size=(3, 1)) * 3], 1)
        if i % 3 == 1:      # improper: every sign branch of OpenCV's RQ
            P[:, :3] = P[:, :3] @ np.diag(rng.choice([-1.0, 1.0], 3))
        yield P * rng.choice([-1.0, 1.0]) * rng.uniform(0.5, 2.0)


def test_decompose_projection_matches_opencv():
    for P in random_projections(300):
        K, R, t = C.decompose_projection(P)
        cK, cR, ct = cv2.decomposeProjectionMatrix(P)[:3]
        np.testing.assert_allclose(K / np.abs(cK).max(), cK / np.abs(cK).max(),
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(R, cR, rtol=0, atol=1e-8)
        np.testing.assert_allclose(t[:3] / t[3], ct[:3] / ct[3], rtol=1e-8,
                                   atol=1e-8)
        for a, b in zip(C.load_k_rt_from_p(P), JC.load_k_rt_from_p(P)):
            assert a.dtype == b.dtype
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("radius", [0, 1, 2, 4, 7, 12, 24, 31])
def test_ellipse_element_and_dilation_match_opencv(radius):
    size = 2 * radius + 1
    el = C.ellipse_element(radius)
    want = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))
    np.testing.assert_array_equal(el, want)
    m = np.random.default_rng(radius).random((90, 130)) > 0.997
    m[0, 5] = m[89, 129] = True                     # reaches the borders
    np.testing.assert_array_equal(
        C.dilate(torch.from_numpy(m), torch.from_numpy(el)).numpy(),
        cv2.dilate(m.astype(np.uint8), want) > 0)


def test_read_mask_is_the_blue_channel(tmp_path):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    path = str(tmp_path / "m.png")
    Image.fromarray(img).save(path)                 # RGB on disk
    np.testing.assert_array_equal(C.read_mask(path),
                                  cv2.imread(path)[:, :, 0] > 127)
    assert not np.array_equal(C.read_mask(path), img[:, :, 0] > 127)


def cull_instance(inst, W=320, H=240):
    """tests/test_dtu_cull.py's instance: one camera at z=-4 looking +z,
    only the left half of the image object."""
    os.makedirs(os.path.join(inst, "mask"))
    K = np.array([[300.0, 0, W / 2, 0], [0, 300, H / 2, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]])
    w2c = np.eye(4)
    w2c[2, 3] = 4.0
    world = np.eye(4)
    world[:3, :4] = (K @ w2c)[:3]
    np.savez(os.path.join(inst, "cameras.npz"),
             world_mat_0=world, scale_mat_0=np.eye(4))
    m = np.zeros((H, W), np.uint8)
    m[:, : W // 2] = 255
    cv2.imwrite(os.path.join(inst, "mask", "000.png"), np.stack([m] * 3, -1))


def test_cull_mesh_dtu_matches_jax(tmp_path):
    inst = str(tmp_path)
    cull_instance(inst)
    # the JAX test's two blobs, and a jittered grid of vertices over the
    # image with faces between neighbours: kept left of the dilated mask
    # edge. (An unjittered grid puts vertices on exact half-pixel ties,
    # which the SVDs' last-bit noise in the camera centre decides.)
    left = np.array([[-1.5, 0, 0], [-1.6, 0.1, 0], [-1.4, -0.1, 0.1]])
    right = np.array([[1.5, 0, 0], [1.6, 0.1, 0], [1.4, -0.1, 0.1]])
    gx, gy = np.meshgrid(np.linspace(-3, 3, 41), np.linspace(-2, 2, 21))
    grid = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], 1)
    grid += np.random.default_rng(6).uniform(-0.01, 0.01, grid.shape)
    verts = np.concatenate([left, right, grid])
    idx = np.arange(gx.size).reshape(gx.shape) + 6
    quads = np.stack([idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1]], -1)
    faces = np.concatenate([[[0, 1, 2], [3, 4, 5]],
                            quads.reshape(-1, 3)]).astype(np.int32)
    for radius in (4, 24):
        got = C.cull_mesh_dtu(verts, faces, inst, width=320, height=240,
                              dilate_radius=radius, device="cpu")
        want = JC.cull_mesh_dtu(verts, faces, inst, width=320, height=240,
                                dilate_radius=radius)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert 0 < len(got[1]) < len(faces)
    with pytest.raises(ValueError, match="expects 1600x1200"):
        C.cull_mesh_dtu(verts, faces, inst, device="cpu")


def jax_eval_geometry():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_geometry", os.path.join(REPO, "scripts", "eval_geometry.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_eval_geometry_cli_matches_jax(tmp_path):
    from vcr_gaus_tpu_torch import eval_geometry

    # chip_smoke.py's DTU instance at 3 views and a sparse STL stand-in; one
    # mask cut to its left half, so the cull removes part of the mesh
    poses = dtu_poses(3)
    data, inst = write_dtu_instance(str(tmp_path), poses, 1600, 1200,
                                    n_stl=30_000)
    half = np.zeros((1200, 1600), np.uint8)
    half[:, :800] = 255
    Image.fromarray(half).save(os.path.join(inst, "mask", "001.png"))
    ax = np.linspace(-1.7, 1.7, 28)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    sdf = (np.sqrt(x ** 2 + y ** 2 + z ** 2) - 1.5).astype(np.float32)
    verts, faces = marching_tets(sdf, 0.0, origin=(-1.7,) * 3,
                                 spacing=(ax[1] - ax[0],) * 3)
    for side in ("port", "jax"):
        os.makedirs(tmp_path / side)
        save_mesh_ply(str(tmp_path / side / "ours.ply"), verts + MESH_CENTER
                      .astype(np.float32), faces)
    args = ["--dataset_dir", data, "--scan", "1", "--instance_dir", inst,
            "--downsample_density", "4"]
    got = eval_geometry.main(["dtu", "--ply_path",
                              str(tmp_path / "port" / "ours.ply"),
                              "--device", "cpu"] + args)
    jax_cli = jax_eval_geometry()
    jax_cli.cmd_dtu(argparse.Namespace(
        ply_path=str(tmp_path / "jax" / "ours.ply"), dataset_dir=data,
        scan=1, downsample_density=4.0, patch_size=60.0, max_dist=20.0,
        instance_dir=inst))
    with open(tmp_path / "jax" / "results.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "results.json") as f:
        assert json.load(f) == got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **NN)
    assert 0 < got["overall"] < 20

    # no ObsMask: the unmasked Chamfer, with the JAX CLI's warning
    shutil.rmtree(os.path.join(data, "ObsMask"))
    got = eval_geometry.main(["dtu", "--ply_path",
                              str(tmp_path / "port" / "ours.ply"),
                              "--device", "cpu"] + args)
    assert np.isfinite(got["overall"])
    # the tnt subcommand scores the mesh against its copy and writes
    # metrics.txt beside it (held to the JAX CLI in
    # tests/test_torch_tnt_eval.py)
    tnt = eval_geometry.main([
        "tnt", "--ply_path", str(tmp_path / "port" / "ours.ply"),
        "--gt_path", str(tmp_path / "jax" / "ours.ply"), "--threshold",
        "0.05", "--down_sample", "0.02", "--device", "cpu"])
    assert list(tnt) == ["Acc", "Comp", "Prec", "Recal", "F-score"]
    assert 0.9 < tnt["F-score"] <= 1
    assert os.path.exists(tmp_path / "port" / "metrics.txt")
