"""The port's mesh extraction against the JAX package on the same numpy
inputs: the outlier tests, depth back-projection, TSDF fusion (axis box,
oriented box, contracted ball), marching tetrahedra and the cleanup, one
whole depth sweep through the renderer, and the depth2mesh entry point.

The JAX side runs in-process on the CPU; the port runs its plain PyTorch
versions (the forward compositing kernel's included) on the CPU.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.spatial import cKDTree

from fixtures import make_cube_points, ring_cameras, write_colmap_scene
from vcr_gaus_tpu.meshing import extract as JX
from vcr_gaus_tpu.meshing import marching as JMC
from vcr_gaus_tpu.meshing import tsdf as JT
from vcr_gaus_tpu.models import gaussians as JGM
from vcr_gaus_tpu.models import ply_io as JPLY
from vcr_gaus_tpu.ops import knn as JK
from vcr_gaus_tpu.render.renderer import RenderConfig as JRenderConfig
from vcr_gaus_tpu.utils import graphics as JG
from vcr_gaus_tpu_torch.meshing import extract as X
from vcr_gaus_tpu_torch.meshing import marching as MC
from vcr_gaus_tpu_torch.meshing import tsdf as T
from vcr_gaus_tpu_torch.models.convert import state_from_numpy
from vcr_gaus_tpu_torch.ops import knn as K
from vcr_gaus_tpu_torch.render.renderer import RenderConfig
from vcr_gaus_tpu_torch.utils import graphics as G

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TSDF_ATOL = 1e-5            # tsdf values of the voxels both fused alike
TSDF_FLIP_SHARE = 1e-4      # voxels whose projected pixel rounds otherwise


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def clustered_points(n, seed):
    """Points in a few Gaussian clusters plus uniform noise, so neighbour
    counts range from 0 to dozens."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (8, 3))
    pts = centers[rng.integers(0, 8, n)] + 0.08 * rng.normal(size=(n, 3))
    noise = rng.random(n) < 0.1
    pts[noise] = rng.uniform(-1.2, 1.2, (int(noise.sum()), 3))
    return pts.astype(np.float32)


# one side of EXACT_MAX_N each: the blocked brute force and the three
# Morton-window passes
@pytest.mark.parametrize("n", [3000, 10_000])
def test_radius_neighbor_counts_match_jax(n):
    pts = clustered_points(n, seed=n)
    got = K.radius_neighbor_counts(torch.from_numpy(pts), 0.05).numpy()
    want = np.asarray(JK.radius_neighbor_counts(jnp.asarray(pts), 0.05))
    np.testing.assert_array_equal(got, want)
    assert 0 < (got >= 5).mean() < 1
    np.testing.assert_array_equal(
        K.remove_radius_outlier(torch.from_numpy(pts), 5, 0.05).numpy(),
        np.asarray(JK.remove_radius_outlier(jnp.asarray(pts), 5, 0.05)))


@pytest.mark.parametrize("n", [3000, 10_000])
def test_statistical_outlier_matches_jax(n):
    pts = clustered_points(n, seed=n + 1)
    got = K.remove_statistical_outlier(torch.from_numpy(pts)).numpy()
    want = np.asarray(JK.remove_statistical_outlier(jnp.asarray(pts)))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_depth_to_points_world_matches_jax():
    rng = np.random.default_rng(3)
    depth = rng.uniform(1, 4, (12, 16)).astype(np.float32)
    K3 = np.array([[20.0, 0, 8], [0, 21, 6], [0, 0, 1]], np.float32)
    R_w2c, Tv = ring_cameras(n_cams=3)[1]
    view = np.eye(4, dtype=np.float32)
    view[:3, :3], view[:3, 3] = R_w2c, Tv
    cam, world = G.depth_to_points_world(torch.from_numpy(depth),
                                         torch.from_numpy(K3),
                                         torch.from_numpy(view.T.copy()))
    jcam, jworld = JG.depth_to_points_world(jnp.asarray(depth),
                                            jnp.asarray(K3),
                                            jnp.asarray(view.T))
    np.testing.assert_array_equal(cam.numpy(), np.asarray(jcam))
    np.testing.assert_allclose(world.numpy(), np.asarray(jworld),
                               rtol=1e-6, atol=1e-6)


def sphere_views(r=0.5, w=64, h=48, n=6):
    """Analytic z-depth of a sphere of radius r at the origin from ``n``
    ring cameras: (depth (H,W), row-vector viewmatrix, intr) each."""
    fx, fy = JG.fov2focal(0.8, w), JG.fov2focal(0.65, h)
    intr = np.array([fx, fy, w / 2, h / 2], np.float32)
    K3 = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]], np.float32)
    dirs = np.asarray(JG.pixel_dirs(jnp.asarray(K3), h, w))
    views = []
    for R_w2c, Tv in ring_cameras(n_cams=n, dist=3.0, h=0.5):
        view = np.eye(4, dtype=np.float32)
        view[:3, :3], view[:3, 3] = R_w2c, Tv
        c2w = np.linalg.inv(view)
        o = c2w[:3, 3]
        d_world = dirs @ c2w[:3, :3].T
        b = 2 * (d_world @ o)
        c = o @ o - r * r
        disc = b * b - 4 * c
        t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / 2, 0)
        depth = np.where(disc > 0, t * dirs[..., 2], 0).astype(np.float32)
        views.append((depth, view.T.copy(), intr))
    return views


def oriented_box():
    q = np.random.default_rng(5).normal(size=(3, 3))
    R = np.linalg.qr(q)[0].astype(np.float32)
    if np.linalg.det(R) < 0:
        R[0] *= -1
    M4 = np.eye(4, dtype=np.float32)
    M4[:3, :3], M4[:3, 3] = R, [0.05, -0.02, 0.03]
    return M4


GRIDS = {
    "axis": lambda m, **kw: m.create_grid(np.zeros(3, np.float32),
                                          np.full(3, 0.7, np.float32), 0.02,
                                          **kw),
    "oriented": lambda m, **kw: m.create_grid(
        oriented_box(), np.array([0.7, 0.75, 0.8], np.float32), 0.02, **kw),
    "contracted": lambda m, **kw: m.create_contracted_grid(np.zeros(3), 1.2,
                                                           64, **kw),
}


@pytest.mark.parametrize("kind", list(GRIDS))
def test_tsdf_integrate_matches_jax(kind):
    jgrid = GRIDS[kind](JT)
    grid = GRIDS[kind](T, device="cpu")
    assert grid.tsdf.shape == jgrid.tsdf.shape
    np.testing.assert_array_equal(grid.spacing, jgrid.spacing)
    np.testing.assert_array_equal(grid.origin, jgrid.origin)
    got = T._voxel_world_coords(grid).numpy()
    want = np.asarray(JT._voxel_world_coords(jgrid, grid.contracted))
    if grid.contracted:
        # 1 / (2 - |y|) magnifies an ulp of |y| without bound near the
        # ball's rim, so the rim's world coordinates are not compared
        ax = grid.origin[0] + grid.spacing[0] * np.arange(64)
        y = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
        inner = np.linalg.norm(y, axis=-1) < 1.9
        got, want = got[inner], want[inner]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for depth, view, intr in sphere_views():
        jgrid = JT.integrate(jgrid, jnp.asarray(depth), jnp.asarray(view),
                             jnp.asarray(intr), contracted=grid.contracted)
        T.integrate(grid, torch.from_numpy(depth), torch.from_numpy(view),
                    torch.from_numpy(intr))
    jw, jt = np.asarray(jgrid.weight), np.asarray(jgrid.tsdf)
    w, t = grid.weight.numpy(), grid.tsdf.numpy()
    assert (jw > 0).sum() > 5000
    differ = (w != jw) | (np.abs(t - jt) > TSDF_ATOL)
    assert differ.sum() <= TSDF_FLIP_SHARE * differ.size, differ.sum()

    # the mesh of the JAX grid, extracted by both packages
    jgrid = jgrid._replace(contracted=grid.contracted)
    same = grid._replace(tsdf=torch.from_numpy(jt.copy()),
                         weight=torch.from_numpy(jw.copy()))
    jv, jf = JT.extract_mesh(jgrid)
    v, f = T.extract_mesh(same)
    assert len(f) > 500
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("voxel", [0.004, 0.003, 0.0066, 0.01, 0.05])
@pytest.mark.parametrize("scale", [1.0, 1.65, [1.3, 0.71, 2.2]])
def test_create_grid_dims_match_jax(voxel, scale, monkeypatch):
    # the JAX grid's volumes as zero-stride views: its dims at DTU sizes
    # without allocating them
    monkeypatch.setattr(JT, "jnp", types.SimpleNamespace(
        float32=np.float32,
        ones=lambda s, d: np.broadcast_to(np.ones((), d), s),
        zeros=lambda s, d: np.broadcast_to(np.zeros((), d), s)))
    grid = T.create_grid(np.zeros(3), scale, voxel, device="meta")
    jgrid = JT.create_grid(np.zeros(3), scale, voxel)
    assert tuple(grid.tsdf.shape) == jgrid.tsdf.shape
    np.testing.assert_array_equal(grid.spacing, jgrid.spacing)


def test_contract_round_trip_matches_jax():
    x = np.random.default_rng(6).normal(size=(500, 3)).astype(np.float32) * 3
    y = T.contract(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(JT.contract(
        jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    assert float(y.norm(dim=-1).max()) < 2.0
    np.testing.assert_allclose(T.inv_contract(y).numpy(), x, rtol=1e-4,
                               atol=1e-4)


def test_marching_tets_matches_jax():
    rng = np.random.default_rng(0)
    sdf = rng.normal(size=(9, 7, 8)).astype(np.float32)
    sdf[0, 0, 0] = np.nan                      # unobserved cell skipped
    args = (0.1, (1, 2, 3), (0.5, 0.25, 1.0))
    v, f = MC.marching_tets(sdf, *args)
    jv, jf = JMC.marching_tets(sdf, *args)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    nv, nf = MC.marching_tets_numpy(sdf[:5, :5, :5], *args)
    jnv, jnf = JMC.marching_tets_numpy(sdf[:5, :5, :5], *args)
    np.testing.assert_array_equal(nv, jnv)
    np.testing.assert_array_equal(nf, jnf)
    # the same surface as the oracle, up to vertex dedup
    v5, f5 = MC.marching_tets(sdf[:5, :5, :5], *args)
    assert len(f5) == len(nf)
    np.testing.assert_allclose(np.sort(v5[f5].mean(1), axis=0),
                               np.sort(nv[nf].mean(1), axis=0), atol=1e-4)


def test_marching_library_is_built_in_the_checkout():
    MC.marching_tets(np.zeros((2, 2, 2), np.float32))
    path = MC.library_path()
    assert path.exists()
    assert path.parent == MC.HOST_BUILD_DIR
    assert os.path.commonpath([str(path), REPO]) == REPO


@pytest.mark.parametrize("radii", [(0.3, 0.15), (0.25, 0.25)])
@pytest.mark.parametrize("n_keep,min_faces", [(1, 0), (2, 0), (0, 50)])
def test_keep_largest_components_matches_jax(radii, n_keep, min_faces):
    # two separated spheres: a larger one and a smaller, or two of one size
    # (the tie order of the kept components)
    ax = np.linspace(-1, 1, 40)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    s1 = np.sqrt((x + 0.5) ** 2 + y ** 2 + z ** 2) - radii[0]
    s2 = np.sqrt((x - 0.5) ** 2 + y ** 2 + z ** 2) - radii[1]
    sdf = np.minimum(s1, s2).astype(np.float32)
    sp = ax[1] - ax[0]
    verts, faces = MC.marching_tets(sdf, 0.0, origin=(-1, -1, -1),
                                    spacing=(sp, sp, sp))
    got = MC.keep_largest_components(verts, faces, n_keep, min_faces)
    want = JMC.keep_largest_components(verts, faces, n_keep, min_faces)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[1]) <= len(faces)


def cube_run(tmp_path, n_pts=300, width=64, height=48):
    """A COLMAP cube scene and a JAX state of ``n_pts`` opaque Gaussians on
    its surface, saved as a trained run's PLY with its config."""
    scene = str(tmp_path / "scene")
    write_colmap_scene(scene, n_cams=8, n_pts=n_pts, width=width,
                       height=height)
    pts, cols = make_cube_points(n_pts, seed=1)
    js = JGM.create_from_pcd(pts, cols, n_pts, sh_degree=3)
    js = js._replace(params=js.params._replace(
        log_scale=js.params.log_scale + np.log(2.0),
        logit_opacity=jnp.full_like(js.params.logit_opacity, 3.0)))
    logdir = tmp_path / "run"
    JPLY.save_gaussian_ply(js, str(logdir / "point_cloud" / "iteration_5"
                                   / "point_cloud.ply"))
    with open(os.path.join(scene, "meta.json"), "w") as f:
        f.write('{"trans": [0, 0, 0], "scale": [1.5, 1.5, 1.5]}')
    cfg = {"_parent_": os.path.join(REPO, "configs", "config_base.yaml"),
           "model": {"source_path": scene, "depth_type": "intersection"}}
    with open(logdir / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return scene, js, logdir


@pytest.mark.parametrize("unbounded", [False, True])
def test_extract_mesh_from_state_matches_jax(tmp_path, unbounded):
    from vcr_gaus_tpu.data.scene import load_scene_info as jload_scene_info
    from vcr_gaus_tpu_torch.data.scene import load_scene_info

    scene, js, _ = cube_run(tmp_path)
    state = state_from_numpy(
        {k: np.asarray(v) for k, v in js.params._asdict().items()},
        np.asarray(js.active), "cpu")
    jinfo, info = jload_scene_info(scene), load_scene_info(scene)
    jrcfg = JRenderConfig(64, 48, entry_budget=1 << 15, mask_depth_thr=1e9)
    rcfg = RenderConfig(64, 48, mask_depth_thr=1e9)
    seen = []
    if unbounded:
        # the contracted ball of radius 2 over 96 voxels, the cameras'
        # sphere (radius 1.1 x 4.4) its unit ball
        voxel = 4 / 95 * 1.1 * float(np.linalg.norm(
            [c.camera_center for c in info.train_cameras], axis=1).max())
        jv, jf = JX.extract_mesh_unbounded_from_state(
            js, jinfo.train_cameras, jrcfg, resolution=96)
        v, f = X.extract_mesh_unbounded_from_state(
            state, info.train_cameras, rcfg, resolution=96,
            progress=seen.append)
    else:
        voxel, kw = 0.05, dict(alpha_thr=0.5, max_depth=6.0)
        jv, jf = JX.extract_mesh_from_state(
            js, jinfo.train_cameras, jrcfg, jinfo.trans, jinfo.scale,
            voxel_size=voxel, **kw)
        v, f = X.extract_mesh_from_state(
            state, info.train_cameras, rcfg, info.trans, info.scale,
            voxel_size=voxel, progress=seen.append, **kw)
    assert seen == list(range(8))
    assert len(jf) > 1000
    assert abs(len(v) - len(jv)) <= 1e-3 * len(jv)
    assert abs(len(f) - len(jf)) <= 1e-3 * len(jf)
    for a, b in ((v, jv), (jv, v)):
        assert cKDTree(b).query(a)[0].mean() <= 0.01 * voxel
    if not unbounded:
        # cameras loaded without masks: the mask cut leaves every view
        v2, f2 = X.extract_mesh_from_state(
            state, info.train_cameras, rcfg, info.trans, info.scale,
            voxel_size=voxel, mask_cut=True, **kw)
        np.testing.assert_array_equal(v2, v)
        np.testing.assert_array_equal(f2, f)


def test_extract_mesh_mask_cut_matches_jax(tmp_path):
    """``mask_cut`` with cameras that carry masks (background on the left
    third of every view, 0 in the blue channel of an RGB PNG, 1 elsewhere)
    and the semantic background cut through a classifier carried across
    from flax: the fused meshes match the JAX package's and hold fewer
    faces than the uncut one."""
    from PIL import Image

    from vcr_gaus_tpu.data.scene import load_scene_info as jload_scene_info
    from vcr_gaus_tpu.models import appearance as JAPP
    from vcr_gaus_tpu_torch.data.scene import load_scene_info
    from vcr_gaus_tpu_torch.models import appearance as APP

    scene, js, _ = cube_run(tmp_path)
    os.makedirs(os.path.join(scene, "masks"))
    label = np.ones((48, 64, 3), np.uint8)
    label[:, :21, 2] = 0
    for i in range(8):
        Image.fromarray(label).save(os.path.join(scene, "masks",
                                                 f"img_{i:03d}.png"))
    jinfo = jload_scene_info(scene, load_mask=True)
    info = load_scene_info(scene, load_mask=True)
    jrcfg = JRenderConfig(64, 48, entry_budget=1 << 15, mask_depth_thr=1e9)
    rcfg = RenderConfig(64, 48, mask_depth_thr=1e9)
    kw = dict(voxel_size=0.05, alpha_thr=0.5, max_depth=6.0)
    jv, jf = JX.extract_mesh_from_state(js, jinfo.train_cameras, jrcfg,
                                        jinfo.trans, jinfo.scale,
                                        mask_cut=True, **kw)
    state = state_from_numpy(
        {k: np.asarray(v) for k, v in js.params._asdict().items()},
        np.asarray(js.active), "cpu")
    v, f = X.extract_mesh_from_state(state, info.train_cameras, rcfg,
                                     info.trans, info.scale, mask_cut=True,
                                     **kw)
    _, f_all = X.extract_mesh_from_state(state, info.train_cameras, rcfg,
                                         info.trans, info.scale, **kw)
    assert 1000 < len(jf) < len(f_all)
    assert abs(len(f) - len(jf)) <= 1e-3 * len(jf)
    for a, b in ((v, jv), (jv, v)):
        assert cKDTree(b).query(a)[0].mean() <= 0.01 * 0.05

    # the semantic cut: two one-hot feature channels, class 0 (the
    # background) on the cube's x < 0 half, a classifier of flax weights on
    # both sides
    x = np.asarray(js.params.xyz)[:, 0]
    sem = np.stack([x < 0, x >= 0], 1)[:, None, :].astype(np.float32)
    js2 = js._replace(params=js.params._replace(obj_dc=jnp.asarray(sem)))
    clf = JAPP.SemanticClassifier(2)
    variables = {"params": {"Dense_0": {
        "kernel": np.array([[1.0, -1.0], [-1.0, 1.0]], np.float32),
        "bias": np.zeros(2, np.float32)}}}
    jv, jf = JX.extract_mesh_from_state(
        js2, jinfo.train_cameras, jrcfg._replace(ch_sem=2), jinfo.trans,
        jinfo.scale, sem_classifier=lambda x: clf.apply(variables, x),
        **kw)
    state2 = state_from_numpy(
        {k: np.asarray(v) for k, v in js2.params._asdict().items()},
        np.asarray(js2.active), "cpu")
    cls = APP.load_flax(APP.SemanticClassifier(2, 2), variables)
    v, f = X.extract_mesh_from_state(state2, info.train_cameras,
                                     rcfg._replace(ch_sem=2), info.trans,
                                     info.scale, sem_classifier=cls, **kw)
    assert 0 < len(jf) < len(f_all)
    assert abs(len(f) - len(jf)) <= 1e-3 * len(jf)
    for a, b in ((v, jv), (jv, v)):
        assert cKDTree(b).query(a)[0].mean() <= 0.01 * 0.05


def test_mesh_ply_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    verts = rng.normal(size=(40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, (30, 3)).astype(np.int32)
    X.save_mesh_ply(str(tmp_path / "a.ply"), verts, faces)
    JX.save_mesh_ply(str(tmp_path / "b.ply"), verts, faces)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply"
                                                 ).read_bytes()
    v, f = X.load_mesh_ply(str(tmp_path / "b.ply"))
    np.testing.assert_array_equal(v, verts)
    np.testing.assert_array_equal(f, faces)


def test_depth2mesh_cli(tmp_path, capsys):
    from vcr_gaus_tpu_torch import depth2mesh

    _, _, logdir = cube_run(tmp_path)
    cfg = str(logdir / "config.yaml")
    base = ["--cfg_path", cfg, "--device", "cpu", "--voxel_size", "0.05"]

    # the dense grid's voxel count gate, before any work
    with pytest.raises(SystemExit) as exc:
        depth2mesh.main(base + ["--max_voxels", "1000"])
    assert exc.value.code == 3
    assert "exceeds --max_voxels=1,000" in capsys.readouterr().err

    # the CLI loads the scene without masks (as the root depth2mesh.py
    # does), so --mask_cut cuts nothing
    plain = X.load_mesh_ply(depth2mesh.main(base + ["--no-prune_outliers"]))
    cut = X.load_mesh_ply(depth2mesh.main(base + ["--mask_cut",
                                                  "--no-prune_outliers"]))
    for a, b in zip(cut, plain):
        np.testing.assert_array_equal(a, b)

    # 300 splats on a 3-wide cube: the radius filter (5 neighbours within
    # 0.01 of the scene radius) finds none, so the inside-box crop is kept
    out = depth2mesh.main(base + ["--prob_thr", "0.5", "--max_depth", "6"])
    log = capsys.readouterr().out
    assert "radius filter would remove every splat" in log
    assert "prune_outliers: kept 300 (removed 0 outliers, 0 outside-box)" \
        in log
    verts, faces = X.load_mesh_ply(out)
    assert out == str(logdir / "ours.ply")
    assert len(faces) > 1000
    assert np.abs(verts).max() <= 1.5 + 1e-6     # inside the meta box
