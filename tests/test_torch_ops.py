"""The port's modules against the JAX package, on the same numpy inputs.

The JAX side runs as its own tests run it on the CPU (Pallas in interpret
mode); the port runs its plain PyTorch versions on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rasterize import H as RH, W as RW, make_scene as raster_scene
from test_renderer import make_scene as render_scene
from vcr_gaus_tpu.data.cameras import Camera as JCamera
from vcr_gaus_tpu.ops import binning as JB
from vcr_gaus_tpu.ops import projection as JPF
from vcr_gaus_tpu.ops import rasterize as JR
from vcr_gaus_tpu.ops import rasterize_ref as JREF
from vcr_gaus_tpu.utils import graphics as JG
from vcr_gaus_tpu.utils import math as JM
from vcr_gaus_tpu.utils import sh as JSH
from vcr_gaus_tpu_torch.data.cameras import Camera
from vcr_gaus_tpu_torch.ops import binning as B
from vcr_gaus_tpu_torch.ops import projection as PF
from vcr_gaus_tpu_torch.ops import rasterize as R
from vcr_gaus_tpu_torch.ops import rasterize_ref as REF
from vcr_gaus_tpu_torch.utils import graphics as G
from vcr_gaus_tpu_torch.utils import math as M
from vcr_gaus_tpu_torch.utils import sh as SH

# forward compositing tolerance of the JAX suite (tests/test_rasterize.py:88)
FWD = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


# --- (b) small modules, atol 1e-5 -----------------------------------------

@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(50, 3, 16)).astype(np.float32)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    want = np.asarray(JSH.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))
    got = SH.eval_sh(deg, t(sh), t(dirs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    rgb = rng.uniform(size=(4, 3)).astype(np.float32)
    np.testing.assert_allclose(SH.sh_to_rgb(SH.rgb_to_sh(t(rgb))).numpy(), rgb,
                               atol=1e-6)


def test_quat_math_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[0] = 0.0                                   # an inactive zero slot
    s = rng.uniform(0.01, 1.0, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(M.quat_to_rotmat(t(q)).numpy(),
                               np.asarray(JM.quat_to_rotmat(jnp.asarray(q))),
                               atol=1e-5)
    np.testing.assert_allclose(
        M.covariance_from_scaling_rotation(t(s), t(q)).numpy(),
        np.asarray(JM.covariance_from_scaling_rotation(jnp.asarray(s),
                                                       jnp.asarray(q))),
        atol=1e-5)
    np.testing.assert_allclose(
        M.shortest_axis_normal(t(s), t(q)).numpy(),
        np.asarray(JM.shortest_axis_normal(jnp.asarray(s), jnp.asarray(q))),
        atol=1e-5)


def test_normals_from_depth_match_jax():
    rng = np.random.default_rng(2)
    depth = rng.uniform(2.0, 3.0, (12, 17)).astype(np.float32)
    depth[3:5, 4:9] = 0.0                        # empty pixels stay finite
    K = JG.intrinsic_matrix(0.9, 0.7, 12, 17)
    want = np.asarray(JG.compute_normals_from_depth(jnp.asarray(depth),
                                                    jnp.asarray(K)))
    got = G.compute_normals_from_depth(t(depth), t(K)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_camera_matrices_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(4):
        a = rng.normal(size=3)
        Rm = np.asarray(JM.quat_to_rotmat(jnp.asarray(
            np.r_[1.0, 0.3 * a].astype(np.float32))), np.float64)
        T = rng.normal(size=3)
        kw = dict(colmap_id=0, idx=2, image_name="c", R=Rm, T=T, fovx=0.9,
                  fovy=0.7, width=40, height=30,
                  image=rng.integers(0, 256, (3, 30, 40), dtype=np.uint8))
        want = JCamera(**kw).arrays()
        got = Camera(**kw).arrays("cpu")
        for name in want._fields:
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       atol=1e-5, err_msg=name)
    np.testing.assert_allclose(G.projection_matrix(0.01, 100.0, 0.9, 0.7),
                               JG.projection_matrix(0.01, 100.0, 0.9, 0.7))
    np.testing.assert_allclose(G.intrinsic_matrix(0.9, 0.7, 30, 40),
                               JG.intrinsic_matrix(0.9, 0.7, 30, 40))


# --- (c) projection ---------------------------------------------------------

def _render_scene_inputs(seed=0):
    state, cam = render_scene(seed=seed)
    p = state.params
    arr = cam.arrays()
    return dict(xyz=np.asarray(p.xyz), scale=np.asarray(state.scaling),
                quat=np.asarray(p.quat),
                opacity=np.asarray(state.opacity[:, 0]),
                view=arr.viewmatrix, proj=arr.projmatrix, tanfov=arr.tanfov,
                width=cam.width, height=cam.height)


def _project_both(s):
    want = JPF.project_gaussians(
        jnp.asarray(s["xyz"]), jnp.asarray(s["scale"]), jnp.asarray(s["quat"]),
        jnp.asarray(s["view"]), jnp.asarray(s["proj"]),
        jnp.asarray(s["tanfov"][0]), jnp.asarray(s["tanfov"][1]),
        s["width"], s["height"], opacity=jnp.asarray(s["opacity"]))
    got = PF.project_gaussians(
        t(s["xyz"]), t(s["scale"]), t(s["quat"]), t(s["view"]), t(s["proj"]),
        t(s["tanfov"])[0], t(s["tanfov"])[1], s["width"], s["height"],
        opacity=t(s["opacity"]))
    return got, want


def _assert_ceil_close(got, want):
    """Integer ceil outputs: float rounding just below an integer may put
    the ceil one step apart, so at least 99.5% match exactly and none
    differs by more than 1."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.995


@pytest.mark.parametrize("seed", [0, 1])
def test_projection_matches_jax(seed):
    got, want = _project_both(_render_scene_inputs(seed))
    for name in ("mean2d", "conic", "depth_z", "mean_cam"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=1e-6, err_msg=name)
    assert got.radius.dtype == torch.int32
    _assert_ceil_close(got.radius.numpy(), np.asarray(want.radius))
    _assert_ceil_close(got.ext.numpy(), np.asarray(want.ext))
    assert int((got.radius > 0).sum()) > 100


@pytest.mark.parametrize("ch_sem", [0, 3])
def test_pack_features_matches_jax(ch_sem):
    s = _render_scene_inputs()
    got_p, want_p = _project_both(s)
    rng = np.random.default_rng(4)
    n = s["xyz"].shape[0]
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    sem = rng.uniform(size=(n, ch_sem)).astype(np.float32)
    want = JPF.pack_features(want_p, jnp.asarray(s["opacity"]),
                             jnp.asarray(rgb), jnp.asarray(nrm),
                             jnp.asarray(sem), ch_sem)
    got = PF.pack_features(got_p, t(s["opacity"]), t(rgb), t(nrm), t(sem),
                           ch_sem)
    assert got.shape == (n, PF.feature_dim(ch_sem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)


# --- (d) binning: exact per-tile gid order ----------------------------------

def _tile_sequences(sorted_gid, starts, counts):
    g, s, c = (np.asarray(x) for x in (sorted_gid, starts, counts))
    return [g[a:a + b].tolist() for a, b in zip(s, c)]


@pytest.mark.parametrize("use_ext", [False, True])
def test_binning_tile_order_equals_jax(use_ext):
    s = _render_scene_inputs(seed=1)
    _, want_p = _project_both(s)
    mean2d = np.asarray(want_p.mean2d)
    radius = np.asarray(want_p.radius)
    depth = np.asarray(want_p.depth_z)
    ext = np.asarray(want_p.ext) if use_ext else None
    W, H = s["width"], s["height"]
    jb = JB.bin_gaussians(jnp.asarray(mean2d), jnp.asarray(radius),
                          jnp.asarray(depth), W, H, 16, 1 << 14,
                          extents=None if ext is None else jnp.asarray(ext))
    pb = B.bin_gaussians(t(mean2d), t(radius), t(depth), W, H,
                         extents=None if ext is None else t(ext))
    assert pb.num_entries == int(jb.num_entries) > 0
    want = _tile_sequences(jb.sorted_gid, jb.tile_starts, jb.tile_counts)
    got = _tile_sequences(pb.sorted_gid, pb.tile_starts, pb.tile_counts)
    assert got == want


# --- (e) compositing --------------------------------------------------------

def _raster_jax(feats, radius, cam, depth_mode, ch_sem, w=RW, h=RH):
    depth_z = feats[:, JPF.F_DEPTH_Z]
    mean2d = feats[:, [JPF.F_MEAN_X, JPF.F_MEAN_Y]]
    out, binn = JR.rasterize_image(feats, jnp.zeros((feats.shape[0], 2)),
                                   mean2d, radius, depth_z, jnp.asarray(cam),
                                   w, h, ch_sem, depth_mode,
                                   entry_budget=8192)
    assert not bool(binn.overflow)
    return np.asarray(out)


def _raster_port(feats, radius, cam, depth_mode, ch_sem, w=RW, h=RH):
    f = t(np.asarray(feats))
    out, binn = R.rasterize_image(
        f, f[:, [PF.F_MEAN_X, PF.F_MEAN_Y]], t(np.asarray(radius)),
        f[:, PF.F_DEPTH_Z], t(cam), w, h, ch_sem, depth_mode)
    assert binn.overflow is False
    return out.numpy()


@pytest.mark.parametrize("depth_mode", ["traditional", "intersection"])
def test_composite_matches_jax_and_oracle(depth_mode):
    feats, radius, cam = raster_scene()
    ch_sem = 2
    got = _raster_port(feats, radius, cam, depth_mode, ch_sem)
    want = _raster_jax(feats, radius, cam, depth_mode, ch_sem)
    assert got.shape == (9 + ch_sem, RH, RW)
    np.testing.assert_allclose(got, want, **FWD)
    f = t(np.asarray(feats))
    order = REF.depth_order(f[:, PF.F_DEPTH_Z], t(np.asarray(radius)))
    ref = REF.composite_reference(f, order, RH, RW, t(cam[4:7]), ch_sem,
                                  depth_mode=depth_mode, cam_k=t(cam[:4]))
    np.testing.assert_allclose(got, ref.numpy(), **FWD)
    jorder = JREF.depth_order(feats[:, JPF.F_DEPTH_Z], radius)
    jref = JREF.composite_reference(feats, jorder, RH, RW,
                                    jnp.asarray(cam[4:7]), ch_sem,
                                    depth_mode=depth_mode,
                                    cam_k=jnp.asarray(cam[:4]))
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), **FWD)


def test_composite_all_culled_is_background():
    feats, radius, cam = raster_scene()
    radius = jnp.zeros_like(radius)
    got = _raster_port(feats, radius, cam, "traditional", 2)
    np.testing.assert_allclose(got, _raster_jax(feats, radius, cam,
                                                "traditional", 2), **FWD)
    bg = np.broadcast_to(cam[4:7, None, None], got[:3].shape)
    np.testing.assert_allclose(got[:3], bg, atol=1e-6)
    np.testing.assert_allclose(got[3:], 0.0, atol=1e-6)


def _saturated_scene(n=700, seed=7):
    """tests/test_rasterize.py:373-413: a saturated multi-batch tile."""
    rng = np.random.default_rng(seed)
    feats = np.zeros((n, PF.feature_dim(0)), np.float32)
    feats[:, PF.F_MEAN_X] = rng.uniform(2, 14, n)
    feats[:, PF.F_MEAN_Y] = rng.uniform(2, 14, n)
    feats[:, PF.F_CONIC_A] = 0.02
    feats[:, PF.F_CONIC_C] = 0.02
    feats[:, PF.F_OPACITY] = 0.95
    depth = np.sort(rng.uniform(1.0, 9.0, n)).astype(np.float32)
    feats[:, PF.F_DEPTH_Z] = depth
    feats[:, PF.F_RGB:PF.F_RGB + 3] = rng.uniform(0, 1, (n, 3))
    feats[:, PF.F_NORMAL + 2] = -1.0
    feats[:, PF.F_PLANE_D] = -depth
    cam = np.array([50.0, 50.0, RW / 2, RH / 2, 0.1, 0.5, 0.9, 0.0],
                   np.float32)
    return jnp.asarray(feats), jnp.full((n,), 30, jnp.int32), cam


def test_composite_early_stop_matches_jax():
    feats, radius, cam = _saturated_scene()
    got = _raster_port(feats, radius, cam, "traditional", 0)
    np.testing.assert_allclose(got, _raster_jax(feats, radius, cam,
                                                "traditional", 0), **FWD)
    # the stop fired: some tile holds more batches than it composited
    f = t(np.asarray(feats))
    binn = B.bin_gaussians(f[:, :2], t(np.asarray(radius)),
                           f[:, PF.F_DEPTH_Z], RW, RH)
    _, batches = R.rasterize_forward(f, binn, t(cam), RW, RH, 0, "traditional")
    nbatch = (binn.tile_counts + R.BATCH - 1) // R.BATCH
    assert int(nbatch.max()) > 1
    assert bool((batches < nbatch).any())
    assert bool((batches >= 1).all())


def test_tile_subset_equals_full_image():
    """The plain version run on a subset of tiles (as chip_smoke.py holds the
    kernel at full width) gives those tiles' pixels of the full run."""
    feats, radius, cam = raster_scene(n=80, seed=3)
    f = t(np.asarray(feats))
    binn = B.bin_gaussians(f[:, :2], t(np.asarray(radius)),
                           f[:, PF.F_DEPTH_Z], RW, RH)
    n_tx, n_ty = B.tile_grid(RW, RH)
    full, _ = R.composite_tiles_torch(f, binn.sorted_gid, binn.tile_starts,
                                      binn.tile_counts, t(cam), n_tx, 2,
                                      "intersection", group=2)
    ids = torch.tensor([4, 1])
    sub, _ = R.composite_tiles_torch(f, binn.sorted_gid, binn.tile_starts,
                                     binn.tile_counts, t(cam), n_tx, 2,
                                     "intersection", tile_ids=ids)
    torch.testing.assert_close(sub, full[ids], atol=0, rtol=0)
    img = R.tiles_to_image(full, n_tx, n_ty, RW, RH)
    assert img.shape == (11, RH, RW)


def test_wrapper_rejects_bad_inputs():
    feats, radius, cam = raster_scene()
    f = t(np.asarray(feats))
    binn = B.bin_gaussians(f[:, :2], t(np.asarray(radius)),
                           f[:, PF.F_DEPTH_Z], RW, RH)
    with pytest.raises(ValueError):
        R.rasterize_forward(f, binn, t(cam), RW, RH, 3, "traditional")
    with pytest.raises(ValueError):
        R.rasterize_forward(f, binn, t(cam), RW, RH, 2, "bogus")
    with pytest.raises(ValueError):
        R.rasterize_forward(f, binn, t(cam), RW + 64, RH, 2, "traditional")
