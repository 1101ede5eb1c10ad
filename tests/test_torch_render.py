"""The port's render path against the JAX package: render(), the PLY
carried across, and the render_eval entry point."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_renderer import make_scene
from vcr_gaus_tpu.models import gaussians as JGM
from vcr_gaus_tpu.models import ply_io as JPLY
from vcr_gaus_tpu.render.renderer import RenderConfig as JRenderConfig
from vcr_gaus_tpu.render.renderer import render as jrender
from vcr_gaus_tpu_torch.data.cameras import Camera
from vcr_gaus_tpu_torch.models import ply_io as PLY
from vcr_gaus_tpu_torch.models.convert import state_from_numpy, state_to_numpy
from vcr_gaus_tpu_torch.models.gaussians import zeros_params
from vcr_gaus_tpu_torch.render.renderer import RenderConfig, render

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def with_random_sh(state, seed=0, scale=0.3):
    """A JAX state with seeded random higher-order SH, so SH degree 3 is
    exercised (create_from_pcd leaves f_rest at zero)."""
    rng = np.random.default_rng(seed)
    f_rest = (scale * rng.normal(size=state.params.f_rest.shape)).astype(
        np.float32)
    return state._replace(params=state.params._replace(
        f_rest=jnp.asarray(f_rest)))


def to_port(jstate):
    params = {k: np.asarray(v) for k, v in jstate.params._asdict().items()}
    return state_from_numpy(params, np.asarray(jstate.active), "cpu",
                            active_sh_degree=int(jstate.active_sh_degree))


def port_camera(jcam):
    return Camera(colmap_id=jcam.colmap_id, idx=jcam.idx,
                  image_name=jcam.image_name, R=jcam.R, T=jcam.T,
                  fovx=jcam.fovx, fovy=jcam.fovy, width=jcam.width,
                  height=jcam.height, image=jcam.image)


@pytest.mark.parametrize("depth_mode", ["traditional", "intersection"])
def test_render_matches_jax(depth_mode):
    jstate, jcam = make_scene(seed=1)
    jstate = with_random_sh(jstate)
    W, H = jcam.width, jcam.height
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    want = jrender(jstate, jcam.arrays(),
                   JRenderConfig(width=W, height=H, entry_budget=1 << 14,
                                 depth_mode=depth_mode),
                   jnp.asarray(bg), sh_degree=3, scene_extent=3.0)
    got = render(to_port(jstate), port_camera(jcam).arrays("cpu"),
                 RenderConfig(width=W, height=H, depth_mode=depth_mode),
                 torch.from_numpy(bg), sh_degree=3, scene_extent=3.0)
    assert got["num_entries"] == int(want["num_entries"])
    assert got["overflow"] is False and not bool(want["overflow"])
    for key in ("render", "depth", "normal", "alpha", "depth_var",
                "distortion"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **FWD)
    # est_normal differentiates the depth map: compare where the depth and
    # its neighbors are solid (alpha > 0.5), where it is well conditioned
    a = np.asarray(want["alpha"]) > 0.5
    solid = a.copy()
    solid[1:-1, 1:-1] &= a[:-2, 1:-1] & a[2:, 1:-1] & a[1:-1, :-2] & a[1:-1, 2:]
    np.testing.assert_allclose(got["est_normal"].numpy()[solid],
                               np.asarray(want["est_normal"])[solid], **FWD)
    mask = got["mask"].numpy()
    np.testing.assert_array_equal(mask, np.asarray(want["mask"]))
    assert 0 < mask.sum() < mask.size
    np.testing.assert_array_equal(got["visibility_filter"].numpy(),
                                  np.asarray(want["visibility_filter"]))
    np.testing.assert_array_equal(got["radii"].numpy(),
                                  np.asarray(want["radii"]))


def test_render_semantic_channels_match_jax():
    jstate, jcam = make_scene(seed=2, ch_sem=3)
    W, H = jcam.width, jcam.height
    want = jrender(jstate, jcam.arrays(),
                   JRenderConfig(width=W, height=H, entry_budget=1 << 14,
                                 ch_sem=3, depth_mode="intersection"),
                   jnp.zeros(3), sh_degree=0, scene_extent=100.0)
    got = render(to_port(jstate), port_camera(jcam).arrays("cpu"),
                 RenderConfig(width=W, height=H, ch_sem=3),
                 torch.zeros(3), sh_degree=0, scene_extent=100.0)
    np.testing.assert_allclose(got["render_sem"].numpy(),
                               np.asarray(want["render_sem"]), **FWD)


def test_ply_written_by_jax_loads_into_port(tmp_path):
    jstate, _ = make_scene(seed=3, ch_sem=2)
    jstate = with_random_sh(jstate, seed=3)
    path = str(tmp_path / "jax.ply")
    JPLY.save_gaussian_ply(jstate, path)
    got = PLY.load_gaussian_ply(path, max_sh_degree=3, device="cpu")
    act = np.asarray(jstate.active)
    want = state_from_numpy(
        {k: np.asarray(v)[act] for k, v in jstate.params._asdict().items()},
        act[act], "cpu")
    for k, v in want.params.as_dict().items():
        torch.testing.assert_close(getattr(got.params, k), v, atol=0, rtol=0)
    assert torch.equal(got.active, want.active)
    assert got.active_sh_degree == 3
    # and back: the port writes the same bytes the JAX package does
    again = str(tmp_path / "port.ply")
    PLY.save_gaussian_ply(got, again)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()


def test_state_numpy_round_trip():
    jstate, _ = make_scene(seed=4)
    st = to_port(jstate)
    params, active = state_to_numpy(st)
    for k, v in jstate.params._asdict().items():
        np.testing.assert_array_equal(params[k], np.asarray(v))
    np.testing.assert_array_equal(active, np.asarray(jstate.active))
    assert st.capacity == 256 and st.num_active == 200
    zp = zeros_params(8, 2, 3, torch.device("cpu"))
    for k, v in JGM.zeros_params(8, 2, 3)._asdict().items():
        assert tuple(getattr(zp, k).shape) == v.shape, k


def test_cuda_entry_point_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    jstate, jcam = make_scene()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_camera(jcam).arrays()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state_from_numpy(
            {k: np.asarray(v) for k, v in jstate.params._asdict().items()},
            np.asarray(jstate.active))


def test_render_eval_psnr_matches_jax(tmp_path):
    from fixtures import make_cube_points, write_colmap_scene

    from vcr_gaus_tpu.data.scene import load_scene_info
    from vcr_gaus_tpu.evaluation import nvs as jnvs
    from vcr_gaus_tpu_torch import render_eval

    scene = str(tmp_path / "scene")
    write_colmap_scene(scene, n_cams=4, width=48, height=32)
    pts, cols = make_cube_points(600)
    jstate = with_random_sh(JGM.create_from_pcd(pts, cols, 640, sh_degree=3),
                            seed=5, scale=0.05)
    logdir = tmp_path / "run"
    JPLY.save_gaussian_ply(jstate, str(logdir / "point_cloud" / "iteration_7"
                                       / "point_cloud.ply"))
    cfg = {"_parent_": os.path.join(REPO, "configs", "config_base.yaml"),
           "model": {"source_path": scene, "depth_type": "intersection"}}
    with open(logdir / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)

    got = render_eval.main(["--cfg_path", str(logdir / "config.yaml"),
                            "--device", "cpu"])
    assert os.path.exists(logdir / "train" / "ours_7" / "renders"
                          / "00003.png")

    info = load_scene_info(scene)
    cam0 = info.train_cameras[0]
    rcfg = JRenderConfig(width=cam0.width, height=cam0.height,
                         depth_mode="intersection", entry_budget=1 << 15,
                         mask_depth_thr=1e9)
    out_dir = str(tmp_path / "jax_eval")
    loaded = JPLY.load_gaussian_ply(str(logdir / "point_cloud" / "iteration_7"
                                        / "point_cloud.ply"))
    jnvs.render_sets(loaded, info.train_cameras, rcfg,
                     np.zeros(3, np.float32), out_dir, sh_degree=3,
                     scene_extent=info.radius)
    want = jnvs.evaluate_dir(out_dir)
    assert abs(got["train"]["PSNR"] - want["PSNR"]) < 0.05
    assert abs(got["train"]["SSIM"] - want["SSIM"]) < 1e-3
    assert 10.0 < got["train"]["PSNR"] < 60.0
