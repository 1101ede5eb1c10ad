"""The port's render paths against the JAX package: the pose PCA, the
ellipse path, the path cameras, the frames of a fly-through (through each
package's renderer on the CPU, the JAX one's Pallas kernel in interpret
mode) and the video writer's fallback chain."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_cube_points, ring_cameras
from vcr_gaus_tpu.data.cameras import Camera as JCamera
from vcr_gaus_tpu.models import gaussians as JGM
from vcr_gaus_tpu.render.renderer import RenderConfig as JRenderConfig
from vcr_gaus_tpu.utils import render_paths as JRP
from vcr_gaus_tpu_torch.data.cameras import Camera
from vcr_gaus_tpu_torch.models.convert import state_from_numpy
from vcr_gaus_tpu_torch.render.renderer import RenderConfig
from vcr_gaus_tpu_torch.utils import render_paths as RP

PATH = dict(rtol=0, atol=1e-12)
W, H = 32, 24


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def camera_pair(n=10, dist=3.0, h=0.5, flip=False):
    """The same ring of cameras in both packages. ``flip`` turns each
    camera upside down, which takes transform_poses_pca's other branch."""
    port, jax_cams = [], []
    for i, (R, Tv) in enumerate(ring_cameras(n_cams=n, dist=dist, h=h)):
        if flip:
            flip_xy = np.diag([-1.0, -1.0, 1.0])
            R, Tv = flip_xy @ R, flip_xy @ Tv
        kw = dict(colmap_id=i, idx=i, image_name=f"c{i}", R=R.T, T=Tv,
                  fovx=0.8, fovy=0.6, width=W, height=H)
        port.append(Camera(**kw))
        jax_cams.append(JCamera(**kw))
    return port, jax_cams


@pytest.mark.parametrize("flip", [False, True])
def test_render_path_matches_jax(flip):
    port, jax_cams = camera_pair(flip=flip)
    poses = RP.poses_c2w(port)
    np.testing.assert_allclose(poses, JRP.poses_c2w(jax_cams), **PATH)
    rec, transform = RP.transform_poses_pca(poses[:, :3, :4])
    want_rec, want_tf = JRP.transform_poses_pca(poses[:, :3, :4])
    np.testing.assert_allclose(rec, want_rec, **PATH)
    np.testing.assert_allclose(transform, want_tf, **PATH)
    assert np.abs(rec[:, :3, 3]).max() <= 1.0 + 1e-12
    np.testing.assert_array_equal(RP.pad_poses(rec), JRP.pad_poses(rec))
    for z in (0.0, 0.4):
        path = RP.generate_ellipse_path(rec, 24, z_variation=z,
                                        z_phase=0.25)
        np.testing.assert_allclose(
            path, JRP.generate_ellipse_path(rec, 24, z_variation=z,
                                            z_phase=0.25), **PATH)
    cams = RP.path_to_cameras(path, np.linalg.inv(transform), port[0])
    want = JRP.path_to_cameras(path, np.linalg.inv(transform), jax_cams[0])
    assert len(cams) == 24
    for c, w in zip(cams, want):
        assert (c.colmap_id, c.idx, c.image_name, c.image) == (
            w.colmap_id, w.idx, w.image_name, None)
        np.testing.assert_allclose(c.R, w.R, **PATH)
        np.testing.assert_allclose(c.T, w.T, **PATH)
        np.testing.assert_allclose(c.R @ c.R.T, np.eye(3), atol=1e-12)


def cube_states(n=400, seed=0):
    """The fixture cube's points as Gaussians in both packages, with
    seeded higher-order SH."""
    pts, cols = make_cube_points(n, seed)
    jstate = JGM.create_from_pcd(pts * 0.8, cols, 512, sh_degree=3)
    rng = np.random.default_rng(seed)
    f_rest = (0.2 * rng.normal(size=jstate.params.f_rest.shape)).astype(
        np.float32)
    jstate = jstate._replace(params=jstate.params._replace(
        f_rest=jnp.asarray(f_rest)))
    params = {k: np.asarray(v) for k, v in jstate.params._asdict().items()}
    state = state_from_numpy(params, np.asarray(jstate.active), "cpu",
                             active_sh_degree=3)
    return state, jstate


def test_flythrough_frames_match_jax(tmp_path, monkeypatch):
    port, jax_cams = camera_pair(n=8, dist=4.0, h=0.8)
    state, jstate = cube_states()
    got, want = [], []
    monkeypatch.setattr(RP, "write_video",
                        lambda path, frames, fps: got.extend(frames) or path)
    monkeypatch.setattr(JRP, "write_video",
                        lambda path, frames, fps: want.extend(frames) or path)
    out = str(tmp_path / "fly.mp4")
    assert RP.render_flythrough(state, port, RenderConfig(width=W, height=H),
                                out, n_frames=8, scene_extent=4.0) == out
    JRP.render_flythrough(jstate, jax_cams,
                          JRenderConfig(width=W, height=H,
                                        entry_budget=1 << 14),
                          out, n_frames=8, scene_extent=4.0)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.shape == (H, W, 3) and g.dtype == np.uint8
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
    # the path orbits the cube: every frame sees it
    assert all(g.max() > 50 for g in got)


def test_write_video_fallback_chain(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
              for _ in range(3)]
    got = RP.write_video(str(tmp_path / "port" / "v.mp4"), frames)
    want = JRP.write_video(str(tmp_path / "jax" / "v.mp4"), frames)
    assert os.path.splitext(got)[1] == os.path.splitext(want)[1]
    assert os.path.basename(got) == os.path.basename(want)
    assert os.path.exists(got)
    # without imageio: the PNG frame directory, with one printed line
    monkeypatch.setitem(sys.modules, "imageio", None)
    capsys.readouterr()
    got = RP.write_video(str(tmp_path / "bare" / "v.mp4"), frames)
    assert capsys.readouterr().out.count("\n") == 1
    assert got == str(tmp_path / "bare" / "v_frames")
    assert sorted(os.listdir(got)) == ["00000.png", "00001.png", "00002.png"]
    from PIL import Image
    np.testing.assert_array_equal(
        np.asarray(Image.open(os.path.join(got, "00001.png"))), frames[1])
