"""The port's LPIPS (vcr_gaus_tpu_torch/evaluation/lpips.py) against the JAX
package's (vcr_gaus_tpu/evaluation/lpips_jax.py): the generated placeholder
weights, the distance, the NVS sweep's LPIPS column and render_eval's
``--lpips_weights`` flag. Distances at atol 2e-4, rtol 1e-3 (the forward
tolerance of the JAX suite, tests/test_rasterize.py:88): both run VGG16 in
float32, with the sums taken in another order."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from vcr_gaus_tpu.evaluation import lpips_jax as JL
from vcr_gaus_tpu.evaluation import nvs as jnvs
from vcr_gaus_tpu_torch.evaluation import lpips as L
from vcr_gaus_tpu_torch.evaluation import nvs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The placeholder file, written by the port."""
    return L.write_placeholder_weights(
        str(tmp_path_factory.mktemp("lpips") / "placeholder.npz"))


@pytest.fixture
def placeholder_env(tmp_path, monkeypatch):
    """LPIPS_WEIGHTS=placeholder, each package's generated file under
    tmp_path."""
    monkeypatch.setenv("LPIPS_WEIGHTS", "placeholder")
    monkeypatch.setattr(L, "placeholder_path",
                        lambda: str(tmp_path / "port_placeholder.npz"))
    monkeypatch.setattr(JL, "placeholder_path",
                        lambda: str(tmp_path / "jax_placeholder.npz"))


def images(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", [0, 3])
def test_placeholder_arrays_equal_jax(tmp_path, seed):
    got = np.load(L.write_placeholder_weights(str(tmp_path / "p.npz"), seed))
    want = np.load(JL.write_placeholder_weights(str(tmp_path / "j.npz"), seed))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_lpips_matches_jax(weights, shape):
    """Odd sizes take the floor at every 2x2 pool, as the JAX VALID
    window does."""
    a, b = images(1, *shape)
    lp = L.LPIPS(weights, device="cpu")
    assert lp.is_placeholder
    got = float(lp(a, b))
    want = JL.LPIPS(weights)(a, b)
    assert got > 1e-6
    np.testing.assert_allclose(got, want, **TOL)
    # a tensor input gives the same distance as an array
    assert float(lp(torch.from_numpy(a), torch.from_numpy(b))) == got


def test_lpips_two_file_form_matches_jax(tmp_path, weights):
    """$LPIPS_VGG_PATH (.pth state_dict) + $LPIPS_LIN_PATH (.npz)."""
    z = np.load(weights)
    torch.save({k: torch.from_numpy(z[k]) for k in z.files
                if k.startswith("features.")}, tmp_path / "vgg.pth")
    np.savez(tmp_path / "lin.npz", **{k: z[k] for k in z.files
                                      if k.startswith("lin")})
    vgg, lin = str(tmp_path / "vgg.pth"), str(tmp_path / "lin.npz")
    a, b = images(2)
    lp = L.LPIPS.maybe(vgg, lin, device="cpu")
    assert lp is not None and not lp.is_placeholder
    np.testing.assert_allclose(float(lp(a, b)), JL.LPIPS(vgg, lin)(a, b),
                               **TOL)
    assert L.LPIPS.maybe(None, None, device="cpu") is None
    assert L.LPIPS.maybe("/nonexistent", lin, device="cpu") is None
    assert L.LPIPS.maybe(vgg, "/nonexistent", device="cpu") is None


def test_lpips_self_distance_zero(weights):
    a, b = images(4)
    lp = L.LPIPS(weights, device="cpu")
    assert abs(float(lp(a, a))) < 1e-6
    assert float(lp(a, b)) == pytest.approx(float(lp(b, a)), rel=1e-5)


def test_from_env(tmp_path, monkeypatch, placeholder_env):
    lp = L.LPIPS.from_env("cpu")
    assert lp is not None and lp.is_placeholder
    assert os.path.exists(tmp_path / "port_placeholder.npz")
    monkeypatch.delenv("LPIPS_WEIGHTS")
    monkeypatch.delenv("LPIPS_VGG_PATH", raising=False)
    monkeypatch.delenv("LPIPS_LIN_PATH", raising=False)
    assert L.LPIPS.from_env("cpu") is None
    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    assert L.LPIPS.from_env("cpu") is None


def _write_sweep(out_dir, n=2):
    for sub in ("renders", "gt"):
        os.makedirs(os.path.join(out_dir, sub))
    for i in range(n):
        a, b = images(10 + i)
        for sub, arr in (("renders", a), ("gt", b)):
            Image.fromarray((arr.transpose(1, 2, 0) * 255).astype(
                np.uint8)).save(os.path.join(out_dir, sub, f"{i:05d}.png"))


def test_evaluate_dir_matches_jax(tmp_path, placeholder_env):
    """LPIPS_WEIGHTS=placeholder: both sweeps on the same renders and gt
    give the same keys, per view and overall, and the same values."""
    _write_sweep(str(tmp_path / "port"))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    got = nvs.evaluate_dir(str(tmp_path / "port"), device="cpu")
    want = jnvs.evaluate_dir(str(tmp_path / "jax"))
    assert set(got) == set(want) == {"PSNR", "SSIM", "LPIPS",
                                     "LPIPS_placeholder"}
    assert got["LPIPS_placeholder"] is want["LPIPS_placeholder"] is True
    for k in ("PSNR", "SSIM", "LPIPS"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    with open(tmp_path / "port" / "per_view.json") as f:
        got_v = json.load(f)
    with open(tmp_path / "jax" / "per_view.json") as f:
        want_v = json.load(f)
    assert set(got_v) == set(want_v)
    for name, rec in want_v.items():
        assert set(got_v[name]) == set(rec) == {"psnr", "ssim", "lpips"}
        np.testing.assert_allclose(got_v[name]["lpips"], rec["lpips"], **TOL)


def test_render_eval_lpips_flag(tmp_path, monkeypatch, weights):
    """``--lpips_weights <npz>`` adds the column, and the JAX sweep on the
    same renders and gt gives the same LPIPS."""
    from fixtures import make_cube_points, write_colmap_scene

    from vcr_gaus_tpu_torch import render_eval
    from vcr_gaus_tpu_torch.models.gaussians import create_from_pcd
    from vcr_gaus_tpu_torch.models.ply_io import save_gaussian_ply

    # the flag sets $LPIPS_WEIGHTS: record its absence so it is restored
    monkeypatch.setenv("LPIPS_WEIGHTS", "unset")
    monkeypatch.delenv("LPIPS_WEIGHTS")
    scene = str(tmp_path / "scene")
    write_colmap_scene(scene, n_cams=3, width=48, height=32)
    pts, cols = make_cube_points(400)
    state = create_from_pcd(pts, cols, 512, 3, device="cpu")
    logdir = tmp_path / "run"
    save_gaussian_ply(state, str(logdir / "point_cloud" / "iteration_5"
                                 / "point_cloud.ply"))
    with open(logdir / "config.yaml", "w") as f:
        yaml.safe_dump({"_parent_": os.path.join(REPO, "configs",
                                                 "config_base.yaml"),
                        "model": {"source_path": scene}}, f)
    got = render_eval.main(["--cfg_path", str(logdir / "config.yaml"),
                            "--lpips_weights", weights, "--skip_test",
                            "--device", "cpu"])
    res = got["train"]
    assert res["LPIPS_placeholder"] is True and res["LPIPS"] > 0
    out_dir = logdir / "train" / "ours_5"
    with open(out_dir / "results.json") as f:
        assert json.load(f)["LPIPS"] == res["LPIPS"]
    with open(out_dir / "per_view.json") as f:
        assert all("lpips" in v for v in json.load(f).values())
    shutil.copytree(out_dir, tmp_path / "jax")
    want = jnvs.evaluate_dir(str(tmp_path / "jax"))
    np.testing.assert_allclose(res["LPIPS"], want["LPIPS"], **TOL)
