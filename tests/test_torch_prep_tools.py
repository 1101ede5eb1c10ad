"""The port's data-preparation tools (vcr_gaus_tpu_torch/tools/make_meta,
extract_priors, convert_lpips) against the JAX package's scripts
(scripts/make_meta.py, extract_priors.py, convert_lpips.py), each script
run in process through its own ``main`` on the same inputs: meta.json of
every mode equal at rtol 1e-6 with equal train/test lists; normals from
depth equal within 1 f16 ulp; all-foreground masks byte for byte; the
gated backends' messages; the converted LPIPS arrays key for key and
exactly, and the port's LPIPS from them against the JAX LPIPS from the
script's file at the LPIPS tests' tolerance. Every tool takes
``--device`` and refuses CUDA where there is none."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from fixtures import write_colmap_scene
from vcr_gaus_tpu_torch.tools import convert_lpips, extract_priors, make_meta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-4, rtol=1e-3)          # tests/test_torch_lpips.py


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def script(name):
    """scripts/<name>.py as a module (its main reads sys.argv)."""
    spec = importlib.util.spec_from_file_location(
        f"script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return script(name).main()


@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prep_scene"))
    write_colmap_scene(root, n_cams=7, n_pts=500, width=40, height=30)
    return root


def read_meta(root):
    with open(os.path.join(root, "meta.json")) as f:
        return json.load(f)


def assert_meta_equal(got, want):
    assert set(got) == set(want)
    for k in ("trans", "scale"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)
    for k in ("train", "test"):
        assert got.get(k) == want.get(k), k


@pytest.mark.parametrize("mode,split", [("points", 0.0), ("pose", 0.0),
                                        ("obb", 0.0), ("points", 0.7),
                                        ("obb", 0.5)])
def test_make_meta_matches_script(colmap_scene, monkeypatch, mode, split):
    argv = ["--source", colmap_scene, "--mode", mode,
            "--split_ratio", str(split)]
    run_script(monkeypatch, "make_meta", argv)
    want = read_meta(colmap_scene)
    os.remove(os.path.join(colmap_scene, "meta.json"))
    got = make_meta.main(argv + ["--device", "cpu"])
    assert got == read_meta(colmap_scene)
    assert_meta_equal(got, want)
    assert ("train" in got) == (split > 0)
    if mode == "obb":
        assert np.asarray(got["trans"]).shape == (4, 4)


def test_make_meta_split_lists(colmap_scene):
    meta = make_meta.main(["--source", colmap_scene, "--split_ratio", "0.7",
                           "--device", "cpu"])
    names = [f"img_{i:03d}" for i in range(7)]
    assert sorted(meta["train"] + meta["test"]) == names
    assert len(meta["test"]) == 7 - int(7 * 0.7)
    assert not set(meta["train"]) & set(meta["test"])


@pytest.fixture
def depth_scene(tmp_path):
    """The scene of tests/test_preprocess.py: two 32x24 views with planar
    depth and a PINHOLE cameras.txt."""
    src = tmp_path / "scene"
    (src / "images").mkdir(parents=True)
    (src / "depths").mkdir()
    (src / "sparse").mkdir()
    h, w = 24, 32
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(
            src / "images" / f"{i:06d}.png")
        depth = (2.0 + 0.01 * np.arange(h)[:, None] + np.zeros((h, w))
                 + 0.05 * rng.uniform(size=(h, w)) * i)
        np.savez_compressed(src / "depths" / f"{i:06d}.npz",
                            depth.astype(np.float32))
    with open(src / "sparse" / "cameras.txt", "w") as fp:
        fp.write(f"1 PINHOLE {w} {h} 30 28 {w/2 + 1} {h/2 - 1}\n")
    return str(src)


def f16_ulps(a, b):
    """Distance of two f16 arrays in units in the last place."""
    def key(x):
        i = x.view(np.int16).astype(np.int32)
        return np.where(i < 0, -(i & 0x7FFF), i)
    return np.abs(key(a) - key(b))


def test_normals_from_depth_match_script(depth_scene, monkeypatch):
    run_script(monkeypatch, "extract_priors",
               ["normals", "--source", depth_scene, "--backend", "depth",
                "--out", os.path.join(depth_scene, "normals_jax")])
    stems = extract_priors.main(["normals", "--source", depth_scene,
                                 "--backend", "depth", "--device", "cpu"])
    assert stems == ["000000", "000001"]
    for stem in stems:
        want = np.load(os.path.join(depth_scene, "normals_jax",
                                    stem + ".npz"))["arr_0"]
        got = np.load(os.path.join(depth_scene, "normals",
                                   stem + ".npz"))["arr_0"]
        assert got.shape == want.shape == (3, 24, 32)
        assert got.dtype == want.dtype == np.float16
        assert f16_ulps(got, want).max() <= 1, stem
        norms = np.linalg.norm(got.astype(np.float32), axis=0)
        np.testing.assert_allclose(norms[2:-2, 2:-2], 1.0, atol=1e-2)


def test_all_fg_masks_match_script(depth_scene, monkeypatch):
    run_script(monkeypatch, "extract_priors",
               ["masks", "--source", depth_scene, "--backend", "all-fg",
                "--out", os.path.join(depth_scene, "masks_jax")])
    stems = extract_priors.main(["masks", "--source", depth_scene,
                                 "--backend", "all-fg", "--device", "cpu"])
    assert stems == ["000000", "000001"]
    for stem in stems:
        with open(os.path.join(depth_scene, "masks", stem + ".png"),
                  "rb") as f:
            got = f.read()
        with open(os.path.join(depth_scene, "masks_jax", stem + ".png"),
                  "rb") as f:
            assert got == f.read()


@pytest.mark.parametrize("kind,env,backend", [
    ("normals", "DSINE_PATH", None), ("normals", "DSINE_PATH", "dsine"),
    ("masks", "GSAM_PATH", None), ("masks", "GSAM_PATH", "gsam")])
def test_external_backends_stay_gated(depth_scene, monkeypatch, kind, env,
                                      backend):
    """The defaults are the external models, which exit non-zero with the
    script's message naming their checkout's variable."""
    monkeypatch.delenv(env, raising=False)
    argv = [kind, "--source", depth_scene] + (
        ["--backend", backend] if backend else [])
    with pytest.raises(SystemExit) as want:
        run_script(monkeypatch, "extract_priors", argv)
    with pytest.raises(SystemExit) as got:
        extract_priors.main(argv + ["--device", "cpu"])
    # the same message, naming the port's own files
    assert str(got.value) == str(want.value).replace(
        "vcr_gaus_tpu/", "vcr_gaus_tpu_torch/")
    assert env in str(got.value)


@pytest.fixture(scope="module")
def lpips_files(tmp_path_factory):
    """The placeholder arrays split into a vgg file and a lin file."""
    from vcr_gaus_tpu_torch.evaluation.lpips import write_placeholder_weights
    d = tmp_path_factory.mktemp("lpips")
    combined = write_placeholder_weights(str(d / "placeholder.npz"))
    with np.load(combined) as z:
        arrays = dict(z)
    assert all((v >= 0).all() for k, v in arrays.items()
               if k.startswith("lin"))
    np.savez(d / "vgg.npz", **{k: v for k, v in arrays.items()
                               if k.startswith("features.")})
    np.savez(d / "lin.npz", **{k: v for k, v in arrays.items()
                               if k.startswith("lin")})
    return d, arrays


def test_convert_lpips_matches_script(lpips_files, monkeypatch):
    d, arrays = lpips_files
    run_script(monkeypatch, "convert_lpips",
               ["--vgg", str(d / "vgg.npz"), "--lin", str(d / "lin.npz"),
                "--out", str(d / "jax.npz")])
    got = convert_lpips.main(["--vgg", str(d / "vgg.npz"), "--lin",
                              str(d / "lin.npz"), "--out",
                              str(d / "port.npz"), "--device", "cpu"])
    with np.load(d / "jax.npz") as z:
        want = dict(z)
    with np.load(d / "port.npz") as z:
        assert set(z) == set(want) == set(got)
        for k, v in want.items():
            assert z[k].dtype == v.dtype, k
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    # the placeholder's heads are non-negative: the abs changes nothing
    for k, v in want.items():
        np.testing.assert_array_equal(v, arrays[k].reshape(v.shape))


def test_convert_lpips_scores_like_jax(lpips_files, monkeypatch, capsys):
    from vcr_gaus_tpu.evaluation.lpips_jax import LPIPS as JLPIPS
    from vcr_gaus_tpu_torch.evaluation.lpips import LPIPS
    d, _ = lpips_files
    run_script(monkeypatch, "convert_lpips",
               ["--vgg", str(d / "vgg.npz"), "--lin", str(d / "lin.npz"),
                "--out", str(d / "jax2.npz")])
    convert_lpips.main(["--vgg", str(d / "vgg.npz"), "--lin",
                        str(d / "lin.npz"), "--out", str(d / "port2.npz"),
                        "--selftest", "--device", "cpu"])
    assert "selftest: d(x,x)=0.000000" in capsys.readouterr().out
    rng = np.random.default_rng(5)
    a, b = rng.uniform(size=(2, 3, 48, 64)).astype(np.float32)
    want = float(JLPIPS(str(d / "jax2.npz"))(a, b))
    got = float(LPIPS(str(d / "port2.npz"), device="cpu")(a, b))
    np.testing.assert_allclose(got, want, **TOL)
    # and the placeholder file itself scores the same
    comb = float(LPIPS(str(d / "placeholder.npz"), device="cpu")(a, b))
    assert got == pytest.approx(comb, rel=1e-6)


def test_convert_lpips_refuses_a_wrong_file(lpips_files, tmp_path):
    d, arrays = lpips_files
    np.savez(tmp_path / "bad.npz", **{k: v for k, v in arrays.items()
                                      if k.startswith("features.")
                                      and not k.startswith("features.28")})
    with pytest.raises(KeyError, match="features.28"):
        convert_lpips.convert(str(tmp_path / "bad.npz"),
                              str(d / "lin.npz"), str(tmp_path / "o.npz"))
    np.savez(tmp_path / "narrow.npz", **{
        k: (v[:, :32] if k.startswith("lin0") else v)
        for k, v in arrays.items() if k.startswith("lin")})
    with pytest.raises(ValueError, match="lin0 width 32"):
        convert_lpips.convert(str(d / "vgg.npz"),
                              str(tmp_path / "narrow.npz"),
                              str(tmp_path / "o.npz"))


@pytest.mark.parametrize("tool,argv", [
    (make_meta, ["--source", "x"]),
    (extract_priors, ["masks", "--source", "x", "--backend", "all-fg"]),
    (convert_lpips, ["--vgg", "a.npz", "--lin", "b.npz"])])
def test_tools_default_to_cuda(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)


@pytest.mark.parametrize("n", [3000, 12000])
def test_filter_point_cloud_matches_jax(n):
    """The init cloud's radius-outlier filter of a scene's first load, on
    both sides of knn.EXACT_MAX_N (a DTU scene's sparse cloud is above
    it): the same points kept as by the JAX package's reader."""
    from vcr_gaus_tpu.data.scene import filter_point_cloud as jfilter
    from vcr_gaus_tpu_torch.data.scene import filter_point_cloud
    from vcr_gaus_tpu_torch.ops.knn import EXACT_MAX_N
    rng = np.random.default_rng(n)
    dense = rng.normal(scale=0.3, size=(n - n // 10, 3))
    sparse = rng.uniform(-2.0, 2.0, size=(n // 10, 3))
    xyz = np.concatenate([dense, sparse]) + np.array([0.5, -0.2, 3.0])
    rgb = rng.uniform(size=(n, 3))
    trans, scale = np.array([0.5, -0.2, 3.0]), np.array([1.5, 1.5, 1.5])
    want = jfilter(trans, scale, xyz, rgb)
    got = filter_point_cloud(trans, scale, xyz, rgb)
    assert (n > EXACT_MAX_N) == (n == 12000)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert n // 20 < n - len(got[0]) < n // 2
