"""The port's scene converters and entry census (vcr_gaus_tpu_torch/tools/
convert_dtu, convert_tnt, convert_360, convert_colmap, visualize_cameras,
entry_stats) against the JAX package's scripts (scripts/convert_dtu.py,
convert_tnt.py, convert_360.py, convert_colmap.py, visualize_cameras.py,
entry_stats.py), each script run in process through its own ``main`` on
the same generated stand-ins: meta.json equal at rtol 1e-6 with equal
train/test lists, the same printed lines, the COLMAP init model byte for
byte, the trajectory log read alike, the colmap stages' commands equal
(a stand-in ``colmap`` that records them), ``poses.png`` written, and the
census's counts exactly and its radii at 1e-5."""

import importlib.util
import json
import os
import sqlite3
import stat
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from fixtures import write_colmap_scene
from test_preprocess import _random_pose
from vcr_gaus_tpu_torch.tools import (convert_360, convert_colmap,
                                      convert_dtu, convert_tnt, entry_stats,
                                      visualize_cameras)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTU = os.path.join(REPO, "configs", "dtu", "base.yaml")


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
    with monkeypatch.context() as mp:
        mp.setattr(sys, "argv", [f"{name}.py", *argv])
        return script(name).main()


def read_json(path):
    with open(path) as f:
        return json.load(f)


def assert_meta_equal(got, want):
    assert set(got) == set(want)
    for k in ("trans", "scale"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)
    for k in ("train", "test"):
        assert got.get(k) == want.get(k), k


# -- convert_dtu ---------------------------------------------------------


@pytest.fixture
def dtu_root(tmp_path):
    """scan7 with views 0, 8, 20 and 34 and its STL stand-in (800 points of
    an anisotropic rotated cloud); scan9 without GT points."""
    from vcr_gaus_tpu_torch.utils.ply import write_points_ply
    rng = np.random.default_rng(4)
    for scan, views in (("scan7", [0, 8, 20, 34]), ("scan9", [1, 2])):
        d = tmp_path / scan / "images"
        d.mkdir(parents=True)
        for i in views:
            Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(
                d / f"{i:06d}.png")
    (tmp_path / "Points" / "stl").mkdir(parents=True)
    pts = rng.normal(size=(800, 3)) * [3.0, 1.0, 0.3]
    write_points_ply(str(tmp_path / "Points" / "stl" / "stl007_total.ply"),
                     pts @ _random_pose(rng)[:3, :3].T + 5.0)
    return tmp_path


@pytest.mark.parametrize("extra", [[], ["--subsample", "1"],
                                   ["--no_split"]])
def test_convert_dtu_matches_script(dtu_root, monkeypatch, capsys, extra):
    argv = ["--dtu_path", str(dtu_root)] + extra
    run_script(monkeypatch, "convert_dtu", argv)
    want_out = capsys.readouterr().out
    want = read_json(dtu_root / "scan7" / "meta.json")
    os.remove(dtu_root / "scan7" / "meta.json")
    metas = convert_dtu.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == want_out
    assert "[skip] scan9" in want_out
    assert list(metas) == ["scan7"]
    assert metas["scan7"] == read_json(dtu_root / "scan7" / "meta.json")
    assert_meta_equal(metas["scan7"], want)
    assert not (dtu_root / "scan9" / "meta.json").exists()
    if "--no_split" not in extra:
        assert want["test"] == ["000008", "000034"]
        assert want["train"] == ["000000", "000020"]


# -- convert_tnt ---------------------------------------------------------


def write_log(path, poses, invalid=()):
    """A TNT *_COLMAP_SfM.log: per view 'idx valid 0' and its 4x4."""
    lines = []
    for i, pose in enumerate(poses):
        lines.append(f"{i} {-1 if i in invalid else i} 0\n")
        lines += [" ".join(repr(float(v)) for v in row) + "\n" for row in pose]
    path.write_text("".join(lines))


def test_sfm_log_and_qvec_match_script(tmp_path):
    rng = np.random.default_rng(0)
    poses = [_random_pose(rng) for _ in range(6)]
    names = [f"{i:06d}.jpg" for i in range(6)]
    write_log(tmp_path / "S_COLMAP_SfM.log", poses, invalid=(2,))
    want = script("convert_tnt").load_sfm_log(
        str(tmp_path / "S_COLMAP_SfM.log"), names)
    got = convert_tnt.load_sfm_log(str(tmp_path / "S_COLMAP_SfM.log"),
                                   names)
    assert list(got) == list(want) == names[:2] + names[3:]
    for n in got:
        np.testing.assert_array_equal(got[n], want[n])
        # the round trip: the log's camera-to-world back from world-to-camera
        np.testing.assert_allclose(np.linalg.inv(got[n]),
                                   poses[names.index(n)], atol=1e-12)
    from vcr_gaus_tpu_torch.utils.colmap import qvec_to_rotmat
    for pose in poses:
        q = convert_tnt.rotmat_to_qvec(pose[:3, :3])
        np.testing.assert_array_equal(
            q, script("convert_tnt").rotmat_to_qvec(pose[:3, :3]))
        assert q[0] >= 0
        np.testing.assert_allclose(qvec_to_rotmat(q), pose[:3, :3],
                                   atol=1e-12)
    trans = tmp_path / "S_trans.txt"
    trans.write_text("\n".join(" ".join(repr(float(v)) for v in row)
                               for row in poses[0]) + "\n")
    np.testing.assert_array_equal(convert_tnt.load_transformation(
        str(trans)), poses[0])


def test_write_init_model_matches_script_bytes(tmp_path):
    """The sqlite database's ids, the text model byte for byte; a view
    the log lacks is left out."""
    rng = np.random.default_rng(1)
    names = [f"{i:06d}.jpg" for i in range(5)]
    w2c = {n: np.linalg.inv(_random_pose(rng)) for n in names[:4]}
    db = tmp_path / "database.db"
    con = sqlite3.connect(db)
    con.execute("CREATE TABLE images (image_id INTEGER, name TEXT)")
    con.executemany("INSERT INTO images VALUES (?, ?)",
                    [(10 + 3 * i, n) for i, n in enumerate(names)])
    con.commit()
    con.close()
    script("convert_tnt").write_init_model(w2c, str(db), str(tmp_path / "j"))
    convert_tnt.write_init_model(w2c, str(db), str(tmp_path / "p"))
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        got = (tmp_path / "p" / name).read_bytes()
        assert got == (tmp_path / "j" / name).read_bytes(), name
    images = (tmp_path / "p" / "images.txt").read_text().split("\n\n")
    assert [ln.split()[0] for ln in images if ln] == ["10", "13", "16",
                                                      "19"]


@pytest.fixture
def tnt_source(tmp_path):
    """Barn's files: the GT cloud (2,000 points), the alignment, a log."""
    from vcr_gaus_tpu_torch.utils.ply import write_points_ply
    rng = np.random.default_rng(2)
    src = tmp_path / "Barn"
    src.mkdir()
    pts = rng.normal(size=(2000, 3)) * [4.0, 2.0, 0.5]
    write_points_ply(str(src / "Barn.ply"), pts)
    (src / "Barn_trans.txt").write_text("\n".join(
        " ".join(repr(float(v)) for v in row) for row in _random_pose(rng)))
    write_log(src / "Barn_COLMAP_SfM.log",
              [_random_pose(rng) for _ in range(3)])
    return src


def test_convert_tnt_export_json_matches_script(tnt_source, monkeypatch,
                                                capsys):
    argv = ["--source", str(tnt_source), "--scene", "Barn", "--export_json"]
    run_script(monkeypatch, "convert_tnt", argv)
    want_out = capsys.readouterr().out
    want = read_json(tnt_source / "meta.json")
    os.remove(tnt_source / "meta.json")
    got = convert_tnt.main(argv + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    assert got == read_json(tnt_source / "meta.json")
    assert_meta_equal(got, want)
    assert got_out.startswith("wrote meta.json:")
    assert want_out.startswith("wrote meta.json:")
    T = np.asarray(got["trans"])
    assert T.shape == (4, 4)
    np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3),
                               atol=1e-12)


@pytest.mark.parametrize("tool,argv", [
    ("convert_tnt", ["--scene", "Barn", "--run_colmap"]),
    ("convert_colmap", []),
    ("convert_colmap", ["--make_meta"])])
def test_colmap_stays_gated(tnt_source, monkeypatch, tool, argv):
    """Without the binary both stop before any stage, with the script's
    message."""
    argv = ["--source", str(tnt_source), "--colmap_executable",
            str(tnt_source / "no_colmap")] + argv
    with pytest.raises(SystemExit) as want:
        run_script(monkeypatch, tool, argv)
    mod = {"convert_tnt": convert_tnt, "convert_colmap": convert_colmap}
    with pytest.raises(SystemExit) as got:
        mod[tool].main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "colmap binary not found" in str(got.value)
    assert not (tnt_source / "sparse").exists()


FAKE_COLMAP = """#!/bin/sh
echo "$@" >> "{log}"
if [ "$1" = image_undistorter ]; then
  mkdir -p "{src}/sparse"
  cp "{model}"/* "{src}/sparse/"
fi
"""


def test_convert_colmap_stages_and_make_meta_match_script(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """A stand-in ``colmap`` that records each stage's arguments and, as
    image_undistorter, puts a sparse model under sparse/: the same stages
    in the same order, the model moved to sparse/0, and --make_meta's
    meta.json the port's make_meta's (equal to the script's)."""
    model = tmp_path / "model"
    write_colmap_scene(str(tmp_path / "scene_src"), n_cams=5, n_pts=200,
                       width=24, height=16)
    os.rename(tmp_path / "scene_src" / "sparse" / "0", model)
    logs, metas = {}, {}
    for side in ("jax", "port"):
        src = tmp_path / side
        (src / "input").mkdir(parents=True)
        log = tmp_path / f"{side}.log"
        exe = tmp_path / f"colmap_{side}"
        exe.write_text(FAKE_COLMAP.format(log=log, src=src, model=model))
        exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
        argv = ["--source", str(src), "--colmap_executable", str(exe),
                "--make_meta"]
        if side == "jax":
            monkeypatch.setenv("PYTHONPATH", REPO)
            run_script(monkeypatch, "convert_colmap", argv)
        else:
            convert_colmap.main(argv + ["--device", "cpu"])
        assert capsys.readouterr().out.rstrip().endswith("done")
        logs[side] = log.read_text().replace(str(src), "SRC").replace(
            str(exe), "EXE")
        assert sorted(os.listdir(src / "sparse")) == ["0"]
        assert sorted(os.listdir(src / "sparse" / "0")) == sorted(
            os.listdir(model))
        metas[side] = read_json(src / "meta.json")
    assert logs["port"] == logs["jax"]
    assert [ln.split()[0] for ln in logs["port"].splitlines()] == [
        "feature_extractor", "exhaustive_matcher", "mapper",
        "image_undistorter"]
    assert_meta_equal(metas["port"], metas["jax"])


# -- convert_360 ---------------------------------------------------------


def test_convert_360_matches_script(tmp_path, monkeypatch, capsys):
    """Two scenes, one with its model under sparse/0 and one under
    sparse/, and a directory without a model (skipped with the script's
    line)."""
    write_colmap_scene(str(tmp_path / "garden"), n_cams=6, n_pts=100,
                       width=24, height=16)
    write_colmap_scene(str(tmp_path / "room"), n_cams=4, n_pts=100,
                       width=24, height=16)
    for f in os.listdir(tmp_path / "room" / "sparse" / "0"):
        os.rename(tmp_path / "room" / "sparse" / "0" / f,
                  tmp_path / "room" / "sparse" / f)
    os.rmdir(tmp_path / "room" / "sparse" / "0")
    (tmp_path / "empty").mkdir()
    argv = ["--data_path", str(tmp_path)]
    run_script(monkeypatch, "convert_360", argv)
    want_out = capsys.readouterr().out
    want = {s: read_json(tmp_path / s / "meta.json")
            for s in ("garden", "room")}
    metas = convert_360.main(argv)
    assert capsys.readouterr().out == want_out
    assert "skip empty: no COLMAP model" in want_out
    assert sorted(metas) == ["garden", "room"]
    for s in metas:
        assert metas[s] == read_json(tmp_path / s / "meta.json")
        assert_meta_equal(metas[s], want[s])


# -- visualize_cameras -----------------------------------------------------


@pytest.fixture
def pose_scene(tmp_path):
    root = tmp_path / "scene"
    write_colmap_scene(str(root), n_cams=4, n_pts=100, width=32, height=24)
    with open(root / "meta.json", "w") as f:
        json.dump({"trans": np.eye(4).tolist(), "scale": [1.0, 2.0, 1.5]},
                  f)
    return root


def test_visualize_cameras_matches_script(pose_scene, monkeypatch, capsys):
    pytest.importorskip("matplotlib")
    run_script(monkeypatch, "visualize_cameras",
               ["--source", str(pose_scene), "--out",
                str(pose_scene / "poses_jax.png")])
    out = visualize_cameras.main(["--source", str(pose_scene)])
    assert out == str(pose_scene / "poses.png")
    assert capsys.readouterr().out.splitlines()[-1] == f"wrote {out}"
    got = np.asarray(Image.open(out))
    want = np.asarray(Image.open(pose_scene / "poses_jax.png"))
    assert got.shape == want.shape and got.shape[0] > 500
    assert (got != want).any(axis=-1).mean() < 1e-3
    # the box's red edges are drawn
    assert ((got[..., 0] > 200) & (got[..., 1] < 80)).sum() > 100


def test_visualize_cameras_without_matplotlib(pose_scene, monkeypatch):
    """Where matplotlib is not installed (the card's machine): a non-zero
    exit that says so, and no file."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit) as e:
        visualize_cameras.main(["--source", str(pose_scene)])
    assert "matplotlib" in str(e.value) and e.value.code != 0
    assert not (pose_scene / "poses.png").exists()


def test_box_and_frustum_lines_match_script():
    rng = np.random.default_rng(5)
    mod = script("visualize_cameras")
    pose = _random_pose(rng)
    for trans, scale in ((pose, [1.0, 2.0, 0.5]), (np.ones(3), [2.0] * 3)):
        got = visualize_cameras.box_lines(np.asarray(trans),
                                          np.asarray(scale))
        want = mod.box_lines(np.asarray(trans), np.asarray(scale))
        assert len(got) == len(want) == 12
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-12)
    np.testing.assert_array_equal(np.asarray(visualize_cameras.frustum_lines(
        pose)), np.asarray(mod.frustum_lines(pose)))


# -- entry_stats ---------------------------------------------------------


@pytest.fixture
def jax_tile_16():
    """The JAX script sets the rasterizer's tile; put it back after."""
    from vcr_gaus_tpu.ops import rasterize_tpu as K
    prev = K.TILE
    yield
    K.set_tile(prev)


def test_entry_census_matches_script_per_camera(jax_tile_16):
    """One population (the script's synthetic generator, 4,000 points at
    160x120) through both: per camera the entry count and every tile's
    count exactly, the radii at 1e-5; then the whole census."""
    import jax
    from vcr_gaus_tpu.render.renderer import (RenderConfig,
                                              compute_camera_binning)
    from vcr_gaus_tpu_torch.models.convert import state_from_arrays
    from test_torch_train import jax_state_arrays
    mod = script("entry_stats")
    js, jcams = mod.synthetic_population(4000, 4096, 4.0, 160, 120)
    want = mod.population_stats(js, jcams, 160, 120, 16, 1 << 20)
    state = state_from_arrays(jax_state_arrays(js), "cpu")
    cams = entry_stats.synthetic_cameras(160, 120, "cpu")
    rcfg = RenderConfig(width=160, height=120, entry_budget=1 << 20,
                        mask_depth_thr=1e9)
    for cam, jcam in zip(cams, jcams):
        aux = compute_camera_binning(js, jcam, rcfg)
        ne, tc, rad, vis = entry_stats.camera_census(state, cam, 160, 120)
        assert ne == int(aux.binn.num_entries) > 0
        np.testing.assert_array_equal(tc, np.asarray(aux.binn.tile_counts))
        assert tc.sum() == ne
        assert vis == int((rad > 0).sum()) > 3000
    got = entry_stats.population_stats(state, cams, 160, 120)
    for k, v in want.items():
        if k == "screen_radius_px":
            for q in v:
                assert got[k][q] == pytest.approx(v[q], rel=1e-5)
        else:
            assert got[k] == v, k
    assert jax.tree.structure(got) == jax.tree.structure(want)


def test_entry_stats_synthetic_cli_matches_script(jax_tile_16, monkeypatch,
                                                  capsys):
    argv = ["--synthetic", "--n", "3000", "--cap", "4096", "--w", "96",
            "--h", "80", "--tile", "16"]
    run_script(monkeypatch, "entry_stats", argv)
    want = json.loads(capsys.readouterr().out)
    got = entry_stats.main(argv + ["--device", "cpu", "--budget", "4096"])
    assert json.loads(capsys.readouterr().out) == got
    assert set(got) == set(want) | {"entry_budget", "device"}
    for k in ("entries_peak", "entries_mean", "tile_occupancy",
              "entries_per_pixel_mean", "visible_per_cam_mean", "active",
              "population", "tile", "dup_factor"):
        assert got[k] == want[k], k
    assert got["screen_radius_px"] == pytest.approx(want["screen_radius_px"],
                                                    rel=1e-5)
    assert got["entry_budget"].startswith("not applicable")
    assert "--budget 4096" in got["entry_budget"]


def test_entry_stats_trained_run_matches_script(jax_tile_16, tmp_path,
                                                monkeypatch, capsys):
    """--cfg_path on a run directory (config.yaml, its scene, the PLY of
    iteration 7 written by the port), the script at the port's tile (the
    DTU recipe's tpu.tile is the TPU's 32)."""
    from vcr_gaus_tpu_torch.config import Config
    from vcr_gaus_tpu_torch.models import gaussians as GM
    from vcr_gaus_tpu_torch.models.ply_io import save_gaussian_ply
    scene = tmp_path / "scene"
    write_colmap_scene(str(scene), n_cams=5, n_pts=600, width=64, height=48)
    run = tmp_path / "run"
    cfg = Config(DTU, overrides=[f"--model.source_path={scene}",
                                 f"--logdir={run}"])
    cfg.save(str(run / "config.yaml"))
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, (800, 3)).astype(np.float32)
    state = GM.create_from_pcd(pts, rng.uniform(size=(800, 3)), 1024,
                               sh_degree=3, device="cpu")
    ply = run / "point_cloud" / "iteration_7" / "point_cloud.ply"
    ply.parent.mkdir(parents=True)
    save_gaussian_ply(state, str(ply))
    (run / "point_cloud" / "iteration_3").mkdir()
    argv = ["--cfg_path", str(run / "config.yaml"), "--tile", "16"]
    run_script(monkeypatch, "entry_stats", argv)
    want = json.loads(capsys.readouterr().out)
    got = entry_stats.main(argv + ["--device", "cpu"])
    assert want["population"].endswith("iter 7 64x48")
    assert got["population"] == want["population"]
    assert got["tile"] == want["tile"] == 16
    for k in ("entries_peak", "entries_mean", "tile_occupancy", "n_cams",
              "active", "tile_grid", "visible_per_cam_mean"):
        assert got[k] == want[k], k
    assert got["n_cams"] == 5 and got["entries_peak"] > 0


def test_entry_stats_refuses_other_tiles():
    with pytest.raises(SystemExit, match="--tile 32: the port bins at its "
                                         "one tile size, 16 pixels"):
        entry_stats.main(["--synthetic", "--n", "100", "--tile", "32",
                          "--device", "cpu"])
    with pytest.raises(SystemExit, match="--cfg_path or --synthetic"):
        entry_stats.main(["--device", "cpu"])
