"""The port's benchmark runners (vcr_gaus_tpu_torch/tools/run_{tnt,dtu,
mipnerf360}.py, full_eval.py) against the JAX package's scripts: the same
stage commands with the root scripts swapped for the port's CLIs and
``--device`` forwarded; and one toy Tanks and Temples run on the CPU
through train, the voxel ladder and the F1."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from fixtures import make_cube_points, write_colmap_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CLI = {"train.py": "train", "depth2mesh.py": "depth2mesh",
            "scripts/eval_geometry.py": "eval_geometry",
            "render_eval.py": "render_eval"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def commands(text):
    """The stage commands a runner printed: lines ``+ cmd``, or
    ``[scene] + cmd`` (run_scannetpp), the scene kept as the first word."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("+ "):
            out.append(ln[2:].split())
        elif ln.startswith("[") and "] + " in ln:
            tag, cmd = ln.split(" + ", 1)
            out.append([tag, *cmd.split()])
    return out


def as_port(cmd, device):
    """A JAX runner's stage command as the port's runner spawns it."""
    tag = [cmd.pop(0)] if cmd[0].startswith("[") else []
    py, script, *rest = cmd
    return [*tag, py, "-m", f"vcr_gaus_tpu_torch.{PORT_CLI[script]}", *rest,
            f"--device={device}"]


RUNNERS = {
    "run_tnt": ["--data_root", "d", "--gt_root", "g", "--scenes", "Barn",
                "Other", "--iterations", "7", "--max_voxels", "1000",
                "--model.eval"],
    "run_dtu": ["--data_root", "d", "--eval_dir", "e", "--scans", "24",
                "37", "--iterations", "7", "--voxel_size", "0.01",
                "--tpu.capacity=1024"],
    "run_mipnerf360": ["--data_root", "d", "--out", "o", "--scenes",
                       "garden", "room", "--iterations", "7"],
    "full_eval": ["--mipnerf360", "m360", "--tanksandtemples", "tnt",
                  "--deepblending", "db", "--output_path", "out"],
    "run_scannetpp": ["--data_root", "d", "--out", "o", "--scenes",
                      "0a5c013435", "8b5caf3398", "--iterations", "7",
                      "--voxel_size", "0.02", "--parallel", "2",
                      "--tpu.capacity=1024"],
}


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("runner", list(RUNNERS))
def test_runner_dry_matches_jax(runner, device, capsys, monkeypatch):
    import importlib
    port = importlib.import_module(f"vcr_gaus_tpu_torch.tools.{runner}")
    args = RUNNERS[runner] + ["--dry"]
    monkeypatch.setattr(sys, "argv", [f"{runner}.py", *args])
    jax_script(runner).main()
    want = commands(capsys.readouterr().out)
    port.main(args + ([] if device is None else ["--device", device]))
    got = commands(capsys.readouterr().out)
    assert got == [as_port(c, device or "cuda") for c in want]
    assert len(got) >= 4


def test_run_tnt_toy_scene_on_cpu(tmp_path, capfd):
    """train -> the voxel ladder (the first rung above --max_voxels exits
    3, the second meshes) -> eval_geometry tnt --icp -> metrics.txt and
    the mean F1; then a scene whose training fails is skipped."""
    from vcr_gaus_tpu_torch.tools import run_tnt
    from vcr_gaus_tpu_torch.utils.ply import write_points_ply

    write_colmap_scene(str(tmp_path / "tnt" / "Toy"), n_cams=4, n_pts=300,
                       width=48, height=32, with_priors=True)
    pts, _ = make_cube_points(2000)
    write_points_ply(str(tmp_path / "gt" / "Toy" / "Toy.ply"), pts)
    base = ["--data_root", str(tmp_path / "tnt"), "--gt_root",
            str(tmp_path / "gt"), "--scenes", "Toy", "--device", "cpu"]
    out = tmp_path / "out"
    results = run_tnt.main(base + [
        "--out", str(out), "--iterations", "6",
        "--voxel_ladder", "0.0001", "0.1", "--max_voxels", "2000000",
        "--tpu.capacity=1024", "--model.depth_type=traditional",
        "--model.use_decoupled_appearance=false",
        "--optim.loss_weight.semantic=0", "--optim.densify_from_iter=1000",
        "--train.test_iterations=[]", "--train.save_iterations=[6]"])
    text = capfd.readouterr()
    assert "--voxel_size=0.0001" in text.out and "--voxel_size=0.1" in \
        text.out
    assert "exceeds --max_voxels=2,000,000" in text.err
    assert (out / "Toy" / "ours.ply").exists()
    assert set(results["Toy"]) == {"Acc", "Comp", "Prec", "Recal",
                                   "F-score"}
    assert 0 <= results["Toy"]["F-score"] <= 1
    assert np.isfinite(results["Toy"]["Acc"])
    assert '"mean_f1"' in text.out
    # a training failure (a key the strict merge rejects) skips the scene
    assert run_tnt.main(base + ["--out", str(tmp_path / "bad"),
                                "--nonexistent.key=1"]) == {}
    assert "TRAIN FAILED: Toy" in capfd.readouterr().out


def test_run_scannetpp_in_process_on_cpu(tmp_path, capfd):
    """Two 48x32 scenes trained for 6 iterations inside this process
    through scene_dispatch over two CPU slots, concurrently, then the mesh
    and eval stages of each as subprocesses, the check_finish gates, and
    the mean PSNR; a scene whose training fails is reported and skipped."""
    import json

    from vcr_gaus_tpu_torch.tools import run_scannetpp

    data = tmp_path / "scannetpp"
    for s in ("sceneA", "sceneB"):
        write_colmap_scene(str(data / s), n_cams=4, n_pts=300, width=48,
                           height=32, with_priors=True)
    out = tmp_path / "out"
    res = run_scannetpp.main([
        "--data_root", str(data), "--out", str(out), "--in_process", "2",
        "--iterations", "6", "--voxel_size", "0.08", "--device", "cpu",
        "--tpu.capacity=1024", "--model.depth_type=traditional",
        "--model.llffhold=3", "--optim.densify_from_iter=1000",
        "--train.test_iterations=[]", "--train.save_iterations=[6]"])
    text = capfd.readouterr().out
    assert "in-process scene-DP over 2 devices: ['cpu', 'cpu']" in text
    assert text.count("trained in-process on device cpu") == 2
    assert res["ok"] == {"sceneA": True, "sceneB": True}
    for s in ("sceneA", "sceneB"):
        assert (out / s / "point_cloud" / "iteration_6").is_dir()
        assert (out / s / "ours.ply").exists()
        assert f"[{s}] + " in text and "vcr_gaus_tpu_torch.train " not in \
            text
    assert set(res["per_scene"]) == {"sceneA", "sceneB"}
    assert np.isfinite(res["mean_psnr"])
    printed = json.loads(text[text.rindex('{\n  "per_scene"'):])
    assert printed["mean_psnr"] == pytest.approx(res["mean_psnr"])
    # a training failure (a key the strict merge rejects) skips the scene
    bad = run_scannetpp.main([
        "--data_root", str(data), "--out", str(tmp_path / "bad"),
        "--scenes", "sceneA", "--in_process", "1", "--device", "cpu",
        "--nonexistent.key=1"])
    assert bad["ok"] == {"sceneA": False}
    assert "TRAIN FAILED in-process" in capfd.readouterr().out
