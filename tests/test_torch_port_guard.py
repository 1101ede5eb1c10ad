"""The PyTorch port stands alone: importing it loads neither jax (nor flax
or optax) nor the JAX package, no source file of the port or
chip_smoke.py imports any of them, nor OpenCV, open3d or trimesh, which the
machine with the card does not have, and the data-preparation tools run as
``python -m`` entry points where none of them can be imported."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "vcr_gaus_tpu_torch")


def test_import_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import vcr_gaus_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'flax', 'optax', 'vcr_gaus_tpu', 'cv2', 'open3d',"
        " 'trimesh'))\n"
        "print(len(list(pkgutil.walk_packages(P.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|vcr_gaus_tpu|cv2|"
                     r"open3d|trimesh)(\.|\s|,|$)", re.M)
    offenders = []
    n_files = 0
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                n_files += 1
                with open(os.path.join(root, name)) as f:
                    if pat.search(f.read()):
                        offenders.append(os.path.relpath(
                            os.path.join(root, name), REPO))
    assert n_files > 10
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        if pat.search(f.read()):
            offenders.append("chip_smoke.py")
    assert offenders == []


def test_walk_imports_the_runners_without_side_effects(tmp_path):
    """The walk above reaches the runners, crop_mesh and render_paths, and
    importing every module of the port prints nothing, writes nothing and
    reads no command line (here a bogus one, from an empty directory)."""
    code = (
        "import contextlib, importlib, io, os, pkgutil, sys\n"
        "import vcr_gaus_tpu_torch as P\n"
        "sys.argv = ['x', '--bogus']\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    P.__path__, P.__name__ + '.')]\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out), "
        "contextlib.redirect_stderr(out):\n"
        "    for n in names:\n"
        "        importlib.import_module(n)\n"
        "print(sorted(names))\n"
        "print(repr(out.getvalue()), os.listdir('.'))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    names, side = res.stdout.splitlines()
    for mod in ("tools.run_tnt", "tools.run_dtu", "tools.run_mipnerf360",
                "tools.full_eval", "tools.crop_mesh", "tools.stages",
                "utils.render_paths", "evaluation.tnt_official",
                "tools.run_scannetpp", "parallel.dp",
                "render.network_gui", "render.orbit", "tools.make_meta",
                "tools.extract_priors", "tools.convert_lpips",
                "tools.convert_dtu", "tools.convert_tnt",
                "tools.convert_360", "tools.convert_colmap",
                "tools.visualize_cameras", "tools.entry_stats"):
        assert f"'vcr_gaus_tpu_torch.{mod}'" in names, mod
    assert side == "'' []"


BLOCKER = (
    "import importlib.abc, sys\n"
    "class Block(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
    "                                  'vcr_gaus_tpu', 'cv2', 'open3d',\n"
    "                                  'trimesh'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, Block())\n")


def test_prep_tools_run_without_jax(tmp_path):
    """make_meta (all three modes), extract_priors (normals from depth,
    all-foreground masks) and convert_lpips (with its self-test) through
    ``runpy`` as ``python -m`` runs them, in a process where importing jax
    or the JAX package raises."""
    import numpy as np
    from PIL import Image

    from fixtures import write_colmap_scene
    scene = tmp_path / "scene"
    write_colmap_scene(str(scene), n_cams=3, n_pts=80, width=24, height=16)
    (scene / "depths").mkdir()
    for i in range(3):
        np.savez(scene / "depths" / f"img_{i:03d}.npz",
                 np.full((16, 24), 2.0, np.float32))
    runs = [("make_meta", ["--source", str(scene), "--mode", m,
                           "--split_ratio", "0.5"])
            for m in ("points", "pose", "obb")]
    runs += [("extract_priors", ["normals", "--source", str(scene),
                                 "--backend", "depth"]),
             ("extract_priors", ["masks", "--source", str(scene),
                                 "--backend", "all-fg"]),
             ("convert_lpips", ["--vgg", str(tmp_path / "w.npz"), "--lin",
                                str(tmp_path / "w.npz"), "--out",
                                str(tmp_path / "c.npz"), "--selftest"])]
    code = BLOCKER + (
        "import runpy\n"
        "from vcr_gaus_tpu_torch.evaluation.lpips import "
        "write_placeholder_weights\n"
        f"write_placeholder_weights({str(tmp_path / 'w.npz')!r})\n"
        f"for tool, argv in {runs!r}:\n"
        "    sys.argv = [tool] + argv + ['--device', 'cpu']\n"
        "    runpy.run_module('vcr_gaus_tpu_torch.tools.' + tool,\n"
        "                     run_name='__main__', alter_sys=True)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'vcr_gaus_tpu'))\n"
        "print('loaded', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "loaded []" in res.stdout
    assert "selftest: d(x,x)=0.000000" in res.stdout
    assert os.path.exists(scene / "meta.json")
    assert len(os.listdir(scene / "normals")) == 3
    with np.load(scene / "normals" / "img_000.npz") as z:
        assert z["arr_0"].dtype == np.float16
    assert np.asarray(Image.open(scene / "masks" / "img_000.png")).min() == 1


def test_converters_run_without_jax(tmp_path):
    """convert_dtu, convert_tnt (--export_json, and --run_colmap stopping
    at the missing binary), convert_360, convert_colmap (stopping at the
    missing binary), visualize_cameras (where matplotlib is installed) and
    entry_stats (--synthetic and --cfg_path) through ``runpy`` as ``python
    -m`` runs them, in a process where importing jax or the JAX package
    raises."""
    import importlib.util

    import numpy as np

    from fixtures import write_colmap_scene
    from vcr_gaus_tpu_torch.config import Config
    from vcr_gaus_tpu_torch.models import gaussians as GM
    from vcr_gaus_tpu_torch.models.ply_io import save_gaussian_ply
    from vcr_gaus_tpu_torch.utils.ply import write_points_ply
    rng = np.random.default_rng(0)
    dtu = tmp_path / "dtu"
    (dtu / "scan1" / "images").mkdir(parents=True)
    (dtu / "Points" / "stl").mkdir(parents=True)
    write_points_ply(str(dtu / "Points" / "stl" / "stl001_total.ply"),
                     rng.normal(size=(300, 3)))
    from PIL import Image
    for i in (0, 8):
        Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(
            dtu / "scan1" / "images" / f"{i:06d}.png")
    tnt = tmp_path / "Barn"
    tnt.mkdir()
    write_points_ply(str(tnt / "Barn.ply"), rng.normal(size=(500, 3)))
    (tnt / "Barn_trans.txt").write_text("\n".join(
        " ".join(str(float(v)) for v in row) for row in np.eye(4)))
    scenes = tmp_path / "m360"
    write_colmap_scene(str(scenes / "garden"), n_cams=3, n_pts=80,
                       width=24, height=16)
    scene = scenes / "garden"
    run = tmp_path / "run"
    cfg = Config(os.path.join(REPO, "configs", "dtu", "base.yaml"),
                 overrides=[f"--model.source_path={scene}"])
    cfg.save(str(run / "config.yaml"))
    state = GM.create_from_pcd(rng.uniform(-1, 1, (200, 3)),
                               rng.uniform(size=(200, 3)), 256, 3,
                               device="cpu")
    ply = run / "point_cloud" / "iteration_2" / "point_cloud.ply"
    ply.parent.mkdir(parents=True)
    save_gaussian_ply(state, str(ply))
    no_colmap = str(tmp_path / "no_colmap")
    runs = [("convert_dtu", ["--dtu_path", str(dtu), "--device", "cpu"]),
            ("convert_tnt", ["--source", str(tnt), "--scene", "Barn",
                             "--export_json", "--device", "cpu"]),
            ("convert_tnt", ["--source", str(tnt), "--scene", "Barn",
                             "--run_colmap", "--colmap_executable",
                             no_colmap]),
            ("convert_360", ["--data_path", str(scenes)]),
            ("convert_colmap", ["--source", str(scene),
                                "--colmap_executable", no_colmap]),
            ("entry_stats", ["--synthetic", "--n", "500", "--cap", "512",
                             "--w", "64", "--h", "48", "--device", "cpu"]),
            ("entry_stats", ["--cfg_path", str(run / "config.yaml"),
                             "--device", "cpu"])]
    with_mpl = importlib.util.find_spec("matplotlib") is not None
    if with_mpl:
        runs.append(("visualize_cameras", ["--source", str(scene)]))
    code = BLOCKER + (
        "import runpy\n"
        f"for tool, argv in {runs!r}:\n"
        "    sys.argv = [tool] + argv\n"
        "    try:\n"
        "        runpy.run_module('vcr_gaus_tpu_torch.tools.' + tool,\n"
        "                         run_name='__main__', alter_sys=True)\n"
        "    except SystemExit as e:\n"
        "        print('exit', tool, e)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'vcr_gaus_tpu', 'cv2', 'open3d', 'trimesh'))\n"
        "print('loaded', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "loaded []" in out
    assert out.count("exit") == 2
    assert out.count("colmap binary not found") == 2
    assert "[meta] scan1" in out and "wrote meta.json:" in out
    for path in (dtu / "scan1", tnt, scene):
        assert os.path.exists(path / "meta.json"), path
    assert out.count('"tile": 16') == 2
    assert os.path.exists(scene / "poses.png") == with_mpl
