"""The PyTorch port stands alone: importing it loads neither jax (nor flax
or optax) nor the JAX package, and no source file of the port or
chip_smoke.py imports any of them, nor OpenCV, open3d or trimesh, which the
machine with the card does not have."""

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
                "tools.run_scannetpp", "parallel.dp"):
        assert f"'vcr_gaus_tpu_torch.{mod}'" in names, mod
    assert side == "'' []"
