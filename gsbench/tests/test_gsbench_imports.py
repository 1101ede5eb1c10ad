"""Nothing the benchmark loads is JAX or the JAX package (by whole
top-level module name), and the reference loads nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from gsbench import harness as H

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "vcr_gaus_tpu"}


def loaded_after(code: str) -> set[str]:
    """Top-level names in ``sys.modules`` of a fresh interpreter after
    ``code``."""
    probe = (code + "\nimport json, sys\n"
             "print(json.dumps(sorted({m.split('.')[0]\n"
             "                         for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=H.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = (
        "import sys\n"
        "sys.path.insert(0, '.')\n"
        "from gsbench import harness as H, control, faults\n"
        "from gsbench.tests.tiny import TINY, SEED\n"
        "bench = H.manifest()\n"
        "for m in bench['per_layer']:\n"
        "    H.load_reader(m['name'])\n"
        "H.run('tnt.step_late', SEED, 0.1, True, 'cpu', overrides=TINY)\n")
    found = loaded_after(code)
    assert "vcr_gaus_tpu_torch" in found
    assert not found & FORBIDDEN, found & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys\nsys.path.insert(0, '.')\n"
            "from gsbench.reference import camera, losses, nets, render\n"
            "from gsbench.reference import step\n"
            "from gsbench import counts, population, scene, trace\n")
    found = loaded_after(code)
    assert not found & (FORBIDDEN | {"vcr_gaus_tpu_torch"}), found


def test_run_py_refuses_the_same_names():
    import ast
    with open(os.path.join(H.ROOT, "gsbench", "run.py")) as f:
        tree = ast.parse(f.read())
    value = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                 and any(getattr(t, "id", "") == "FORBIDDEN"
                         for t in n.targets))
    assert set(ast.literal_eval(value)) == FORBIDDEN
