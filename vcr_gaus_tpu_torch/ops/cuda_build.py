"""Build and load the port's hand-written CUDA kernels.

Each source under ``vcr_gaus_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, one ``nvcc`` per source, all
started together, into ``build/torch_kernels/`` of the checkout, keyed by a
hash of the source, the headers under ``csrc/`` and the flags, so an
unchanged source is never rebuilt.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"

# kernel library name -> source file under csrc/
SOURCES = {"rasterize_fwd": "rasterize_fwd.cu",
           "rasterize_bwd": "rasterize_bwd.cu",
           "rasterize_stats": "rasterize_stats.cu",
           "kernel_microprobe": "kernel_microprobe.cu",
           "preprocess": "preprocess.cu",
           "adam": "adam.cu",
           "ssim": "ssim.cu",
           "binning": "binning.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=None) -> dict[str, str]:
    """Build every missing library in parallel; returns name -> the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills),
    empty for a library that was already built. Raises on a failed build."""
    names = list(SOURCES) if names is None else list(names)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {n: "" for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {n: "" for n in names}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


# kernel name -> launches since the last reset
# (``rasterize.reset_launch_counts``); a wrapper adds one where it launches
# its kernel and nowhere else
LAUNCHES: Counter = Counter()

_LOAD_LOCK = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed; one build at a
    time when several threads (``parallel.dp.scene_dispatch``) ask."""
    with _LOAD_LOCK:
        return _load(name)


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))
