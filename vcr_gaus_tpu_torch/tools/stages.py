"""What the benchmark runners share: a stage is one of the port's CLIs,
spawned as ``python -m vcr_gaus_tpu_torch.<module>`` from the repository's
root (where the recipes' relative ``configs/`` paths resolve)."""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cli(module: str, argv: list[str]) -> list[str]:
    """The command line of one stage: ``module`` is ``train``,
    ``depth2mesh``, ``eval_geometry`` or ``render_eval``."""
    return [sys.executable, "-m", f"vcr_gaus_tpu_torch.{module}", *argv]


def run(cmd: list[str], dry: bool, label: str = "",
        env: dict | None = None) -> int:
    """Print the command (after ``label``, such as ``[scene] ``) and,
    unless ``dry``, run it in ``env`` (default: this process's); its exit
    code (0 when dry)."""
    print(f"{label}+", " ".join(cmd), flush=True)
    if dry:
        return 0
    return subprocess.run(cmd, cwd=REPO, env=env).returncode


def check(cmd: list[str], dry: bool) -> None:
    """``run``, raising CalledProcessError when the stage fails."""
    rc = run(cmd, dry)
    if rc:
        raise subprocess.CalledProcessError(rc, cmd)
