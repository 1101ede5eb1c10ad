"""The legacy 3DGS ``cfg_args`` dump (vcr_gaus_tpu/compat/arguments.py), so
upstream-style tooling finds a run's settings."""

from __future__ import annotations

import os
from argparse import Namespace


def write_cfg_args(cfg, logdir: str) -> None:
    """Write the config, flattened with ``_`` joins, as the repr of an
    argparse Namespace to ``<logdir>/cfg_args``."""
    flat = {}

    def walk(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "_")
            else:
                flat[prefix + k] = v

    walk(dict(cfg))
    with open(os.path.join(logdir, "cfg_args"), "w") as f:
        f.write(str(Namespace(**flat)))
