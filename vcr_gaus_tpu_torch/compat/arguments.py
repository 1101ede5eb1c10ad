"""Legacy 3DGS-style argparse parameter groups and the ``cfg_args`` dump,
the port's copy of vcr_gaus_tpu/compat/arguments.py.

The port's configuration surface is the layered YAML and the dotted CLI
(``config.py``); these groups keep scripts written against the upstream
``-s/-m/--eval`` conventions working. Each group is a dataclass:
``register`` derives argparse flags from its fields, ``extract`` pulls the
matching namespace entries back out, and ``ModelParams.to_overrides`` maps
legacy flag names onto the dotted config keys. ``write_cfg_args`` writes a
run's settings where upstream-style tools look for them, and
``get_combined_args`` reads them back under the command line.
"""

from __future__ import annotations

import ast
import os
from argparse import ArgumentParser, Namespace
from dataclasses import dataclass, fields


class GroupParams:
    """Bag of extracted values."""


@dataclass
class ParamGroup:
    #: fields whose legacy flag also has a one-letter shorthand (the first
    #: letter of the field's name)
    _shorthand: tuple = ()

    def register(self, parser: ArgumentParser, name: str,
                 fill_none: bool = False) -> None:
        group = parser.add_argument_group(name)
        for f in fields(self):
            if f.name == "_shorthand":
                continue
            value = None if fill_none else getattr(self, f.name)
            names = ["--" + f.name]
            if f.name in self._shorthand:
                names.append("-" + f.name[0])
            if f.type is bool or isinstance(getattr(self, f.name), bool):
                group.add_argument(*names, default=value,
                                   action="store_true")
            else:
                group.add_argument(*names, default=value,
                                   type=type(getattr(self, f.name)))

    def extract(self, args: Namespace) -> GroupParams:
        out = GroupParams()
        known = {f.name for f in fields(self)} - {"_shorthand"}
        for key, value in vars(args).items():
            if key in known:
                setattr(out, key, value)
        return out


@dataclass
class ModelParams(ParamGroup):
    """The loading parameters. ``data_device`` defaults to ``"cuda"``,
    where the JAX package's default is ``"tpu"``; it is the only default
    of these groups that differs."""
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = False
    _shorthand: tuple = ("source_path", "model_path", "images",
                         "resolution", "white_background")

    def extract(self, args: Namespace) -> GroupParams:
        g = super().extract(args)
        if getattr(g, "source_path", ""):
            g.source_path = os.path.abspath(g.source_path)
        return g

    # legacy flag -> dotted config key
    _CONFIG_KEYS = {
        "sh_degree": "model.sh_degree",
        "source_path": "model.source_path",
        "model_path": "logdir",
        "images": "model.images",
        "resolution": "model.resolution",
        "white_background": "model.white_background",
        "eval": "model.eval",
    }

    def to_overrides(self, g: GroupParams) -> dict:
        """The extracted legacy flags as dotted override keys."""
        out = {}
        for legacy, dotted in self._CONFIG_KEYS.items():
            if hasattr(g, legacy):
                out[dotted] = getattr(g, legacy)
        return out


@dataclass
class PipelineParams(ParamGroup):
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclass
class OptimizationParams(ParamGroup):
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False


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


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """The run's saved ``<model_path>/cfg_args`` under the command line:
    every argument the command line gives (not None) wins. The file is
    parsed with ``ast`` (never evaluated); one that does not parse is
    ignored."""
    args_cmdline = parser.parse_args(argv)
    merged = {}
    path = os.path.join(getattr(args_cmdline, "model_path", "") or "",
                        "cfg_args")
    if os.path.isfile(path):
        with open(path) as f:
            inner = f.read().strip()
        if inner.startswith("Namespace(") and inner.endswith(")"):
            try:
                node = ast.parse(inner, mode="eval").body
                merged = {kw.arg: ast.literal_eval(kw.value)
                          for kw in node.keywords}
            except (ValueError, SyntaxError):
                merged = {}
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)
