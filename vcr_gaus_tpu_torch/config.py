"""Layered YAML configuration (the port's own copy of vcr_gaus_tpu/config.py).

Keeps the reference's config surface (VCR-GauS configs/config.py):
  * attribute-style access on nested dicts,
  * recursive ``_parent_`` inheritance chains,
  * strict dotted CLI overrides ``--a.b.c=v``, booleans via ``--flag`` and
    ``--flag!``,
  * save/reload round-trip so downstream stages (mesh extraction, eval) can
    re-open ``logdir/config.yaml``.

It reads the same ``configs/*.yaml`` recipes as the JAX package. Of their
``tpu:`` block the port's trainer acts on ``camera_batch`` (views averaged a
step, split over the ranks of a process group), ``capacity``,
``eval_max_cams`` and ``visi_resolution``; the other keys size the JAX
package's static shapes and programs on the TPU and have no counterpart.
"""

from __future__ import annotations

import copy
import os
from typing import Any

import yaml


class AttrDict(dict):
    """A dict whose items are also attributes, recursively."""

    def __init__(self, mapping: dict | None = None):
        super().__init__()
        if mapping:
            for key, value in mapping.items():
                self[key] = _wrap(value)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:  # pragma: no cover - attribute protocol
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __setitem__(self, name: str, value: Any) -> None:
        super().__setitem__(name, _wrap(value))

    def __deepcopy__(self, memo):
        out = AttrDict()
        for key, value in self.items():
            dict.__setitem__(out, key, copy.deepcopy(value, memo))
        return out

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, AttrDict) else v) for k, v in self.items()
        }


def _wrap(value: Any) -> Any:
    if isinstance(value, AttrDict):
        return value
    if isinstance(value, dict):
        return AttrDict(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_wrap(v) for v in value)
    return value


def _deep_update(base: dict, new: dict) -> dict:
    """Merge ``new`` into ``base`` recursively (new wins)."""
    for key, value in new.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            _deep_update(base[key], value)
        else:
            base[key] = value
    return base


def _deep_update_strict(base: dict, new: dict, path: str = "") -> dict:
    """Merge ``new`` into ``base``; error on keys absent from ``base``."""
    for key, value in new.items():
        here = f"{path}.{key}" if path else key
        if key not in base:
            raise KeyError(f"CLI/override key not found in config: {here}")
        if isinstance(value, dict) and isinstance(base[key], dict):
            _deep_update_strict(base[key], value, here)
        else:
            base[key] = value
    return base


def load_yaml_with_parents(path: str) -> dict:
    """Load a YAML file, recursively resolving its ``_parent_`` chain.

    Child values override parent values (reference semantics:
    configs/config.py:107-134)."""
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    parent = data.pop("_parent_", None)
    if parent is None:
        return data
    if not os.path.isabs(parent):
        # parents are repo-root-relative in the reference recipes; resolve
        # against cwd first, then against the child file's directory.
        cand = parent if os.path.exists(parent) else os.path.join(
            os.path.dirname(os.path.abspath(path)), parent
        )
        # also try walking up from the child's directory (configs/x/base.yaml
        # referencing configs/base.yaml from an arbitrary cwd)
        if not os.path.exists(cand):
            up = os.path.dirname(os.path.abspath(path))
            while up != os.path.dirname(up):
                probe = os.path.join(up, parent)
                if os.path.exists(probe):
                    cand = probe
                    break
                up = os.path.dirname(up)
        parent = cand
    base = load_yaml_with_parents(parent)
    return _deep_update(base, data)


def _parse_value(text: str) -> Any:
    return yaml.safe_load(text)


def parse_cmdline_overrides(argv: list[str]) -> dict:
    """Parse ``--a.b.c=v`` / ``--flag`` / ``--flag!`` into a nested dict."""
    out: dict = {}
    for arg in argv:
        if not arg.startswith("--"):
            raise ValueError(f"override must start with '--': {arg}")
        body = arg[2:]
        if "=" in body:
            key, raw = body.split("=", 1)
            value = _parse_value(raw)
        elif body.endswith("!"):
            key, value = body[:-1], False
        else:
            key, value = body, True
        node = out
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


class Config(AttrDict):
    """Top-level config = YAML chain + optional strict CLI overrides."""

    def __init__(self, path: str | None = None, data: dict | None = None,
                 overrides: list[str] | None = None):
        merged = load_yaml_with_parents(path) if path else {}
        if data:
            _deep_update(merged, data)
        if overrides:
            _deep_update_strict(merged, parse_cmdline_overrides(overrides))
        super().__init__(merged)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def print_config(self) -> None:
        print(yaml.safe_dump(self.to_dict(), sort_keys=False))


def default_config() -> Config:
    """The baked-in defaults mirroring configs/config_base.yaml."""
    here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "config_base.yaml")
    return Config(here)
