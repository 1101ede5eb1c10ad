"""Carrying states across: the JAX ``GaussianState``'s arrays, as numpy,
to the port's state and back.

``state_from_numpy`` / ``state_to_numpy`` carry the parameters and the
active mask (a loaded model); ``state_from_arrays`` / ``state_to_arrays``
carry the whole training state: parameters, Adam moments and step, and the
densification statistics, in the JAX state's field names."""

from __future__ import annotations

import math
from dataclasses import fields

import numpy as np
import torch

from ..utils.device import resolve_device
from .gaussians import AdamState, GaussianParams, GaussianState, new_state

STATS = ("max_radii2d", "grad_accum", "denom")


def _params(arrays: dict[str, np.ndarray], dev: torch.device) -> GaussianParams:
    names = [f.name for f in fields(GaussianParams)]
    missing = set(names) - set(arrays)
    if missing:
        raise KeyError(f"missing parameter arrays: {sorted(missing)}")
    return GaussianParams(**{
        k: torch.tensor(np.asarray(arrays[k], np.float32), device=dev)
        for k in names})


def state_from_numpy(params: dict[str, np.ndarray], active: np.ndarray,
                     device: str | torch.device = "cuda",
                     active_sh_degree: int | None = None) -> GaussianState:
    """``params`` holds the seven fields of the JAX ``GaussianParams``
    (xyz, f_dc, f_rest, log_scale, quat, logit_opacity, obj_dc) in its
    layouts; ``active`` is the (C,) bool mask. The active SH degree defaults
    to the highest the f_rest width holds; moments and statistics are 0."""
    dev = resolve_device(device)
    p = _params(params, dev)
    if active_sh_degree is None:
        active_sh_degree = math.isqrt(p.f_rest.shape[1] + 1) - 1
    return new_state(p, torch.tensor(np.asarray(active, bool), device=dev),
                     active_sh_degree)


def state_to_numpy(state: GaussianState) -> tuple[dict[str, np.ndarray],
                                                  np.ndarray]:
    """(params as numpy in the JAX layouts, active mask)."""
    params = {k: v.detach().cpu().numpy()
              for k, v in state.params.as_dict().items()}
    return params, state.active.cpu().numpy()


def state_from_arrays(arrays: dict, device: str | torch.device = "cuda"
                      ) -> GaussianState:
    """The whole state from the JAX state's fields as numpy: ``params``,
    ``mu`` and ``nu`` (dicts of the seven parameter arrays), ``step``,
    ``active``, ``max_radii2d``, ``grad_accum``, ``denom`` and
    ``active_sh_degree``."""
    dev = resolve_device(device)

    def vec(name):
        return torch.tensor(np.asarray(arrays[name], np.float32), device=dev)

    return GaussianState(
        params=_params(arrays["params"], dev),
        adam=AdamState(_params(arrays["mu"], dev), _params(arrays["nu"], dev),
                       int(arrays["step"])),
        active=torch.tensor(np.asarray(arrays["active"], bool), device=dev),
        **{k: vec(k) for k in STATS},
        active_sh_degree=int(arrays["active_sh_degree"]))


def state_to_arrays(state: GaussianState) -> dict:
    """The inverse of ``state_from_arrays``."""
    def host(p: GaussianParams):
        return {k: v.detach().cpu().numpy() for k, v in p.as_dict().items()}

    out = {"params": host(state.params), "mu": host(state.adam.mu),
           "nu": host(state.adam.nu), "step": state.adam.step,
           "active": state.active.cpu().numpy(),
           "active_sh_degree": state.active_sh_degree}
    out.update({k: getattr(state, k).cpu().numpy() for k in STATS})
    return out
