"""Carrying weights across: the JAX ``GaussianState``'s arrays, as numpy,
to the port's state and back."""

from __future__ import annotations

import math
from dataclasses import fields

import numpy as np
import torch

from ..utils.device import resolve_device
from .gaussians import GaussianParams, GaussianState


def state_from_numpy(params: dict[str, np.ndarray], active: np.ndarray,
                     device: str | torch.device = "cuda",
                     active_sh_degree: int | None = None) -> GaussianState:
    """``params`` holds the seven fields of the JAX ``GaussianParams``
    (xyz, f_dc, f_rest, log_scale, quat, logit_opacity, obj_dc) in its
    layouts; ``active`` is the (C,) bool mask. The active SH degree defaults
    to the highest the f_rest width holds."""
    dev = resolve_device(device)
    names = [f.name for f in fields(GaussianParams)]
    missing = set(names) - set(params)
    if missing:
        raise KeyError(f"missing parameter arrays: {sorted(missing)}")
    tensors = {k: torch.tensor(np.asarray(params[k], np.float32), device=dev)
               for k in names}
    if active_sh_degree is None:
        active_sh_degree = math.isqrt(tensors["f_rest"].shape[1] + 1) - 1
    return GaussianState(
        params=GaussianParams(**tensors),
        active=torch.tensor(np.asarray(active, bool), device=dev),
        active_sh_degree=int(active_sh_degree))


def state_to_numpy(state: GaussianState) -> tuple[dict[str, np.ndarray],
                                                  np.ndarray]:
    """(params as numpy in the JAX layouts, active mask)."""
    params = {k: v.detach().cpu().numpy()
              for k, v in state.params.as_dict().items()}
    return params, state.active.cpu().numpy()
