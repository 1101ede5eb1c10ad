"""Gaussian population state (vcr_gaus_tpu/models/gaussians.py).

The parameters keep the JAX package's fixed capacity and ``active`` mask,
so the two packages' states compare slot by slot. Adam, densify and prune
belong to the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from ..utils import math as M


@dataclass
class GaussianParams:
    """Learnable per-Gaussian parameters (padded to capacity), in the JAX
    package's layouts: f_dc (C,1,3), f_rest (C,K,3) with
    K = (max_sh_degree+1)^2 - 1, obj_dc (C,1,S)."""
    xyz: torch.Tensor            # (C, 3)
    f_dc: torch.Tensor           # (C, 1, 3)
    f_rest: torch.Tensor         # (C, K, 3)
    log_scale: torch.Tensor      # (C, 3)
    quat: torch.Tensor           # (C, 4) unnormalized (w,x,y,z)
    logit_opacity: torch.Tensor  # (C, 1)
    obj_dc: torch.Tensor         # (C, 1, S) semantic features (S=0 disables)

    def as_dict(self) -> dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in fields(self)}


@dataclass
class GaussianState:
    params: GaussianParams
    active: torch.Tensor         # (C,) bool
    active_sh_degree: int

    @property
    def capacity(self) -> int:
        return self.active.shape[0]

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    @property
    def scaling(self) -> torch.Tensor:
        return torch.exp(self.params.log_scale)

    @property
    def opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.params.logit_opacity)

    def shortest_axis_normal(self) -> torch.Tensor:
        """Per-Gaussian normal = rotation column of the smallest-scale axis."""
        return M.shortest_axis_normal(self.scaling, self.params.quat)


def zeros_params(capacity: int, sh_degree: int, ch_sem: int,
                 device: torch.device) -> GaussianParams:
    k = (sh_degree + 1) ** 2 - 1

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return GaussianParams(
        xyz=z(capacity, 3), f_dc=z(capacity, 1, 3), f_rest=z(capacity, k, 3),
        log_scale=z(capacity, 3), quat=z(capacity, 4),
        logit_opacity=z(capacity, 1), obj_dc=z(capacity, 1, ch_sem))
