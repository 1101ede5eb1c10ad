"""Gaussian population state, its init and the padded Adam step
(vcr_gaus_tpu/models/gaussians.py).

The state keeps the JAX package's fixed capacity and ``active`` mask, its
Adam moments with one shared bias-correction step, and the densification
statistics, so the two packages' states compare slot by slot. Clone, split,
prune and opacity reset belong to a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..utils import math as M
from ..utils import sh as SH


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

    def map(self, fn) -> GaussianParams:
        return GaussianParams(**{k: fn(v) for k, v in self.as_dict().items()})


@dataclass
class AdamState:
    mu: GaussianParams
    nu: GaussianParams
    step: int                    # shared bias-correction step


@dataclass
class GaussianState:
    params: GaussianParams
    adam: AdamState
    active: torch.Tensor         # (C,) bool
    max_radii2d: torch.Tensor    # (C,) f32
    grad_accum: torch.Tensor     # (C,) f32: sum of |d mean2d| norms
    denom: torch.Tensor          # (C,) f32: visible-step count
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

    def replace(self, **kw) -> GaussianState:
        return dataclasses.replace(self, **kw)


def zeros_params(capacity: int, sh_degree: int, ch_sem: int,
                 device: torch.device) -> GaussianParams:
    k = (sh_degree + 1) ** 2 - 1

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return GaussianParams(
        xyz=z(capacity, 3), f_dc=z(capacity, 1, 3), f_rest=z(capacity, k, 3),
        log_scale=z(capacity, 3), quat=z(capacity, 4),
        logit_opacity=z(capacity, 1), obj_dc=z(capacity, 1, ch_sem))


def new_state(params: GaussianParams, active: torch.Tensor,
              active_sh_degree: int) -> GaussianState:
    """A state over ``params`` with zero Adam moments and statistics."""
    def stat():
        return torch.zeros(active.shape[0], dtype=torch.float32,
                           device=active.device)

    return GaussianState(
        params=params, adam=AdamState(params.map(torch.zeros_like),
                                      params.map(torch.zeros_like), 0),
        active=active, max_radii2d=stat(), grad_accum=stat(), denom=stat(),
        active_sh_degree=int(active_sh_degree))


def create_from_pcd(points: np.ndarray, colors: np.ndarray, capacity: int,
                    sh_degree: int, ch_sem: int = 0, seed: int = 0,
                    device: str | torch.device = "cuda") -> GaussianState:
    """Init from a point cloud: SH DC from the colors, isotropic log-scale
    from sqrt(mean squared distance to the 3 nearest neighbours), identity
    quaternions, opacity 0.1, active SH degree 0."""
    from ..ops.knn import mean_sq_dist_to_3nn
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"init pcd ({n}) exceeds capacity ({capacity})")
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    dist2 = torch.clamp_min(mean_sq_dist_to_3nn(pts), 1e-7)
    log_scale = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    p = zeros_params(capacity, sh_degree, ch_sem, dev)
    p.xyz[:n] = pts
    p.f_dc[:n] = SH.rgb_to_sh(torch.as_tensor(
        np.asarray(colors, np.float32), device=dev))[:, None, :]
    p.log_scale[:n] = log_scale
    p.quat[:n, 0] = 1.0
    p.logit_opacity[:n] = M.inverse_sigmoid(
        torch.full((n, 1), 0.1, device=dev))
    if ch_sem:
        rng = np.random.default_rng(seed)
        p.obj_dc[:n, 0] = SH.rgb_to_sh(torch.as_tensor(
            rng.random((n, ch_sem)), dtype=torch.float32, device=dev))
    active = torch.zeros(capacity, dtype=torch.bool, device=dev)
    active[:n] = True
    return new_state(p, active, 0)


# padded Adam: eps as torch.optim.Adam(eps=1e-15) in the reference
B1, B2, EPS = 0.9, 0.999, 1e-15


@dataclass(frozen=True)
class LearningRates:
    """Per-group LRs; xyz follows the exponential schedule per step."""
    xyz: float
    f_dc: float
    f_rest: float
    opacity: float
    scaling: float
    rotation: float
    obj_dc: float

    def per_param(self) -> dict[str, float]:
        return {"xyz": self.xyz, "f_dc": self.f_dc, "f_rest": self.f_rest,
                "log_scale": self.scaling, "quat": self.rotation,
                "logit_opacity": self.opacity, "obj_dc": self.obj_dc}


def adam_step(state: GaussianState, grads: GaussianParams,
              lrs: LearningRates) -> GaussianState:
    """One Adam update over all padded parameter arrays with one shared
    bias-correction step. Inactive slots have zero grads (mask_grads), so
    their moments stay 0. Returns a new state; the inputs are not
    modified."""
    step = state.adam.step + 1
    f32 = np.float32
    bc1 = float(f32(1.0) - f32(B1) ** f32(step))
    bc2 = float(f32(1.0) - f32(B2) ** f32(step))
    lr = lrs.per_param()
    new_p, new_mu, new_nu = {}, {}, {}
    for name, p in state.params.as_dict().items():
        g = getattr(grads, name)
        mu = B1 * getattr(state.adam.mu, name) + (1 - B1) * g
        nu = B2 * getattr(state.adam.nu, name) + (1 - B2) * g * g
        new_p[name] = p - lr[name] * (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        new_mu[name], new_nu[name] = mu, nu
    return state.replace(params=GaussianParams(**new_p),
                         adam=AdamState(GaussianParams(**new_mu),
                                        GaussianParams(**new_nu), step))


def mask_grads(grads: GaussianParams, active: torch.Tensor) -> GaussianParams:
    """Zero the gradients of inactive slots."""
    def m(g):
        return g * active.to(g.dtype).reshape((-1,) + (1,) * (g.ndim - 1))
    return grads.map(m)


def add_densification_stats(state: GaussianState, abs_grad2d: torch.Tensor,
                            radii: torch.Tensor,
                            visibility: torch.Tensor) -> GaussianState:
    """Accumulate the screen-space gradient norms and the max radii of the
    visible active slots. ``abs_grad2d`` is the (C,2) |d mean2d| stream."""
    gnorm = torch.linalg.vector_norm(abs_grad2d, dim=-1)
    vis = visibility & state.active
    return state.replace(
        grad_accum=state.grad_accum + torch.where(vis, gnorm, 0.0),
        denom=state.denom + vis.to(torch.float32),
        max_radii2d=torch.where(
            vis, torch.maximum(state.max_radii2d, radii.to(torch.float32)),
            state.max_radii2d))
