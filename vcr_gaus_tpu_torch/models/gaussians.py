"""Gaussian population state, its init, the padded Adam step and the
population edits (vcr_gaus_tpu/models/gaussians.py).

The state keeps the JAX package's fixed capacity and ``active`` mask, its
Adam moments with one shared bias-correction step, and the densification
statistics, so the two packages' states compare slot by slot. Clone, split
and prune move rows between slots in the JAX package's slot order; the
capacity grows only through ``expand_capacity``.

``adam_and_stats`` is the training step's update: on a CUDA tensor the
hand-written kernel ``csrc/adam.cu`` (``vcr_adam_stats``), one launch over
every slot of every leaf and the statistics; on the CPU its plain version
``adam_and_stats_torch``: ``mask_grads``, ``adam_step`` and
``add_densification_stats`` in turn. The kernel's outputs equal the plain
version's on the card bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass, fields
from typing import NamedTuple

import numpy as np
import torch

from ..ops import cuda_build
from ..utils import math as M
from ..utils import sh as SH
from ..utils import tracing


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


def bias_corrections(step: int) -> tuple[float, float]:
    """Adam's (1 - B1^step, 1 - B2^step), in float32 as the JAX package."""
    f32 = np.float32
    return (float(f32(1.0) - f32(B1) ** f32(step)),
            float(f32(1.0) - f32(B2) ** f32(step)))


def adam_step(state: GaussianState, grads: GaussianParams,
              lrs: LearningRates) -> GaussianState:
    """One Adam update over all padded parameter arrays with one shared
    bias-correction step. Inactive slots have zero grads (mask_grads), so
    their moments stay 0. Returns a new state; the inputs are not
    modified."""
    step = state.adam.step + 1
    bc1, bc2 = bias_corrections(step)
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


class AdamTable(NamedTuple):
    """What ``vcr_adam_stats`` receives besides pointers: the leaves of
    nonzero width in field order as (name, floats a slot, learning rate),
    and the update's scalars, each the float32 that PyTorch's eager chain
    on the card uses: a Python float rounded to float32, and for ``t / s``
    the float32 reciprocal of ``s`` (``inv_bc1``, ``inv_bc2``)."""
    leaves: list[tuple[str, int, np.float32]]
    scalars: dict[str, np.float32]


def adam_table(params: GaussianParams, lrs: LearningRates,
               step: int) -> AdamTable:
    """The kernel's leaf table and scalars for the update to ``step``."""
    f32 = np.float32
    lr = lrs.per_param()
    capacity = params.xyz.shape[0]
    leaves = [(name, p.numel() // capacity, f32(lr[name]))
              for name, p in params.as_dict().items() if p.numel()]
    bc1, bc2 = bias_corrections(step)
    return AdamTable(leaves, {
        "b1": f32(B1), "c1": f32(1 - B1), "b2": f32(B2), "c2": f32(1 - B2),
        "inv_bc1": f32(1.0) / f32(bc1), "inv_bc2": f32(1.0) / f32(bc2),
        "eps": f32(EPS)})


def adam_and_stats_torch(state: GaussianState, grads: GaussianParams,
                         lrs: LearningRates, g2d: torch.Tensor,
                         ndc_scale: tuple[float, float], radii: torch.Tensor,
                         visibility: torch.Tensor) -> GaussianState:
    """The plain version of ``adam_and_stats``: ``mask_grads``,
    ``adam_step`` and ``add_densification_stats`` of ``g2d * ndc_scale``
    in turn."""
    new = adam_step(state, mask_grads(grads, state.active), lrs)
    return add_densification_stats(new, g2d * g2d.new_tensor(ndc_scale),
                                   radii, visibility)


def adam_and_stats(state: GaussianState, grads: GaussianParams,
                   lrs: LearningRates, g2d: torch.Tensor,
                   ndc_scale: tuple[float, float], radii: torch.Tensor,
                   visibility: torch.Tensor) -> GaussianState:
    """The training step's update: the kernel on a CUDA tensor,
    ``adam_and_stats_torch`` otherwise. ``g2d`` is the densify dummy's
    (C, 2) gradient (pixels), ``ndc_scale`` the ndc2Pix jacobian (0.5 W,
    0.5 H). Returns a new state; the inputs are not modified."""
    if state.active.device.type != "cuda":
        return adam_and_stats_torch(state, grads, lrs, g2d, ndc_scale, radii,
                                    visibility)
    capacity, dev = state.capacity, state.active.device
    step = state.adam.step + 1
    table = adam_table(state.params, lrs, step)

    def check(x, dtype, shape):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"expected a {dtype} tensor of shape {shape} on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
        return x

    out = {name: [torch.empty(p.shape, dtype=torch.float32, device=dev)
                  for _ in range(3)]
           for name, p in state.params.as_dict().items()}
    leaves = []        # held until the launch: contiguous copies may be new
    for name, _, _ in table.leaves:
        shape = tuple(getattr(state.params, name).shape)
        leaves += [check(getattr(x, name), torch.float32, shape).contiguous()
                   for x in (state.params, grads, state.adam.mu,
                             state.adam.nu)] + out[name]
    # the dummy's gradient may be a column slice of K2's (C, 16+S) output
    g2d = check(g2d, torch.float32, (capacity, 2))
    if g2d.stride(1) != 1 or g2d.stride(0) < 2:
        g2d = g2d.contiguous()
    active, visibility = (check(x, torch.bool, (capacity,)).contiguous()
                          for x in (state.active, visibility))
    radii = check(radii, torch.int32, (capacity,)).contiguous()
    stats_in = [check(x, torch.float32, (capacity,)).contiguous()
                for x in (state.grad_accum, state.denom, state.max_radii2d)]
    stats_out = [torch.empty(capacity, dtype=torch.float32, device=dev)
                 for _ in range(3)]
    n, sc = len(table.leaves), table.scalars
    with torch.cuda.device(dev):
        err = _adam_kernel()(
            (ctypes.c_longlong * (7 * n))(*(x.data_ptr() for x in leaves)),
            (ctypes.c_longlong * n)(*(w * capacity
                                      for _, w, _ in table.leaves)),
            (ctypes.c_int * n)(*(w for _, w, _ in table.leaves)),
            (ctypes.c_float * n)(*(lr for _, _, lr in table.leaves)), n,
            *(sc[k] for k in ("b1", "c1", "b2", "c2", "inv_bc1", "inv_bc2",
                              "eps")),
            active.data_ptr(), capacity, g2d.data_ptr(), g2d.stride(0),
            *(np.float32(x) for x in ndc_scale), radii.data_ptr(),
            visibility.data_ptr(),
            *(x.data_ptr() for x in stats_in + stats_out),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adam_stats launch failed: cudaError {err}")
    cuda_build.LAUNCHES["adam_stats"] += 1
    tracing.count("train.adam.slots", capacity)
    return state.replace(
        params=GaussianParams(**{k: v[0] for k, v in out.items()}),
        adam=AdamState(GaussianParams(**{k: v[1] for k, v in out.items()}),
                       GaussianParams(**{k: v[2] for k, v in out.items()}),
                       step),
        grad_accum=stats_out[0], denom=stats_out[1],
        max_radii2d=stats_out[2])


@functools.cache
def _adam_kernel():
    fn = cuda_build.load("adam").vcr_adam_stats
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([p] * 4 + [i] + [f] * 7 + [p, i, p, i, f, f] + [p] * 8
                   + [p])
    fn.restype = ctypes.c_int
    return fn


# --- population edits: allocation, clone, split, prune (fixed capacity) -------

def _slot_assignment(active: torch.Tensor, sel: torch.Tensor):
    """For each selected slot (in index order), a distinct free slot (in
    index order). Returns (src (C,), dst (C,), n_copy, dropped): src[j] is
    copied to dst[j] for j < n_copy; the selected slots beyond the free
    supply are dropped. The stable sorts are those of jnp.argsort."""
    src = torch.argsort((~sel).to(torch.uint8), stable=True)
    dst = torch.argsort(active.to(torch.uint8), stable=True)
    n_sel, n_free = (int(x) for x in torch.stack(
        [sel.sum(), (~active).sum()]).tolist())
    return src, dst, min(n_sel, n_free), max(n_sel - n_free, 0)


def _scatter_copy(params: GaussianParams, src: torch.Tensor, dst: torch.Tensor,
                  n_copy: int) -> GaussianParams:
    """params[dst[j]] = params[src[j]] for j < n_copy, on copies."""
    s, d = src[:n_copy], dst[:n_copy]

    def cp(a):
        a = a.clone()
        a[d] = a[s]
        return a
    return params.map(cp)


def _zero_rows(params: GaussianParams, rows: torch.Tensor) -> GaussianParams:
    """Multiply the rows ``rows`` by 0, as the JAX package does."""
    def z(a):
        return a * (~rows).to(a.dtype).reshape((-1,) + (1,) * (a.ndim - 1))
    return params.map(z)


def prune(state: GaussianState, prune_mask: torch.Tensor) -> GaussianState:
    """Deactivate the pruned active slots and zero their parameters, moments
    and statistics, so that densification reuses them clean."""
    kill = prune_mask & state.active
    return state.replace(
        params=_zero_rows(state.params, kill),
        adam=AdamState(_zero_rows(state.adam.mu, kill),
                       _zero_rows(state.adam.nu, kill), state.adam.step),
        active=state.active & ~kill,
        max_radii2d=torch.where(kill, 0.0, state.max_radii2d),
        grad_accum=torch.where(kill, 0.0, state.grad_accum),
        denom=torch.where(kill, 0.0, state.denom))


def _insert_copies(state: GaussianState, sel: torch.Tensor, edit_fn=None):
    """Copy the selected rows into free slots (whose moments and statistics
    are zero). ``edit_fn(params, src, dst, n_copy)`` may rewrite the copies.
    Returns (state, dropped)."""
    src, dst, n_copy, dropped = _slot_assignment(state.active, sel)
    params = _scatter_copy(state.params, src, dst, n_copy)
    if edit_fn is not None:
        params = edit_fn(params, src, dst, n_copy)
    active = state.active.clone()
    active[dst[:n_copy]] = True
    return state.replace(params=params, active=active), dropped


def densify_and_clone(state: GaussianState, grads_norm: torch.Tensor,
                      grad_threshold: float, percent_dense: float,
                      scene_extent: float):
    """Clone the small high-gradient Gaussians: exact copies with zero
    moments. Returns (state, dropped)."""
    max_scale = torch.amax(state.scaling, dim=-1)
    sel = (state.active & (grads_norm >= grad_threshold)
           & (max_scale <= percent_dense * scene_extent))
    return _insert_copies(state, sel)


def densify_and_split_along_maxscaling(
        state: GaussianState, grads_norm: torch.Tensor, grad_threshold: float,
        percent_dense: float, scene_extent: float,
        box_mask: torch.Tensor | None = None, n_std: float = 2.0):
    """VCR-GauS split: two children displaced by +-(n_std/3) max_scale along
    the longest axis, whose scale is divided by 1.6. ``box_mask`` also
    selects the large visible Gaussians inside the box. Child 1 overwrites
    the parent slot (moments and statistics zeroed), child 2 takes a free
    slot. Returns (state, dropped)."""
    max_scale = torch.amax(state.scaling, dim=-1)
    sel = (state.active & (grads_norm >= grad_threshold)
           & (max_scale > percent_dense * scene_extent))
    if box_mask is not None:
        sel = sel | (state.active & box_mask)

    dirs, max_scaling, axis = M.longest_axis_dir(state.scaling,
                                                 state.params.quat)
    offset = dirs * (n_std * max_scaling / 3.0)[:, None]
    child_scale = M.set_axis_value(state.scaling, axis, max_scaling / 1.6)
    child_log_scale = torch.log(torch.clamp_min(child_scale, 1e-12))

    p = state.params
    selc = sel[:, None]
    p1 = dataclasses.replace(
        p, xyz=torch.where(selc, p.xyz + offset, p.xyz),
        log_scale=torch.where(selc, child_log_scale, p.log_scale))
    st = state.replace(
        params=p1,
        adam=AdamState(_zero_rows(state.adam.mu, sel),
                       _zero_rows(state.adam.nu, sel), state.adam.step),
        max_radii2d=torch.where(sel, 0.0, state.max_radii2d),
        grad_accum=torch.where(sel, 0.0, state.grad_accum),
        denom=torch.where(sel, 0.0, state.denom))

    def edit(params, src, dst, n_copy):
        # the copy holds child 1 (parent + offset): child 2 is copy - 2 offset
        xyz = params.xyz.clone()
        xyz[dst[:n_copy]] += -2.0 * offset[src[:n_copy]]
        return dataclasses.replace(params, xyz=xyz)

    return _insert_copies(st, sel, edit)


def densify_and_prune(state: GaussianState, grad_threshold: float,
                      min_opacity: float, scene_extent: float,
                      max_screen_size: float | None, percent_dense: float,
                      box_mask: torch.Tensor | None = None):
    """Clone and split from the accumulated gradients, then prune by
    opacity, screen radius and world size, and restart the statistics.
    Returns (state, dropped), the children that found no free slot."""
    grads_norm = torch.where(
        state.denom > 0, state.grad_accum / torch.clamp_min(state.denom, 1.0),
        0.0)
    state, d1 = densify_and_clone(state, grads_norm, grad_threshold,
                                  percent_dense, scene_extent)
    state, d2 = densify_and_split_along_maxscaling(
        state, grads_norm, grad_threshold, percent_dense, scene_extent,
        box_mask=box_mask)
    prune_mask = state.opacity[:, 0] < min_opacity
    if max_screen_size is not None:
        big_vs = state.max_radii2d > max_screen_size
        big_ws = torch.amax(state.scaling, dim=-1) > 0.1 * scene_extent
        prune_mask = prune_mask | big_vs | big_ws
    state = prune(state, prune_mask)
    zero = torch.zeros_like(state.grad_accum)
    return state.replace(grad_accum=zero, denom=zero.clone(),
                         max_radii2d=zero.clone()), d1 + d2


def prune_by_importance(state: GaussianState, imp_score: torch.Tensor,
                        percent: float) -> GaussianState:
    """LightGaussian prune, positional as in the JAX package: exactly
    k = percent (n_active - 1) active Gaussians go (float32, truncated), the
    lowest scores first, ties broken by slot index."""
    score = torch.where(state.active, imp_score, torch.inf)
    n_act = state.active.sum().to(torch.float32)
    k = (torch.tensor(percent, dtype=torch.float32) * (n_act.cpu() - 1.0)
         ).to(torch.int32)
    order = torch.sort(score, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(state.capacity, device=order.device)
    return prune(state, rank < int(k))


def v_imp_score(state: GaussianState, imp_list: torch.Tensor,
                v_pow: float) -> torch.Tensor:
    """Volume-reweighted importance: imp (volume / kth)^v_pow, kth the
    volume at rank int(0.9 n_active) in descending order over the active
    slots."""
    volume = torch.prod(state.scaling, dim=-1)
    vol_act = torch.where(state.active, volume, -torch.inf)
    n_act = state.active.sum().to(torch.float32)
    idx = int((torch.tensor(0.9, dtype=torch.float32) * n_act.cpu()
               ).to(torch.int32))
    kth = torch.sort(vol_act, descending=True).values[
        min(max(idx, 0), state.capacity - 1)]
    return torch.pow(volume / kth, v_pow) * imp_list


def reset_opacity(state: GaussianState) -> GaussianState:
    """Clamp the opacity to <= 0.01 and zero its Adam moments."""
    new_op = M.inverse_sigmoid(torch.clamp_max(state.opacity, 0.01))
    zero = torch.zeros_like(new_op)
    return state.replace(
        params=dataclasses.replace(state.params, logit_opacity=new_op),
        adam=AdamState(dataclasses.replace(state.adam.mu, logit_opacity=zero),
                       dataclasses.replace(state.adam.nu,
                                           logit_opacity=zero.clone()),
                       state.adam.step))


def oneup_sh_degree(state: GaussianState, max_sh_degree: int) -> GaussianState:
    return state.replace(active_sh_degree=min(state.active_sh_degree + 1,
                                              max_sh_degree))


def expand_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Grow the padded capacity with zero rows (inactive)."""
    extra = new_capacity - state.capacity
    if extra <= 0:
        raise ValueError(f"new capacity {new_capacity} is not above "
                         f"{state.capacity}")

    def pad(a):
        return torch.cat([a, a.new_zeros((extra,) + tuple(a.shape[1:]))])

    return GaussianState(
        params=state.params.map(pad),
        adam=AdamState(state.adam.mu.map(pad), state.adam.nu.map(pad),
                       state.adam.step),
        active=pad(state.active), max_radii2d=pad(state.max_radii2d),
        grad_accum=pad(state.grad_accum), denom=pad(state.denom),
        active_sh_degree=state.active_sh_degree)
