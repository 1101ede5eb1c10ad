"""The plain training step of the recipes, and what the check reads from it.

One step (the recipe's, with a camera batch of one): the view is drawn in
the trainer's order (epochs without replacement from ``random.Random(seed)``,
the first draw serving the first step), the background is the recipe's
(``np.random.default_rng(iteration)`` when it is random), the render and
the losses are differentiated over the Gaussians' parameters and the side
networks', the Gaussians' gradient is masked to the active slots, Adam
(eps 1e-15, one shared float32 bias correction) updates them with the
per-group rates and the exponential position schedule, and the side
networks take one Adam step each. ``run_reference`` follows the first
steps from the inputs the benchmark made and returns the readings the
check compares: each step's losses (by term and total), each leaf's
gradient norm at the first step, and each leaf's change over the steps.
Imports nothing of the program.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from . import camera as C
from . import losses as L
from . import render as R
from .nets import SideNets

B1, B2, EPS = 0.9, 0.999, 1e-15
SUPPORTED_LOSSES = {"l1", "ssim", "l1_scale", "entropy", "mono_normal",
                    "depth_normal", "curv", "consistent_normal", "distortion",
                    "depth_var", "semantic"}


def recipe_weights(optim: dict) -> dict:
    w = {k: float(v) for k, v in optim["loss_weight"].items() if float(v) > 0}
    unknown = set(w) - SUPPORTED_LOSSES
    if unknown:
        raise ValueError(f"the reference has no loss {sorted(unknown)}")
    return w


def camera_order(seed: int, n_views: int, n_steps: int) -> list[int]:
    """The views of the first ``n_steps`` steps in the trainer's order."""
    rng = random.Random(seed)
    stack, out = [], []
    for _ in range(n_steps):
        if not stack:
            stack = list(range(n_views))
        out.append(stack.pop(rng.randint(0, len(stack) - 1)))
    return out


def expon_lr(step, lr_init, lr_final, max_steps) -> float:
    f32 = np.float32
    step = f32(step)
    t = np.clip(step / f32(max_steps), f32(0), f32(1))
    return float(np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                        + np.log(f32(lr_final)) * t))


def adam(params: dict, mu: dict, nu: dict, grads: dict, lrs: dict,
         step: int):
    f32 = np.float32
    bc1 = float(f32(1.0) - f32(B1) ** f32(step))
    bc2 = float(f32(1.0) - f32(B2) ** f32(step))
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = B1 * mu[k] + (1 - B1) * g
        v = B2 * nu[k] + (1 - B2) * g * g
        new_p[k] = p - lrs[k] * (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        new_mu[k], new_nu[k] = m, v
    return new_p, new_mu, new_nu


class Inputs:
    """What the benchmark hands the reference: the recipe (the cell's
    configuration as a dict), the seed, the views, the population, the
    side networks' weights, the scene's box and the first iteration."""

    def __init__(self, cfg: dict, seed: int, views: list, fovx: float,
                 fovy: float, params: dict, active, net_weights: dict,
                 trans, scale, start_iteration: int):
        self.cfg, self.seed, self.views = cfg, seed, views
        self.fovx, self.fovy = fovx, fovy
        self.params, self.active = params, active
        self.net_weights = net_weights
        self.trans, self.scale = trans, scale
        self.start_iteration = start_iteration


def run_reference(inp: Inputs, n_steps: int, device,
                  dtype=torch.float32) -> dict:
    """{"loss": [{term: value} per step, "total" among them],
    "grad": {leaf: norm at step 1},
    "delta": {leaf: norm of its change over the steps}}, computed in
    ``dtype`` (float32 for the reference, a lower precision for its
    control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, o, m = inp.cfg, inp.cfg["optim"], inp.cfg["model"]
    weights = recipe_weights(o)
    ch_sem = int(m["ch_sem_feat"]) if weights.get("semantic", 0) > 0 else 0
    num_cls = int(m["num_cls"])
    sh_max = int(m["sh_degree"])
    width, height = inp.views[0].image.shape[2], inp.views[0].image.shape[1]
    cams = [C.make_cam(v.qvec, v.tvec, inp.fovx, inp.fovy, width, height,
                       device) for v in inp.views]
    extent = C.camera_extent(np.stack([c.cam_center.double().cpu().numpy()
                                       for c in cams]))
    cams = [C.Cam(*(t.to(dtype) for t in c)) for c in cams]
    params = {k: v.to(device, dtype).clone() for k, v in inp.params.items()}
    start = {k: v.clone() for k, v in params.items()}
    active = inp.active.to(device)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    nets = SideNets(inp.net_weights, ch_sem, num_cls, device, dtype)
    net_start = [p.detach().clone() for p in nets.leaves()]
    trans = torch.tensor(inp.trans, dtype=dtype, device=device)
    scale = torch.tensor(inp.scale, dtype=dtype, device=device)
    order = camera_order(inp.seed, len(inp.views), n_steps)
    out = {"loss": [], "grad": {}, "delta": {}}
    for s in range(n_steps):
        it = inp.start_iteration + s
        view = inp.views[order[s]]
        cam = cams[order[s]]
        gt = torch.tensor(view.image, device=device).to(dtype) / 255.0
        gt_normal = (torch.tensor(view.normal, device=device).to(dtype)
                     if view.normal is not None
                     else torch.zeros((3, height, width), dtype=dtype,
                                      device=device))
        labels = (torch.tensor(view.labels, device=device)
                  if view.labels is not None else None)
        bg = (np.random.default_rng(it).random(3).astype(np.float32)
              if cfg["optim"]["random_background"] else
              np.array([1, 1, 1] if m["white_background"] else [0, 0, 0],
                       np.float32))
        bg = torch.tensor(bg, dtype=dtype, device=device)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        inside = torch.all(torch.abs((leaves["xyz"] - trans) / scale) < 1.0,
                           dim=-1)
        r = R.render(leaves, active, cam, width, height, bg,
                     min(it // 1000, sh_max), ch_sem, m["depth_type"],
                     float(o["mask_depth_thr"]), extent, cam_mask=labels,
                     classifier=nets.cls)
        total, terms = L.compute_losses(
            r, gt, gt_normal, labels, leaves, active, inside, weights,
            L.gates(o, it), float(o["exp_t"]), num_cls,
            nets.appearance if nets.app is not None else None, order[s])
        names = list(leaves)
        all_leaves = [leaves[k] for k in names] + nets.leaves()
        grads = torch.autograd.grad(total, all_leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(all_leaves, grads)]
        g_gauss = {k: g * active.to(g.dtype).reshape(
                       (-1,) + (1,) * (g.ndim - 1))
                   for k, g in zip(names, grads)}
        g_nets = grads[len(names):]
        if s == 0:
            out["grad"] = leaf_norms(g_gauss, g_nets)
        out["loss"].append({k: float(v.detach()) for k, v in
                            {**terms, "total": total}.items()})
        nets.step(g_nets)
        lrs = {"xyz": expon_lr(it, o["position_lr_init"] * extent,
                               o["position_lr_final"] * extent,
                               o["position_lr_max_steps"]),
               "f_dc": o["feature_lr"], "f_rest": o["feature_lr"] / 20.0,
               "log_scale": o["scaling_lr"], "quat": o["rotation_lr"],
               "logit_opacity": o["opacity_lr"], "obj_dc": o["feature_lr"]}
        with torch.no_grad():
            params, mu, nu = adam(params, mu, nu, g_gauss, lrs, s + 1)
        del r, total, grads, leaves
    out["delta"] = leaf_norms(
        {k: params[k] - start[k] for k in params},
        [p.detach() - q for p, q in zip(nets.leaves(), net_start)])
    return out


def leaf_norms(gauss: dict, nets: list) -> dict:
    """{leaf: float64 norm}: the Gaussians' leaves by name, the side
    networks' as ``net.<i>`` in their optimizers' order; empty leaves
    left out."""
    out = {}
    for k, t in gauss.items():
        if t.numel():
            out[k] = float(torch.linalg.vector_norm(t.double()))
    for i, t in enumerate(nets):
        out[f"net.{i}"] = float(torch.linalg.vector_norm(t.double()))
    return out


# A leaf's gradient under this share of the largest leaf's is float32
# rounding of the step's sums (unit round-off 6e-8), not a signal.
ROUNDING = 1e-7


def rounding_floor(grad: dict) -> float:
    """The norm under which a leaf's reading is rounding alone."""
    return ROUNDING * max(grad.values(), default=0.0)


def rounding_leaves(grad: dict) -> set:
    """The leaves whose reference gradient is rounding alone: Adam moves
    them by round-off, so their change is not compared."""
    floor = rounding_floor(grad)
    return {k for k, v in grad.items() if v < floor}


def gap(program: dict, reference: dict, leave_out=(),
        floor: float = 0.0) -> tuple[float, str]:
    """The worst leaf's |program norm - reference norm| over the larger of
    its own reference norm and ``floor``, over the leaves not in
    ``leave_out``: (gap, leaf). Each leaf is held to its own size, so a
    leaf far smaller than the others (the colours beside DTU's distortion
    gradients) is seen as well as the largest."""
    worst, name = 0.0, ""
    for k, v in reference.items():
        if k in leave_out:
            continue
        p = program.get(k, 0.0)
        d = max(v, floor)
        g = abs(p - v) / d if d > 0 else (0.0 if p == v else math.inf)
        if not math.isfinite(p):
            g = math.inf
        if g >= worst:
            worst, name = g, k
    return worst, name


def loss_gap(program: list, reference: list) -> float:
    """The largest relative gap of a step's loss, over the steps and over
    the recipe's terms and their total (a term the program lacks, or a
    non-finite one, reads inf)."""
    if len(program) != len(reference):
        return math.inf
    out = 0.0
    for p, r in zip(program, reference):
        for k, rv in r.items():
            pv = p.get(k, math.nan)
            if not math.isfinite(pv):
                return math.inf
            g = abs(pv - rv) / abs(rv) if rv else (math.inf if pv else 0.0)
            out = max(out, g)
    return out
