"""Training: the step and the host loop (vcr_gaus_tpu/train/trainer.py).

One step renders a batch of ``tpu.camera_batch`` cameras, one view at a
time (each through the semantic classifier when the recipe has one),
assembles the recipe's losses (the L1 through the appearance network when
it has one), takes the gradient of the total over the parameters, the
densify dummy and the side networks, averages the views' gradients and
losses, masks the Gaussians' gradient to the active slots, runs Adam with
the per-group learning rates, adds the densification statistics and steps
the side networks' Adam once. When a process group is initialised
(``parallel.dp``) the batch is split over the ranks and the averages are
all-reduced, as the JAX package's camera-DP step does over its mesh.
``Trainer`` loads the scene and its priors, initializes the state from its
point cloud (or a checkpoint) and runs the schedule: steps in the JAX
package's camera order (its single-step path and its camera-DP path draw
alike), then the host actions of each iteration (densify with the
box-guided split, over training views or random cameras on the box;
opacity reset, capacity growth, the LightGaussian prune), the test sweeps
with their panels and mIoU, the metric writers (TensorBoard with
``VCR_TB=1``, wandb with ``VCR_WANDB=1``, each skipped with a printed line
when its package is absent), the PLY, ``model.pkl`` and checkpoint saves
and the final importance dump; across ranks rank 0 alone writes. The stats
sweeps behind the box mask and the prune run the stats kernel once per
view. The learning-rate schedule, the SH degree warmup, the loss gates and
the debug hooks (``detect_anomaly``, ``train.debug_from``) follow the
iteration as in the JAX package. The JAX package's entry budget, overflow
handling, supersteps (``tpu.steps_per_call``), binning lookahead and
camera cache exist for its static shapes on the TPU and have no
counterpart here. With ``port > 0`` rank 0 serves the SIBR viewer
(``render.network_gui``): before each iteration it answers the pending
viewer requests, one render of the requested camera each, and a
``train: false`` request pauses training until the viewer resumes it or
disconnects.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import pickle
import random
import time
from typing import NamedTuple

import numpy as np
import torch

from ..compat.arguments import write_cfg_args
from ..data.box_cameras import sample_box_cameras
from ..data.cameras import CameraArrays
from ..data.scene import camera_to_json, load_scene_info
from ..models import appearance as APP
from ..models import gaussians as GM
from ..models import ply_io
from ..parallel import dp as DP
from ..render.network_gui import NetworkGUI
from ..render.renderer import RenderConfig, render, render_stats
from ..utils import math as M
from ..utils import tracing
from ..utils.device import resolve_device
from . import losses as L
from . import visualization as VZ
from .side_nets import SideNets

# every loss of the JAX package's compute_losses
PORTED_LOSSES = ("l1", "ssim", "l1_scale", "entropy", "mono_depth",
                 "mono_normal", "depth_normal", "curv", "consistent_normal",
                 "distortion", "depth_var", "semantic")


class Gates(NamedTuple):
    """Loss gates by iteration (the *_from_iter thresholds)."""
    mono_normal: bool
    depth_normal: bool
    curv: bool
    consistent_normal: bool
    close_depth: bool


def recipe_weights(cfg) -> dict[str, float]:
    """The recipe's positive loss weights."""
    return {k: float(v) for k, v in cfg.optim.loss_weight.items()
            if float(v) > 0}


def compute_losses(out: dict, cam: CameraArrays, state: GM.GaussianState,
                   weights: dict, gates: Gates, cfg,
                   inside_mask: torch.Tensor, nets: SideNets | None = None,
                   num_cls: int = 0):
    """(total, {name: loss}) of the recipe, as the JAX compute_losses: the
    L1 on the appearance-transformed centre crop when ``nets`` has the
    appearance network; curv inside the depth_normal gate."""
    losses = {}
    gt = cam.image
    if nets is not None and nets.app is not None:
        transformed, (top, left, h, w) = APP.appearance_transform(
            nets.app, nets.emb, out["render"], cam.idx)
        losses["l1"] = L.l1_loss(transformed,
                                 gt[:, top:top + h, left:left + w])
    else:
        losses["l1"] = L.l1_loss(out["render"], gt)
    # the SSIM kernels take no strides: a caller's crop of the view is laid
    # out anew here (a no-op on the step's own contiguous images)
    losses["ssim"] = 1.0 - L.ssim(out["render"].contiguous(),
                                  gt.contiguous())
    act = state.active
    if weights.get("l1_scale", 0) > 0:
        # amin splits the gradient among tied axes, as jnp.min does
        min_scale = torch.amin(state.scaling, -1)
        m = (act & inside_mask).to(torch.float32)
        losses["l1_scale"] = (torch.sum(min_scale * m)
                              / torch.clamp_min(m.sum(), 1.0))
    if weights.get("entropy", 0) > 0:
        losses["entropy"] = L.entropy_loss(state.opacity[:, 0],
                                           act & inside_mask)
    if weights.get("mono_depth", 0) > 0:
        m = (out["depth"] > 0) & cam.has_depth
        losses["mono_depth"] = L.scale_and_shift_invariant_depth_loss(
            out["depth"], cam.depth, m.to(torch.float32))
    gt_normal = cam.normal.permute(1, 2, 0)                    # (H,W,3)
    if weights.get("mono_normal", 0) > 0 and gates.mono_normal:
        losses["mono_normal"] = L.monosdf_normal_loss(out["normal"],
                                                      gt_normal)
    if weights.get("depth_normal", 0) > 0 and gates.depth_normal:
        w_conf = L.cos_weight(out["normal"].detach(), gt_normal,
                              cfg.optim.exp_t)
        losses["depth_normal"] = L.masked_monosdf_normal_loss(
            out["est_normal"], gt_normal, out["mask"], w_conf)
        if weights.get("curv", 0) > 0 and gates.curv:
            curv = L.normal2curv(out["est_normal"],
                                 out["mask"][..., None].to(torch.float32))
            losses["curv"] = torch.abs(curv).mean()
    if weights.get("consistent_normal", 0) > 0 and gates.consistent_normal:
        losses["consistent_normal"] = L.monosdf_normal_loss(
            out["est_normal"], out["normal"])
    if weights.get("distortion", 0) > 0 and gates.close_depth:
        losses["distortion"] = L.edge_aware_distortion_map(
            gt, out["distortion"]).mean()
    if weights.get("depth_var", 0) > 0 and gates.close_depth:
        losses["depth_var"] = L.edge_aware_distortion_map(
            gt, out["depth_var"]).mean()
    if weights.get("semantic", 0) > 0:
        losses["semantic"] = L.semantic_cross_entropy(
            out["render_sem"], cam.mask, num_cls)
    total = torch.zeros((), device=gt.device)
    for name, w in weights.items():
        if name in losses:
            total = total + w * losses[name]
    losses["total"] = total
    return total, losses


def make_train_step(cfg, rcfg: RenderConfig, weights: dict,
                    scene_extent: float, trans, scale, num_cls: int = 0,
                    distributed: bool = False):
    """The step for a batch of cameras:
    step(state, cams, bg, lr_xyz, sh_degree, gates, nets=None)
    -> (state, losses, aux), where ``cams`` is one CameraArrays or a list of
    k. As the JAX package's step: each view is rendered and differentiated
    in turn (one view's graph alive at a time), the gradients and losses
    summed in view order and, when k > 1, multiplied by 1/k; radii by max,
    visibility by OR, the entry count by max. With ``distributed`` (a
    process group is initialised) the gradients, the densify dummy's, the
    side networks' and the losses are then all-reduced as a mean over the
    ranks, radii, visibility and the entry count as a maximum, before the
    update that every rank runs alike. The state passed in is not modified;
    the side networks ``nets`` take one Adam step, in place, on the
    averaged gradients. One background serves every view of the step."""
    o = cfg.optim
    ndc_scale = (0.5 * rcfg.width, 0.5 * rcfg.height)

    def step(state: GM.GaussianState, cams, bg: torch.Tensor,
             lr_xyz: float, sh_degree: int, gates: Gates,
             nets: SideNets | None = None):
        if isinstance(cams, CameraArrays):
            cams = [cams]
        inside_mask, _ = M.get_inside_normalized(state.params.xyz, trans,
                                                 scale)
        params = state.params.map(lambda p: p.detach().requires_grad_(True))
        dummy = torch.zeros((state.capacity, 2), device=state.active.device,
                            requires_grad=True)
        st = state.replace(params=params)
        leaves = list(params.as_dict().values()) + [dummy]
        n_gauss = len(leaves)
        if nets is not None:
            leaves += nets.leaves()
        grads = losses = radii = visibility = num_entries = None
        for cam in cams:
            # the appearance network's convolutions, backward included, in
            # full float32 (cuDNN would take TF32)
            with (torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
                  if nets is not None and nets.app is not None
                  else contextlib.nullcontext()):
                out = render(st, cam, rcfg, bg, sh_degree,
                             scene_extent=scene_extent, densify_dummy=dummy,
                             classifier=(nets.cls if nets is not None
                                         else None))
                with tracing.span("train.losses"):
                    total, losses_i = compute_losses(
                        out, cam, st, weights, gates, cfg, inside_mask,
                        nets, num_cls)
                grads_i = torch.autograd.grad(total, leaves,
                                              allow_unused=True)
            grads_i = [torch.zeros_like(x) if g is None else g
                       for x, g in zip(leaves, grads_i)]
            losses_i = {k: v.detach() for k, v in losses_i.items()}
            if grads is None:
                grads, losses = grads_i, losses_i
                radii = out["radii"]
                visibility = out["visibility_filter"]
                num_entries = out["num_entries"]
            else:
                grads = [a + b for a, b in zip(grads, grads_i)]
                losses = {k: v + losses_i[k] for k, v in losses.items()}
                radii = torch.maximum(radii, out["radii"])
                visibility = visibility | out["visibility_filter"]
                num_entries = max(num_entries, out["num_entries"])
            del out, total, grads_i, losses_i
        if len(cams) > 1:
            inv = 1.0 / len(cams)
            grads = [g * inv for g in grads]
            losses = {k: v * inv for k, v in losses.items()}
        if distributed:
            with tracing.span("train.all_reduce"):
                names = list(losses)
                reduced = DP.reduce_mean(grads + [losses[k] for k in names])
                grads = reduced[:len(grads)]
                losses = dict(zip(names, reduced[len(grads):]))
                radii, visibility, num_entries = DP.reduce_max(
                    radii, visibility, num_entries)
        if nets is not None:
            with tracing.span("train.side_nets"):
                nets.step(grads[n_gauss:])
        grads = grads[:n_gauss]
        g_params = GM.GaussianParams(*grads[:-1])
        with tracing.span("train.adam"), torch.no_grad():
            lrs = GM.LearningRates(
                xyz=lr_xyz, f_dc=o.feature_lr, f_rest=o.feature_lr / 20.0,
                opacity=o.opacity_lr, scaling=o.scaling_lr,
                rotation=o.rotation_lr, obj_dc=o.feature_lr)
            # the kernel's stream is in pixels; the reference reports mean2D
            # grads through the ndc2Pix jacobian (0.5 W, 0.5 H), and the
            # densify threshold is in those units
            new_state = GM.adam_and_stats(state, g_params, lrs, grads[-1],
                                          ndc_scale, radii, visibility)
        aux = {"num_entries": num_entries}
        return new_state, losses, aux

    return step


def _auto_capacity(n_init: int) -> int:
    """The next power of two above 8x the init count, at least 2^16."""
    return max(1 << 16, 1 << math.ceil(math.log2(max(n_init, 1) * 8)))


class Trainer:
    """Loads the scene, builds the initial state (or resumes from
    ``train.start_checkpoint``) and runs the recipe's schedule on
    ``device``: steps, host actions, sweeps and saves."""

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        # the JAX package's debug hooks: detect_anomaly for the whole run,
        # train.debug_from from that iteration on
        if bool(getattr(cfg, "detect_anomaly", False)):
            torch.autograd.set_detect_anomaly(True)
        self._debug_from = int(getattr(cfg.train, "debug_from", -1))
        self._debug_on = False
        # camera-DP over the default process group, when one is initialised
        self.rank, self.world_size = DP.world()
        self.distributed = DP.initialized()
        self.is_main = self.rank == 0
        # the viewer bridge (port > 0), on rank 0 alone
        self._gui = None
        self._gui_paused = False
        self._gui_rcfgs: dict[tuple[int, int], RenderConfig] = {}
        if int(getattr(cfg, "port", -1) or -1) > 0 and self.is_main:
            self._gui = NetworkGUI(str(getattr(cfg, "ip", "127.0.0.1")),
                                   int(cfg.port), self.device)
        self.camera_batch = max(int(getattr(cfg.tpu, "camera_batch", 1)), 1)
        if self.camera_batch % self.world_size:
            raise ValueError(
                f"tpu.camera_batch={self.camera_batch} must be a multiple of "
                f"the mesh size {self.world_size} (the world size)")
        w = recipe_weights(cfg)
        self.weights = w
        load_mask = "semantic" in w or bool(getattr(cfg.model, "load_mask",
                                                     False))
        self.scene = load_scene_info(
            cfg.model.source_path, images_dir=cfg.model.images,
            eval_split=cfg.model.eval, llffhold=cfg.model.llffhold,
            ratio=cfg.model.ratio, use_meta_split=cfg.model.split,
            load_depth="mono_depth" in w,
            load_normal="mono_normal" in w or "depth_normal" in w,
            load_mask=load_mask, normal_folder=cfg.model.normal_folder,
            depth_folder=cfg.model.depth_folder,
            resolution=cfg.model.resolution,
            data_device=str(getattr(cfg.model, "data_device", "host")))
        info = self.scene
        self.extent = info.radius
        self.trans = np.asarray(info.trans, np.float32)
        self.scale = np.asarray(info.scale, np.float32)
        # semantic feature channels only when the recipe trains them
        self.ch_sem = int(cfg.model.ch_sem_feat) if w.get("semantic", 0) > 0 \
            else 0
        self.num_cls = int(cfg.model.num_cls)

        pts = info.points.astype(np.float32)
        cols = info.colors.astype(np.float32)
        max_init = getattr(cfg.model, "max_init_points", None)
        cap = int(cfg.tpu.capacity) or _auto_capacity(len(pts))
        limit = min(x for x in (max_init, cap) if x)
        if len(pts) > limit:
            self._print(f"subsampling init cloud {len(pts)} -> {limit}")
            sel = np.random.default_rng(cfg.seed).choice(
                len(pts), limit, replace=False)
            pts, cols = pts[sel], cols[sel]
        self.state = GM.create_from_pcd(pts, cols, cap, cfg.model.sh_degree,
                                        self.ch_sem, device=self.device)
        cam0 = info.train_cameras[0]
        self.rcfg = RenderConfig(
            width=cam0.width, height=cam0.height, ch_sem=self.ch_sem,
            depth_mode=cfg.model.depth_type,
            mask_depth_thr=float(cfg.optim.mask_depth_thr))
        self.step_fn = make_train_step(cfg, self.rcfg, w, self.extent,
                                       self.trans, self.scale, self.num_cls,
                                       distributed=self.distributed)
        # the side networks, drawn from the trainer's own generator
        self.nets = SideNets(
            cfg, len(info.train_cameras) + len(info.test_cameras),
            self.ch_sem, self.num_cls,
            torch.Generator().manual_seed(int(cfg.seed)), self.device)
        self.iteration = 0
        self.viewpoint_stack: list[int] = []
        self.bg = np.array([1, 1, 1] if cfg.model.white_background
                           else [0, 0, 0], np.float32)
        self.rng = random.Random(cfg.seed)
        # the one-step camera lookahead: the next step's batch of indices
        self._next_idxs: list[int] | None = None
        self._pending_dropped: int | None = None
        self.history: list[dict] = []
        self.test_history: list[dict] = []
        # one record per host action: iteration, action, population before
        # and after
        self.host_log: list[dict] = []
        # rank 0 alone writes: the logdir, the metric writers, the run
        # metadata downstream tools reload
        self._tb = None
        if self.is_main:
            os.makedirs(cfg.logdir, exist_ok=True)
            self._tb = make_writer(cfg.logdir)
            with open(os.path.join(cfg.logdir, "cameras.json"), "w") as f:
                json.dump([camera_to_json(i, c) for i, c in enumerate(
                    info.train_cameras + info.test_cameras)], f)
            write_cfg_args(cfg, cfg.logdir)
        start_ckpt = getattr(cfg.train, "start_checkpoint", None)
        if start_ckpt:
            self.restore_checkpoint(start_ckpt)
            self._print(f"resumed from {start_ckpt} at iteration "
                        f"{self.iteration}")
        DP.barrier()

    def _print(self, msg: str) -> None:
        """A log line, printed by rank 0 alone."""
        if self.is_main:
            print(msg, flush=True)

    def _on_main(self, fn, *args):
        """``fn(*args)`` on rank 0 while the other ranks wait at a barrier;
        its result on rank 0, None elsewhere."""
        out = fn(*args) if self.is_main else None
        DP.barrier()
        return out

    # -- schedule -----------------------------------------------------------

    def _sh_degree(self, it: int | None = None) -> int:
        """SH warmup: +1 every 1000 iterations."""
        it = self.iteration if it is None else it
        return min(it // 1000, self.cfg.model.sh_degree)

    def _gates(self, it: int | None = None) -> Gates:
        o = self.cfg.optim
        it = self.iteration if it is None else it
        return Gates(
            mono_normal=it > o.normal_from_iter,
            depth_normal=it > o.dnormal_from_iter,
            curv=it > o.curv_from_iter,
            consistent_normal=it > o.consistent_normal_from_iter,
            close_depth=it > o.close_depth_from_iter)

    def _lr_xyz(self, it: int | None = None) -> float:
        o = self.cfg.optim
        it = self.iteration if it is None else it
        return M.expon_lr(it, o.position_lr_init * self.extent,
                          o.position_lr_final * self.extent,
                          max_steps=o.position_lr_max_steps)

    def _next_camera_index(self) -> int:
        """Epochs without replacement in the JAX package's order."""
        if not self.viewpoint_stack:
            self.viewpoint_stack = list(range(len(self.scene.train_cameras)))
        return self.viewpoint_stack.pop(
            self.rng.randint(0, len(self.viewpoint_stack) - 1))

    def _pick_camera_batch(self) -> list[int]:
        """This step's ``tpu.camera_batch`` cameras. The next step's batch
        is drawn now, before the step and its host actions, as the JAX
        package's one-step camera prefetch draws it (the first step draws
        two batches); the densify's draws from the same generator follow.
        Every rank draws the same indices from the same seeded generator."""
        k = self.camera_batch
        if self._next_idxs is None:
            self._next_idxs = [self._next_camera_index() for _ in range(k)]
        idxs = self._next_idxs
        self._next_idxs = [self._next_camera_index() for _ in range(k)]
        return idxs

    def _maybe_enable_debug(self) -> None:
        """From iteration ``train.debug_from`` on (checked before the
        step, as the JAX package does): anomaly detection, and every step's
        losses host-checked for finiteness after its host actions."""
        if self._debug_on or self._debug_from < 0:
            return
        if self.iteration >= self._debug_from:
            self._debug_on = True
            torch.autograd.set_detect_anomaly(True)
            self._print(f"[debug] NaN tracing + per-step finite checks "
                        f"enabled from iteration {self.iteration}")

    def _debug_check(self, losses: dict) -> None:
        if not self._debug_on:
            return
        for k, v in losses.items():
            if not math.isfinite(float(v)):
                raise FloatingPointError(
                    f"non-finite loss '{k}' at iteration {self.iteration}")

    def host_actions(self, j: int) -> list[str]:
        """The host actions the schedule runs after iteration j (the JAX
        package's _is_action_iter names them all)."""
        o, t = self.cfg.optim, self.cfg.train
        final = j == int(o.iterations)
        acts = []
        if j < o.densify_until_iter:
            if j > o.densify_from_iter and j % o.densification_interval == 0:
                acts.append("densify")
            if j % o.opacity_reset_interval == 0 or (
                    self.cfg.model.white_background
                    and j == o.densify_from_iter):
                acts.append("reset opacity")
        if j in list(o.prune.iterations):
            acts.append("prune")
        if final or j in list(t.test_iterations):
            acts.append("test")
        if final or j in list(t.save_iterations):
            acts.append("save")
        if j in list(t.checkpoint_iterations):
            acts.append("checkpoint")
        if final and list(o.prune.iterations):
            acts.append("dump importance")
        return acts

    def _box_cameras(self):
        """The densify_large settings when the box mask is on, else None."""
        dl = getattr(self.cfg.optim, "densify_large", None)
        if not dl or float(getattr(dl, "percent_dense", 0) or 0) <= 0:
            return None
        if int(getattr(dl.sample_cams, "num", 0)) <= 0:
            return None
        return dl

    # -- loop ---------------------------------------------------------------

    def train_step(self):
        """One iteration: this rank's share of the step's camera batch
        (all of it on one process), then the host actions. Under a profiler
        the ``train.step`` span holds it all and ``train.upload`` the views'
        and the background's copies to the device."""
        with tracing.step(self.iteration + 1, self.device):
            self._maybe_enable_debug()
            self.iteration += 1
            idxs = self._pick_camera_batch()
            share = len(idxs) // self.world_size
            mine = idxs[self.rank * share:(self.rank + 1) * share]
            with tracing.span("train.upload"):
                cams = [self.scene.train_cameras[i].arrays(self.device)
                        for i in mine]
                bg = (np.random.default_rng(self.iteration).random(3).astype(
                    np.float32) if self.cfg.optim.random_background
                    else self.bg)
                bg = torch.as_tensor(bg, device=self.device)
            self.state, losses, aux = self.step_fn(
                self.state, cams, bg, self._lr_xyz(), self._sh_degree(),
                self._gates(), self.nets)
            self._post_step_actions()
            self._debug_check(losses)
        return losses, aux

    def train(self, max_iters: int | None = None, log_every: int = 50):
        """Run iterations up to ``max_iters`` (default: the recipe's) with
        their host actions, sweeps and saves. Returns the history: one
        record of floats per iteration."""
        max_iters = int(max_iters or self.cfg.optim.iterations)
        final_it = int(self.cfg.optim.iterations)
        t = self.cfg.train
        self._t0 = time.time()
        pending = []
        while self.iteration < max_iters:
            with tracing.span("train.gui"):
                self._gui_pump()
            losses, _ = self.train_step()
            pending.append((self.iteration, losses,
                            self.state.active.sum()))
            it = self.iteration
            if it % log_every == 0 or it == max_iters:
                self._flush(pending, max_iters)
            final = it == final_it
            # rank 0 alone sweeps and writes; the others wait for it
            if final or it in list(t.test_iterations):
                self._flush(pending, max_iters)
                self._on_main(self.run_test)
            if final or it in list(t.save_iterations):
                self._on_main(self.save)
            if it in list(t.checkpoint_iterations):
                self._on_main(self.save_checkpoint)
            if final and list(self.cfg.optim.prune.iterations):
                self._on_main(self.save_importance)
        self._flush(pending, max_iters)
        return self.history

    def _flush(self, pending: list, max_iters: int) -> None:
        """Fetch the pending per-step losses in one transfer and log the
        last of them."""
        if not pending:
            return
        names = list(pending[0][1])
        vals = torch.stack([torch.stack([ls[k] for k in names]
                                        + [n.to(torch.float32)])
                            for _, ls, n in pending]).tolist()
        for (it, _, _), row in zip(pending, vals):
            rec = dict(zip(names, row))
            rec.update(iter=it, n_active=int(row[-1]))
            self.history.append(rec)
        pending.clear()
        rec = self.history[-1]
        self._log_scalars({**rec, "time": time.time() - self._t0})
        self._print(f"[{rec['iter']}/{max_iters}] loss={rec['total']:.4f} "
                    f"n_active={rec['n_active']}")

    def _log_scalars(self, rec: dict) -> None:
        """``train/<name>`` of each float of a history record."""
        if self._tb is not None:
            for k, v in rec.items():
                if isinstance(v, float):
                    self._tb.scalar(f"train/{k}", v, rec["iter"])

    def finalize(self) -> None:
        """Flush and close the metric writers."""
        if self._tb is not None:
            self._tb.finish()

    # -- viewer -------------------------------------------------------------

    def _gui_pump(self) -> None:
        """Serve the viewer's pending requests: each request with a camera
        gets one frame (``gui_frame``). A ``train: false`` request pauses
        training: the pump keeps polling across empty polls until a
        ``train: true`` request arrives or the viewer disconnects."""
        if self._gui is None:
            return
        while True:
            req = self._gui.poll()
            if req is None:
                if not self._gui_paused or self._gui.conn is None:
                    return
                time.sleep(0.01)
                continue
            self._gui_paused = not req.do_training and req.keep_alive
            if req.camera is not None:
                self._gui.send_image(
                    self.gui_frame(req.camera, req.scaling_modifier),
                    self.cfg.model.source_path)
            if req.do_training:
                return
            time.sleep(0.01)

    def gui_frame(self, cam: CameraArrays,
                  scaling_modifier: float = 1.0) -> torch.Tensor:
        """The viewer's (3,H,W) frame of ``cam`` at its size: no semantic
        channels or normals, a zero background, the model's full SH degree
        (exact during the warmup: the degrees not yet trained have zero
        coefficients), and the scaling modifier folded into the log-scales
        as log(max(sm, 1e-6)), as the JAX package does, not into
        ``RenderConfig.scale_modifier``. One forward kernel launch, no
        autograd graph."""
        h, w = cam.image.shape[1:]
        rcfg = self._gui_rcfgs.get((w, h))
        if rcfg is None:
            rcfg = self._gui_rcfgs[(w, h)] = self.rcfg._replace(
                width=w, height=h, ch_sem=0, return_normal=False)
        log_sm = torch.log(torch.clamp_min(torch.tensor(
            scaling_modifier, dtype=torch.float32), 1e-6)).to(self.device)
        p = self.state.params
        state = self.state.replace(params=dataclasses.replace(
            p, log_scale=p.log_scale + log_sm))
        with torch.no_grad():
            out = render(state, cam, rcfg,
                         torch.zeros(3, device=self.device),
                         int(self.cfg.model.sh_degree),
                         scene_extent=float(self.extent))
        return out["render"]

    # -- host actions -------------------------------------------------------

    def _post_step_actions(self) -> None:
        """The host actions of this iteration. Every rank runs them on its
        identical state; after an action that changes the population, rank
        0's state is broadcast, so that the float atomics of the stats
        kernel cannot set the ranks apart."""
        o = self.cfg.optim
        it = self.iteration
        if it < o.densify_until_iter:
            if it > o.densify_from_iter and it % o.densification_interval == 0:
                self.densify(20 if it > o.opacity_reset_interval else None)
                DP.replicate(self.state)
            if it % o.opacity_reset_interval == 0 or (
                    self.cfg.model.white_background
                    and it == o.densify_from_iter):
                self.state = GM.reset_opacity(self.state)
                self._log_action("reset opacity")
        if it in list(o.prune.iterations):
            self.light_gaussian_prune(list(o.prune.iterations).index(it))
            DP.replicate(self.state)

    def _log_action(self, action: str, n_before: int | None = None,
                    **more) -> None:
        n = self.state.num_active
        self.host_log.append({"iter": self.iteration, "action": action,
                              "n_before": n if n_before is None else n_before,
                              "n_after": n, **more})

    def densify(self, max_screen_size: float | None) -> None:
        """Clone, split (with the box mask) and prune, then grow the
        capacity if the PREVIOUS densify dropped children, as the JAX
        package does: it reads each densify's drop count one event late and
        discards the count in flight when it grows, so both packages grow
        at the same iterations."""
        o = self.cfg.optim
        n_before = self.state.num_active
        with tracing.span("train.densify"):
            box_mask = self._box_densify_mask()
            prev = self._pending_dropped
            self.state, dropped = GM.densify_and_prune(
                self.state, grad_threshold=float(o.densify_grad_threshold),
                min_opacity=0.005, scene_extent=self.extent,
                max_screen_size=max_screen_size,
                percent_dense=float(o.percent_dense), box_mask=box_mask)
            self._pending_dropped = dropped
            if prev:
                self._grow_capacity(prev)
                self._pending_dropped = None
        self._log_action("densify", n_before, dropped=dropped,
                         capacity=self.state.capacity)

    def _stats_sweep(self, cams: list[CameraArrays],
                     rcfg: RenderConfig | None = None):
        """Per-Gaussian (count, importance) summed over the views, rendered
        at ``rcfg`` (default: the training views')."""
        rcfg = self.rcfg if rcfg is None else rcfg
        count = torch.zeros(self.state.capacity, device=self.device)
        imp = torch.zeros_like(count)
        with tracing.span("train.stats_sweep"):
            for cam in cams:
                c, i = render_stats(self.state, cam, rcfg)
                count += c
                imp += i
        return count, imp

    def _full_stats_cams(self) -> list[CameraArrays]:
        """Every train and test view, geometry only."""
        return [c.arrays(self.device, pixels=False) for c in
                list(self.scene.train_cameras) + list(self.scene.test_cameras)]

    def get_visi_mask_acc(self, n: int, up: bool,
                          around: bool) -> torch.Tensor:
        """The active Gaussians inside the box that n views see (hit counts
        of the stats sweep). With ``sample_cams.random`` the views are
        cameras on the box (``sample_box_cameras``, ``tpu.visi_resolution``
        pixels square, default 512, seeded by the iteration: the trainer's
        generator draws nothing); else training views drawn from the
        trainer's generator."""
        if getattr(self.cfg.optim.densify_large.sample_cams, "random", True):
            size = int(getattr(self.cfg.tpu, "visi_resolution", 512))
            views = sample_box_cameras(
                n, self.trans, self.scale, up=up, around=around,
                sample_mode="random", size=size, seed=self.iteration,
                device=self.device)
            rcfg = self.rcfg._replace(width=size, height=size, ch_sem=0)
        else:
            cams = self.scene.train_cameras
            views = [cams[self.rng.randint(0, len(cams) - 1)].arrays(
                self.device, pixels=False) for _ in range(n)]
            rcfg = self.rcfg
        count, _ = self._stats_sweep(views, rcfg)
        inside, _ = M.get_inside_normalized(self.state.params.xyz, self.trans,
                                            self.scale)
        return (count > 0) & inside

    def _box_densify_mask(self) -> torch.Tensor | None:
        """Large visible Gaussians inside the box, force-split whatever
        their gradient (the densify_large gate)."""
        dl = self._box_cameras()
        if dl is None:
            return None
        sc = dl.sample_cams
        visi = self.get_visi_mask_acc(int(sc.num), bool(sc.up),
                                      bool(sc.around))
        large = torch.amax(self.state.scaling, dim=-1) > (
            float(dl.percent_dense) * self.extent)
        return visi & large

    def light_gaussian_prune(self, prune_round: int) -> None:
        """Importance over every train and test view, volume-reweighted;
        the lowest decay^round x percent of the population goes."""
        o = self.cfg.optim.prune
        n_before = self.state.num_active
        with tracing.span("train.prune"):
            _, imp = self._stats_sweep(self._full_stats_cams())
            v = GM.v_imp_score(self.state, imp, float(o.v_pow))
            self.state = GM.prune_by_importance(
                self.state, v, (o.decay ** prune_round) * o.percent)
        self._log_action("prune", n_before)

    def _grow_capacity(self, dropped: int) -> None:
        """Densify dropped children: double the capacity, bounded by
        ``model.max_mem`` GiB of parameters and moments."""
        cap = self.state.capacity
        bytes_per = 4 * 3 * (3 + 3 + 3 * ((self.cfg.model.sh_degree + 1) ** 2
                                          - 1) + 3 + 4 + 1 + self.rcfg.ch_sem
                             + 3)
        new_cap = cap * 2
        if new_cap * bytes_per > self.cfg.model.max_mem * (1 << 30):
            self._print(f"[capacity] at max_mem cap ({cap}); densify drops "
                        f"{dropped} splats")
            return
        self._print(f"[capacity] {cap} -> {new_cap} (densify dropped "
                    f"{dropped})")
        self.state = GM.expand_capacity(self.state, new_cap)

    # -- outputs ------------------------------------------------------------

    def run_test(self) -> dict:
        """PSNR/L1 (and mIoU with the semantic head) over the train and
        test splits, each capped at ``tpu.eval_max_cams`` views (0 = all),
        the panels of the first train view under ``<logdir>/vis``, and the
        writer's scalars, panels (the first view of each split) and opacity
        histogram, under the JAX package's tags."""
        cap = int(getattr(self.cfg.tpu, "eval_max_cams", 0) or 0)
        res = {"train": self.evaluate(max_cams=cap)}
        test_cams = self.scene.test_cameras
        if test_cams:
            res["test"] = self.evaluate(test_cams, max_cams=cap)
        num_cls = self.num_cls if self.ch_sem else 0
        splits = {"train": self.scene.train_cameras[0]}
        if test_cams and self._tb is not None:
            splits["test"] = test_cams[0]
        for mode, view in splits.items():
            cam = view.arrays(self.device)
            with torch.no_grad():
                out = render(self.state, cam, self.rcfg,
                             torch.as_tensor(self.bg, device=self.device),
                             self._sh_degree(), scene_extent=self.extent,
                             classifier=self.nets.cls)
            host = {k: out[k].cpu().numpy() for k in PANEL_KEYS if k in out}
            if mode == "train":
                VZ.save_panels(os.path.join(self.cfg.logdir, "vis"),
                               f"iter_{self.iteration:06d}", host,
                               cam.image.cpu().numpy(), num_cls=num_cls)
            if self._tb is not None:
                panels = VZ.panel_images(
                    host, gt_image=cam.image.cpu().numpy(),
                    gt_normal=(cam.normal.cpu().numpy()
                               if bool(cam.has_normal) else None),
                    exp_t=float(self.cfg.optim.exp_t), num_cls=num_cls,
                    gt_mask=(cam.mask.cpu().numpy() if bool(cam.has_mask)
                             else None))
                for suffix, arr in panels.items():
                    tag = f"vis/{mode}" + (f"_{suffix}" if suffix else "")
                    self._tb.image(tag, arr, self.iteration)
        print(f"[ITER {self.iteration}] " + "  ".join(
            f"{k}: psnr={v['psnr']:.2f} l1={v['l1']:.4f}"
            + (f" miou={v['miou']:.3f}" if "miou" in v else "")
            for k, v in res.items()), flush=True)
        if self._tb is not None:
            for split, v in res.items():
                for name in ("psnr", "l1", "miou"):
                    if name in v:
                        self._tb.scalar(f"eval/{split}_{name}", v[name],
                                        self.iteration)
            self._tb.scalar("scene/total_points",
                            float(self.state.num_active), self.iteration)
            act = self.state.active
            self._tb.histogram("scene/opacity_histogram",
                               self.state.opacity[act, 0].cpu().numpy(),
                               self.iteration)
        self.test_history.append({"iter": self.iteration, **res})
        return res

    @torch.no_grad()
    def evaluate(self, cameras=None, max_cams: int = 0) -> dict:
        """Mean PSNR and L1 of the clipped renders over a camera list, and
        with the semantic head the mIoU: a confusion matrix of
        argmax(logits) against clip(mask, 0, num_cls - 1) summed over the
        cameras that have a mask, its IoU averaged over the classes
        present."""
        cams = cameras if cameras is not None else self.scene.train_cameras
        if max_cams:
            cams = cams[:max_cams]
        bg = torch.as_tensor(self.bg, device=self.device)
        with_cls = self.nets.cls is not None
        n = self.num_cls
        conf = torch.zeros(n * n, dtype=torch.int64, device=self.device)
        psnr, l1 = [], []
        for cam in cams:
            arr = cam.arrays(self.device)
            out = render(self.state, arr, self.rcfg, bg, self._sh_degree(),
                         scene_extent=self.extent, classifier=self.nets.cls)
            img = torch.clamp(out["render"], 0.0, 1.0)
            mse = torch.mean((img - arr.image) ** 2)
            psnr.append(-10.0 * torch.log10(mse + 1e-12))
            l1.append(L.l1_loss(img, arr.image))
            if with_cls and bool(arr.has_mask):
                pred = torch.argmax(out["render_sem"], dim=0)
                gt = torch.clamp(arr.mask.to(torch.int64), 0, n - 1)
                conf += torch.bincount((gt * n + pred).ravel(),
                                       minlength=n * n)
        psnr, l1 = torch.stack(psnr).tolist(), torch.stack(l1).tolist()
        res = {"psnr": float(np.mean(psnr)), "l1": float(np.mean(l1))}
        if with_cls:
            conf = conf.cpu().numpy().reshape(n, n)
            if conf.sum() > 0:
                inter = np.diag(conf).astype(np.float64)
                union = conf.sum(0) + conf.sum(1) - np.diag(conf)
                present = union > 0
                res["miou"] = float((inter[present] / union[present]).mean())
        return res

    def save(self) -> str:
        """``<logdir>/point_cloud/iteration_<it>/``: the PLY of the active
        slots, the PLY of those inside the box with their normals, and the
        .splat export when ``train.save_splat``. Returns the PLY's path."""
        out = os.path.join(self.cfg.logdir, "point_cloud",
                           f"iteration_{self.iteration}")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, "point_cloud.ply")
        ply_io.save_gaussian_ply(self.state, path)
        inside, _ = M.get_inside_normalized(self.state.params.xyz, self.trans,
                                            self.scale)
        ply_io.save_inside_ply(self.state,
                               os.path.join(out, "point_cloud_inside.ply"),
                               inside.cpu().numpy())
        if bool(getattr(self.cfg.train, "save_splat", False)):
            ply_io.save_splat(self.state, os.path.join(out, "pcd.splat"))
        side = self.nets.save_model()
        if side:
            # the JAX package's model.pkl: plain dicts and tuples of numpy
            with open(os.path.join(out, "model.pkl"), "wb") as f:
                pickle.dump(side, f)
        return path

    def save_importance(self) -> str:
        """The final volume-reweighted importance over every train and test
        view, ``<logdir>/imp_score.npz``."""
        _, imp = self._stats_sweep(self._full_stats_cams())
        v = GM.v_imp_score(self.state, imp, float(self.cfg.optim.prune.v_pow))
        path = os.path.join(self.cfg.logdir, "imp_score.npz")
        np.savez(path, v.cpu().numpy())
        return path

    def save_checkpoint(self) -> str:
        """``<logdir>/chkpnt<it>.npz``: the Gaussian state, and the side
        networks with their Adam states (None where absent) as plain numpy
        in the flax layout. Either package reads a checkpoint without side
        networks; the JAX package does not read the port's side networks."""
        path = os.path.join(self.cfg.logdir, f"chkpnt{self.iteration}.npz")
        ply_io.save_checkpoint(path, self.state, self.iteration,
                               extra={"net": self.nets.state_dict()})
        return path

    def restore_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint of either package, side networks
        included."""
        state, it, extra = ply_io.load_checkpoint(path, self.device)
        net = extra.get("net") or {}
        if any(v is not None for v in net.values()):
            self.nets.load_state_dict(net)
        self.state, self.iteration = state, it


# the render outputs the panels read
PANEL_KEYS = ("render", "depth", "alpha", "normal", "est_normal",
              "render_sem", "distortion", "depth_var")


class _TB:
    """TensorBoard through ``torch.utils.tensorboard`` under
    ``<logdir>/tb``."""

    def __init__(self, logdir: str):
        from torch.utils.tensorboard import SummaryWriter
        self._w = SummaryWriter(os.path.join(logdir, "tb"))

    def scalar(self, tag, value, step):
        self._w.add_scalar(tag, value, step)

    def histogram(self, tag, values, step):
        self._w.add_histogram(tag, np.asarray(values), step)

    def image(self, tag, arr_hwc, step):
        self._w.add_image(tag, np.asarray(arr_hwc), step, dataformats="HWC")

    def finish(self):
        self._w.close()


class _Wandb:
    """wandb with the run named after the logdir and resumed through
    ``<logdir>/wandb_id.txt``, as the JAX package's writer."""

    def __init__(self, logdir: str):
        import wandb
        self._wandb = wandb
        id_file = os.path.join(logdir, "wandb_id.txt")
        if os.path.exists(id_file):
            with open(id_file) as f:
                run_id = f.read().strip()
            resume = "must"
        else:
            run_id = wandb.util.generate_id()
            with open(id_file, "w") as f:
                f.write(run_id)
            resume = "allow"
        parts = os.path.normpath(logdir).split(os.sep)
        wandb.init(project=os.environ.get("WANDB_PROJECT", "vcr_gaus_tpu"),
                   group=parts[-2] if len(parts) > 1 else None,
                   name=parts[-1], id=run_id, resume=resume, dir=logdir)

    def scalar(self, tag, value, step):
        self._wandb.log({tag: value}, step=step)

    def histogram(self, tag, values, step):
        self._wandb.log({tag: self._wandb.Histogram(np.asarray(values))},
                        step=step)

    def image(self, tag, arr_hwc, step):
        self._wandb.log({tag: self._wandb.Image(np.asarray(arr_hwc))},
                        step=step)

    def finish(self):
        self._wandb.finish()


class _Multi:
    """Several writers as one."""

    def __init__(self, writers: list):
        self.writers = writers

    def scalar(self, tag, value, step):
        for w in self.writers:
            w.scalar(tag, value, step)

    def histogram(self, tag, values, step):
        for w in self.writers:
            w.histogram(tag, values, step)

    def image(self, tag, arr_hwc, step):
        for w in self.writers:
            w.image(tag, arr_hwc, step)

    def finish(self):
        for w in self.writers:
            w.finish()


def make_writer(logdir: str):
    """The metric writers the environment asks for: wandb with
    ``VCR_WANDB=1``, TensorBoard with ``VCR_TB=1``; each is skipped with a
    printed line when it cannot start (its package absent). None when
    there is none."""
    writers = []
    if os.environ.get("VCR_WANDB", "0") == "1":
        try:
            writers.append(_Wandb(logdir))
        except Exception as e:   # a writer is no part of the training path
            print(f"[wandb] disabled: {e}", flush=True)
    if os.environ.get("VCR_TB", "0") == "1":
        try:
            writers.append(_TB(logdir))
        except ImportError as e:
            print(f"[tensorboard] disabled: {e}", flush=True)
    if not writers:
        return None
    return writers[0] if len(writers) == 1 else _Multi(writers)
