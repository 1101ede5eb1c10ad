"""Training: the step and the host loop (vcr_gaus_tpu/train/trainer.py).

One step renders a camera, assembles the recipe's losses, takes the
gradient of the total over the parameters and the densify dummy, masks it
to the active slots, runs Adam with the per-group learning rates and adds
the densification statistics. ``Trainer`` loads the scene, initializes the
state from its point cloud (or a checkpoint) and runs the schedule: steps in
the JAX package's camera order, then the host actions of each iteration
(densify with the box-guided split, opacity reset, capacity growth, the
LightGaussian prune), the test sweeps with their panels, the PLY and
checkpoint saves and the final importance dump. The stats sweeps behind the
box mask and the prune run the stats kernel once per view.

The random box cameras (``densify_large.sample_cams.random: true``) come
with a later slice of the port: ``train`` raises NotImplementedError before
an iteration that would densify with them. The learning-rate schedule, the
SH degree warmup and the loss gates follow the iteration as in the JAX
package. The JAX package's entry budget, overflow handling, supersteps
(``tpu.steps_per_call``), binning lookahead and camera cache exist for its
static shapes on the TPU and have no counterpart here; the camera order
is that of its single-step path (``tpu.steps_per_call: 1``).
"""

from __future__ import annotations

import json
import math
import os
import random
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..compat.arguments import write_cfg_args
from ..data.cameras import CameraArrays
from ..data.scene import camera_to_json, load_scene_info
from ..models import gaussians as GM
from ..models import ply_io
from ..render.renderer import RenderConfig, render, render_stats
from ..utils import math as M
from ..utils.device import resolve_device
from . import losses as L
from . import visualization as VZ

# losses this slice computes, and the slice that brings each other one
PORTED_LOSSES = ("l1", "ssim", "l1_scale", "mono_normal", "depth_normal",
                 "consistent_normal", "distortion", "depth_var")
LATER_LOSSES = {"entropy": "slice C", "mono_depth": "slice C",
                "curv": "slice C", "semantic": "slice E"}


class Gates(NamedTuple):
    """Loss gates by iteration (the *_from_iter thresholds)."""
    mono_normal: bool
    depth_normal: bool
    curv: bool
    consistent_normal: bool
    close_depth: bool


def recipe_weights(cfg) -> dict[str, float]:
    """The recipe's positive loss weights; raises for a loss or network
    that a later slice of the port brings."""
    w = {k: float(v) for k, v in cfg.optim.loss_weight.items()
         if float(v) > 0}
    for name in w:
        if name not in PORTED_LOSSES:
            raise NotImplementedError(
                f"loss '{name}' comes with "
                f"{LATER_LOSSES.get(name, 'a later slice')} of the port")
    if cfg.model.use_decoupled_appearance:
        raise NotImplementedError(
            "the decoupled appearance network comes with slice E of the port")
    return w


def compute_losses(out: dict, cam: CameraArrays, state: GM.GaussianState,
                   weights: dict, gates: Gates, cfg,
                   inside_mask: torch.Tensor):
    """(total, {name: loss}) of the recipe, as the JAX compute_losses."""
    losses = {}
    gt = cam.image
    losses["l1"] = L.l1_loss(out["render"], gt)
    losses["ssim"] = 1.0 - L.ssim(out["render"], gt)
    if weights.get("l1_scale", 0) > 0:
        # amin splits the gradient among tied axes, as jnp.min does
        min_scale = torch.amin(state.scaling, -1)
        m = (state.active & inside_mask).to(torch.float32)
        losses["l1_scale"] = (torch.sum(min_scale * m)
                              / torch.clamp_min(m.sum(), 1.0))
    gt_normal = cam.normal.permute(1, 2, 0)                    # (H,W,3)
    if weights.get("mono_normal", 0) > 0 and gates.mono_normal:
        losses["mono_normal"] = L.monosdf_normal_loss(out["normal"],
                                                      gt_normal)
    if weights.get("depth_normal", 0) > 0 and gates.depth_normal:
        w_conf = L.cos_weight(out["normal"].detach(), gt_normal,
                              cfg.optim.exp_t)
        losses["depth_normal"] = L.masked_monosdf_normal_loss(
            out["est_normal"], gt_normal, out["mask"], w_conf)
    if weights.get("consistent_normal", 0) > 0 and gates.consistent_normal:
        losses["consistent_normal"] = L.monosdf_normal_loss(
            out["est_normal"], out["normal"])
    if weights.get("distortion", 0) > 0 and gates.close_depth:
        losses["distortion"] = L.edge_aware_distortion_map(
            gt, out["distortion"]).mean()
    if weights.get("depth_var", 0) > 0 and gates.close_depth:
        losses["depth_var"] = L.edge_aware_distortion_map(
            gt, out["depth_var"]).mean()
    total = torch.zeros((), device=gt.device)
    for name, w in weights.items():
        if name in losses:
            total = total + w * losses[name]
    losses["total"] = total
    return total, losses


def make_train_step(cfg, rcfg: RenderConfig, weights: dict,
                    scene_extent: float, trans, scale):
    """The step for one camera:
    step(state, cam, bg, lr_xyz, sh_degree, gates) -> (state, losses, aux).
    The state passed in is not modified."""
    o = cfg.optim
    ndc_scale = (0.5 * rcfg.width, 0.5 * rcfg.height)

    def step(state: GM.GaussianState, cam: CameraArrays, bg: torch.Tensor,
             lr_xyz: float, sh_degree: int, gates: Gates):
        inside_mask, _ = M.get_inside_normalized(state.params.xyz, trans,
                                                 scale)
        params = state.params.map(lambda p: p.detach().requires_grad_(True))
        dummy = torch.zeros((state.capacity, 2), device=state.active.device,
                            requires_grad=True)
        st = state.replace(params=params)
        out = render(st, cam, rcfg, bg, sh_degree, scene_extent=scene_extent,
                     densify_dummy=dummy)
        with record_function("train.losses"):
            total, losses = compute_losses(out, cam, st, weights, gates, cfg,
                                           inside_mask)
        leaves = list(params.as_dict().values()) + [dummy]
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        g_params = GM.GaussianParams(*grads[:-1])
        with record_function("train.adam"), torch.no_grad():
            g_params = GM.mask_grads(g_params, state.active)
            lrs = GM.LearningRates(
                xyz=lr_xyz, f_dc=o.feature_lr, f_rest=o.feature_lr / 20.0,
                opacity=o.opacity_lr, scaling=o.scaling_lr,
                rotation=o.rotation_lr, obj_dc=o.feature_lr)
            new_state = GM.adam_step(state, g_params, lrs)
            # the kernel's stream is in pixels; the reference reports mean2D
            # grads through the ndc2Pix jacobian (0.5 W, 0.5 H), and the
            # densify threshold is in those units
            g_dummy = grads[-1] * grads[-1].new_tensor(ndc_scale)
            new_state = GM.add_densification_stats(
                new_state, g_dummy, out["radii"], out["visibility_filter"])
        aux = {"num_entries": out["num_entries"]}
        return new_state, {k: v.detach() for k, v in losses.items()}, aux

    return step


# the JAX package's side-network state, saved as None in checkpoints
NET_FIELDS = ("app_embeddings", "app_params", "app_opt", "cls_params",
              "cls_opt")


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

        pts = info.points.astype(np.float32)
        cols = info.colors.astype(np.float32)
        max_init = getattr(cfg.model, "max_init_points", None)
        cap = int(cfg.tpu.capacity) or _auto_capacity(len(pts))
        limit = min(x for x in (max_init, cap) if x)
        if len(pts) > limit:
            print(f"subsampling init cloud {len(pts)} -> {limit}")
            sel = np.random.default_rng(cfg.seed).choice(
                len(pts), limit, replace=False)
            pts, cols = pts[sel], cols[sel]
        self.state = GM.create_from_pcd(pts, cols, cap, cfg.model.sh_degree,
                                        0, device=self.device)
        cam0 = info.train_cameras[0]
        self.rcfg = RenderConfig(
            width=cam0.width, height=cam0.height,
            depth_mode=cfg.model.depth_type,
            mask_depth_thr=float(cfg.optim.mask_depth_thr))
        self.step_fn = make_train_step(cfg, self.rcfg, w, self.extent,
                                       self.trans, self.scale)
        self.iteration = 0
        self.viewpoint_stack: list[int] = []
        self.bg = np.array([1, 1, 1] if cfg.model.white_background
                           else [0, 0, 0], np.float32)
        self.rng = random.Random(cfg.seed)
        self._next_idx: int | None = None   # the one-step camera lookahead
        self._pending_dropped: int | None = None
        self.history: list[dict] = []
        self.test_history: list[dict] = []
        # one record per host action: iteration, action, population before
        # and after
        self.host_log: list[dict] = []
        os.makedirs(cfg.logdir, exist_ok=True)
        # the run metadata downstream tools reload
        with open(os.path.join(cfg.logdir, "cameras.json"), "w") as f:
            json.dump([camera_to_json(i, c) for i, c in enumerate(
                info.train_cameras + info.test_cameras)], f)
        write_cfg_args(cfg, cfg.logdir)
        start_ckpt = getattr(cfg.train, "start_checkpoint", None)
        if start_ckpt:
            self.restore_checkpoint(start_ckpt)
            print(f"resumed from {start_ckpt} at iteration {self.iteration}",
                  flush=True)

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

    def _pick_camera_index(self) -> int:
        """This step's camera. The next one's index is drawn now, before
        the step and its host actions, as the JAX package's one-slot camera
        prefetch draws it; the densify's draws from the same generator
        follow it."""
        if self._next_idx is None:
            self._next_idx = self._next_camera_index()
        idx, self._next_idx = self._next_idx, self._next_camera_index()
        return idx

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
        self.iteration += 1
        cam = self.scene.train_cameras[self._pick_camera_index()].arrays(
            self.device)
        bg = (np.random.default_rng(self.iteration).random(3).astype(
            np.float32) if self.cfg.optim.random_background else self.bg)
        self.state, losses, aux = self.step_fn(
            self.state, cam, torch.as_tensor(bg, device=self.device),
            self._lr_xyz(), self._sh_degree(), self._gates())
        self._post_step_actions()
        return losses, aux

    def train(self, max_iters: int | None = None, log_every: int = 50):
        """Run iterations up to ``max_iters`` (default: the recipe's) with
        their host actions, sweeps and saves. Returns the history: one
        record of floats per iteration."""
        max_iters = int(max_iters or self.cfg.optim.iterations)
        final_it = int(self.cfg.optim.iterations)
        t = self.cfg.train
        pending = []
        while self.iteration < max_iters:
            dl = self._box_cameras()
            if (dl is not None and getattr(dl.sample_cams, "random", True)
                    and "densify" in self.host_actions(self.iteration + 1)):
                self._flush(pending, max_iters)
                raise NotImplementedError(
                    f"iteration {self.iteration + 1} would densify with "
                    "random box cameras (densify_large.sample_cams.random): "
                    "they come with a later slice of the port")
            losses, _ = self.train_step()
            pending.append((self.iteration, losses,
                            self.state.active.sum()))
            it = self.iteration
            if it % log_every == 0 or it == max_iters:
                self._flush(pending, max_iters)
            final = it == final_it
            if final or it in list(t.test_iterations):
                self._flush(pending, max_iters)
                self.run_test()
            if final or it in list(t.save_iterations):
                self.save()
            if it in list(t.checkpoint_iterations):
                self.save_checkpoint()
            if final and list(self.cfg.optim.prune.iterations):
                self.save_importance()
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
        print(f"[{rec['iter']}/{max_iters}] loss={rec['total']:.4f} "
              f"n_active={rec['n_active']}", flush=True)

    # -- host actions -------------------------------------------------------

    def _post_step_actions(self) -> None:
        o = self.cfg.optim
        it = self.iteration
        if it < o.densify_until_iter:
            if it > o.densify_from_iter and it % o.densification_interval == 0:
                self.densify(20 if it > o.opacity_reset_interval else None)
            if it % o.opacity_reset_interval == 0 or (
                    self.cfg.model.white_background
                    and it == o.densify_from_iter):
                with record_function("train.reset_opacity"):
                    self.state = GM.reset_opacity(self.state)
                self._log_action("reset opacity")
        if it in list(o.prune.iterations):
            self.light_gaussian_prune(list(o.prune.iterations).index(it))

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
        with record_function("train.densify"):
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

    def _stats_sweep(self, cams: list[CameraArrays]):
        """Per-Gaussian (count, importance) summed over the views."""
        count = torch.zeros(self.state.capacity, device=self.device)
        imp = torch.zeros_like(count)
        with record_function("train.stats_sweep"):
            for cam in cams:
                c, i = render_stats(self.state, cam, self.rcfg)
                count += c
                imp += i
        return count, imp

    def _full_stats_cams(self) -> list[CameraArrays]:
        """Every train and test view, geometry only."""
        return [c.arrays(self.device, pixels=False) for c in
                list(self.scene.train_cameras) + list(self.scene.test_cameras)]

    def get_visi_mask_acc(self, n: int) -> torch.Tensor:
        """The active Gaussians inside the box that n training views drawn
        from the trainer's generator see: hit counts of the stats sweep."""
        if getattr(self.cfg.optim.densify_large.sample_cams, "random", True):
            raise NotImplementedError(
                "the random box cameras (densify_large.sample_cams.random) "
                "come with a later slice of the port")
        cams = self.scene.train_cameras
        views = [cams[self.rng.randint(0, len(cams) - 1)].arrays(
            self.device, pixels=False) for _ in range(n)]
        count, _ = self._stats_sweep(views)
        inside, _ = M.get_inside_normalized(self.state.params.xyz, self.trans,
                                            self.scale)
        return (count > 0) & inside

    def _box_densify_mask(self) -> torch.Tensor | None:
        """Large visible Gaussians inside the box, force-split whatever
        their gradient (the densify_large gate)."""
        dl = self._box_cameras()
        if dl is None:
            return None
        visi = self.get_visi_mask_acc(int(dl.sample_cams.num))
        large = torch.amax(self.state.scaling, dim=-1) > (
            float(dl.percent_dense) * self.extent)
        return visi & large

    def light_gaussian_prune(self, prune_round: int) -> None:
        """Importance over every train and test view, volume-reweighted;
        the lowest decay^round x percent of the population goes."""
        o = self.cfg.optim.prune
        n_before = self.state.num_active
        with record_function("train.prune"):
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
            print(f"[capacity] at max_mem cap ({cap}); densify drops "
                  f"{dropped} splats", flush=True)
            return
        print(f"[capacity] {cap} -> {new_cap} (densify dropped {dropped})",
              flush=True)
        self.state = GM.expand_capacity(self.state, new_cap)

    # -- outputs ------------------------------------------------------------

    def run_test(self) -> dict:
        """PSNR/L1 over the train and test splits, each capped at
        ``tpu.eval_max_cams`` views (0 = all), and the panels of the first
        train view under ``<logdir>/vis``."""
        cap = int(getattr(self.cfg.tpu, "eval_max_cams", 0) or 0)
        res = {"train": self.evaluate(max_cams=cap)}
        if self.scene.test_cameras:
            res["test"] = self.evaluate(self.scene.test_cameras, max_cams=cap)
        cam = self.scene.train_cameras[0].arrays(self.device)
        with torch.no_grad():
            out = render(self.state, cam, self.rcfg,
                         torch.as_tensor(self.bg, device=self.device),
                         self._sh_degree(), scene_extent=self.extent)
        host = {k: out[k].cpu().numpy() for k in
                ("render", "depth", "alpha", "normal", "est_normal")}
        VZ.save_panels(os.path.join(self.cfg.logdir, "vis"),
                       f"iter_{self.iteration:06d}", host,
                       cam.image.cpu().numpy())
        print(f"[ITER {self.iteration}] " + "  ".join(
            f"{k}: psnr={v['psnr']:.2f} l1={v['l1']:.4f}"
            for k, v in res.items()), flush=True)
        self.test_history.append({"iter": self.iteration, **res})
        return res

    @torch.no_grad()
    def evaluate(self, cameras=None, max_cams: int = 0) -> dict:
        """Mean PSNR and L1 of the clipped renders over a camera list."""
        cams = cameras if cameras is not None else self.scene.train_cameras
        if max_cams:
            cams = cams[:max_cams]
        bg = torch.as_tensor(self.bg, device=self.device)
        psnr, l1 = [], []
        for cam in cams:
            arr = cam.arrays(self.device)
            img = torch.clamp(render(self.state, arr, self.rcfg, bg,
                                     self._sh_degree(),
                                     scene_extent=self.extent)["render"],
                              0.0, 1.0)
            mse = torch.mean((img - arr.image) ** 2)
            psnr.append(-10.0 * torch.log10(mse + 1e-12))
            l1.append(L.l1_loss(img, arr.image))
        psnr, l1 = torch.stack(psnr).tolist(), torch.stack(l1).tolist()
        return {"psnr": float(np.mean(psnr)), "l1": float(np.mean(l1))}

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
        """``<logdir>/chkpnt<it>.npz``, readable by either package (the side
        networks, which the port does not have, are stored as None)."""
        path = os.path.join(self.cfg.logdir, f"chkpnt{self.iteration}.npz")
        ply_io.save_checkpoint(path, self.state, self.iteration,
                               extra={"net": dict.fromkeys(NET_FIELDS)})
        return path

    def restore_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint of either package."""
        state, it, extra = ply_io.load_checkpoint(path, self.device)
        if any(v is not None for v in (extra.get("net") or {}).values()):
            raise NotImplementedError(
                "the checkpoint holds side networks (appearance, semantic "
                "classifier): they come with slice E of the port")
        self.state, self.iteration = state, it
