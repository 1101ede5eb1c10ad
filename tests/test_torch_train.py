"""The port's training slice against the JAX package on the same numpy
inputs: math helpers, losses, kNN, the Gaussian state and its Adam step,
the normal prior, one whole training step, the Trainer and its CLI.

The JAX side runs as its own tests run it on the CPU (Pallas in interpret
mode); the port runs its plain PyTorch versions on the CPU.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import write_colmap_scene
from test_renderer import make_scene as render_scene
from test_torch_render import port_camera
from vcr_gaus_tpu.config import Config as JConfig
from vcr_gaus_tpu.data.scene import load_scene_info as jload_scene_info
from vcr_gaus_tpu.models import gaussians as JGM
from vcr_gaus_tpu.ops import knn as JK
from vcr_gaus_tpu.render.renderer import RenderConfig as JRenderConfig
from vcr_gaus_tpu.train import losses as JL
from vcr_gaus_tpu.train import trainer as JT
from vcr_gaus_tpu.utils import math as JM
from vcr_gaus_tpu_torch.config import Config
from vcr_gaus_tpu_torch.data.scene import load_scene_info
from vcr_gaus_tpu_torch.models import gaussians as GM
from vcr_gaus_tpu_torch.models.convert import state_from_arrays, state_to_arrays
from vcr_gaus_tpu_torch.ops import knn as K
from vcr_gaus_tpu_torch.render.renderer import RenderConfig
from vcr_gaus_tpu_torch.train import losses as L
from vcr_gaus_tpu_torch.train import trainer as T
from vcr_gaus_tpu_torch.utils import math as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


def jax_state_arrays(js) -> dict:
    """A JAX GaussianState as the port's state_from_arrays dict."""
    def host(p):
        return {k: np.asarray(v) for k, v in p._asdict().items()}
    return dict(params=host(js.params), mu=host(js.adam.mu),
                nu=host(js.adam.nu), step=int(js.adam.step),
                active=np.asarray(js.active),
                max_radii2d=np.asarray(js.max_radii2d),
                grad_accum=np.asarray(js.grad_accum),
                denom=np.asarray(js.denom),
                active_sh_degree=int(js.active_sh_degree))


def assert_state_close(port, js, atol=1e-6, rtol=1e-6):
    got = state_to_arrays(port)
    want = jax_state_arrays(js)
    for group in ("params", "mu", "nu"):
        for k, v in want[group].items():
            np.testing.assert_allclose(got[group][k], v, atol=atol,
                                       rtol=rtol, err_msg=f"{group}.{k}")
    for k in ("active", "max_radii2d", "grad_accum", "denom"):
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                                   err_msg=k)
    assert got["step"] == want["step"]


# --- utils/math ----------------------------------------------------------------

def test_math_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.01, 0.99, (50, 1)).astype(np.float32)
    np.testing.assert_allclose(M.inverse_sigmoid(t(x)).numpy(),
                               np.asarray(JM.inverse_sigmoid(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    for step in (0, 1, 7, 500, 29999, 30000, 40000):
        for delay in (0, 100):
            want = float(JM.expon_lr(step, 1.6e-4 * 3.3, 1.6e-6 * 3.3,
                                     lr_delay_steps=delay,
                                     lr_delay_mult=0.01, max_steps=30000))
            got = M.expon_lr(step, 1.6e-4 * 3.3, 1.6e-6 * 3.3,
                             lr_delay_steps=delay, lr_delay_mult=0.01,
                             max_steps=30000)
            assert got == pytest.approx(want, rel=1e-6)
    assert M.expon_lr(5, 0.0, 0.0) == 0.0
    xyz = rng.normal(size=(200, 3)).astype(np.float32)
    box = np.eye(4, dtype=np.float32)
    box[:3, :3] = np.asarray(JM.quat_to_rotmat(jnp.asarray(
        np.array([0.9, 0.1, -0.2, 0.3], np.float32))))
    box[:3, 3] = [0.1, -0.2, 0.3]
    for trans, scale in ((np.array([0.1, 0.2, -0.1], np.float32),
                          np.array([1.0, 0.8, 1.2], np.float32)),
                         (box, np.float32(1.1))):
        inside, pts = M.get_inside_normalized(t(xyz), trans, scale)
        j_inside, j_pts = JM.get_inside_normalized(jnp.asarray(xyz), trans,
                                                   scale)
        np.testing.assert_allclose(pts.numpy(), np.asarray(j_pts), atol=1e-6)
        np.testing.assert_array_equal(inside.numpy(), np.asarray(j_inside))
        assert 0 < int(inside.sum()) < 200


# --- losses ---------------------------------------------------------------------

def _loss_inputs(seed=0, h=12, w=15):
    rng = np.random.default_rng(seed)

    def unit(*shape):
        v = rng.normal(size=shape).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    return dict(pred=rng.uniform(size=(3, h, w)).astype(np.float32),
                gt=rng.uniform(size=(3, h, w)).astype(np.float32),
                n_pred=unit(h, w, 3), n_gt=unit(h, w, 3),
                weight=rng.uniform(size=(h, w)).astype(np.float32),
                mask=rng.uniform(size=(h, w)) > 0.4,
                dist=rng.uniform(size=(h, w)).astype(np.float32))


LOSSES = {
    "l1_loss": (lambda m, a: m.l1_loss(a["pred"], a["gt"]), "pred"),
    "monosdf_normal_loss": (lambda m, a: m.monosdf_normal_loss(
        a["n_pred"], a["n_gt"]), "n_pred"),
    "monosdf_normal_loss_weighted": (lambda m, a: m.monosdf_normal_loss(
        a["n_pred"], a["n_gt"], a["weight"]), "n_pred"),
    "masked_monosdf_normal_loss": (lambda m, a: m.masked_monosdf_normal_loss(
        a["n_pred"], a["n_gt"], a["mask"], a["weight"]), "n_pred"),
    "masked_monosdf_empty_mask": (lambda m, a: m.masked_monosdf_normal_loss(
        a["n_pred"], a["n_gt"], a["mask"] & False), "n_pred"),
    "cos_weight": (lambda m, a: m.cos_weight(a["n_pred"], a["n_gt"],
                                             0.01).sum(), None),
    "edge_aware_distortion_map": (lambda m, a: m.edge_aware_distortion_map(
        a["gt"], a["dist"]).mean(), "dist"),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_grad_match_jax(name):
    fn, wrt = LOSSES[name]
    a = _loss_inputs()
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    ta = {k: t(v) for k, v in a.items()}
    if wrt is not None:
        ta[wrt].requires_grad_(True)
    got = fn(L, ta)
    want = fn(JL, ja)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-7)
    if wrt is None:
        return
    want_g = jax.grad(lambda x: fn(JL, {**ja, wrt: x}))(ja[wrt])
    got_g, = torch.autograd.grad(got, ta[wrt])
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-7)


# --- kNN ------------------------------------------------------------------------

def test_knn_exact_matches_jax():
    pts = np.random.default_rng(1).normal(size=(3000, 3)).astype(np.float32)
    got = K.knn_sq_dists(t(pts)).numpy()
    want = np.asarray(JK.knn_sq_dists(jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        K.mean_sq_dist_to_3nn(t(pts)).numpy(),
        np.asarray(JK.mean_sq_dist_to_3nn(jnp.asarray(pts))), rtol=1e-6)
    # fewer points than neighbours
    tiny = pts[:3]
    np.testing.assert_array_equal(
        K.knn_sq_dists(t(tiny)).numpy(),
        np.asarray(JK.knn_sq_dists(jnp.asarray(tiny))))


@pytest.mark.parametrize("rot", [0, 1, 2])
def test_knn_window_pass_matches_jax(rot):
    """The Morton-window pass, forced at small N. The same neighbours are
    found. In the identity frame the distances are equal; in the rotated
    frames the float32 rotation rounds differently (XLA's CPU dot rounds
    column by column in its own order), which moves a squared distance by
    about 1e-7 |p|^2, so those take atol 1e-6 max|p|^2."""
    pts = np.random.default_rng(2).uniform(-1, 1, (2000, 3)).astype(
        np.float32)
    r = K._ROTS[rot]
    got_d, got_i = K._window_pass(t(pts), 3, 32, 512, r)
    want_d, want_i = JK._window_pass(jnp.asarray(pts), 3, 32, 512, r)
    np.testing.assert_array_equal(np.sort(got_i.numpy(), 1),
                                  np.sort(np.asarray(want_i), 1))
    atol = 0.0 if rot == 0 else 1e-6 * float(np.max(np.sum(pts ** 2, 1)))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6,
                               atol=atol)


def test_knn_merged_window_path_matches_jax():
    pts = np.random.default_rng(3).uniform(0, 1, (K.EXACT_MAX_N + 500, 3)
                                           ).astype(np.float32)
    got = K.knn_sq_dists(t(pts)).numpy()
    want = np.asarray(JK.knn_sq_dists(jnp.asarray(pts)))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.max(np.sum(pts ** 2, 1))))


# --- the Gaussian state ------------------------------------------------------------

@pytest.mark.parametrize("ch_sem", [0, 2])
def test_create_from_pcd_matches_jax(ch_sem):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    cols = rng.uniform(size=(300, 3)).astype(np.float32)
    got = GM.create_from_pcd(pts, cols, 384, 3, ch_sem, seed=5, device="cpu")
    want = JGM.create_from_pcd(pts, cols, 384, 3, ch_sem, seed=5)
    assert_state_close(got, want)
    assert got.capacity == 384 and got.num_active == 300
    assert got.active_sh_degree == int(want.active_sh_degree) == 0


def _random_grads(params: dict, rng) -> dict:
    return {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in params.items()}


def test_adam_mask_and_stats_match_jax():
    """The same state and the SAME grads into both packages' mask_grads,
    adam_step (two steps, so the shared bias-correction step moves) and
    add_densification_stats."""
    rng = np.random.default_rng(6)
    js, _ = render_scene(seed=2, ch_sem=2)
    ps = state_from_arrays(jax_state_arrays(js), "cpu")
    lr = dict(f_dc=2.5e-3, f_rest=1.25e-4, opacity=0.05, scaling=5e-3,
              rotation=1e-3, obj_dc=2.5e-3)
    for it in range(2):
        g = _random_grads(jax_state_arrays(js)["params"], rng)
        jg = JGM.mask_grads(JGM.GaussianParams(**{
            k: jnp.asarray(v) for k, v in g.items()}), js.active)
        pg = GM.mask_grads(GM.GaussianParams(**{k: t(v) for k, v in g.items()}),
                           ps.active)
        np.testing.assert_array_equal(pg.xyz.numpy(), np.asarray(jg.xyz))
        js = JGM.adam_step(js, jg, JGM.LearningRates(xyz=jnp.float32(3e-4),
                                                     **lr))
        ps = GM.adam_step(ps, pg, GM.LearningRates(xyz=3e-4, **lr))
        g2d = rng.uniform(0, 2, (js.capacity, 2)).astype(np.float32)
        radii = rng.integers(0, 9, js.capacity).astype(np.int32)
        vis = radii > 2
        js = JGM.add_densification_stats(js, jnp.asarray(g2d),
                                         jnp.asarray(radii), jnp.asarray(vis))
        ps = GM.add_densification_stats(ps, t(g2d), t(radii), t(vis))
    assert ps.adam.step == 2
    assert_state_close(ps, js)
    assert float(ps.denom.max()) == 2.0


def test_state_arrays_round_trip_both_ways():
    js, _ = render_scene(seed=3)
    arrays = jax_state_arrays(js)
    arrays["step"] = 4
    arrays["denom"] = np.arange(js.capacity, dtype=np.float32)
    ps = state_from_arrays(arrays, "cpu")
    back = state_to_arrays(ps)
    rebuilt = JGM.GaussianState(
        params=JGM.GaussianParams(**back["params"]),
        adam=JGM.AdamState(JGM.GaussianParams(**back["mu"]),
                           JGM.GaussianParams(**back["nu"]),
                           jnp.int32(back["step"])),
        active=back["active"], max_radii2d=back["max_radii2d"],
        grad_accum=back["grad_accum"], denom=back["denom"],
        active_sh_degree=jnp.int32(back["active_sh_degree"]))
    assert_state_close(ps, rebuilt, atol=0, rtol=0)
    np.testing.assert_array_equal(back["denom"], arrays["denom"])
    assert back["step"] == 4


# --- the normal prior ------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_train_scene"))
    write_colmap_scene(root, n_cams=6, n_pts=400, width=64, height=48,
                       with_priors=True)
    return root


@pytest.mark.parametrize("data_device", ["host", "lazy"])
def test_normal_prior_read_like_jax(scene_dir, data_device):
    kw = dict(load_normal=True, normal_folder="normals",
              data_device=data_device)
    got = load_scene_info(scene_dir, **kw)
    want = jload_scene_info(scene_dir, **kw)
    assert len(got.train_cameras) == len(want.train_cameras) == 6
    for gc, wc in zip(got.train_cameras, want.train_cameras):
        ga, wa = gc.arrays("cpu"), wc.arrays()
        np.testing.assert_array_equal(ga.normal.numpy(), np.asarray(wa.normal))
        assert bool(ga.has_normal) and bool(wa.has_normal)
        np.testing.assert_array_equal(ga.image.numpy(), np.asarray(wa.image))
    with pytest.raises(NotImplementedError, match="slice C"):
        load_scene_info(scene_dir, load_depth=True)


def test_normal_prior_resized_like_jax(tmp_path):
    """A prior stored (H', W', 3) at another resolution is resized
    bilinearly to the image (the JAX package uses cv2's INTER_LINEAR)."""
    root = str(tmp_path / "scene")
    write_colmap_scene(root, n_cams=2, n_pts=100, width=64, height=48)
    os.makedirs(os.path.join(root, "nrm"))
    rng = np.random.default_rng(7)
    for i in range(2):
        n = rng.normal(size=(24, 32, 3)).astype(np.float32)
        np.savez(os.path.join(root, "nrm", f"img_{i:03d}.npz"), n)
    got = load_scene_info(root, load_normal=True, normal_folder="nrm")
    want = jload_scene_info(root, load_normal=True, normal_folder="nrm")
    for gc, wc in zip(got.train_cameras, want.train_cameras):
        assert gc.normal.shape == wc.normal.shape == (3, 48, 64)
        assert gc.normal.dtype == wc.normal.dtype == np.float16
        np.testing.assert_allclose(gc.normal.astype(np.float32),
                                   wc.normal.astype(np.float32), atol=2e-3)


# --- one training step --------------------------------------------------------------------

def test_train_step_matches_jax():
    """One step of the JAX make_train_step and the port's from the same
    state and camera, reconstruct-recipe weights with depth_normal on.
    Losses at rtol 1e-4; each parameter group's gradient (recovered from
    the first Adam moment: mu = 0.1 g after one step from zero moments) and
    the densify stats at 2e-3 max|g|. The updated parameters are not
    compared: at Adam's first step the update is lr g/|g|, which flips by
    2 lr for a gradient near 0."""
    js, jcam = render_scene(seed=1)
    rng = np.random.default_rng(5)
    nrm = rng.normal(size=(3, jcam.height, jcam.width)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    jcam = dataclasses.replace(jcam, normal=nrm)
    path = os.path.join(REPO, "configs", "reconstruct.yaml")
    jcfg, cfg = JConfig(path), Config(path)
    weights = {k: float(v) for k, v in cfg.optim.loss_weight.items()
               if float(v) > 0}
    assert weights["depth_normal"] > 0 and "semantic" not in weights
    w_, h_ = jcam.width, jcam.height
    trans = np.array([0.0, 0.0, 4.0], np.float32)
    scale = np.array([1.2, 1.2, 1.5], np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jstep = JT.make_train_step(
        jcfg, JRenderConfig(width=w_, height=h_, entry_budget=1 << 14,
                            depth_mode="intersection", mask_depth_thr=0.8),
        weights, 3.0, trans, scale, 0, None, None)
    gates = (True,) * 5
    jnew, _, jlosses, _ = jstep(js, JT.NetState(None, None, None, None, None),
                                jcam.arrays(), jnp.asarray(bg),
                                jnp.float32(1e-3), sh_degree=1,
                                gates=JT.Gates(*gates))
    step = T.make_train_step(
        cfg, RenderConfig(width=w_, height=h_, depth_mode="intersection",
                          mask_depth_thr=0.8),
        weights, 3.0, trans, scale)
    pcam = dataclasses.replace(port_camera(jcam), normal=nrm).arrays("cpu")
    ps = state_from_arrays(jax_state_arrays(js), "cpu")
    pnew, plosses, aux = step(ps, pcam, t(bg), 1e-3, 1, T.Gates(*gates))
    assert set(plosses) == {k for k in jlosses}
    for k, v in jlosses.items():
        assert float(plosses[k]) == pytest.approx(float(v), rel=1e-4,
                                                  abs=1e-7), k
    assert float(plosses["l1_scale"]) > 0 and float(plosses["depth_normal"]) > 0
    for k in state_to_arrays(pnew)["mu"]:
        got = getattr(pnew.adam.mu, k).numpy() / 0.1
        want = np.asarray(getattr(jnew.adam.mu, k)) / 0.1
        if want.size == 0:
            continue
        scale_g = np.abs(want).max()
        assert scale_g > 0, k
        np.testing.assert_allclose(got, want, atol=2e-3 * scale_g, rtol=2e-3,
                                   err_msg=k)
    for k in ("grad_accum", "denom", "max_radii2d"):
        want = np.asarray(getattr(jnew, k))
        np.testing.assert_allclose(getattr(pnew, k).numpy(), want,
                                   atol=2e-3 * np.abs(want).max(), rtol=2e-3,
                                   err_msg=k)
    assert pnew.adam.step == int(jnew.adam.step) == 1
    # the state passed in is left as it was
    np.testing.assert_array_equal(ps.params.xyz.numpy(),
                                  np.asarray(js.params.xyz))
    assert aux["num_entries"] > 0


def test_unported_losses_raise():
    cfg = Config(os.path.join(REPO, "configs", "config_base.yaml"))
    cfg.optim.loss_weight.entropy = 0.1
    with pytest.raises(NotImplementedError, match="slice C"):
        T.recipe_weights(cfg)
    cfg.optim.loss_weight.entropy = 0
    cfg.optim.loss_weight.semantic = 0.1
    with pytest.raises(NotImplementedError, match="slice E"):
        T.recipe_weights(cfg)
    cfg.optim.loss_weight.semantic = 0
    cfg.model.use_decoupled_appearance = True
    with pytest.raises(NotImplementedError, match="slice E"):
        T.recipe_weights(cfg)


# --- the Trainer and the CLI -------------------------------------------------------------------

def _dtu_cfg(scene_dir, logdir, **optim):
    cfg = Config(os.path.join(REPO, "configs", "dtu", "base.yaml"))
    cfg.logdir = str(logdir)
    cfg.model.source_path = scene_dir
    cfg.model.normal_folder = "normals"
    for k, v in optim.items():
        cfg.optim[k] = v
    return cfg


def test_trainer_trains_then_stops_before_densify(scene_dir, tmp_path):
    """The Trainer from its init state through its first densify (after
    iteration 4 here) and on; it stops only where a host action needs what
    the port does not have yet, the random box cameras."""
    cfg = _dtu_cfg(scene_dir, tmp_path, densify_from_iter=2,
                   densification_interval=4)
    cfg.optim.densify_large.sample_cams.num = 3
    tr = T.Trainer(cfg, device="cpu")
    # the init state is the JAX package's from the same scene
    info = jload_scene_info(scene_dir, load_normal=True,
                            normal_folder="normals")
    want = JGM.create_from_pcd(info.points.astype(np.float32),
                               info.colors.astype(np.float32),
                               tr.state.capacity, 3)
    assert_state_close(tr.state, want)
    assert tr.state.capacity == 1 << 16
    # the camera order is the JAX Trainer's
    stub = types.SimpleNamespace(viewpoint_stack=[], rng=__import__(
        "random").Random(cfg.seed), _cam_arrays=range(6))
    order = [JT.Trainer._next_camera_index(stub) for _ in range(9)]
    probe = T.Trainer.__new__(T.Trainer)
    probe.scene, probe.viewpoint_stack = tr.scene, []
    probe.rng = __import__("random").Random(cfg.seed)
    assert [probe._next_camera_index() for _ in range(9)] == order
    # the schedule helpers are the JAX Trainer's
    jtr = types.SimpleNamespace(cfg=JConfig(os.path.join(
        REPO, "configs", "dtu", "base.yaml")), extent=tr.extent, iteration=0)
    for it in (1, 999, 1000, 15001):
        assert tr._sh_degree(it) == JT.Trainer._sh_degree(jtr, it)
        assert tuple(tr._gates(it)) == tuple(JT.Trainer._gates(jtr, it))
        assert tr._lr_xyz(it) == pytest.approx(
            float(JT.Trainer._lr_xyz(jtr, it)), rel=1e-6)

    tr.train(max_iters=5, log_every=2)
    assert [r["iter"] for r in tr.history] == [1, 2, 3, 4, 5]
    assert tr.iteration == 5
    (dens,) = tr.host_log
    assert (dens["iter"], dens["action"]) == (4, "densify")
    assert dens["n_after"] != dens["n_before"] == 400
    for rec in tr.history:
        assert np.isfinite(rec["total"]) and rec["l1"] > 0
        assert set(rec) >= {"l1", "ssim", "l1_scale", "mono_normal", "total"}
    assert tr.history[-1]["n_active"] == tr.state.num_active
    assert tr.state.adam.step == 5
    # the statistics restarted at the densify: one visible step since
    assert float(tr.state.denom.max()) == 1.0
    # the random box cameras are a later slice's
    tr.cfg.optim.densify_large.sample_cams.random = True
    with pytest.raises(NotImplementedError, match="iteration 8 would "
                       "densify with random box cameras"):
        tr.train(max_iters=10, log_every=2)
    assert tr.iteration == 7


def test_train_cli_main_on_cpu(scene_dir, tmp_path, capsys):
    """The CLI runs the DTU recipe with its own prune schedule (compressed:
    densify after 2, 4 and 6, prune at 3 and 5, 6 iterations), then resumes
    from its checkpoint."""
    from vcr_gaus_tpu_torch.models.ply_io import load_gaussian_ply
    from vcr_gaus_tpu_torch.train.__main__ import main

    args = ["--config", os.path.join(REPO, "configs", "dtu", "base.yaml"),
            f"--logdir={tmp_path}", f"--model.source_path={scene_dir}",
            "--model.normal_folder=normals", "--optim.iterations=6",
            "--optim.densify_from_iter=1", "--optim.densification_interval=2",
            "--optim.prune.iterations=[3, 5]",
            "--optim.densify_large.sample_cams.num=2",
            "--train.checkpoint_iterations=[4]"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(args)
    tr = main(args + ["--device", "cpu"])
    assert tr.iteration == 6 and len(tr.history) == 6
    out = capsys.readouterr().out
    assert "[ITER 6] train: psnr=" in out and "final: {'psnr'" in out
    assert os.path.exists(tmp_path / "config.yaml")
    assert [(r["iter"], r["action"]) for r in tr.host_log] == [
        (2, "densify"), (3, "prune"), (4, "densify"), (5, "prune"),
        (6, "densify")]
    prunes = [r for r in tr.host_log if r["action"] == "prune"]
    for k, rec in enumerate(prunes):
        n = rec["n_before"]
        drop = int(np.float32(0.5 * 0.6 ** k) * np.float32(n - 1))
        assert rec["n_after"] == n - drop
    ply = tmp_path / "point_cloud" / "iteration_6" / "point_cloud.ply"
    loaded = load_gaussian_ply(str(ply), device="cpu")
    assert loaded.num_active == tr.state.num_active
    torch.testing.assert_close(loaded.params.xyz,
                               tr.state.params.xyz[tr.state.active])
    assert os.path.exists(tmp_path / "imp_score.npz")
    assert os.path.exists(tmp_path / "point_cloud" / "iteration_6"
                          / "point_cloud_inside.ply")
    # resume through the CLI from the checkpoint at 4
    again = main(args + ["--device", "cpu", f"--logdir={tmp_path / 'resume'}",
                         f"--train.start_checkpoint={tmp_path}/chkpnt4.npz"])
    assert [r["iter"] for r in again.history] == [5, 6]
    assert [(r["iter"], r["action"]) for r in again.host_log] == [
        (5, "prune"), (6, "densify")]
