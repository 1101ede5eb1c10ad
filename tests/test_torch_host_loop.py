"""The port's host training loop against the JAX Trainer: the DTU recipe on
a small scene with a compressed schedule (densify from 2 every 3, opacity
reset every 6, LightGaussian prune at 7, test, save and checkpoint at 9, 4
sampled views per box mask, capacity 512 so densify drops children and the
capacity grows).

The JAX Trainer runs its single-step path (tpu.steps_per_call 1; its
supersteps are a TPU setting the port does not have) with tile 16, in
interpret mode on the CPU. Camera draws and host-action iterations must be
equal; one host action run from the same converted state must give the same
active mask.
"""

import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import write_colmap_scene
from test_torch_train import assert_state_close, jax_state_arrays
from vcr_gaus_tpu.config import Config as JConfig
from vcr_gaus_tpu.models import ply_io as JPLY
from vcr_gaus_tpu.train import trainer as JT
from vcr_gaus_tpu_torch.config import Config
from vcr_gaus_tpu_torch.models import ply_io as PLY
from vcr_gaus_tpu_torch.models.convert import state_from_arrays
from vcr_gaus_tpu_torch.train import trainer as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTU = os.path.join(REPO, "configs", "dtu", "base.yaml")
ITERS = 9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class RecordingRandom(random.Random):
    """random.Random that records every randint draw."""

    def __init__(self, seed):
        super().__init__(seed)
        self.draws = []

    def randint(self, a, b):
        v = super().randint(a, b)
        self.draws.append((a, b, v))
        return v


def overrides(scene, logdir, **more):
    ov = {"logdir": str(logdir), "model.source_path": scene,
          "model.normal_folder": "normals",
          "optim.iterations": ITERS, "optim.densify_from_iter": 2,
          "optim.densification_interval": 3,
          "optim.opacity_reset_interval": 6, "optim.prune.iterations": [7],
          "optim.densify_large.sample_cams.num": 4,
          "train.test_iterations": [ITERS], "train.save_iterations": [ITERS],
          "train.checkpoint_iterations": [6, ITERS],
          "tpu.capacity": 512, "tpu.steps_per_call": 1, "tpu.tile": 16}
    ov.update(more)
    return [f"--{k}={json.dumps(v) if isinstance(v, list) else v}"
            for k, v in ov.items()]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("host_loop_scene"))
    write_colmap_scene(root, n_cams=6, n_pts=400, width=64, height=48,
                       with_priors=True)
    return root


@pytest.fixture(scope="module")
def runs(scene_dir, tmp_path_factory):
    """Both trainers over the whole schedule, with recording generators."""
    jdir = tmp_path_factory.mktemp("jax_run")
    pdir = tmp_path_factory.mktemp("port_run")
    jtr = JT.Trainer(JConfig(DTU, overrides=overrides(scene_dir, jdir)))
    ptr = T.Trainer(Config(DTU, overrides=overrides(scene_dir, pdir)),
                    device="cpu")
    jtr.rng, ptr.rng = RecordingRandom(0), RecordingRandom(0)
    jtr.train(log_every=3)
    ptr.train(log_every=3)
    return jtr, ptr, str(jdir), str(pdir)


@pytest.fixture
def trainers(runs):
    """The two trainers of ``runs``, for a test that drives them from a
    state of its own: every attribute is put back afterwards (lists copied,
    as the host log is appended to), so the other tests of this module read
    the trainers as the whole schedule left them, in any order."""
    pair = runs[:2]
    saved = [{k: list(v) if isinstance(v, list) else v
              for k, v in vars(t).items()} for t in pair]
    yield pair
    for t, attrs in zip(pair, saved):
        vars(t).clear()
        vars(t).update(attrs)


def test_host_actions_fire_at_the_jax_iterations(runs):
    jtr, ptr, _, _ = runs
    assert ptr.iteration == jtr.iteration == ITERS
    want = [j for j in range(1, ITERS + 1) if jtr._is_action_iter(j)]
    assert [j for j in range(1, ITERS + 1) if ptr.host_actions(j)] == want
    done = [(r["iter"], r["action"]) for r in ptr.host_log]
    assert done == [(3, "densify"), (6, "densify"), (6, "reset opacity"),
                    (7, "prune"), (9, "densify")]
    assert ptr.host_actions(ITERS) == ["densify", "test", "save",
                                       "checkpoint", "dump importance"]
    # capacity growth at the iteration the JAX Trainer grew it
    assert ptr.state.capacity == jtr.state.capacity
    grew = [r["iter"] for r in ptr.host_log if r.get("capacity", 512) > 512]
    assert grew and grew[0] in (6, 9)


def test_camera_draws_match_jax_across_densify(runs):
    """Every draw from the trainer's generator, in order: the camera
    indices (one step ahead) and the box mask's 4 views per densify."""
    jtr, ptr, _, _ = runs
    assert ptr.rng.draws == jtr.rng.draws
    # 9 steps + the lookahead draw, 3 densifies x 4 views
    assert len(ptr.rng.draws) == ITERS + 1 + 3 * 4


def test_outputs_written(runs):
    jtr, ptr, jdir, pdir = runs
    for name in ("cameras.json", "cfg_args"):
        with open(os.path.join(pdir, name)) as a, \
                open(os.path.join(jdir, name)) as b:
            got, want = a.read(), b.read()
        if name == "cfg_args":
            got, want = (s.replace(d, "<logdir>") for s, d in
                         ((got, pdir), (want, jdir)))
        assert got == want, name
    out = os.path.join(pdir, "point_cloud", f"iteration_{ITERS}")
    for name in ("point_cloud.ply", "point_cloud_inside.ply"):
        assert os.path.getsize(os.path.join(out, name)) > 0
    assert os.path.exists(os.path.join(pdir, "vis", f"iter_{ITERS:06d}.png"))
    imp = np.load(os.path.join(pdir, "imp_score.npz"))["arr_0"]
    assert imp.shape == (ptr.state.capacity,) and np.isfinite(imp).all()
    assert float(imp[ptr.state.active.numpy()].max()) > 0
    # the checkpoint loads in both packages to the port's final state
    path = os.path.join(pdir, f"chkpnt{ITERS}.npz")
    js, it, _ = JPLY.load_checkpoint(path)
    assert it == ITERS
    assert_state_close(ptr.state, js, atol=0, rtol=0)
    assert [t["iter"] for t in ptr.test_history] == [ITERS]
    for rec in ptr.history:
        assert all(np.isfinite(v) for v in rec.values())


def test_resume_continues_at_the_next_iteration(runs, scene_dir, tmp_path):
    _, ptr, _, pdir = runs
    ckpt = os.path.join(pdir, "chkpnt6.npz")
    tr = T.Trainer(Config(DTU, overrides=overrides(
        scene_dir, tmp_path, **{"train.start_checkpoint": ckpt})),
        device="cpu")
    assert tr.iteration == 6
    saved, _, _ = PLY.load_checkpoint(ckpt, device="cpu")
    assert tr.state.capacity == saved.capacity
    tr.train(log_every=1)
    assert [r["iter"] for r in tr.history] == [7, 8, 9]
    assert [(r["iter"], r["action"]) for r in tr.host_log] == [
        (7, "prune"), (9, "densify")]
    assert os.path.exists(tmp_path / "imp_score.npz")


@pytest.mark.parametrize("it", [9, 7])
def test_post_step_actions_match_jax_from_one_state(trainers, it):
    """Densify with the box mask and the size cut (iteration 9) and the
    LightGaussian prune (iteration 7), from the JAX Trainer's final state
    with seeded densify statistics, on both trainers."""
    jtr, ptr = trainers
    rng = np.random.default_rng(it)
    js = jtr.state
    act = np.asarray(js.active)
    denom = (rng.integers(0, 4, js.capacity) * act).astype(np.float32)
    js = js._replace(
        grad_accum=jnp.asarray(rng.uniform(0, 2e-3, js.capacity) * denom,
                               jnp.float32),
        denom=jnp.asarray(denom),
        max_radii2d=jnp.asarray(rng.uniform(0, 30, js.capacity) * act,
                                jnp.float32))
    jtr.state, jtr.iteration = js, it
    ptr.state = state_from_arrays(jax_state_arrays(js), "cpu")
    ptr.iteration = it
    jtr.rng, ptr.rng = random.Random(5), random.Random(5)
    jtr._pending_dropped = ptr._pending_dropped = None
    jtr._post_step_actions()
    ptr._post_step_actions()
    np.testing.assert_array_equal(ptr.state.active.numpy(),
                                  np.asarray(jtr.state.active))
    assert ptr._pending_dropped == (None if jtr._pending_dropped is None
                                    else int(jtr._pending_dropped))
    assert_state_close(ptr.state, jtr.state, atol=1e-5, rtol=1e-5)
    assert ptr.state.num_active != int(np.sum(act))


def test_run_test_caps_views_like_jax(scene_dir, tmp_path, monkeypatch):
    """tpu.eval_max_cams caps both splits; the same state gives the JAX
    run_test's PSNR and L1."""
    ov = overrides(scene_dir, tmp_path / "j", **{
        "model.eval": True, "model.llffhold": 3, "tpu.eval_max_cams": 1})
    jtr = JT.Trainer(JConfig(DTU, overrides=ov))
    ptr = T.Trainer(Config(DTU, overrides=overrides(
        scene_dir, tmp_path / "p", **{"model.eval": True,
                                      "model.llffhold": 3,
                                      "tpu.eval_max_cams": 1})), device="cpu")
    assert len(ptr.scene.train_cameras) == 4
    assert len(ptr.scene.test_cameras) == 2
    ptr.state = state_from_arrays(jax_state_arrays(jtr.state), "cpu")
    jcalls, pcalls = [], []
    make = jtr._eval_metrics_fn

    def counting_metrics(*a, **kw):
        fn = make(*a, **kw)
        return lambda *args: (jcalls.append(1), fn(*args))[1]

    monkeypatch.setattr(jtr, "_eval_metrics_fn", counting_metrics)
    real = T.render
    monkeypatch.setattr(T, "render", lambda *a, **kw: (
        pcalls.append(1), real(*a, **kw))[1])
    want = jtr.run_test()
    got = ptr.run_test()
    assert len(jcalls) == 2
    assert len(pcalls) == 2 + 1          # the two views and the panel view
    for split in ("train", "test"):
        assert got[split]["psnr"] == pytest.approx(want[split]["psnr"],
                                                   abs=1e-3)
        assert got[split]["l1"] == pytest.approx(want[split]["l1"], abs=1e-5)
    assert os.path.exists(tmp_path / "p" / "vis" / "iter_000000.png")
