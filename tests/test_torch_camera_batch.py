"""The camera batch (``tpu.camera_batch``) of the port's trainer against
the JAX Trainer, step for step: the DTU recipe on a 48x32 scene of 300
points, 4 steps with a densify after step 3 (its box mask over 3 training
views drawn from the trainer's generator).

The JAX Trainer runs ``steps_per_call: 1`` on conftest's virtual CPU
devices: its mesh is then min(8, k) devices with one view each, the same
mean of k views as the port's k views on one device, up to the order of
the sums. Both start from the JAX init state with anisotropic scales and
random rotations (``anisotropic``). Per step every loss at rtol 1e-4, the camera draws equal, the
active masks and the densify's population exactly; the state afterwards at
atol/rtol 1e-5; with the appearance network and the semantic head the side
networks at atol 1e-5. The one-view step is unchanged bit for bit.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from fixtures import write_colmap_scene
from test_torch_host_loop import RecordingRandom
from test_torch_train import assert_state_close, jax_state_arrays
from vcr_gaus_tpu.config import Config as JConfig
from vcr_gaus_tpu.train import trainer as JT
from vcr_gaus_tpu_torch.config import Config
from vcr_gaus_tpu_torch.models.convert import (state_from_arrays,
                                               state_to_arrays)
from vcr_gaus_tpu_torch.train import trainer as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTU = os.path.join(REPO, "configs", "dtu", "base.yaml")
ITERS = 4
SIDE_NETS = {"model.use_decoupled_appearance": True, "model.ch_sem_feat": 2,
             "model.num_cls": 2, "optim.loss_weight.semantic": 0.005}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def overrides(scene, logdir, k, **more):
    ov = {"logdir": str(logdir), "model.source_path": scene,
          "model.normal_folder": "normals", "model.depth_type": "traditional",
          "optim.iterations": 100, "optim.densify_from_iter": 1,
          "optim.densification_interval": 3,
          "optim.densify_large.sample_cams.num": 3,
          "train.test_iterations": [], "train.save_iterations": [],
          "train.checkpoint_iterations": [], "tpu.capacity": 512,
          "tpu.steps_per_call": 1, "tpu.tile": 16, "tpu.camera_batch": k}
    ov.update(more)
    return [f"--{k}={json.dumps(v) if isinstance(v, list) else v}"
            for k, v in ov.items()]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("camera_batch_scene"))
    write_colmap_scene(root, n_cams=6, n_pts=300, width=48, height=32,
                       with_priors=True)
    return root


def anisotropic(jtr):
    """The JAX Trainer's init state with seeded anisotropic scales and
    random rotations. The kNN init is isotropic: there a quaternion's
    gradient is rounding noise, which the first Adam steps (eps 1e-15) turn
    into a full +-lr step of either sign, in either package and at any
    camera batch; from a rotation that matters the steps compare."""
    import jax.numpy as jnp
    from vcr_gaus_tpu.parallel import dp as JDP
    rng = np.random.default_rng(1)
    js = jtr.state
    c = js.capacity
    params = js.params._replace(
        log_scale=js.params.log_scale + jnp.asarray(
            rng.uniform(-0.7, 0.7, (c, 3)), jnp.float32),
        quat=jnp.asarray(rng.normal(size=(c, 4)), jnp.float32))
    js = js._replace(params=params)
    return js if jtr.mesh is None else JDP.replicate(js, jtr.mesh)


def run_both(jcfg, cfg, with_nets=False):
    """Both trainers ITERS steps from the same Gaussians (``anisotropic``)
    and side networks, with recording generators: per step the losses as floats,
    the active masks and the populations."""
    jtr = JT.Trainer(jcfg)
    ptr = T.Trainer(cfg, device="cpu")
    assert_state_close(ptr.state, jtr.state)
    jtr.state = anisotropic(jtr)
    ptr.state = state_from_arrays(jax_state_arrays(jtr.state), "cpu")
    if with_nets:
        ptr.nets.load_state_dict(jax.tree.map(np.asarray,
                                              jtr.net._asdict()))
    jtr.rng, ptr.rng = RecordingRandom(0), RecordingRandom(0)
    steps = []
    for _ in range(ITERS):
        jl, _ = jtr.train_step()
        pl, _ = ptr.train_step()
        steps.append(({k: float(v) for k, v in jl.items()},
                      {k: float(v) for k, v in pl.items()},
                      np.asarray(jtr.state.active),
                      ptr.state.active.numpy().copy(),
                      len(ptr.rng.draws), len(jtr.rng.draws)))
    return jtr, ptr, steps


def arrays_close_but_noise(got, want, tol=1e-5, noise=1e-4):
    """Two states as ``state_to_arrays`` dicts at atol/rtol ``tol``, but
    for parameter elements whose Adam first moment is rounding noise:
    below ``noise`` times its group's largest in both, where the sign of a
    sum that cancels decides a full-size Adam step (eps 1e-15) and two
    summation orders (a mean over k views on one device, over k devices or
    ranks) may pick either sign. At most 1 in 500 elements of a parameter
    may be such noise; every other field is held at ``tol``."""
    for k, w in want["params"].items():
        g = got["params"][k]
        far = ~np.isclose(g, w, atol=tol, rtol=tol)
        mu_g, mu_w = np.abs(got["mu"][k]), np.abs(want["mu"][k])
        floor = noise * max(mu_g.max(initial=0), mu_w.max(initial=0))
        quiet = (mu_g < floor) & (mu_w < floor)
        assert not (far & ~quiet).any(), (k, np.argwhere(far & ~quiet))
        assert far.sum() <= max(1, far.size // 500), (k, far.sum())
    for group in ("mu", "nu"):
        for k, v in want[group].items():
            np.testing.assert_allclose(got[group][k], v, atol=tol, rtol=tol,
                                       err_msg=f"{group}.{k}")
    for k in ("active", "max_radii2d", "grad_accum", "denom"):
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                                   err_msg=k)
    assert got["step"] == want["step"]


def assert_state_close_but_noise(port, js):
    """``arrays_close_but_noise`` of a port state and a JAX state."""
    arrays_close_but_noise(state_to_arrays(port), jax_state_arrays(js))


def check_steps(jtr, ptr, steps, k):
    assert ptr.iteration == jtr.iteration == ITERS
    for it, (want, got, jact, pact, npd, njd) in enumerate(steps, 1):
        assert set(got) == set(want), it
        for name, v in want.items():
            assert got[name] == pytest.approx(v, rel=1e-4, abs=1e-7), (
                it, name)
        np.testing.assert_array_equal(pact, jact, err_msg=f"step {it}")
        # the camera draws up to this step: 2k before the first step,
        # k a step after it, the box mask's 3 views at the densify
        assert npd == njd == k * (it + 1) + (3 if it >= 3 else 0), it
    assert ptr.rng.draws == jtr.rng.draws
    assert [(r["iter"], r["action"]) for r in ptr.host_log] == [
        (3, "densify")]
    assert ptr.state.num_active == int(jtr.state.num_active)
    assert ptr.host_log[0]["n_after"] != ptr.host_log[0]["n_before"]
    assert_state_close_but_noise(ptr.state, jtr.state)


@pytest.mark.parametrize("k", [2, 3])
def test_camera_batch_matches_jax_trainer(scene_dir, tmp_path, k):
    jcfg = JConfig(DTU, overrides=overrides(scene_dir, tmp_path / "j", k))
    cfg = Config(DTU, overrides=overrides(scene_dir, tmp_path / "p", k))
    jtr, ptr, steps = run_both(jcfg, cfg)
    assert jtr.mesh is not None and jtr.mesh.devices.size == k
    assert ptr.camera_batch == k
    check_steps(jtr, ptr, steps, k)


def test_camera_batch_with_side_networks_matches_jax(scene_dir, tmp_path):
    """k = 2 with the appearance network and the semantic head (masks
    under masks/): the side networks take one Adam step a step, on the
    averaged gradients."""
    jcfg = JConfig(DTU, overrides=overrides(scene_dir, tmp_path / "j", 2,
                                            **SIDE_NETS))
    cfg = Config(DTU, overrides=overrides(scene_dir, tmp_path / "p", 2,
                                          **SIDE_NETS))
    jtr, ptr, steps = run_both(jcfg, cfg, with_nets=True)
    assert ptr.nets.app is not None and ptr.nets.cls is not None
    assert "semantic" in steps[0][1]
    check_steps(jtr, ptr, steps, 2)
    want = jax.tree.map(np.asarray, jtr.net._asdict())
    got = ptr.nets.state_dict()
    for name in ("app_embeddings", "app_params", "cls_params"):
        for a, b in zip(jax.tree.leaves(got[name]),
                        jax.tree.leaves(want[name])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    for name in ("app_opt", "cls_opt"):
        # one Adam step per iteration, not one per view
        assert int(got[name]["count"]) == int(want[name][0].count) == ITERS


def test_camera_batch_must_divide_over_ranks(scene_dir, tmp_path,
                                             monkeypatch):
    from vcr_gaus_tpu_torch.parallel import dp
    cfg = Config(DTU, overrides=overrides(scene_dir, tmp_path, 3))
    monkeypatch.setattr(dp, "world", lambda: (0, 2))
    with pytest.raises(ValueError, match="camera_batch=3 must be a "
                                         "multiple of the mesh size 2"):
        T.Trainer(cfg, device="cpu")


def test_one_view_step_unchanged(scene_dir, tmp_path):
    """The one-view step is the same whether its camera comes alone or as
    a list of one, and equals, bit for bit, the two-view step over the
    same view twice ((g + g) * 0.5 = g in floating point): the averaging
    path adds nothing to the one-view path. Side networks included."""
    cfg = Config(DTU, overrides=overrides(scene_dir, tmp_path, 1,
                                          **SIDE_NETS))
    tr = T.Trainer(cfg, device="cpu")
    cam = tr.scene.train_cameras[2].arrays("cpu")
    bg = torch.zeros(3)
    nets0 = tr.nets.state_dict()
    outs = []
    for cams in (cam, [cam], [cam, cam]):
        tr.nets.load_state_dict(nets0)
        state, losses, aux = tr.step_fn(tr.state, cams, bg, 1e-3, 1,
                                        tr._gates(100), tr.nets)
        outs.append((state_to_arrays(state),
                     {k: float(v) for k, v in losses.items()}, aux,
                     tr.nets.state_dict()))
    ref = outs[0]
    for got in outs[1:]:
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)
        assert got[1] == ref[1] and got[2] == ref[2]
    assert ref[0]["denom"].max() == 1.0
    assert ref[3]["app_opt"]["count"] == 1
