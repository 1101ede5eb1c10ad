"""The Tanks and Temples recipe's training against the JAX Trainer: the
appearance network, the semantic head, the mask priors (RGB PNGs, the label
in blue), the random box cameras of the densify, and the losses no TNT
recipe sets (entropy and mono_depth, switched on here), on a 64x64 scene
with a compressed schedule (4 iterations, a checkpoint at 3, test, save and
a densify with 6 box views of 64x64 at 4).

Both start from the same Gaussians and side networks (the JAX Trainer's,
carried across in the flax layout), the Gaussians with anisotropic scales
and random rotations (``test_torch_camera_batch.anisotropic``): from the
isotropic kNN init a quaternion's gradient is rounding noise (its Adam
first moment 4e-8 of the group's largest), which Adam (eps 1e-15) turns
into a full +-lr step of either sign, and the two runs' rendered depth
then parts by 1e-2 within three steps. The JAX Trainer runs its
single-step path (tpu.steps_per_call 1) with tile 16, in interpret mode
on the CPU. Per step every loss at rtol 1e-4, and mono_depth's inputs and
function on their own; the side networks after every step, each step
from the JAX Trainer's state, at atol 1e-5 but for Adam's rounding noise
(a ReLU whose sign rounding decides parts the free-running runs); the
camera draws equal; a densify from one state with its active mask and
drop count exactly equal; mIoU at 1e-6; the writer's tags; the saves,
model.pkl and the checkpoints of both packages.
"""

import copy
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fixtures import write_colmap_scene
from test_torch_camera_batch import anisotropic, steps_close_but_noise
from test_torch_host_loop import RecordingRandom
from test_torch_train import assert_state_close, jax_state_arrays
from vcr_gaus_tpu.config import Config as JConfig
from vcr_gaus_tpu.models import ply_io as JPLY
from vcr_gaus_tpu.train import losses as JL
from vcr_gaus_tpu.train import trainer as JT
from vcr_gaus_tpu_torch.config import Config
from vcr_gaus_tpu_torch.models import ply_io as PLY
from vcr_gaus_tpu_torch.models.convert import state_from_arrays
from vcr_gaus_tpu_torch.train import losses as L
from vcr_gaus_tpu_torch.train import trainer as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TNT = os.path.join(REPO, "configs", "tnt", "base.yaml")
ITERS = 4
# two losses of the port that no TNT recipe sets (curv, whose value on
# the background's near-zero depths is rounding noise, is held from one
# state by test_compute_losses_match_jax)
EXTRA = {"optim.loss_weight.entropy": 0.01,
         "optim.loss_weight.mono_depth": 0.01}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Writer:
    """Records the metric writer's calls."""

    def __init__(self):
        self.calls = []

    def scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, float(value), step))

    def histogram(self, tag, values, step):
        self.calls.append(("histogram", tag, np.asarray(values), step))

    def image(self, tag, arr, step):
        self.calls.append(("image", tag, np.asarray(arr), step))

    def finish(self):
        self.calls.append(("finish",))

    def tags(self, kind):
        return {c[1] for c in self.calls if c[0] == kind}


def overrides(scene, logdir, **more):
    ov = {"logdir": str(logdir), "model.source_path": scene,
          "optim.iterations": ITERS, "optim.densify_from_iter": 1,
          "optim.densification_interval": ITERS,
          "optim.densify_large.sample_cams.num": 6,
          "train.test_iterations": [ITERS], "train.save_iterations": [ITERS],
          "train.checkpoint_iterations": [3], "tpu.capacity": 2048,
          "tpu.steps_per_call": 1, "tpu.tile": 16, **EXTRA}
    ov.update(more)
    return [f"--{k}={json.dumps(v) if isinstance(v, list) else v}"
            for k, v in ov.items()]


def configs(scene, jdir, pdir, **more):
    jcfg = JConfig(TNT, overrides=overrides(scene, jdir, **more))
    cfg = Config(TNT, overrides=overrides(scene, pdir, **more))
    for c in (jcfg, cfg):
        c.tpu.visi_resolution = 64
    return jcfg, cfg


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """6 views of 64x64 with normal and depth priors, and RGB masks: label
    1 on the left half, 0 on the right, in blue. (A view without a depth
    prior would give the JAX step NaN gradients with mono_depth on: its
    SSI mask is empty; tests/test_torch_losses.py holds that case.)"""
    root = str(tmp_path_factory.mktemp("tnt_scene"))
    write_colmap_scene(root, n_cams=6, n_pts=400, width=64, height=64,
                       with_priors=True)
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "depths"))
    for i in range(6):
        rgb = np.zeros((64, 64, 3), np.uint8)
        rgb[..., 0], rgb[..., 1] = 9, 4
        rgb[:, :32, 2] = 1
        Image.fromarray(rgb, "RGB").save(os.path.join(root, "masks",
                                                      f"img_{i:03d}.png"))
        np.savez(os.path.join(root, "depths", f"img_{i:03d}.npz"),
                 rng.uniform(0.1, 1.0, (64, 64)).astype(np.float32))
    return root


def recording_depth_loss(monkeypatch, record):
    """Both packages' scale_and_shift_invariant_depth_loss, unchanged in
    value, recording their inputs (the step's rendered depth, the prior and
    the mask) as numpy into ``record["jax"]`` and ``record["port"]``; the
    JAX one through a debug callback from inside its jitted step."""
    jfn, pfn = JL.scale_and_shift_invariant_depth_loss, \
        L.scale_and_shift_invariant_depth_loss

    def keep(side, *arrays):
        record[side].append(tuple(np.array(a) for a in arrays))

    def jax_loss(prediction, target, mask=None, **kw):
        jax.debug.callback(lambda *a: keep("jax", *a), prediction, target,
                           mask)
        return jfn(prediction, target, mask, **kw)

    def port_loss(prediction, target, mask=None, **kw):
        keep("port", *(x.detach() for x in (prediction, target, mask)))
        return pfn(prediction, target, mask, **kw)

    monkeypatch.setattr(JL, "scale_and_shift_invariant_depth_loss",
                        jax_loss)
    monkeypatch.setattr(L, "scale_and_shift_invariant_depth_loss",
                        port_loss)


def host_net(net) -> dict:
    """The JAX Trainer's side networks as numpy (its NetState fields)."""
    return jax.tree.map(np.asarray, net._asdict())


def record_steps(jtr, ptr, steps):
    """Wrap both trainers' steps to keep, per step, what a replay needs:
    the JAX Trainer's Gaussians and side networks before its step and its
    side networks after it (``steps["jax"]``); the port's step arguments
    and its side networks before and after (``steps["port"]``), and the
    port's step itself (``steps["step_fn"]``)."""
    jstep, pstep = jtr.train_step, ptr.step_fn

    def jax_step():
        before = (jtr.state, host_net(jtr.net))
        out = jstep()
        steps["jax"].append((*before, host_net(jtr.net)))
        return out

    def port_step(state, cams, bg, lr_xyz, sh_degree, gates, nets):
        before = nets.state_dict()
        out = pstep(state, cams, bg, lr_xyz, sh_degree, gates, nets)
        steps["port"].append(((state, cams, bg, lr_xyz, sh_degree, gates),
                              before, nets.state_dict()))
        return out

    jtr.train_step, ptr.step_fn = jax_step, port_step
    steps["step_fn"] = pstep


def net_arrays(net: dict) -> dict:
    """A side-network state (either package's fields, as numpy) in the
    form ``steps_close_but_noise`` holds: every leaf of the embeddings, the
    appearance network and the classifier under ``params``, their Adam
    moments under ``mu`` and ``nu``, keyed by tree path."""
    out = {"params": {}, "mu": {}, "nu": {}}
    for tag, params, opt in (
            ("app", (net["app_embeddings"], net["app_params"]),
             net["app_opt"]),
            ("cls", net["cls_params"], net["cls_opt"])):
        adam = opt if isinstance(opt, dict) else opt[0]._asdict()
        for group, tree in (("params", params), ("mu", adam["mu"]),
                            ("nu", adam["nu"])):
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                out[group][tag + jax.tree_util.keystr(path)] = np.asarray(
                    leaf)
    return out


def replay_side_nets(ptr, steps, before, perturb=None):
    """The port's recorded steps again, each on its own arguments (views,
    background, learning rate, SH degree, gates) but from the Gaussians and
    side networks ``before[i]`` (a port GaussianState and a side-network
    dict), with the gradients the side networks' Adam takes first passed
    through ``perturb``: the side networks after each step, as
    ``net_arrays`` dicts."""
    nets = copy.deepcopy(ptr.nets)
    if perturb is not None:
        adam_step = nets.step
        nets.step = lambda grads: adam_step(perturb(grads))
    out = []
    for (args, _, _), (state, net) in zip(steps["port"], before):
        nets.load_state_dict(net)
        steps["step_fn"](state, *args[1:], nets)
        out.append(net_arrays(nets.state_dict()))
    return out


def hold_side_nets(got_steps, want_steps):
    """The side networks' rule (ROADMAP.md §3, F5): after each step, every
    step from the same start, at atol 1e-5 (rtol 0) but for Adam's
    rounding-noise elements of that step (``steps_close_but_noise``)."""
    for it, (got, want) in enumerate(zip(got_steps, want_steps), 1):
        try:
            steps_close_but_noise([got], [want], tol=1e-5, rtol=0)
        except AssertionError as e:
            raise AssertionError(f"step {it}: {e}") from e


@pytest.fixture(scope="module")
def runs(scene_dir, tmp_path_factory):
    """Both trainers over the schedule from the same Gaussians
    (``anisotropic``: the init state with anisotropic scales and random
    rotations) and side networks, with recording generators and writers,
    the inputs of each step's mono_depth loss in both packages, and each
    step's record (``record_steps``)."""
    jdir = tmp_path_factory.mktemp("jax_tnt")
    pdir = tmp_path_factory.mktemp("port_tnt")
    jcfg, cfg = configs(scene_dir, jdir, pdir)
    depth_inputs = {"jax": [], "port": []}
    steps = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        recording_depth_loss(mp, depth_inputs)
        jtr = JT.Trainer(jcfg)
        ptr = T.Trainer(cfg, device="cpu")
        assert_state_close(ptr.state, jtr.state)
        jtr.state = anisotropic(jtr)
        ptr.state = state_from_arrays(jax_state_arrays(jtr.state), "cpu")
        ptr.nets.load_state_dict(host_net(jtr.net))
        jtr.rng, ptr.rng = RecordingRandom(0), RecordingRandom(0)
        jtr._tb, ptr._tb = Writer(), Writer()
        record_steps(jtr, ptr, steps)
        jtr.train(log_every=1)
        ptr.train(log_every=1)
    return jtr, ptr, str(jdir), str(pdir), depth_inputs, steps


def test_losses_match_jax_per_step(runs):
    jtr, ptr = runs[:2]
    assert [r["iter"] for r in ptr.history] == list(range(1, ITERS + 1))
    assert ptr.ch_sem == jtr.ch_sem == 2 and ptr.nets.app is not None
    for want, got in zip(jtr.history, ptr.history):
        names = set(want) - {"iter", "n_active", "overflow", "time"}
        assert names == set(got) - {"iter", "n_active"}
        assert names >= {"l1", "semantic", "entropy", "mono_depth",
                         "depth_normal", "total"}
        for k in names:
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-7), (
                got["iter"], k)
    assert min(r["mono_depth"] for r in ptr.history) > 0
    assert [(r["iter"], r["action"]) for r in ptr.host_log] == [
        (ITERS, "densify")]
    # the run's densify, from states equal to ~1e-6
    assert ptr.state.num_active == int(jtr.state.num_active) > 400


def test_depth_loss_and_its_inputs_match_jax(runs):
    """Each step's mono_depth split into its inputs and its function: the
    rendered depth at the forward tolerance (tests/test_rasterize.py:88),
    the prior and the mask exactly, and the port's function on the JAX
    step's inputs at rtol 1e-5 of the JAX function's."""
    record = runs[4]
    assert len(record["jax"]) == len(record["port"]) == ITERS
    for it, ((dj, tj, mj), (dp, tp, mp)) in enumerate(
            zip(record["jax"], record["port"]), 1):
        np.testing.assert_allclose(dp, dj, atol=2e-4, rtol=1e-3,
                                   err_msg=f"depth, step {it}")
        np.testing.assert_array_equal(tp, tj, err_msg=f"prior, step {it}")
        np.testing.assert_array_equal(mp, mj, err_msg=f"mask, step {it}")
        assert mj.sum() > 0.5 * mj.size, it
        want = float(JL.scale_and_shift_invariant_depth_loss(
            jnp.asarray(dj), jnp.asarray(tj), jnp.asarray(mj)))
        got = float(L.scale_and_shift_invariant_depth_loss(
            torch.from_numpy(dj), torch.from_numpy(tj),
            torch.from_numpy(mj)))
        assert got == pytest.approx(want, rel=1e-5), it


def test_side_networks_match_jax(runs):
    """The side networks after every step, each step the port's from the
    JAX Trainer's Gaussians and side networks before it, at atol 1e-5 but
    for Adam's rounding-noise elements (``hold_side_nets``). Free-running,
    the two runs' side networks part from step 3 (ROADMAP.md §3, F5): one
    ReLU of Conv_1 sits at +4.8e-9 in the port and -2.1e-8 in JAX on the
    port's step-3 parameters, which moves the gradients above it by
    1.5e-3 of their largest, and Adam (eps 1e-15) turns that into steps of
    up to lr on elements whose first moments are 1e-6 of their leaf's
    largest."""
    jtr, ptr, steps = runs[0], runs[1], runs[5]
    assert len(steps["jax"]) == len(steps["port"]) == ITERS
    got = replay_side_nets(ptr, steps, [
        (state_from_arrays(jax_state_arrays(js), "cpu"), net)
        for js, net, _ in steps["jax"]])
    hold_side_nets(got, [net_arrays(after) for _, _, after in steps["jax"]])
    want = host_net(jtr.net)
    got = ptr.nets.state_dict()
    for name in ("app_opt", "cls_opt"):
        assert int(got[name]["count"]) == int(want[name][0].count) == ITERS
    # the embedding rows of the views trained moved, the others did not
    start = PLY.load_checkpoint(os.path.join(runs[3], "chkpnt3.npz"),
                                "cpu")[2]["net"]["app_embeddings"]
    assert not np.array_equal(got["app_embeddings"], start)


def perturb_ulp(seed):
    """Moves every nonzero gradient element one float32 ulp up or down,
    at random from ``seed``: another summation order's rounding."""
    gen = torch.Generator().manual_seed(seed)

    def perturb(grads):
        out = []
        for g in grads:
            up = torch.rand(g.shape, generator=gen) < 0.5
            moved = torch.nextafter(g, torch.where(
                up, torch.full_like(g, np.inf), torch.full_like(g, -np.inf)))
            out.append(torch.where(g == 0, g, moved))
        return out
    return perturb


def flip_one_leaf(grads):
    """A real fault: the sign of one leaf's gradient (Conv_0's kernel)."""
    return [-g if g.dim() == 4 and g.shape[0] == 256 else g for g in grads]


@pytest.mark.parametrize("fault", ["ulp0", "ulp1", "ulp2", "sign_flip"])
def test_side_network_rule_tolerates_rounding_catches_faults(runs, fault):
    """The side networks' rule on the port alone: the port's own steps
    replayed from its own Gaussians and side networks before each step,
    with the side networks' gradients moved by one ulp (another host's
    summation order, three seeds) or with one leaf's gradient negated.
    The rule holds the first and refuses the second."""
    ptr, steps = runs[1], runs[5]
    before = [(args[0], net) for args, net, _ in steps["port"]]
    want = [net_arrays(after) for _, _, after in steps["port"]]
    assert len(want) == ITERS
    hold_side_nets(replay_side_nets(ptr, steps, before), want)
    perturb = (flip_one_leaf if fault == "sign_flip"
               else perturb_ulp(int(fault[-1])))
    got = replay_side_nets(ptr, steps, before, perturb)
    if fault == "sign_flip":
        with pytest.raises(AssertionError, match=r"\['Conv_0'\]\['kernel'\]"):
            hold_side_nets(got, want)
    else:
        hold_side_nets(got, want)


def test_camera_draws_match_jax(runs):
    """The random box cameras draw nothing from the trainer's generator:
    the draws are the steps' cameras and the lookahead alone."""
    jtr, ptr = runs[:2]
    assert ptr.rng.draws == jtr.rng.draws
    assert len(ptr.rng.draws) == ITERS + 1


@pytest.fixture
def synced(runs):
    """The two trainers of ``runs`` with the port's state and side
    networks set to the JAX Trainer's; every attribute is put back
    afterwards."""
    jtr, ptr = runs[:2]
    saved = [dict(vars(t)) for t in (jtr, ptr)]
    nets = ptr.nets.state_dict()       # updated in place: kept by value
    ptr.nets.load_state_dict(jax.tree.map(np.asarray, jtr.net._asdict()))
    ptr.state = state_from_arrays(jax_state_arrays(jtr.state), "cpu")
    yield jtr, ptr
    for t, attrs in zip((jtr, ptr), saved):
        vars(t).clear()
        vars(t).update(attrs)
    ptr.nets.load_state_dict(nets)


def test_random_box_densify_matches_jax_from_one_state(runs, synced):
    """A densify at iteration 4 with its 6 random box views and seeded
    densify statistics, from the JAX Trainer's final state on both."""
    jtr, ptr = synced
    rng = np.random.default_rng(3)
    js = jtr.state
    act = np.asarray(js.active)
    denom = (rng.integers(0, 4, js.capacity) * act).astype(np.float32)
    js = js._replace(
        grad_accum=jnp.asarray(rng.uniform(0, 2e-3, js.capacity) * denom,
                               jnp.float32),
        denom=jnp.asarray(denom),
        max_radii2d=jnp.asarray(rng.uniform(0, 30, js.capacity) * act,
                                jnp.float32))
    jtr.state, jtr.iteration = js, ITERS
    ptr.state = state_from_arrays(jax_state_arrays(js), "cpu")
    ptr.iteration = ITERS
    jtr._pending_dropped = ptr._pending_dropped = None
    ptr.host_log = []
    jtr._post_step_actions()
    ptr._post_step_actions()
    np.testing.assert_array_equal(ptr.state.active.numpy(),
                                  np.asarray(jtr.state.active))
    assert ptr._pending_dropped == int(jtr._pending_dropped)
    assert_state_close(ptr.state, jtr.state, atol=1e-5, rtol=1e-5)
    assert ptr.state.num_active != int(act.sum())


def test_evaluate_miou_matches_jax(runs, synced):
    jtr, ptr = synced
    want = jtr.evaluate()
    got = ptr.evaluate()
    assert set(got) == set(want) == {"psnr", "l1", "miou"}
    assert got["miou"] == pytest.approx(want["miou"], abs=1e-6)
    assert 0 < got["miou"] < 1
    assert got["psnr"] == pytest.approx(want["psnr"], abs=1e-3)


def test_run_test_writes_jax_tags(runs):
    """The writer's scalar, image and histogram tags of the run (its
    per-step scalars and the test at 4) are the JAX Trainer's."""
    jtr, ptr = runs[:2]
    jw, pw = jtr._tb, ptr._tb
    for kind in ("scalar", "image", "histogram"):
        assert pw.tags(kind) == jw.tags(kind), kind
    assert {"eval/train_psnr", "eval/train_l1", "eval/train_miou",
            "scene/total_points", "train/total", "train/semantic",
            "train/time"} <= pw.tags("scalar")
    assert {"vis/train", "vis/train_sem", "vis/train_normal_gt"
            } <= pw.tags("image")
    assert pw.tags("histogram") == {"scene/opacity_histogram"}
    (hist,) = [c for c in pw.calls if c[0] == "histogram"]
    assert hist[2].shape == (ptr.state.num_active,)
    steps = [c[3] for c in pw.calls if c[1] == "train/total"]
    assert steps == list(range(1, ITERS + 1))
    ptr.finalize()
    assert pw.calls[-1] == ("finish",)
    assert ptr.test_history[-1]["train"]["miou"] == pytest.approx(
        jtr.test_history[-1]["train"]["miou"], abs=5e-3)


def test_save_writes_model_pkl_like_jax(runs, synced, tmp_path,
                                       monkeypatch):
    """From one state and one set of side networks, model.pkl holds the
    JAX package's arrays in its layout; the panel strip has the semantic
    column."""
    jtr, ptr = synced
    monkeypatch.setitem(jtr.cfg, "logdir", str(tmp_path / "j"))
    monkeypatch.setitem(ptr.cfg, "logdir", str(tmp_path / "p"))
    jtr.save()
    ptr.save()
    out = os.path.join("point_cloud", f"iteration_{ptr.iteration}",
                       "model.pkl")
    with open(tmp_path / "j" / out, "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "p" / out, "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == ["appearance", "classifier"]
    assert isinstance(got["appearance"], tuple)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert type(a) is np.ndarray and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    strip = np.asarray(Image.open(os.path.join(
        runs[3], "vis", f"iter_{ITERS:06d}.png")))
    assert strip.shape == (64, 6 * 64, 3)


def test_checkpoints_with_side_networks_resume(runs, scene_dir, tmp_path):
    """The JAX Trainer's checkpoint at 3 (optax's Adam state pickled)
    resumes in the port with equal Gaussians, networks and Adam states;
    the port's own checkpoint at 3 resumes the same way."""
    jtr, ptr, jdir, pdir = runs[:4]
    _, cfg = configs(scene_dir, tmp_path / "j", tmp_path / "p", **{
        "train.start_checkpoint": os.path.join(jdir, "chkpnt3.npz")})
    tr = T.Trainer(cfg, device="cpu")
    assert tr.iteration == 3
    z = np.load(os.path.join(jdir, "chkpnt3.npz"))
    want = pickle.loads(z["extra"].tobytes())["net"]
    got = tr.nets.state_dict()
    assert type(want["app_opt"][0]).__module__ == "optax._src.transform"
    for name in ("app_embeddings", "app_params", "cls_params"):
        for a, b in zip(jax.tree.leaves(got[name]),
                        jax.tree.leaves(want[name])):
            np.testing.assert_array_equal(a, b)
    for name in ("app_opt", "cls_opt"):
        adam = want[name][0]
        assert int(got[name]["count"]) == int(adam.count) == 3
        for part in ("mu", "nu"):
            for a, b in zip(jax.tree.leaves(got[name][part]),
                            jax.tree.leaves(getattr(adam, part))):
                np.testing.assert_array_equal(a, b)
    js, _, _ = JPLY.load_checkpoint(os.path.join(jdir, "chkpnt3.npz"))
    assert_state_close(tr.state, js, atol=0, rtol=0)
    tr.train(log_every=1)
    assert [r["iter"] for r in tr.history] == [4]
    # the port's checkpoint: plain dicts of numpy, read back equal
    path = os.path.join(pdir, "chkpnt3.npz")
    saved = PLY.load_checkpoint(path, "cpu")[2]["net"]
    assert isinstance(saved["app_opt"], dict)
    _, cfg2 = configs(scene_dir, tmp_path / "j2", tmp_path / "p2", **{
        "train.start_checkpoint": path})
    tr2 = T.Trainer(cfg2, device="cpu")
    assert jax.tree.structure(tr2.nets.state_dict()) == jax.tree.structure(
        saved)
    for a, b in zip(jax.tree.leaves(tr2.nets.state_dict()),
                    jax.tree.leaves(saved)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_extra_refuses_other_globals():
    class Sneaky:
        def __reduce__(self):
            return (os.system, ("true",))

    data = pickle.dumps({"net": Sneaky()})
    with pytest.raises(pickle.UnpicklingError, match="refused"):
        PLY.load_extra(data)
    ok = PLY.load_extra(pickle.dumps({"a": (np.arange(3), None)}))
    np.testing.assert_array_equal(ok["a"][0], np.arange(3))


def test_train_cli_writes_tensorboard(scene_dir, tmp_path, monkeypatch,
                                      capsys):
    """The CLI on the TNT recipe with VCR_TB=1: the event file under
    <logdir>/tb holds the JAX package's tags; VCR_WANDB=1 without the wandb
    package prints that it is disabled and trains on."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    from vcr_gaus_tpu_torch.train.__main__ import main

    monkeypatch.setenv("VCR_TB", "1")
    monkeypatch.setenv("VCR_WANDB", "1")
    monkeypatch.setitem(sys.modules, "wandb", None)
    args = ["--config", TNT, "--device", "cpu"] + overrides(
        scene_dir, tmp_path, **{"optim.iterations": 2,
                                "train.test_iterations": [2],
                                "train.save_iterations": [2],
                                "train.checkpoint_iterations": []})
    tr = main(args)
    assert tr.iteration == 2
    assert "[wandb] disabled" in capsys.readouterr().out
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    tags = acc.Tags()
    assert {"train/total", "train/semantic", "eval/train_miou",
            "scene/total_points"} <= set(tags["scalars"])
    assert "vis/train_sem" in tags["images"]
    assert "scene/opacity_histogram" in tags["histograms"]
    # one record per flush: every 50 iterations and the last
    assert [e.step for e in acc.Scalars("train/total")] == [2]


@pytest.mark.parametrize("gates", [(True,) * 5, (True, True, False, True,
                                                  True),
                                   (True, False, True, True, True)],
                         ids=["open", "curv_closed", "depth_normal_closed"])
def test_compute_losses_match_jax(gates):
    """compute_losses of both packages on one render's outputs (smooth
    depth, so that its normals are well defined), every loss of the JAX
    package weighted: the same losses at rtol 1e-5; curv only inside the
    depth_normal gate and its own."""
    from test_renderer import make_scene
    from vcr_gaus_tpu.data.cameras import CameraArrays as JCam
    from vcr_gaus_tpu.models import appearance as JAPP
    from vcr_gaus_tpu_torch.data.cameras import CameraArrays
    from vcr_gaus_tpu_torch.train.side_nets import SideNets

    rng = np.random.default_rng(9)
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = 2.0 + 0.3 * np.sin(xx / 9.0) * np.cos(yy / 7.0)

    def unit(a):
        return a / np.linalg.norm(a, axis=-1, keepdims=True)

    out = {"render": rng.uniform(size=(3, h, w)),
           "depth": depth, "normal": unit(rng.normal(size=(h, w, 3))),
           "est_normal": unit(np.stack([np.sin(xx / 9.0), np.cos(yy / 7.0),
                                        -2.0 * np.ones_like(xx)], -1)),
           "mask": rng.uniform(size=(h, w)) > 0.2,
           "distortion": rng.uniform(size=(h, w)),
           "depth_var": rng.uniform(size=(h, w)),
           "render_sem": rng.normal(size=(2, h, w))}
    out = {k: v.astype(np.float32) if v.dtype != bool else v
           for k, v in out.items()}
    cam = dict(viewmatrix=np.eye(4, dtype=np.float32),
               projmatrix=np.eye(4, dtype=np.float32),
               cam_center=np.zeros(3, np.float32),
               intr=np.array([50, 50, 32, 24], np.float32),
               tanfov=np.ones(2, np.float32),
               image=rng.uniform(size=(3, h, w)).astype(np.float32),
               normal=unit(rng.normal(size=(h, w, 3))).transpose(
                   2, 0, 1).astype(np.float32),
               depth=rng.uniform(0.1, 1, (h, w)).astype(np.float32),
               mask=rng.integers(0, 3, (h, w)).astype(np.int32),
               has_normal=np.asarray(True), has_depth=np.asarray(True),
               has_mask=np.asarray(True), idx=np.asarray(1, np.int32))
    js, _ = make_scene(n=200, cap=256, seed=2)
    inside = rng.uniform(size=256) > 0.3
    cfg = Config(TNT)
    weights = {k: 0.1 for k in T.PORTED_LOSSES}
    emb, params = JAPP.init_appearance(jax.random.PRNGKey(1), 3, h, w)
    net = JT.NetState(emb, params, None, None, None)
    _, want = JT.compute_losses(
        {k: jnp.asarray(v) for k, v in out.items()},
        JCam(**{k: jnp.asarray(v) for k, v in cam.items()}), js, weights,
        JT.Gates(*gates), JConfig(TNT), net, jnp.asarray(inside), 2)
    nets = SideNets(cfg, 3, 0, 2, torch.Generator().manual_seed(0), "cpu")
    nets.load_state_dict({"app_embeddings": np.asarray(emb),
                          "app_params": jax.tree.map(np.asarray, params),
                          "app_opt": {"count": 0, "mu": (
                              np.zeros((3, 64), np.float32),
                              jax.tree.map(np.zeros_like, params)),
                              "nu": (np.zeros((3, 64), np.float32),
                                     jax.tree.map(np.zeros_like, params))}})
    _, got = T.compute_losses(
        {k: torch.tensor(v) for k, v in out.items()},
        CameraArrays(**{k: torch.tensor(v) for k, v in cam.items()}),
        state_from_arrays(jax_state_arrays(js), "cpu"), weights,
        T.Gates(*gates), cfg, torch.tensor(inside), nets, 2)
    assert set(got) == set(want)
    assert ("curv" in got) == (gates[1] and gates[2])
    for k, v in want.items():
        assert float(got[k]) == pytest.approx(float(v), rel=1e-5,
                                              abs=1e-9), k
