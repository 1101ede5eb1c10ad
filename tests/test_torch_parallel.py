"""Camera-DP and scene-DP of the port (vcr_gaus_tpu_torch/parallel/dp.py)
on the CPU: 2 gloo ranks started by torch.multiprocessing.spawn, their
process group at a ``file://`` store under the test's directory (no TCP
port, safe under xdist).

Each rank trains the DTU recipe at ``tpu.camera_batch = 4`` (2 views a
rank a step) for 4 steps with a densify after step 3, from the JAX
Trainer's init state with anisotropic scales and random rotations
(``test_torch_camera_batch.anisotropic``), then runs the standalone
``make_camera_dp_step`` on its camera of a 2-camera batch. Held: both
ranks' states identical, exactly; against the single-process port and the
JAX Trainer at camera_batch 4 (its mesh of 4 virtual devices), per-step
losses at rtol 1e-4, the camera draws equal, the active masks exactly and
the state at 1e-5 (but for Adam's rounding-noise elements, as in
test_torch_camera_batch); only rank 0 wrote files; the standalone step
against the JAX package's ``make_camera_dp_step`` on a 2-device mesh.
``scene_dispatch`` returns its results in order, sequential and parallel.
"""

import json
import os
import pickle
import random
import threading

import numpy as np
import pytest
import torch

from fixtures import write_colmap_scene
from vcr_gaus_tpu_torch.config import Config
from vcr_gaus_tpu_torch.models.convert import (state_from_arrays,
                                               state_to_arrays)
from vcr_gaus_tpu_torch.parallel import dp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTU = os.path.join(REPO, "configs", "dtu", "base.yaml")
ITERS = 4
K = 4
WORLD = 2


class Recording(random.Random):
    """random.Random that records every randint draw."""

    def __init__(self, seed):
        super().__init__(seed)
        self.draws = []

    def randint(self, a, b):
        v = super().randint(a, b)
        self.draws.append((a, b, v))
        return v


def overrides(scene, logdir):
    ov = {"logdir": str(logdir), "model.source_path": scene,
          "model.normal_folder": "normals", "model.depth_type": "traditional",
          "optim.iterations": 100, "optim.densify_from_iter": 1,
          "optim.densification_interval": 3,
          "optim.densify_large.sample_cams.num": 3,
          "train.test_iterations": [], "train.save_iterations": [ITERS],
          "train.checkpoint_iterations": [ITERS], "tpu.capacity": 512,
          "tpu.steps_per_call": 1, "tpu.tile": 16, "tpu.camera_batch": K}
    return [f"--{k}={json.dumps(v) if isinstance(v, list) else v}"
            for k, v in ov.items()]


def train_port(scene, logdir, start):
    """The port's Trainer over ITERS steps from the state ``start`` (a
    ``state_to_arrays`` dict): (state arrays, history, draws, active masks
    per step)."""
    from vcr_gaus_tpu_torch.train.trainer import Trainer
    tr = Trainer(Config(DTU, overrides=overrides(scene, logdir)),
                 device="cpu")
    tr.state = state_from_arrays(start, "cpu")
    tr.rng = Recording(0)
    masks = []
    step = tr.train_step

    def recorded():
        out = step()
        masks.append(tr.state.active.numpy().copy())
        return out

    tr.train_step = recorded
    tr.train(max_iters=ITERS, log_every=1)
    return state_to_arrays(tr.state), tr.history, tr.rng.draws, masks


def _rank_main(rank, store, scene, out_dir, inputs):
    """One gloo rank: the trainer at camera_batch K, then the standalone
    step on this rank's camera; its results pickled under ``out_dir``."""
    torch.set_num_threads(1)
    dp.init_process_group(rank, WORLD, f"file://{store}", "cpu")
    try:
        with open(inputs, "rb") as f:
            inp = pickle.load(f)
        res = dict(zip(("state", "history", "draws", "masks"), train_port(
            scene, os.path.join(out_dir, f"log{rank}"), inp["start"])))
        # the standalone step on this rank's share of a 2-camera batch
        from vcr_gaus_tpu_torch.data.cameras import CameraArrays
        from vcr_gaus_tpu_torch.render.renderer import RenderConfig
        batch = dp.stack_cameras([CameraArrays(**{
            k: torch.tensor(v) for k, v in cam.items()})
            for cam in inp["cams"]])
        step = dp.make_camera_dp_step(
            RenderConfig(width=64, height=48, ch_sem=0,
                         depth_mode="traditional"), scene_extent=100.0)
        st, loss = step(state_from_arrays(inp["synthetic"], "cpu"),
                        dp.shard_camera_batch(batch), torch.zeros(3), 1e-3)
        res["dp_step"] = (state_to_arrays(st), float(loss))
        res["world"] = dp.world()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX Trainer and the standalone JAX step, the single-process
    port and the two gloo ranks, from the same states."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as g
    from test_torch_camera_batch import anisotropic
    from test_torch_train import jax_state_arrays
    from vcr_gaus_tpu.config import Config as JConfig
    from vcr_gaus_tpu.parallel import dp as JDP
    from vcr_gaus_tpu.render.renderer import RenderConfig as JRCfg
    from vcr_gaus_tpu.train import trainer as JT

    root = tmp_path_factory.mktemp("parallel")
    scene = str(root / "scene")
    write_colmap_scene(scene, n_cams=6, n_pts=300, width=48, height=32,
                       with_priors=True)
    jtr = JT.Trainer(JConfig(DTU, overrides=overrides(scene, root / "j")))
    assert jtr.mesh is not None and jtr.mesh.devices.size == K
    jtr.state = anisotropic(jtr)
    start = jax_state_arrays(jtr.state)
    jtr.rng = Recording(0)
    jax_steps = []
    for _ in range(ITERS):
        losses, _ = jtr.train_step()
        jax_steps.append(({k: float(v) for k, v in losses.items()},
                          np.asarray(jtr.state.active)))

    # the standalone step: 2 cameras on a 2-device mesh, the synthetic
    # state made anisotropic as above
    rng = np.random.default_rng(2)
    syn = g._synthetic_state(n=128, cap=256)
    syn = syn._replace(params=syn.params._replace(
        log_scale=syn.params.log_scale + jnp.asarray(
            rng.uniform(-0.7, 0.7, (256, 3)), jnp.float32),
        quat=jnp.asarray(rng.normal(size=(256, 4)), jnp.float32)))
    cams = [g._synthetic_camera(idx=i, seed=i) for i in range(WORLD)]
    mesh = JDP.data_mesh(WORLD)
    jstep = JDP.make_camera_dp_step(
        JRCfg(width=64, height=48, ch_sem=0, depth_mode="traditional",
              entry_budget=1 << 13), mesh, scene_extent=100.0)
    jst, jloss = jstep(JDP.replicate(syn, mesh), JDP.shard_camera_batch(
        JDP.stack_cameras(cams), mesh), jnp.zeros(3), jnp.asarray(1e-3))

    inputs = str(root / "inputs.pkl")
    with open(inputs, "wb") as f:
        pickle.dump({"start": start, "synthetic": jax_state_arrays(syn),
                     "cams": [{k: np.asarray(v) for k, v in
                               c._asdict().items()} for c in cams]}, f)
    out = root / "ranks"
    out.mkdir()
    torch.multiprocessing.spawn(
        _rank_main, args=(str(root / "store"), scene, str(out), inputs),
        nprocs=WORLD)
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    single = train_port(scene, root / "single", start)
    return dict(jax=(jtr, jax_steps), jax_step=(jax_state_arrays(jst),
                                                float(jloss)),
                single=single, ranks=ranks, out=out)


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [np.asarray(tree)]


def test_ranks_stay_identical(runs):
    a, b = runs["ranks"]
    assert [r["world"] for r in runs["ranks"]] == [(0, 2), (1, 2)]
    for x, y in zip(leaves(a["state"]), leaves(b["state"])):
        np.testing.assert_array_equal(x, y)
    assert a["history"] == b["history"]
    assert a["draws"] == b["draws"]
    for x, y in zip(leaves(a["dp_step"][0]), leaves(b["dp_step"][0])):
        np.testing.assert_array_equal(x, y)
    assert a["dp_step"][1] == b["dp_step"][1]


def check_against(rank, history, draws, masks, state):
    from test_torch_camera_batch import arrays_close_but_noise
    assert [r["iter"] for r in rank["history"]] == list(range(1, ITERS + 1))
    for want, got in zip(history, rank["history"]):
        for name, v in want.items():
            if name not in ("iter", "n_active", "time"):
                assert got[name] == pytest.approx(v, rel=1e-4, abs=1e-7), (
                    got["iter"], name)
    assert rank["draws"] == draws
    # 2K before the first step, K a step, the densify's 3 box-mask views
    assert len(draws) == K * (ITERS + 1) + 3
    for x, y in zip(rank["masks"], masks):
        np.testing.assert_array_equal(x, y)
    arrays_close_but_noise(rank["state"], state)


def test_camera_dp_matches_single_process(runs):
    state, history, draws, masks = runs["single"]
    check_against(runs["ranks"][0], history, draws, masks, state)


def test_camera_dp_matches_jax_trainer(runs):
    from test_torch_train import jax_state_arrays
    jtr, steps = runs["jax"]
    history = [{**losses, "iter": i} for i, (losses, _) in
               enumerate(steps, 1)]
    check_against(runs["ranks"][0], history, jtr.rng.draws,
                  [m for _, m in steps], jax_state_arrays(jtr.state))


def test_only_rank_zero_writes(runs):
    out = runs["out"]
    log0 = out / "log0"
    assert {"cameras.json", "cfg_args", "chkpnt4.npz",
            "point_cloud"} <= set(os.listdir(log0))
    assert (log0 / "point_cloud" / "iteration_4" / "point_cloud.ply").exists()
    assert not (out / "log1").exists()


def test_camera_dp_step_matches_jax(runs):
    from test_torch_camera_batch import arrays_close_but_noise
    want, want_loss = runs["jax_step"]
    got, loss = runs["ranks"][0]["dp_step"]
    assert loss == pytest.approx(want_loss, rel=1e-5)
    arrays_close_but_noise(got, want)
    start = runs["ranks"][0]["dp_step"][0]["step"]
    assert start == 1 and np.abs(got["params"]["xyz"]).max() > 0


@pytest.mark.parametrize("parallel", [False, True])
def test_scene_dispatch_returns_in_order(parallel):
    seen, lock, live = [], threading.Lock(), [0, 0]

    def make(i):
        def fn(device):
            with lock:
                live[0] += 1
                live[1] = max(live[1], live[0])
            x = torch.full((8,), float(i), device=device)
            seen.append(device)
            with lock:
                live[0] -= 1
            return float(x.sum())
        return fn

    out = dp.scene_dispatch([make(i) for i in range(5)], ["cpu", "cpu"],
                            parallel=parallel)
    assert out == [0.0, 8.0, 16.0, 24.0, 32.0]
    assert all(d == torch.device("cpu") for d in seen) and len(seen) == 5
    assert live[1] <= 2


def test_process_group_helpers_without_a_group():
    assert dp.world() == (0, 1)
    assert dp.backend_for("cpu") == "gloo"
    assert dp.backend_for("cuda:1") == "nccl"
    with pytest.raises(ValueError, match="index"):
        dp.init_process_group(0, 1, "file:///nonexistent/store", "cuda")
    state = {"a": torch.ones(3)}
    assert dp.replicate(state) is state
    dp.barrier()
