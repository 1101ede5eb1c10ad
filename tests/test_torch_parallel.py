"""Camera-DP and scene-DP of the port (vcr_gaus_tpu_torch/parallel/dp.py)
on the CPU: 2 gloo ranks started by torch.multiprocessing.spawn, their
process group at a ``file://`` store under the test's directory (no TCP
port, safe under xdist).

Each rank trains the DTU recipe at ``tpu.camera_batch = 4`` (2 views a
rank a step) for 4 steps with a densify after step 3, from the JAX
Trainer's init state with anisotropic scales and random rotations
(``test_torch_camera_batch.anisotropic``): the trainer's own camera-DP
step, the port's only one. Held: both ranks' states identical, exactly;
against the single-process port and the JAX Trainer at camera_batch 4 (its
mesh of 4 virtual devices), per-step losses at rtol 1e-4, the camera draws
equal, the active masks exactly and the state after every step at 1e-5
(but for Adam's rounding-noise elements,
``test_torch_camera_batch.steps_close_but_noise``); only rank 0 wrote
files. ``scene_dispatch`` returns its results in order, sequential and
parallel; the process-group helpers work without a group.
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
    ``state_to_arrays`` dict): (state arrays, history, draws, state arrays
    after each step)."""
    from vcr_gaus_tpu_torch.train.trainer import Trainer
    tr = Trainer(Config(DTU, overrides=overrides(scene, logdir)),
                 device="cpu")
    tr.state = state_from_arrays(start, "cpu")
    tr.rng = Recording(0)
    states = []
    step = tr.train_step

    def recorded():
        out = step()
        states.append(state_to_arrays(tr.state))
        return out

    tr.train_step = recorded
    tr.train(max_iters=ITERS, log_every=1)
    return state_to_arrays(tr.state), tr.history, tr.rng.draws, states


def _rank_main(rank, store, scene, out_dir, inputs):
    """One gloo rank: the trainer at camera_batch K; its results pickled
    under ``out_dir``."""
    torch.set_num_threads(1)
    dp.init_process_group(rank, WORLD, f"file://{store}", "cpu")
    try:
        with open(inputs, "rb") as f:
            inp = pickle.load(f)
        res = dict(zip(("state", "history", "draws", "states"), train_port(
            scene, os.path.join(out_dir, f"log{rank}"), inp["start"])))
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
    """The JAX Trainer, the single-process port and the two gloo ranks,
    from the same state."""
    from test_torch_camera_batch import anisotropic
    from test_torch_train import jax_state_arrays
    from vcr_gaus_tpu.config import Config as JConfig
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
                          jax_state_arrays(jtr.state)))

    inputs = str(root / "inputs.pkl")
    with open(inputs, "wb") as f:
        pickle.dump({"start": start}, f)
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
    return dict(jax=(jtr, jax_steps), single=single, ranks=ranks, out=out)


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


def check_against(rank, history, draws, states):
    from test_torch_camera_batch import steps_close_but_noise
    assert [r["iter"] for r in rank["history"]] == list(range(1, ITERS + 1))
    for want, got in zip(history, rank["history"]):
        for name, v in want.items():
            if name not in ("iter", "n_active", "time"):
                assert got[name] == pytest.approx(v, rel=1e-4, abs=1e-7), (
                    got["iter"], name)
    assert rank["draws"] == draws
    # 2K before the first step, K a step, the densify's 3 box-mask views
    assert len(draws) == K * (ITERS + 1) + 3
    assert len(rank["states"]) == len(states) == ITERS
    for x, y in zip(rank["states"], states):
        np.testing.assert_array_equal(x["active"], y["active"])
    steps_close_but_noise(rank["states"], states)


def test_camera_dp_matches_single_process(runs):
    _, history, draws, states = runs["single"]
    check_against(runs["ranks"][0], history, draws, states)


def test_camera_dp_matches_jax_trainer(runs):
    jtr, steps = runs["jax"]
    history = [{**losses, "iter": i} for i, (losses, _) in
               enumerate(steps, 1)]
    check_against(runs["ranks"][0], history, jtr.rng.draws,
                  [st for _, st in steps])


def test_only_rank_zero_writes(runs):
    out = runs["out"]
    log0 = out / "log0"
    assert {"cameras.json", "cfg_args", "chkpnt4.npz",
            "point_cloud"} <= set(os.listdir(log0))
    assert (log0 / "point_cloud" / "iteration_4" / "point_cloud.ply").exists()
    assert not (out / "log1").exists()


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
