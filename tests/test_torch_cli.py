"""The port's train CLI takes the root train.py's ``--seed`` and ``--wandb``
as train.py does (train.py:21-27): ``--seed`` is parsed and dropped, so the
run keeps the YAML's seed and draws the JAX Trainer's camera order for it;
``--wandb`` sets ``VCR_WANDB=1``."""

import os
import random
import types

import pytest
import torch

from fixtures import write_colmap_scene
from vcr_gaus_tpu.config import Config as JConfig
from vcr_gaus_tpu.train import trainer as JT
from vcr_gaus_tpu_torch.train import trainer as T
from vcr_gaus_tpu_torch.train.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "dtu", "base.yaml")
ITERS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_cli_scene"))
    write_colmap_scene(root, n_cams=6, n_pts=300, width=48, height=32,
                       with_priors=True)
    return root


def jax_camera_order(n_cams: int, n: int) -> list[int]:
    """The cameras the JAX Trainer draws from the YAML's seed, which its
    CLI keeps whatever --seed says."""
    seed = JConfig(CONFIG).seed
    stub = types.SimpleNamespace(viewpoint_stack=[], rng=random.Random(seed),
                                 _cam_arrays=range(n_cams))
    return [JT.Trainer._next_camera_index(stub) for _ in range(n)]


@pytest.mark.parametrize("extra", [["--seed=3"], ["--seed", "3"],
                                   ["--seed", "3", "--wandb"]],
                         ids=["seed_eq", "seed_space", "seed_wandb"])
def test_train_cli_seed_and_wandb(scene_dir, tmp_path, monkeypatch, extra):
    # record VCR_WANDB's absence so the flag's setting is undone afterwards
    monkeypatch.setenv("VCR_WANDB", "unset")
    monkeypatch.delenv("VCR_WANDB")
    picked = []
    pick = T.Trainer._pick_camera_batch

    def spy(self):
        picked.extend(pick(self))      # one camera a step at camera_batch 1
        return picked[-1:]

    monkeypatch.setattr(T.Trainer, "_pick_camera_batch", spy)
    tr = main(["--config", CONFIG, f"--logdir={tmp_path}",
               f"--model.source_path={scene_dir}",
               "--model.normal_folder=normals",
               f"--optim.iterations={ITERS}", "--device", "cpu", *extra])
    assert tr.iteration == ITERS
    assert tr.cfg.seed == JConfig(CONFIG).seed == 0
    # the iterations' cameras, then the final test sweep's panel draws none
    assert picked == jax_camera_order(6, ITERS)
    assert (os.environ.get("VCR_WANDB") == "1") == ("--wandb" in extra)
