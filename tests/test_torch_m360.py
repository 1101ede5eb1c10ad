"""The Mip-NeRF 360 recipe on the port, at a small size on the CPU: the
benchmark's ``m360.step_late`` cell cut to 3,000 Gaussians in 4,096 slots
(an object, the ground and the surroundings, in the cell's proportions) and
eight 96x64 views orbiting inside them.

- ``Trainer.train_step`` against the plain reference
  (``gsbench/reference/step.py``) from the same seed: the losses by term,
  the step-1 gradient norms and the update, within the cell's limits;
- the recipe's llffhold 8 split: the trainer trains on views 1-7, the
  reference follows its camera order and its camera extent;
- the ``render.binned`` counter: on every traced view, the Gaussians the
  reference's own binning gives at least one tile.
"""

import numpy as np
import pytest
import torch

from gsbench import harness as H
from gsbench.drivers import train_steps_unbounded as UD
from gsbench.population import PARAM_NAMES
from gsbench.reference import camera as RC
from gsbench.reference import render as RR
from gsbench.reference import step as RS
from gsbench.tests.tiny import SEED
from gsbench.tests.tiny_unbounded import CELL, TINY
from vcr_gaus_tpu_torch.train.trainer import Trainer
from vcr_gaus_tpu_torch.utils import tracing


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(one_thread, tmp_path_factory):
    """The tiny cell driven as the benchmark drives it: set-up (3 checked
    steps, a warm-up step), a short window, 2 traced steps, then the
    reference; with the trainer's camera picks and each traced step's
    counter record, state and view."""
    cell = H.cell(CELL, overrides=TINY)
    r = UD.Run(cell, SEED, "cpu", str(tmp_path_factory.mktemp("m360")))
    picks, pick = [], Trainer._pick_camera_batch

    def spy(self):
        idxs = pick(self)
        picks.extend(self.scene.train_cameras[i].image_name for i in idxs)
        return idxs

    Trainer._pick_camera_batch = spy
    try:
        r.setup()
        trainer = r.trainer
        split = ([c.image_name for c in trainer.scene.train_cameras],
                 [c.image_name for c in trainer.scene.test_cameras])
        extent = float(trainer.extent)
        r.window(0.05)
        r.trace()
    finally:
        Trainer._pick_camera_batch = pick
    n = len(r.states)
    records = tracing.steps(n)
    order = RS.camera_order(SEED, len(r.scene.views), r.done + n)[r.done:]
    traced = [(params, active, r.scene.views[vi])
              for (params, active), vi in zip(r.states, order, strict=True)]
    del trainer
    r.traced()
    return {"cell": cell, "run": r, "numbers": r.numbers(), "picks": picks,
            "split": split, "extent": extent, "records": records,
            "traced": traced}


def test_the_step_matches_the_reference(run):
    limits = H.cell(CELL).limits
    assert set(limits) == {"loss_gap", "grad_gap", "update_gap"}
    for k, limit in limits.items():
        assert run["numbers"][k] <= limit, (k, run["numbers"])
    prog, ref = run["run"].prog, run["run"].ref
    terms = {"l1", "ssim", "l1_scale", "mono_normal", "depth_normal",
             "total"}
    assert [set(x) for x in ref["loss"]] == [terms] * 3
    assert [set(x) for x in prog["loss"]] == [terms] * 3
    assert set(prog["grad"]) == set(ref["grad"]) == set(prog["delta"])
    assert all(v > 0 for v in ref["delta"].values())


def test_the_trainer_trains_on_views_1_to_7(run):
    train, test = run["split"]
    assert train == [f"view_{i:03d}" for i in range(1, 8)]
    assert test == ["view_000"]
    views = run["run"].scene.views
    assert [v.name for v in views] == train
    # every step's view, the checked, warm-up, window and traced ones
    order = RS.camera_order(SEED, len(views), len(run["picks"]))
    assert run["picks"] == [views[i].name for i in order]
    assert len(run["picks"]) == run["run"].done + len(run["traced"])
    scene = run["run"].scene
    centers = np.stack([RC.make_cam(v.qvec, v.tvec, scene.fovx, scene.fovy,
                                    scene.width, scene.height, "cpu")
                        .cam_center.double().numpy() for v in views])
    assert run["extent"] == pytest.approx(RC.camera_extent(centers),
                                          rel=1e-5)


def test_binned_counts_the_reference_binning(run):
    cfg, scene = run["cell"].cfg, run["run"].scene
    assert len(run["records"]) == len(run["traced"]) == 2
    for record, (params, active, view) in zip(run["records"], run["traced"],
                                              strict=True):
        cam = RC.make_cam(view.qvec, view.tvec, scene.fovx, scene.fovy,
                          scene.width, scene.height, "cpu")
        p = {k: getattr(params, k).detach() for k in PARAM_NAMES}
        _, binn, _ = RR.prepare(p, active, cam, scene.width, scene.height,
                                int(cfg["model"]["sh_degree"]), 0)
        binned = int(torch.unique(binn.sorted_gid).numel())
        assert 0 < binned < int(active.sum())
        assert record["render.binned"] == [binned]
        assert record["render.entries"] == [binn.sorted_gid.numel()]
