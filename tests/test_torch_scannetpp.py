"""The ScanNet++ recipe on the port, at a small size on the CPU: the
benchmark's ``scannetpp.step_late`` cell cut to 3,000 Gaussians in 4,096
slots (the room's shell and furniture, in the cell's proportions) and ten
96x64 views standing inside the room.

- the configuration is the recipe, merged as the port merges it;
- the room is drawn as its ``bench`` block states;
- ``Trainer.train_step`` against the plain reference
  (``gsbench/reference/step.py``) from the same seed: the losses by term,
  the curvature among them, the step-1 gradient norms and the update,
  within the cell's limits;
- the recipe's metadata split: the trainer trains on meta.json's eight
  train views, the reference follows its camera order and its camera
  extent;
- the check is tight enough: a program without the curvature, and the
  reference in bfloat16, read ``correct`` false;
- the ``train.losses.curv`` span and its reader ``curv_ms.step``.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from gsbench import harness as H
from gsbench import room as RM
from gsbench.drivers import train_steps as TS
from gsbench.drivers import train_steps_room as RD
from gsbench.reference import camera as RC
from gsbench.reference import step as RS
from gsbench.tests.test_gsbench_tracing_readers import EVENTS, read, traced, x
from gsbench.tests.tiny import SEED
from gsbench.tests.tiny_room import CELL, TINY
from vcr_gaus_tpu_torch.config import load_yaml_with_parents
from vcr_gaus_tpu_torch.train import losses as L
from vcr_gaus_tpu_torch.train.trainer import Trainer

RECIPE = os.path.join(H.ROOT, "configs", "scannetpp", "base.yaml")
TRAIN = [f"view_{i:03d}" for i in (0, 1, 2, 3, 5, 6, 7, 8)]
TEST = ["view_004", "view_009"]


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
    reference; with the trainer's camera picks, its split and extent, and
    the scene's meta.json."""
    cell = H.cell(CELL, overrides=TINY)
    r = RD.Run(cell, SEED, "cpu", str(tmp_path_factory.mktemp("room")))
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
    with open(os.path.join(r.scene.root, "meta.json")) as f:
        meta = json.load(f)
    del trainer
    r.traced()
    return {"cell": cell, "run": r, "numbers": r.numbers(), "picks": picks,
            "split": split, "extent": extent, "meta": meta,
            "trace": r.tr_obj}


def test_the_configuration_is_the_recipe():
    """Every key of the recipe merged over its parents, as the port merges
    it; changed: the capacity, and the ``bench`` block added."""
    cfg = H.cell(CELL).cfg
    bench = cfg.pop("bench")
    recipe = load_yaml_with_parents(RECIPE)
    assert cfg["tpu"].pop("capacity") == 1 << 22
    recipe["tpu"].pop("capacity")
    assert cfg == recipe
    o, m = cfg["optim"], cfg["model"]
    assert (o["loss_weight"]["curv"], o["curv_from_iter"]) == (0.05, 15000)
    assert (o["mask_depth_thr"], m["split"], m["eval"]) == (0, True, True)
    pop = bench["population"]
    assert pop["capacity"] == 1 << 22
    assert pop["count"] == (bench["room"]["shell"]["count"]
                            + bench["room"]["furniture"]["count"])


@pytest.mark.parametrize("layout_seed", [0, 7, 2 ** 40 + 3])
def test_the_room_is_drawn_as_stated(layout_seed):
    """The shell on the room's faces and the furniture on its boxes, each
    part at twice its own spacing; the views in the free space, at their
    heights and tilts. The room is the layout seed's, whatever the run's
    seed."""
    cfg = H.cell(CELL, overrides={**TINY, "config": {
        **TINY["config"], "bench": {**TINY["config"]["bench"],
                                    "layout_seed": layout_seed}}}).cfg
    b = cfg["bench"]
    room, views = b["room"], b["views"]
    half = np.asarray(room["half_extents"])
    lay = RM.layout(b)
    boxes = lay["boxes"]
    f = room["furniture"]
    assert boxes.shape == (f["boxes"], 2, 3)
    side = boxes[:, 1] - boxes[:, 0]
    assert np.all((side >= f["side"][0]) & (side <= f["side"][1]))
    mid = boxes.mean(1)
    assert np.all(np.abs(mid[:, [0, 2]]) <= half[[0, 2]]
                  - f["wall_clearance"] + 1e-12)
    floor = np.isclose(boxes[:, 0, 1], -half[1])
    assert floor[:f["boxes"] - f["raised"]].all()
    assert np.all(boxes[:, 1] < half) and np.all(boxes[:, 0] >= -half)
    c = lay["centers"]
    clear = views["clearance"]
    assert np.all(np.abs(c[:, [0, 2]]) <= half[[0, 2]] - clear)
    assert np.all((c[:, 1] >= views["y_range"][0])
                  & (c[:, 1] <= views["y_range"][1]))
    assert np.all(RM._box_distance(c, boxes) >= clear)
    for (q, t), p in zip(lay["poses"], c, strict=True):
        R = RC.qvec_to_rotmat(q)
        np.testing.assert_allclose(-R.T @ t, p, atol=1e-9)
        tilt = math.degrees(math.asin(-R[2, 1]))
        assert views["tilt_deg"][0] - 1e-9 <= tilt <= views["tilt_deg"][1]
        assert abs(R[0, 1]) < 1e-9          # no roll: the image's x is level

    params, active = RD.make_population(cfg, SEED, "cpu")
    assert int(active.sum()) == b["population"]["count"] == 3000
    xyz = params["xyz"][active].double().numpy()
    ls = params["log_scale"][active].double().numpy()
    tol = 1e-6
    on_wall = (np.abs(np.abs(xyz) - half) < tol).any(1)
    within = ((xyz[:, None] >= boxes[None, :, 0] - tol)
              & (xyz[:, None] <= boxes[None, :, 1] + tol)).all(2)
    on_face = ((np.abs(xyz[:, None] - boxes[None, :, 0]) < tol)
               | (np.abs(xyz[:, None] - boxes[None, :, 1]) < tol)).any(2)
    on_box = (within & on_face).any(1)
    assert (on_wall | on_box).all()
    assert on_wall.sum() >= room["shell"]["count"]
    assert (on_box & ~on_wall).sum() > 0.9 * f["count"]
    area_room = 8 * (half[0] * half[1] + half[1] * half[2]
                     + half[0] * half[2])
    area_boxes = 2 * (side[:, 0] * side[:, 1] + side[:, 1] * side[:, 2]
                      + side[:, 0] * side[:, 2]).sum()
    for part, area in ((~on_box, area_room), (on_box & ~on_wall,
                                              area_boxes)):
        assert abs(float(ls[part].mean())
                   - math.log(2 * math.sqrt(area / 1500))) < 0.02
    assert torch.equal(params["xyz"][~active],
                       torch.zeros_like(params["xyz"][~active]))


def test_the_step_matches_the_reference(run):
    limits = H.cell(CELL).limits
    assert set(limits) == {"loss_gap", "grad_gap", "update_gap"}
    for k, limit in limits.items():
        assert run["numbers"][k] <= limit, (k, run["numbers"])
    prog, ref = run["run"].prog, run["run"].ref
    terms = {"l1", "ssim", "l1_scale", "mono_normal", "depth_normal", "curv",
             "total"}
    assert [set(x) for x in ref["loss"]] == [terms] * 3
    assert [set(x) for x in prog["loss"]] == [terms] * 3
    assert all(x["curv"] > 0 for x in prog["loss"] + ref["loss"])
    assert set(prog["grad"]) == set(ref["grad"]) == set(prog["delta"])
    assert all(v > 0 for v in ref["delta"].values())


def test_the_trainer_trains_on_the_metadata_train_views(run):
    train, test = run["split"]
    assert (train, test) == (TRAIN, TEST)
    meta = run["meta"]
    assert (meta["train"], meta["test"]) == (TRAIN, TEST)
    half = H.cell(CELL).cfg["bench"]["room"]["half_extents"]
    np.testing.assert_allclose(meta["scale"], 1.1 * np.asarray(half))
    views = run["run"].scene.views
    assert [v.name for v in views] == train
    # every step's view, the checked, warm-up, window and traced ones
    order = RS.camera_order(SEED, len(views), len(run["picks"]))
    assert run["picks"] == [views[i].name for i in order]
    scene = run["run"].scene
    centers = np.stack([RC.make_cam(v.qvec, v.tvec, scene.fovx, scene.fovy,
                                    scene.width, scene.height, "cpu")
                        .cam_center.double().numpy() for v in views])
    assert run["extent"] == pytest.approx(RC.camera_extent(centers),
                                          rel=1e-5)


@pytest.mark.parametrize("weaker", ["no_curvature", "bfloat16"])
def test_a_weaker_program_is_not_correct(run, weaker, tmp_path,
                                         monkeypatch):
    """The program with a curvature that reads zero, and the reference
    itself in bfloat16 put in the program's place, each fail a limit."""
    r, cfg = run["run"], run["cell"].cfg
    if weaker == "no_curvature":
        monkeypatch.setattr(L, "normal2curv", lambda n, m: torch.zeros_like(
            n[..., :1]))
        scene = RD.make_scene(cfg, SEED, str(tmp_path / "scene"), "cpu")
        trainer = RD.build_trainer(cfg, scene, SEED, "cpu")
        got = TS.program_readings(trainer, r.n_check, r.start)
        assert all(x["curv"] == 0 for x in got["loss"])
    else:
        inp = RD.reference_inputs(cfg, r.scene, r.n_images, SEED, r.start,
                                  "cpu")
        got = RS.run_reference(inp, r.n_check, "cpu", dtype=torch.bfloat16)
    nums = TS.numbers(got, r.ref)
    checks = {k: {"value": nums[k], "limit": v}
              for k, v in H.cell(CELL).limits.items()}
    assert not H.passed(checks), checks


def test_the_traced_steps_hold_the_curvature_span(run):
    trace = run["trace"]

    def spans(name):
        return sorted((s, e) for evs in trace.host.values()
                      for s, e, n in evs if n == name)

    curv, losses = spans("train.losses.curv"), spans("train.losses")
    assert len(curv) == len(losses) == 2
    for (s, e), (ls, le) in zip(curv, losses, strict=True):
        assert ls <= s and e <= le
    # no device on the CPU: the reader finds nothing to read
    assert read("curv_ms.step", H.Traced(trace, 2, [], 0.01, {})) is None


@pytest.mark.parametrize("steps", [1, 2])
def test_curv_ms_reads_the_spans_kernels(steps):
    """The device ms a step of the kernels launched inside the span, which
    ``losses_ms.step`` counts too; nothing without the span."""
    events = EVENTS + [
        x("user_annotation", "train.losses", 400, 100),
        x("user_annotation", "train.losses.curv", 410, 50),
        x("cuda_runtime", "cudaLaunchKernel", 420, 5, corr=9),
        x("kernel", "abs_kernel", 600, 40, tid=7, corr=9),
        x("cuda_runtime", "cudaLaunchKernel", 470, 5, corr=10),
        x("kernel", "mean_kernel", 650, 30, tid=7, corr=10)]
    assert math.isclose(read("curv_ms.step", traced(events, steps)),
                        0.04 / steps)
    assert math.isclose(read("losses_ms.step", traced(events, steps)),
                        0.07 / steps)
    assert read("curv_ms.step", traced(EVENTS, steps)) is None
