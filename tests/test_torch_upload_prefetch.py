"""The train views' upload one step ahead (``Trainer._prefetch`` and
``Trainer._views``): each step gets the views it drew, bit for bit as
``Camera.arrays`` gives them, whether the previous step uploaded them (a
hit) or the step uploads them itself (a miss), and the counter
``train.upload.prefetched`` says which.

The scenes are the benchmark's tiny cells (``gsbench/tests/tiny.py``): the
TNT recipe's (a u8 image, an f16 normal prior, an int32 mask, random
backgrounds) and the DTU recipe's. The file imports no JAX, so the card's
cases run where only the port is installed:

    python -m pytest --noconftest tests/test_torch_upload_prefetch.py -q
"""

import copy
import json
import os
import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsbench import build as BLD
from gsbench import harness as H
from gsbench.tests.tiny import SEED, TINY
from vcr_gaus_tpu_torch.data.cameras import PIXELS
from vcr_gaus_tpu_torch.utils import tracing

COUNTER = "train.upload.prefetched"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step's compositing kernels and "
                    "the copy stream have no CPU mode")
    return torch.device("cuda")


def cell(workload, **config):
    ov = copy.deepcopy(TINY)
    BLD.deep_update(ov["config"], config)
    return H.cell(workload, overrides=ov)


def build(c, root, device):
    """A trainer over the cell's scene, at the cell's first iteration."""
    scene = BLD.make_scene(c.cfg, SEED, str(root), device)
    trainer = BLD.build_trainer(c.cfg, scene, SEED, device)
    trainer.iteration = int(c.traffic["start_iteration"]) - 1
    return trainer


class Recorder:
    """Wraps a trainer's step and its camera draws: per step the indices
    this rank drew, the iteration, the state it started from, clones of
    the views and background it was given (taken on the step's stream
    before the step and again after it, so what a later copy overwrote
    shows) and its losses. ``step_fn`` is the trainer's own step."""

    def __init__(self, trainer, lag=None):
        self.steps = []
        self.step_fn = step_fn = trainer.step_fn
        pick = trainer._pick_camera_batch

        def clone(cams):
            return [[t.clone() for t in cam] for cam in cams]

        def spy_pick():
            idxs = pick()
            self.steps.append({"idxs": trainer._mine(idxs)})
            return idxs

        def spy_step(state, cams, bg, *args):
            if lag is not None:
                lag()
            rec = self.steps[-1]
            rec.update(iteration=trainer.iteration, state=state, args=args,
                       cams=clone(cams), bg=bg.clone())
            out = step_fn(state, cams, bg, *args)
            rec.update(cams_after=clone(cams), losses=out[1])
            return out

        trainer._pick_camera_batch = spy_pick
        trainer.step_fn = spy_step


def assert_views_equal(got, want):
    """Every field of every view equal bit for bit, dtype and shape."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name, a, b in zip(w._fields, g, w):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a.cpu(), b.cpu()), name


def assert_steps_uploaded(trainer, steps):
    """Each step's views are ``Camera.arrays`` of the cameras it drew, and
    its background the iteration's draw (random backgrounds) or the
    recipe's."""
    for rec in steps:
        want = [trainer.scene.train_cameras[i].arrays(trainer.device)
                for i in rec["idxs"]]
        assert_views_equal(rec["cams"], want)
        assert_views_equal(rec["cams_after"], want)
        bg = (np.random.default_rng(rec["iteration"]).random(3).astype(
            np.float32) if trainer.cfg.optim.random_background
            else trainer.bg)
        np.testing.assert_array_equal(rec["bg"].cpu().numpy(), bg)


def run_profiled(trainer, n):
    """``n`` steps under the CPU profiler; their counter records."""
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(n):
            trainer.train_step()
    return tracing.steps(n)


def prefetched(records):
    return [r.get(COUNTER) for r in records]


# -- CPU ---------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_each_step_gets_the_views_it_drew(tmp_path, k):
    """Over 12 steps of the TNT recipe, with one and two views a step:
    each step's views and background as uploaded directly, the first step
    a miss and every later one a hit."""
    trainer = build(cell("tnt.step_late", tpu={"camera_batch": k}),
                    tmp_path, "cpu")
    rec = Recorder(trainer)
    records = run_profiled(trainer, 12)
    assert prefetched(records) == [[0] * k] + [[1] * k] * 11
    assert [len(r["idxs"]) for r in rec.steps] == [k] * 12
    assert_steps_uploaded(trainer, rec.steps)


def test_a_moved_order_misses_once(tmp_path):
    """A reset of the iteration, as the benchmark's check makes between
    set-up and its steps, keeps the prefetched views (they do not depend on
    the iteration; the background, formed in the step, follows the new
    one). Next indices changed by a caller give one miss with the right
    views, then hits again."""
    trainer = build(cell("tnt.step_late"), tmp_path, "cpu")
    rec = Recorder(trainer)
    first = run_profiled(trainer, 3)
    trainer.iteration -= 3
    again = run_profiled(trainer, 2)
    n = len(trainer.scene.train_cameras)
    trainer._next_idxs = [(trainer._next_idxs[0] + 1) % n]
    moved = run_profiled(trainer, 3)
    assert prefetched(first + again + moved) == [[0], [1], [1], [1], [1],
                                                 [0], [1], [1]]
    assert [r["iteration"] for r in rec.steps[3:5]] == [
        r["iteration"] for r in rec.steps[:2]]
    assert_steps_uploaded(trainer, rec.steps)


def test_lazy_views_are_uploaded_in_the_step(tmp_path):
    """With ``data_device: lazy`` nothing is prefetched: every view is a
    miss, decoded and uploaded in its step."""
    trainer = build(cell("tnt.step_late", model={"data_device": "lazy"}),
                    tmp_path, "cpu")
    assert trainer.scene.train_cameras[0].loaders
    rec = Recorder(trainer)
    assert prefetched(run_profiled(trainer, 4)) == [[0]] * 4
    assert trainer._prefetched is None
    assert_steps_uploaded(trainer, rec.steps)


def test_steps_match_direct_uploads(tmp_path):
    """Four steps of the DTU recipe give the losses and the state, bit for
    bit, of ``step_fn`` on ``Camera.arrays`` uploads of the same cameras
    from the same start."""
    c = cell("dtu.step_late")
    trainer = build(c, tmp_path / "a", "cpu")
    rec = Recorder(trainer)
    for _ in range(4):
        trainer.train_step()
    plain = build(c, tmp_path / "b", "cpu")
    state = plain.state
    for r in rec.steps:
        cams = [plain.scene.train_cameras[i].arrays("cpu") for i in r["idxs"]]
        state, losses, _ = plain.step_fn(state, cams, r["bg"], *r["args"])
        assert losses.keys() == r["losses"].keys()
        for key, v in losses.items():
            assert torch.equal(v, r["losses"][key]), key
    for a, b in zip(state.params.as_dict().values(),
                    trainer.state.params.as_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(state.adam.nu.xyz, trainer.state.adam.nu.xyz)


# -- the card ----------------------------------------------------------------

def assert_matches(trainer, rec):
    """The card's steps against direct uploads: the views each step saw,
    before and after it, and its losses bit for bit."""
    assert_steps_uploaded(trainer, rec.steps)
    for r in rec.steps:
        cams = [trainer.scene.train_cameras[i].arrays(trainer.device)
                for i in r["idxs"]]
        _, losses, _ = rec.step_fn(r["state"], cams, r["bg"], *r["args"])
        for key, v in losses.items():
            assert torch.equal(v, r["losses"][key]), (r["iteration"], key)


@pytest.mark.cuda
def test_card_steps_match_direct_uploads(cuda, tmp_path):
    """Ten steps on the card: each step's views as the step's stream saw
    them before and after it equal blocking ``Camera.arrays`` uploads bit
    for bit, and its losses equal ``step_fn``'s on those uploads from the
    state it started from; the first step misses, the rest hit."""
    trainer = build(cell("dtu.step_late"), tmp_path, cuda)
    rec = Recorder(trainer)
    records = run_profiled(trainer, 10)
    torch.cuda.synchronize()
    assert prefetched(records) == [[0]] + [[1]] * 9
    assert_matches(trainer, rec)


@pytest.mark.cuda
def test_card_train_views_are_page_locked(cuda, tmp_path):
    """Every resident pixel array of every train view is page-locked, in
    its reader's dtype and layout, and the prefetch runs on a stream other
    than the step's."""
    trainer = build(cell("tnt.step_late"), tmp_path, cuda)
    for cam in trainer.scene.train_cameras:
        arrays = [getattr(cam, k) for k in PIXELS
                  if getattr(cam, k) is not None]
        assert {a.dtype for a in arrays} == {np.dtype(np.uint8),
                                             np.dtype(np.float16),
                                             np.dtype(np.int32)}
        assert all(torch.from_numpy(a).is_pinned() for a in arrays)
        # the image keeps its (H, W, 3) buffer under the (3, H, W) view
        assert cam.image.shape[0] == 3 and cam.image.strides[0] == 1
    assert trainer._copy_stream != torch.cuda.current_stream(cuda)


def chrome_events(trainer, tmp_path, n):
    """The Chrome trace's complete events over ``n`` profiled steps."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            trainer.train_step()
        torch.cuda.synchronize()
    path = os.path.join(str(tmp_path), "upload_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


@pytest.mark.cuda
def test_card_upload_neither_blocks_nor_pages(cuda, tmp_path):
    """Profiled steps after the first: inside the ``train.upload`` spans
    no pageable copy and no stream synchronisation; the copies the span at
    a step's end launches (the next step's views) run on a stream other
    than the step's kernels', and the step's views are copied there."""
    trainer = build(cell("tnt.step_late"), tmp_path, cuda)
    trainer.train_step()
    trainer.train_step()
    events = chrome_events(trainer, tmp_path, 3)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                   if e.get("name") == "train.upload"
                   and e.get("cat") == "user_annotation")
    assert len(spans) == 6                       # two a step
    runtime = [e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launches = {e["args"]["correlation"]: e for e in runtime
                if "correlation" in e.get("args", {})}

    def span_of(launch):
        return next((i for i, (s, e, tid) in enumerate(spans)
                     if s <= launch["ts"] <= e and tid == launch["tid"]),
                    None)

    syncs = [e for e in runtime
             if "Synchronize" in e["name"] and span_of(e) is not None]
    assert not syncs
    step_streams = {e["args"]["stream"] for e in events
                    if e.get("cat") == "kernel"
                    and "rasterize_fwd_kernel" in e["name"]}
    assert len(step_streams) == 1
    copies = copies_by_span(events, launches, span_of)
    for i, names_streams in copies.items():
        assert not any("Pageable" in n for n, _ in names_streams), i
    for i in (1, 3, 5):                          # the spans at a step's end
        assert copies.get(i), i
        assert all(s not in step_streams for _, s in copies[i]), i


def copies_by_span(events, launches, span_of):
    """{upload span's index: [(copy's name, its stream)]} of the host to
    device copies launched inside each ``train.upload`` span."""
    out = {}
    for e in events:
        if e.get("cat") != "gpu_memcpy" or "HtoD" not in e["name"]:
            continue
        launch = launches.get(e["args"].get("correlation"))
        i = span_of(launch) if launch else None
        if i is not None:
            out.setdefault(i, []).append((e["name"], e["args"]["stream"]))
    return out


@pytest.mark.cuda
def test_card_lagging_copies_still_match(cuda, tmp_path):
    """Forty steps with the copy stream and the step's stream held back by
    sleep kernels in a seeded random pattern, and the next indices moved at
    random steps (misses): every step still sees its own views, before and
    after it, and gives the direct uploads' losses. A copy that wrote the
    memory a running step reads, or a step that read before its copy
    landed, would show here."""
    trainer = build(cell("dtu.step_late"), tmp_path, cuda)
    draw = random.Random(7)

    def lag():
        if draw.random() < 0.5:
            torch.cuda._sleep(draw.randrange(1_000_000, 20_000_000))

    rec = Recorder(trainer, lag=lag)
    prefetch = trainer._prefetch
    n = len(trainer.scene.train_cameras)

    def lagging_prefetch(mine):
        with torch.cuda.stream(trainer._copy_stream):
            lag()
        prefetch(mine)
        if draw.random() < 0.2:
            trainer._next_idxs = [draw.randrange(n)]

    trainer._prefetch = lagging_prefetch
    records = run_profiled(trainer, 40)
    torch.cuda.synchronize()
    hits = [r[COUNTER] for r in records]
    assert [0] in hits[1:] and hits.count([1]) >= 20
    assert_matches(trainer, rec)
