"""The port's cameras on the scene box against the JAX package's: every
matrix bit for bit (the geometry is numpy float64 in both), in grid and
random modes, for an offset box and an oriented 4x4 box; and the visibility
mask of the random branch of Trainer.get_visi_mask_acc through the stats
kernel's plain version against the JAX Trainer's (its Pallas kernel in
interpret mode), with the trainer's generator untouched.
"""

import functools
import os
import random
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_renderer import make_scene
from test_torch_train import jax_state_arrays
from vcr_gaus_tpu.config import Config as JConfig
from vcr_gaus_tpu.data import box_cameras as JBC
from vcr_gaus_tpu.render.renderer import RenderConfig as JRenderConfig
from vcr_gaus_tpu.train import trainer as JT
from vcr_gaus_tpu.utils import math as JM
from vcr_gaus_tpu_torch.config import Config
from vcr_gaus_tpu_torch.data import box_cameras as BC
from vcr_gaus_tpu_torch.models.convert import state_from_arrays
from vcr_gaus_tpu_torch.render.renderer import RenderConfig
from vcr_gaus_tpu_torch.train import trainer as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECON = os.path.join(REPO, "configs", "reconstruct.yaml")
GEOMETRY = ("viewmatrix", "projmatrix", "cam_center", "intr", "tanfov")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def oriented_box():
    """A 4x4 world-to-box transform with a rotation, around the scene of
    ``make_scene`` (points in [-1, 1]^2 x [3, 6])."""
    box = np.eye(4, dtype=np.float32)
    box[:3, :3] = np.asarray(JM.quat_to_rotmat(jnp.asarray(
        np.array([0.9, 0.1, -0.2, 0.3], np.float32))))
    box[:3, 3] = -box[:3, :3] @ np.array([0.0, 0.0, 4.5], np.float32) + [
        0.1, -0.2, 0.3]
    return box


BOXES = {"offset": (np.array([0.1, 0.2, 4.5], np.float32),
                    np.array([1.2, 1.1, 1.8], np.float32)),
         "oriented": (oriented_box(), np.float32(2.0))}


@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("mode", ["grid", "random"])
@pytest.mark.parametrize("n", [24, 200])
def test_box_cameras_equal_jax(n, mode, box):
    trans, scale = BOXES[box]
    want = JBC.sample_box_cameras(n, trans, scale, sample_mode=mode,
                                  size=64, seed=7)
    got = BC.sample_box_cameras(n, trans, scale, sample_mode=mode, size=64,
                                seed=7, device="cpu")
    assert len(got) == len(want) > 0
    if mode == "random" and n == 200:
        assert len(got) == 66 + 4 * 33
    for g, w in zip(got, want):
        for name in GEOMETRY:
            a, b = getattr(g, name).numpy(), np.asarray(getattr(w, name))
            assert a.dtype == b.dtype == np.float32, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        # geometry only: 1x1 placeholders, no prior
        assert tuple(g.image.shape) == (3, 1, 1)
        assert tuple(g.mask.shape) == (1, 1) and g.mask.dtype == torch.int32
        assert not bool(g.has_normal | g.has_depth | g.has_mask)
        assert int(g.idx) == 0


@pytest.mark.parametrize("up,around", [(True, False), (False, True)])
def test_box_cameras_one_face_set_equal_jax(up, around):
    trans, scale = BOXES["oriented"]
    for mode in ("grid", "random"):
        want = JBC.sample_box_cameras(30, trans, scale, up=up, around=around,
                                      sample_mode=mode, seed=3)
        got = BC.sample_box_cameras(30, trans, scale, up=up, around=around,
                                    sample_mode=mode, seed=3, device="cpu")
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.viewmatrix.numpy(),
                                          np.asarray(w.viewmatrix))


def test_look_at_and_axis_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        pos, tgt = rng.normal(size=3), rng.normal(size=3)
        np.testing.assert_array_equal(BC.look_at_w2c(pos, tgt),
                                      JBC.look_at_w2c(pos, tgt))
    # a view along y: the up vector switches to x, in float64
    pos, tgt = np.array([0.0, -2.0, 0.0]), np.array([1e-4, 1.0, 0.0])
    got = BC.look_at_w2c(pos, tgt)
    np.testing.assert_array_equal(got, JBC.look_at_w2c(pos, tgt))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-12)
    for R in (np.eye(3), oriented_box()[:3, :3].astype(np.float64)):
        for name in ("up", "front", "right"):
            assert BC.find_axis(R, name) == JBC.find_axis(R, name)


def stub_trainers(box, size):
    """A JAX and a port trainer stub holding what get_visi_mask_acc reads:
    the config, the box, the iteration, the render config, one state and
    the generator."""
    js, _ = make_scene(n=200, cap=256, seed=4)
    trans, scale = BOXES[box]
    jcfg, cfg = JConfig(RECON), Config(RECON)
    for c in (jcfg, cfg):
        c.tpu.visi_resolution = size
    jstub = types.SimpleNamespace(
        cfg=jcfg, trans=trans, scale=scale, iteration=11,
        rcfg=JRenderConfig(width=64, height=48, entry_budget=1 << 15),
        state=js, bg=np.zeros(3, np.float32), rng=random.Random(5),
        _stats_fn_cache={})
    jstub._stats_sweep = functools.partial(JT.Trainer._stats_sweep, jstub)
    stub = types.SimpleNamespace(
        cfg=cfg, trans=trans, scale=scale, iteration=11,
        rcfg=RenderConfig(width=64, height=48), device=torch.device("cpu"),
        state=state_from_arrays(jax_state_arrays(js), "cpu"),
        rng=random.Random(5))
    stub._stats_sweep = functools.partial(T.Trainer._stats_sweep, stub)
    return jstub, stub


@pytest.mark.parametrize("box", sorted(BOXES))
def test_visibility_mask_random_branch_equal_jax(box):
    """12 random box cameras at 48x48 through the stats kernel (the plain
    version here): the mask of visible Gaussians inside the box is exactly
    the JAX Trainer's, and neither trainer draws from its generator."""
    jstub, stub = stub_trainers(box, 48)
    rng_before = stub.rng.getstate()
    want = np.asarray(JT.Trainer.get_visi_mask_acc(jstub, 12, True, True))
    got = T.Trainer.get_visi_mask_acc(stub, 12, True, True).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < int(got.sum()) < int(stub.state.active.sum())
    assert stub.rng.getstate() == jstub.rng.getstate() == rng_before
