"""The port's population edits and model files against the JAX package:
densify (clone, split along the longest axis, box-guided split, prune),
the LightGaussian prune and its score, opacity reset, capacity growth,
checkpoints both ways, the inside PLY and the .splat export.

Both packages start from the same state, converted with state_from_arrays;
the active mask and the drop counts must be equal, parameters, moments and
statistics within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_renderer import make_scene
from test_torch_train import assert_state_close, jax_state_arrays
from vcr_gaus_tpu.models import gaussians as JGM
from vcr_gaus_tpu.models import ply_io as JPLY
from vcr_gaus_tpu.utils import math as JM
from vcr_gaus_tpu_torch.models import gaussians as GM
from vcr_gaus_tpu_torch.models import ply_io as PLY
from vcr_gaus_tpu_torch.models.convert import state_from_arrays
from vcr_gaus_tpu_torch.utils import math as M

EXTENT = 3.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def training_state(seed=0, n=200, cap=256, holes=True):
    """A JAX state as training leaves it: random scales (small and large),
    rotations and opacities (some below the prune threshold), non-zero
    moments and densify statistics on the active slots, and inactive holes
    among them."""
    js, _ = make_scene(n=n, cap=cap, seed=seed)
    rng = np.random.default_rng(seed + 100)
    act = np.asarray(js.active).copy()
    if holes:
        act[rng.choice(n, n // 8, replace=False)] = False
    m = act.astype(np.float32)

    def rows(a):
        return (a * m.reshape((-1,) + (1,) * (a.ndim - 1))).astype(np.float32)

    p = {k: np.asarray(v) for k, v in js.params._asdict().items()}
    p["log_scale"] = rng.uniform(-4.0, -0.5, (cap, 3))
    p["quat"] = rng.normal(size=(cap, 4))
    p["logit_opacity"] = rng.uniform(-7.0, 3.0, (cap, 1))
    p = {k: rows(v) for k, v in p.items()}

    def moments(scale):
        return JGM.GaussianParams(**{
            k: jnp.asarray(rows(scale(rng, v.shape))) for k, v in p.items()})

    denom = rows(rng.integers(0, 6, cap).astype(np.float32))
    return JGM.GaussianState(
        params=JGM.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()}),
        adam=JGM.AdamState(moments(lambda r, s: r.normal(size=s)),
                           moments(lambda r, s: r.uniform(0, 1, s)),
                           jnp.int32(37)),
        active=jnp.asarray(act),
        max_radii2d=jnp.asarray(rows(rng.uniform(0, 40, cap))),
        grad_accum=jnp.asarray(rows(rng.uniform(0, 0.01, cap)) * denom),
        denom=jnp.asarray(denom),
        active_sh_degree=jnp.int32(2))


def to_port(js):
    return state_from_arrays(jax_state_arrays(js), "cpu")


def test_longest_axis_helpers_match_jax():
    rng = np.random.default_rng(1)
    scale = rng.uniform(0.01, 1.0, (64, 3)).astype(np.float32)
    scale[:8, 1] = scale[:8, 0]             # ties: the first axis wins
    quat = rng.normal(size=(64, 4)).astype(np.float32)
    got = M.longest_axis_dir(torch.from_numpy(scale), torch.from_numpy(quat))
    want = JM.longest_axis_dir(jnp.asarray(scale), jnp.asarray(quat))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    value = rng.uniform(size=64).astype(np.float32)
    np.testing.assert_array_equal(
        M.set_axis_value(torch.from_numpy(scale), got[2],
                         torch.from_numpy(value)).numpy(),
        np.asarray(JM.set_axis_value(jnp.asarray(scale), want[2],
                                     jnp.asarray(value))))


# threshold 2e-4 selects more slots than are free (children are dropped);
# 8e-3 selects fewer
@pytest.mark.parametrize("threshold", [2e-4, 8e-3])
@pytest.mark.parametrize("box", [False, True])
@pytest.mark.parametrize("screen", [None, 20])
def test_densify_and_prune_matches_jax(threshold, box, screen):
    js = training_state(seed=int(threshold * 1e4) + 2 * box)
    rng = np.random.default_rng(3)
    box_mask = rng.uniform(size=js.capacity) < 0.3 if box else None
    kw = dict(grad_threshold=threshold, min_opacity=0.005,
              scene_extent=EXTENT, max_screen_size=screen, percent_dense=0.01)
    want, w_drop = JGM.densify_and_prune(
        js, box_mask=None if box_mask is None else jnp.asarray(box_mask), **kw)
    got, g_drop = GM.densify_and_prune(
        to_port(js), box_mask=None if box_mask is None
        else torch.from_numpy(box_mask), **kw)
    assert g_drop == int(w_drop)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    assert_state_close(got, want)
    if threshold < 1e-3:
        assert g_drop > 0
    else:
        assert g_drop == 0 and got.num_active != int(js.num_active)


def test_clone_and_split_alone_match_jax():
    js = training_state(seed=4)
    grads = np.asarray(js.grad_accum) / np.maximum(np.asarray(js.denom), 1)
    for jfn, fn in ((JGM.densify_and_clone, GM.densify_and_clone),
                    (JGM.densify_and_split_along_maxscaling,
                     GM.densify_and_split_along_maxscaling)):
        want, w_drop = jfn(js, jnp.asarray(grads), 1e-3, 0.1, EXTENT)
        got, g_drop = fn(to_port(js), torch.from_numpy(grads), 1e-3, 0.1,
                         EXTENT)
        assert g_drop == int(w_drop)
        assert_state_close(got, want)
        assert got.num_active > int(js.num_active)


@pytest.mark.parametrize("scores", ["random", "tied"])
def test_prune_by_importance_matches_jax(scores):
    js = training_state(seed=5)
    rng = np.random.default_rng(6)
    imp = (rng.uniform(0, 1, js.capacity).astype(np.float32)
           if scores == "random" else np.full(js.capacity, 0.25, np.float32))
    want_v = JGM.v_imp_score(js, jnp.asarray(imp), 0.1)
    got_v = GM.v_imp_score(to_port(js), torch.from_numpy(imp), 0.1)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-6,
                               atol=1e-7)
    for percent in (0.5, 0.5 * 0.6):
        want = JGM.prune_by_importance(js, want_v, percent)
        got = GM.prune_by_importance(to_port(js), got_v, percent)
        np.testing.assert_array_equal(got.active.numpy(),
                                      np.asarray(want.active))
        assert_state_close(got, want)
        n = int(js.num_active)
        assert got.num_active == n - int(np.float32(percent)
                                         * np.float32(n - 1))


def test_reset_opacity_grow_and_sh_match_jax():
    js = training_state(seed=7)
    want = JGM.reset_opacity(js)
    got = GM.reset_opacity(to_port(js))
    assert_state_close(got, want)
    assert float(got.opacity[got.active].max()) <= 0.01 + 1e-7
    want = JGM.expand_capacity(js, 384)
    got = GM.expand_capacity(to_port(js), 384)
    assert got.capacity == 384
    assert_state_close(got, want)
    with pytest.raises(ValueError):
        GM.expand_capacity(got, 384)
    st = to_port(js)
    assert GM.oneup_sh_degree(st, 3).active_sh_degree == int(
        JGM.oneup_sh_degree(js, 3).active_sh_degree) == 3
    assert GM.oneup_sh_degree(GM.oneup_sh_degree(st, 3), 3
                              ).active_sh_degree == 3


# --- files --------------------------------------------------------------------------

def test_checkpoint_written_by_jax_resumes_in_port(tmp_path):
    js = training_state(seed=8)
    path = str(tmp_path / "chkpnt7.npz")
    net = {"app_embeddings": None, "app_params": None, "app_opt": None,
           "cls_params": None, "cls_opt": None}
    JPLY.save_checkpoint(path, js, 7, extra={"net": net})
    got, it, extra = PLY.load_checkpoint(path, device="cpu")
    assert it == 7 and extra == {"net": net}
    assert_state_close(got, js, atol=0, rtol=0)
    assert got.active_sh_degree == 2 and got.adam.step == 37


def test_checkpoint_written_by_port_resumes_in_jax(tmp_path):
    js = training_state(seed=9)
    st = to_port(js)
    path = str(tmp_path / "chkpnt9.npz")
    PLY.save_checkpoint(path, st, 9, extra={"net": {"cls_params": None}})
    want, it, extra = JPLY.load_checkpoint(path)
    assert it == 9 and extra == {"net": {"cls_params": None}}
    assert_state_close(st, want, atol=0, rtol=0)
    assert int(want.active_sh_degree) == 2 and int(want.adam.step) == 37
    back, _, _ = PLY.load_checkpoint(path, device="cpu")
    assert_state_close(back, want, atol=0, rtol=0)


def test_inside_ply_and_splat_match_jax(tmp_path):
    js = training_state(seed=10)
    inside = np.random.default_rng(11).uniform(size=js.capacity) < 0.6
    st = to_port(js)
    for name, jfn, fn, args in (
            ("inside.ply", JPLY.save_inside_ply, PLY.save_inside_ply,
             (inside,)),
            ("pcd.splat", JPLY.save_splat, PLY.save_splat, ())):
        jpath, ppath = str(tmp_path / f"jax_{name}"), str(tmp_path / name)
        jfn(js, jpath, *args)
        fn(st, ppath, *args)
        with open(jpath, "rb") as a, open(ppath, "rb") as b:
            want, got = a.read(), b.read()
        assert len(got) == len(want) > 0, name
        if name.endswith(".splat"):
            assert got == want
        else:
            # the normal slots hold float32 rotation columns, equal to 1 ulp
            from vcr_gaus_tpu.utils.ply import read_ply
            gd, wd = read_ply(ppath), read_ply(jpath)
            assert list(gd) == list(wd)
            for k in wd:
                np.testing.assert_allclose(gd[k], wd[k], atol=1e-6, rtol=0,
                                           err_msg=k)
