"""The port's stats path against the JAX package: the plain version of the
stats kernel (per-Gaussian pixel hits and importance) and ``render_stats``.

The JAX side runs its stats kernel in interpret mode on the CPU, as its own
tests do. Importance is held to the forward tolerance (atol 2e-4, rtol 1e-3,
tests/test_rasterize.py:88), the hit counts to exact equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import saturated_scene, splat_scene, threshold_scene
from test_renderer import make_scene
from test_torch_render import port_camera, to_port
from vcr_gaus_tpu.ops import rasterize as JR
from vcr_gaus_tpu.render.renderer import RenderConfig as JRenderConfig
from vcr_gaus_tpu.render.renderer import render_stats as jrender_stats
from vcr_gaus_tpu_torch.ops import binning as B
from vcr_gaus_tpu_torch.ops import projection as PF
from vcr_gaus_tpu_torch.ops import rasterize as R
from vcr_gaus_tpu_torch.ops.rasterize_ref import ALPHA_EPS
from vcr_gaus_tpu_torch.render.renderer import RenderConfig, render_stats

FWD = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_stats_match(got, want):
    count, imp = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[0].numpy(), count)
    np.testing.assert_allclose(got[1].numpy(), imp, **FWD)


def jax_entry_stats(feats, radius, width, height):
    cam = np.zeros(8, np.float32)
    return JR.rasterize_entry_stats(
        jnp.asarray(feats), jnp.asarray(feats[:, :2]), jnp.asarray(radius),
        jnp.asarray(feats[:, 6]), jnp.asarray(cam), width, height, 0, 1 << 14)


def port_entry_stats(feats, radius, width, height):
    f = torch.from_numpy(feats)
    return R.rasterize_entry_stats(f, f[:, :2], torch.from_numpy(radius),
                                   f[:, 6], width, height)


# --- the plain version of the kernel, on packed splats ---------------------------

@pytest.mark.parametrize("case", ["ragged_40x24", "saturated_40x24",
                                  "all_culled", "dense_72x40"])
def test_entry_stats_match_jax(case):
    if case == "saturated_40x24":
        feats, radius, _ = saturated_scene()
        w, h = 40, 24
    else:
        w, h = (72, 40) if case == "dense_72x40" else (40, 24)
        feats, radius, _ = splat_scene(n=400 if w == 72 else 60, seed=3,
                                       width=w, height=h)
        if case == "all_culled":
            radius = radius * 0
    got = port_entry_stats(feats, radius, w, h)
    want = jax_entry_stats(feats, radius, w, h)
    assert_stats_match(got, want)
    if case == "all_culled":
        assert float(got[0].abs().sum() + got[1].abs().sum()) == 0.0
    else:
        assert float(got[0].sum()) > 0 and float(got[1].sum()) > 0


@pytest.mark.parametrize("seed", [11, 12])
def test_entry_stats_at_the_dead_pair_threshold_match_jax(seed):
    """The scene whose pairs lie within 4e-3 of the alpha threshold, on
    both sides of the kernel's dead-pair threshold, on a ragged 45x29
    image: the plain version the card holds the stats kernel against
    there, against the JAX stats kernel. Every band of pairs is hit."""
    feats, radius, _ = threshold_scene(seed=seed)
    got = port_entry_stats(feats, radius, 45, 29)
    assert_stats_match(got, jax_entry_stats(feats, radius, 45, 29))
    # a splat 2 pixels clear of the edges hits the 13 pixels within
    # squared distance 4 of its centre, and its ring of 8 at squared
    # distance 5 exactly when the power there is above the alpha threshold
    f = torch.from_numpy(feats)
    power = -0.5 * (f[:, PF.F_CONIC_A] + 4.0 * f[:, PF.F_CONIC_C])
    ring = f[:, PF.F_OPACITY] * torch.exp(power) >= ALPHA_EPS
    inner = ((f[:, 0] >= 2) & (f[:, 0] <= 42) & (f[:, 1] >= 2)
             & (f[:, 1] <= 26))
    assert 0 < int((inner & ring).sum()) < int(inner.sum())
    torch.testing.assert_close(got[0][inner], 13.0 + 8.0 * ring[inner],
                               rtol=0, atol=0)


def test_saturated_tile_stops_early_and_ragged_tile_does_not():
    """In the saturated scene the first tile stops within its first batch;
    the forward compositor, whose out-of-image pixels composite, stops the
    ragged tiles of the bottom row too, where the stats walk never stops:
    out-of-image pixels keep T = 1 there."""
    feats, radius, cam = saturated_scene()
    f = torch.from_numpy(feats)
    binn = B.bin_gaussians(f[:, :2], torch.from_numpy(radius), f[:, 6], 40, 24)
    n_tx, _ = B.tile_grid(40, 24)
    _, batches = R.composite_tiles_stats_torch(
        f, binn.sorted_gid, binn.tile_starts, binn.tile_counts, n_tx, 40, 24)
    held = (binn.tile_counts + R.BATCH - 1) // R.BATCH
    assert int(batches[0]) < int(held[0])
    # a ragged tile full of opaque splats: K1 stops it, the stats walk not
    sat = feats.copy()
    sat[:, 1] += 16.0                       # onto the bottom (ragged) row
    f = torch.from_numpy(sat)
    binn = B.bin_gaussians(f[:, :2], torch.from_numpy(radius), f[:, 6], 40, 24)
    _, fwd_batches = R.composite_tiles_torch(
        f, binn.sorted_gid, binn.tile_starts, binn.tile_counts,
        torch.from_numpy(cam), n_tx, 0, "traditional")
    _, st_batches = R.composite_tiles_stats_torch(
        f, binn.sorted_gid, binn.tile_starts, binn.tile_counts, n_tx, 40, 24)
    held = (binn.tile_counts + R.BATCH - 1) // R.BATCH
    t = n_tx                                # first tile of the ragged row
    assert int(fwd_batches[t]) < int(held[t]) == int(st_batches[t])
    assert_stats_match(port_entry_stats(sat, radius, 40, 24),
                       jax_entry_stats(sat, radius, 40, 24))


# --- render_stats -----------------------------------------------------------------

def _stats_pair(jstate, jcam, depth_mode):
    w, h = jcam.width, jcam.height
    want = jrender_stats(jstate, jcam.arrays(),
                         JRenderConfig(width=w, height=h, entry_budget=1 << 14,
                                       depth_mode=depth_mode), jnp.zeros(3))
    got = render_stats(to_port(jstate), port_camera(jcam).arrays("cpu"),
                       RenderConfig(width=w, height=h, depth_mode=depth_mode))
    return got, want


@pytest.mark.parametrize("depth_mode", ["traditional", "intersection"])
def test_render_stats_matches_jax(depth_mode):
    jstate, jcam = make_scene(seed=5)
    got, want = _stats_pair(jstate, jcam, depth_mode)
    assert_stats_match(got, want)
    assert got[0].shape == (256,) and float(got[1][:200].sum()) > 0


def test_render_stats_ragged_view_matches_jax():
    jstate, jcam = make_scene(seed=6)
    jcam = dataclasses.replace(jcam, width=40, height=24,
                               image=np.zeros((3, 24, 40), np.float32))
    got, want = _stats_pair(jstate, jcam, "intersection")
    assert_stats_match(got, want)
    assert float(got[0].sum()) > 0


def test_render_stats_inactive_and_culled_slots():
    jstate, jcam = make_scene(seed=7)
    act = np.asarray(jstate.active).copy()
    act[::3] = False                        # inactive slots amid active ones
    jstate = jstate._replace(active=jnp.asarray(act))
    got, want = _stats_pair(jstate, jcam, "traditional")
    assert_stats_match(got, want)
    assert float(got[0][~torch.from_numpy(act)].abs().sum()) == 0.0
    assert float(got[1][~torch.from_numpy(act)].abs().sum()) == 0.0
    # every Gaussian behind the camera: an all-culled view gives zeros
    xyz = np.asarray(jstate.params.xyz).copy()
    xyz[:, 2] = -xyz[:, 2]
    behind = jstate._replace(params=jstate.params._replace(
        xyz=jnp.asarray(xyz)))
    got, want = _stats_pair(behind, jcam, "traditional")
    assert_stats_match(got, want)
    assert float(got[0].sum()) == 0.0 and float(got[1].sum()) == 0.0


def test_stats_wrapper_rejects_mismatched_binning():
    feats, radius, _ = splat_scene(seed=2)
    f = torch.from_numpy(feats)
    binn = B.bin_gaussians(f[:, :2], torch.from_numpy(radius), f[:, 6], 40, 24)
    with pytest.raises(ValueError, match="image size"):
        R.rasterize_stats(f, binn, 72, 40)
    with pytest.raises(ValueError, match="int32"):
        R.rasterize_stats(f, binn._replace(
            tile_counts=binn.tile_counts.to(torch.int64)), 40, 24)
