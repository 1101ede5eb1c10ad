"""The port's backward pass against the JAX package: the backward
compositing kernel's plain version against jax.grad through the JAX
rasterize_image, and the renderer's VJP (projection, SH, normals,
post-processing) against jax.vjp of the JAX render.

The JAX side runs as its own tests run it on the CPU (Pallas in interpret
mode). Gradients are held to the JAX suite's kernel-vs-oracle tolerance,
atol 2e-3 * max|g| (tests/test_rasterize.py:126), with max|g| taken per
column group (mean, conic, opacity, depth, plane, normal, rgb, sem,
|d mean2d|): the groups differ by orders of magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import assert_grads_close
from test_rasterize import H, W, make_scene
from test_renderer import make_scene as render_scene
from test_torch_ops import _saturated_scene
from test_torch_render import port_camera, to_port, with_random_sh
from vcr_gaus_tpu.ops import projection as JPF
from vcr_gaus_tpu.ops import rasterize as JR
from vcr_gaus_tpu.render.renderer import RenderConfig as JRenderConfig
from vcr_gaus_tpu.render.renderer import render as jrender
from vcr_gaus_tpu_torch.ops import binning as B
from vcr_gaus_tpu_torch.ops import projection as PF
from vcr_gaus_tpu_torch.ops import rasterize as R
from vcr_gaus_tpu_torch.render.renderer import RenderConfig, render


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _grads_jax(feats, radius, cam, g_img, depth_mode, ch_sem):
    mean2d = feats[:, [JPF.F_MEAN_X, JPF.F_MEAN_Y]]
    depth_z = feats[:, JPF.F_DEPTH_Z]

    def loss(f, dummy):
        out, _ = JR.rasterize_image(f, dummy, mean2d, radius, depth_z,
                                    jnp.asarray(cam), W, H, ch_sem,
                                    depth_mode, entry_budget=8192)
        return jnp.sum(out * g_img)

    gf, gd = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(feats), jnp.zeros((feats.shape[0], 2)))
    return np.asarray(gf), np.asarray(gd)


def _grads_port(feats, radius, cam, g_img, depth_mode, ch_sem):
    f = torch.tensor(np.asarray(feats), requires_grad=True)
    dummy = torch.zeros((f.shape[0], 2), requires_grad=True)
    fd = f.detach()
    out, _ = R.rasterize_image(
        f, dummy, fd[:, [PF.F_MEAN_X, PF.F_MEAN_Y]],
        torch.tensor(np.asarray(radius)), fd[:, PF.F_DEPTH_Z],
        torch.tensor(cam), W, H, ch_sem, depth_mode)
    (out * torch.from_numpy(g_img)).sum().backward()
    return f.grad.numpy(), dummy.grad.numpy()


def _assert_grads(got, want, ch_sem, rtol=2e-3):
    """got and want are (feature gradient, dummy gradient) pairs; each
    column group at atol 2e-3 times its own max|g| and ``rtol``."""
    got, want = (torch.from_numpy(np.concatenate(g, axis=1))
                 for g in (got, want))
    groups = assert_grads_close(got, want, ch_sem, rtol)
    assert max(scale for _, scale in groups.values()) > 0
    return groups


@pytest.mark.parametrize("depth_mode", ["traditional", "intersection"])
@pytest.mark.parametrize("ch_sem", [0, 2])
def test_backward_matches_jax_grad(depth_mode, ch_sem):
    feats, radius, cam = make_scene(n=40, seed=1, ch_sem=ch_sem)
    g_img = np.random.default_rng(3).normal(
        size=(9 + ch_sem, H, W)).astype(np.float32)
    got = _grads_port(feats, radius, cam, g_img, depth_mode, ch_sem)
    want = _grads_jax(feats, radius, cam, g_img, depth_mode, ch_sem)
    _assert_grads(got, want, ch_sem)


def test_backward_saturated_early_stop_matches_jax_grad():
    """A saturated multi-batch tile: pixels' T underflows while the tile
    keeps compositing; the front-to-back walk must still give the weights
    (rtol 5e-2 as tests/test_rasterize.py:432)."""
    feats, radius, cam = _saturated_scene()
    g_img = np.random.default_rng(7).normal(size=(9, H, W)).astype(np.float32)
    got = _grads_port(feats, radius, cam, g_img, "traditional", 0)
    want = _grads_jax(feats, radius, cam, g_img, "traditional", 0)
    _assert_grads(got, want, 0, rtol=5e-2)
    # a stopped tile gives its entries past the stop no gradient
    f = torch.tensor(np.asarray(feats))
    binn = B.bin_gaussians(f[:, :2], torch.tensor(np.asarray(radius)),
                           f[:, PF.F_DEPTH_Z], W, H)
    img, batches = R.rasterize_forward(f, binn, torch.tensor(cam), W, H, 0,
                                       "traditional")
    stopped = torch.nonzero(batches.to(torch.int64) * R.BATCH
                            < binn.tile_counts.to(torch.int64)).squeeze(1)
    assert stopped.numel() > 0
    t = int(stopped[0])
    g_t = R.composite_tiles_backward_torch(
        f, binn.sorted_gid, binn.tile_starts, binn.tile_counts, batches,
        torch.tensor(cam), img, torch.from_numpy(g_img), 0, "traditional",
        tile_ids=stopped[:1])
    s, n = int(binn.tile_starts[t]), int(binn.tile_counts[t])
    done = int(batches[t]) * R.BATCH
    late = binn.sorted_gid[s + done:s + n].to(torch.int64)
    early = binn.sorted_gid[s:s + done].to(torch.int64)
    assert late.numel() > 0
    assert bool((g_t[late] == 0).all())
    assert bool((g_t[early] != 0).any())


def test_backward_capped_alpha_matches_jax_grad():
    """Near-opaque splats whose alpha is capped at 0.99: no gradient reaches
    the power (opacity, mean, conic) through a capped pair."""
    feats, radius, cam = make_scene(n=40, seed=4, ch_sem=0)
    f = np.asarray(feats).copy()
    f[::2, PF.F_OPACITY] = 0.9995
    g_img = np.random.default_rng(5).normal(size=(9, H, W)).astype(np.float32)
    got = _grads_port(f, radius, cam, g_img, "traditional", 0)
    want = _grads_jax(f, radius, cam, g_img, "traditional", 0)
    _assert_grads(got, want, 0)
    # the cap was active: a visible splat reaches alpha > 0.99 at a pixel
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    vis = np.asarray(radius) > 0
    dx = xs[..., None] - f[vis, PF.F_MEAN_X]
    dy = ys[..., None] - f[vis, PF.F_MEAN_Y]
    power = (-0.5 * (f[vis, PF.F_CONIC_A] * dx * dx
                     + f[vis, PF.F_CONIC_C] * dy * dy)
             - f[vis, PF.F_CONIC_B] * dx * dy)
    alpha = np.where(power <= 0, f[vis, PF.F_OPACITY] * np.exp(power), 0.0)
    assert (alpha > 0.99).any()


def test_backward_clamped_denominator_matches_jax_grad():
    """Near-tangent planes hit the |ray . n| >= 1e-2 clamp: no normal
    gradient through the clamped denominator (tests/test_rasterize.py:184)."""
    feats, radius, cam = make_scene(n=40, seed=7)
    f = np.asarray(feats).copy()
    rng = np.random.default_rng(8)
    nxy = rng.normal(size=(f.shape[0], 2))
    nxy /= np.linalg.norm(nxy, axis=1, keepdims=True)
    f[:, PF.F_NORMAL:PF.F_NORMAL + 2] = nxy
    f[:, PF.F_NORMAL + 2] = rng.uniform(-5e-3, 5e-3, f.shape[0])
    mean_cam = np.stack([rng.normal(size=f.shape[0]),
                         rng.normal(size=f.shape[0]), f[:, PF.F_DEPTH_Z]], 1)
    f[:, PF.F_PLANE_D] = np.sum(f[:, PF.F_NORMAL:PF.F_NORMAL + 3] * mean_cam, 1)
    g_img = rng.normal(size=(11, H, W)).astype(np.float32)
    got = _grads_port(f, radius, cam, g_img, "intersection", 2)
    want = _grads_jax(f, radius, cam, g_img, "intersection", 2)
    groups = _assert_grads(got, want, 2)
    assert groups["normal"][1] > 0


def test_densify_stream_matches_jax_grad():
    """The dummy's gradient is the per-pixel sum of |d mean2d| terms
    (tests/test_rasterize.py:229): it matches JAX's and dominates the signed
    mean gradient."""
    feats, radius, cam = make_scene(n=30, seed=2, ch_sem=0)
    g_img = np.random.default_rng(4).normal(size=(9, H, W)).astype(np.float32)
    got_f, got_d = _grads_port(feats, radius, cam, g_img, "traditional", 0)
    want = _grads_jax(feats, radius, cam, g_img, "traditional", 0)
    _assert_grads((got_f, got_d), want, 0)
    g_mean = got_f[:, [PF.F_MEAN_X, PF.F_MEAN_Y]]
    assert np.all(got_d + 1e-6 >= np.abs(g_mean) - 1e-4)
    assert got_d.sum() > 0


def test_backward_tile_subset_sums_to_full():
    """The plain version over a split of the tiles adds up to the full
    gradient (chip_smoke.py holds the kernel to it tile group by group)."""
    feats, radius, cam = make_scene(n=60, seed=5, ch_sem=2)
    f = torch.tensor(np.asarray(feats))
    binn = B.bin_gaussians(f[:, :2], torch.tensor(np.asarray(radius)),
                           f[:, PF.F_DEPTH_Z], W, H)
    img, batches = R.rasterize_forward(f, binn, torch.tensor(cam), W, H, 2,
                                       "intersection")
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=img.shape).astype(np.float32))
    args = (f, binn.sorted_gid, binn.tile_starts, binn.tile_counts, batches,
            torch.tensor(cam), img, g, 2, "intersection")
    full = R.composite_tiles_backward_torch(*args, group=2)
    parts = sum(R.composite_tiles_backward_torch(*args, tile_ids=ids)
                for ids in (torch.tensor([0, 3, 5]), torch.tensor([1, 2, 4])))
    torch.testing.assert_close(parts, full, atol=1e-4, rtol=1e-5)
    wrapped = R.rasterize_backward(f, binn, torch.tensor(cam), img, g,
                                   batches, W, H, 2, "intersection")
    torch.testing.assert_close(wrapped, full, atol=1e-4, rtol=1e-5)


def test_backward_wrapper_rejects_bad_inputs():
    feats, radius, cam = make_scene()
    f = torch.tensor(np.asarray(feats))
    binn = B.bin_gaussians(f[:, :2], torch.tensor(np.asarray(radius)),
                           f[:, PF.F_DEPTH_Z], W, H)
    img, batches = R.rasterize_forward(f, binn, torch.tensor(cam), W, H, 2,
                                       "traditional")
    g = torch.zeros_like(img)
    with pytest.raises(ValueError):
        R.rasterize_backward(f, binn, torch.tensor(cam), img, g[:3], batches,
                             W, H, 2, "traditional")
    with pytest.raises(ValueError):
        R.rasterize_backward(f, binn, torch.tensor(cam), img, g,
                             batches.to(torch.int64), W, H, 2, "traditional")
    strided = img.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        R.rasterize_backward(f, binn, torch.tensor(cam), strided, g, batches,
                             W, H, 2, "traditional")


# --- the renderer's VJP ------------------------------------------------------

OUTPUTS = ("render", "depth", "normal", "est_normal", "alpha", "depth_var",
           "distortion")


@pytest.mark.parametrize("depth_mode", ["traditional", "intersection"])
def test_render_vjp_matches_jax(depth_mode):
    """torch.autograd.grad of the port's render against jax.vjp of the JAX
    render, for one random cotangent on every output, per parameter group.
    The cotangents of the normalized maps (normal, est_normal) are kept
    where the alpha map is solid: at empty pixels normalization divides by
    a vanishing norm (eps 1e-24), where rounding is amplified 1e12-fold in
    both packages alike."""
    jstate, jcam = render_scene(seed=1)
    jstate = with_random_sh(jstate)
    Wd, Ht = jcam.width, jcam.height
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    jrcfg = JRenderConfig(width=Wd, height=Ht, entry_budget=1 << 14,
                          depth_mode=depth_mode)
    jarr = jcam.arrays()

    def jfun(params, dummy):
        out = jrender(jstate._replace(params=params), jarr, jrcfg,
                      jnp.asarray(bg), sh_degree=3, scene_extent=3.0,
                      densify_dummy=dummy)
        return {k: out[k] for k in OUTPUTS}

    jdummy = jnp.zeros((jstate.capacity, 2))
    want_out, vjp = jax.vjp(jfun, jstate.params, jdummy)
    rng = np.random.default_rng(11)
    alpha = np.asarray(want_out["alpha"])
    solid = alpha > 0.5
    solid[1:-1, 1:-1] &= (solid[:-2, 1:-1] & solid[2:, 1:-1]
                          & solid[1:-1, :-2] & solid[1:-1, 2:])
    cot = {}
    for k in OUTPUTS:
        c = rng.normal(size=want_out[k].shape).astype(np.float32)
        if k in ("normal", "est_normal"):
            c *= solid[..., None]
        cot[k] = c
    want_p, want_d = vjp({k: jnp.asarray(v) for k, v in cot.items()})

    state = to_port(jstate)
    params = state.params.map(lambda p: p.detach().requires_grad_(True))
    dummy = torch.zeros((state.capacity, 2), requires_grad=True)
    out = render(state.replace(params=params), port_camera(jcam).arrays("cpu"),
                 RenderConfig(width=Wd, height=Ht, depth_mode=depth_mode),
                 torch.from_numpy(bg), sh_degree=3, scene_extent=3.0,
                 densify_dummy=dummy)
    assert out["densify_dummy"] is dummy
    total = sum((out[k] * torch.from_numpy(cot[k])).sum() for k in OUTPUTS)
    leaves = list(params.as_dict().values()) + [dummy]
    got = torch.autograd.grad(total, leaves, allow_unused=True)
    names = list(params.as_dict())
    for name, g in zip(names + ["densify_dummy"], got):
        want = np.asarray(getattr(want_p, name) if name != "densify_dummy"
                          else want_d)
        if want.size == 0:
            continue
        g = np.zeros_like(want) if g is None else g.numpy()
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, want, atol=2e-3 * scale, rtol=2e-3,
                                   err_msg=name)
