"""The renderer's per-slot preprocess on the CPU: the closed-form backward
(``preprocess_backward_torch``) against autograd of the plain forward
(``preprocess_torch``), leaf by leaf, on inputs that reach each of its
branches; the gradient of the port's ``preprocess`` (through its
``torch.autograd.Function``) against ``jax.vjp`` of the JAX package's chain,
leaf by leaf and slot group by slot group; the renderer going through the
Function; the wrapper's checks. The kernels themselves run in
tests/test_torch_kernels.py on the card."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import preprocess_groups, preprocess_scene
from vcr_gaus_tpu.ops import projection as JPF
from vcr_gaus_tpu.utils import math as JM
from vcr_gaus_tpu.utils import sh as JSH
from vcr_gaus_tpu_torch.data.cameras import Camera
from vcr_gaus_tpu_torch.models.gaussians import GaussianParams, new_state
from vcr_gaus_tpu_torch.ops import projection as PF
from vcr_gaus_tpu_torch.render import renderer as RD

W, H = 64, 48
# the JAX suite's gradient tolerance (tests/test_rasterize.py), as atol
# times the leaf's max|g| in each slot group
GRAD_ATOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def branch_scene(seed=0, identity=True, dtype=torch.float64):
    """chip_smoke.preprocess_scene's 400 slots at 64x48, which reach each
    branch of the preprocess."""
    return preprocess_scene(400, seed=seed, identity=identity, width=W,
                            height=H, dtype=dtype)


def autograd_grads(lv, active, cam, var, g):
    leaves = lv.map(lambda x: x.detach().requires_grad_(True))
    feats = PF.preprocess_torch(leaves, active, cam, var).feats
    grads = torch.autograd.grad((feats * g).sum(),
                                list(leaves.as_dict().values()),
                                allow_unused=True)
    return GaussianParams(*grads)


def assert_leaves_close(got, want, rtol, atol_rel):
    for name, b in want.as_dict().items():
        a = getattr(got, name)
        if b is None:
            assert a is None, name
            continue
        tol = atol_rel * max(float(b.abs().max()), 1e-30)
        torch.testing.assert_close(a, b, rtol=rtol, atol=tol, msg=name)


@pytest.mark.parametrize("with_normal", [False, True])
@pytest.mark.parametrize("ch_sem", [0, 2])
@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_backward_equals_autograd(deg, ch_sem, with_normal):
    lv, active, cam = branch_scene(seed=deg)
    var = PF.Variant(W, H, deg, ch_sem, with_normal, 1.0)
    g = torch.randn((lv.xyz.shape[0], PF.feature_dim(ch_sem)),
                    generator=torch.Generator().manual_seed(deg),
                    dtype=lv.xyz.dtype)
    want = autograd_grads(lv, active, cam, var, g)
    got = PF.preprocess_backward_torch(g, lv, cam, var)
    # float64: the same function to rounding
    assert_leaves_close(got, want, rtol=1e-9, atol_rel=1e-11)


@pytest.mark.parametrize("scale_modifier", [1.0, 0.5])
def test_backward_equals_autograd_rotated_float32(scale_modifier):
    lv, active, cam = branch_scene(seed=7, identity=False,
                                   dtype=torch.float32)
    var = PF.Variant(W, H, 3, 2, True, scale_modifier)
    g = torch.randn((lv.xyz.shape[0], PF.feature_dim(2)),
                    generator=torch.Generator().manual_seed(7))
    want = autograd_grads(lv, active, cam, var, g)
    got = PF.preprocess_backward_torch(g, lv, cam, var)
    # float32: another order of the same sums
    assert_leaves_close(got, want, rtol=1e-4, atol_rel=1e-5)


def jax_chain(cam, var):
    """The JAX package's per-slot chain as its renderer composes it
    (vcr_gaus_tpu/render/renderer.py): the packed features as a function
    of the leaves, in GaussianParams' field order."""
    V, Pm, center, tfx, tfy = (jnp.asarray(x.numpy())
                               for x in PF._camera(cam))

    def feats(xyz, f_dc, f_rest, log_scale, quat, logit_opacity, obj_dc):
        scales = jnp.exp(log_scale)
        opacity = jax.nn.sigmoid(logit_opacity)[:, 0]
        proj = JPF.project_gaussians(xyz, scales, quat, V, Pm, tfx, tfy,
                                     var.width, var.height,
                                     var.scale_modifier, opacity=opacity)
        shs = jnp.swapaxes(jnp.concatenate([f_dc, f_rest], axis=1), 1, 2)
        dir_pp = JM.safe_normalize(xyz - center[None])
        rgb = jnp.maximum(JSH.eval_sh(var.sh_degree, shs, dir_pp) + 0.5, 0.0)
        normal_cam = None
        if var.with_normal:
            normal = JM.shortest_axis_normal(scales, quat)
            view_dir = xyz - center[None]
            sign = jnp.where(jnp.sum(view_dir * normal, -1) > 0, 1.0, -1.0)
            normal_cam = (normal * sign[:, None]) @ V[:3, :3]
        sem = obj_dc[:, 0, :] if var.ch_sem else None
        return JPF.pack_features(proj, opacity, rgb, normal_cam, sem,
                                 var.ch_sem)

    return feats


def assert_grad_matches_jax(lv, active, cam, var, seed):
    """The VJP of ``PF.preprocess`` for a seeded g against ``jax.vjp`` of
    the JAX chain (run op by op, without jit), per leaf and slot group."""
    leaves = lv.map(lambda x: x.detach().requires_grad_(True))
    inputs = list(leaves.as_dict().values())
    pre = PF.preprocess(leaves, active, cam, var)
    g = torch.randn(pre.feats.shape, generator=torch.Generator()
                    .manual_seed(seed))
    got = torch.autograd.grad(pre.feats, inputs, g, allow_unused=True)
    _, vjp = jax.vjp(jax_chain(cam, var),
                     *(jnp.asarray(x.detach().numpy()) for x in inputs))
    want = vjp(jnp.asarray(g.numpy()))
    groups = preprocess_groups(lv, cam, pre.radius)
    assert all(bool(rows.any()) for rows in groups.values())
    for name, a, b in zip(lv.as_dict(), got, want):
        b = np.asarray(b)
        if a is None:
            assert name == "obj_dc" and not var.ch_sem
            assert not b.any()
            continue
        a = a.numpy()
        assert np.isfinite(a).all(), name
        for group, rows in groups.items():
            ga, gb = a[rows.numpy()], b[rows.numpy()]
            np.testing.assert_allclose(
                ga, gb, rtol=0, atol=GRAD_ATOL * np.abs(gb).max(),
                err_msg=f"{name} ({group})")


# every variant on the identity camera, whose means reach tz = 0 exactly,
# and the densest one through a random rotation at two scale modifiers
GRAD_CASES = ([(deg, ch_sem, normal, True, 1.0) for deg in range(4)
               for ch_sem in (0, 2) for normal in (False, True)]
              + [(3, 2, True, False, sm) for sm in (1.0, 0.5)])


@pytest.mark.parametrize("deg,ch_sem,with_normal,identity,scale_modifier",
                         GRAD_CASES)
def test_preprocess_grad_matches_jax(deg, ch_sem, with_normal, identity,
                                     scale_modifier):
    seed = deg if identity else 7
    lv, active, cam = branch_scene(seed=seed, identity=identity,
                                   dtype=torch.float32)
    assert_grad_matches_jax(
        lv, active, cam,
        PF.Variant(W, H, deg, ch_sem, with_normal, scale_modifier), seed)


def test_branch_scene_reaches_the_branches():
    lv, active, cam = branch_scene()
    V, Pm, _, tfx, tfy = PF._camera(cam)
    t = PF._terms(lv.xyz, torch.exp(lv.log_scale), lv.quat, V, Pm, tfx, tfy,
                  W, H, 1.0)
    pre = PF.preprocess_torch(lv, active, cam,
                              PF.Variant(W, H, 3, 2, True, 1.0))
    radius, ext = pre.radius, pre.ext
    op = torch.sigmoid(lv.logit_opacity[:, 0])
    s = lv.log_scale
    assert int((t.tz == 0).sum()) == 15
    assert int(((t.tz <= 0.2) & (t.tz != 0)).sum()) >= 15
    assert int((t.ux.abs() > t.lim_x).sum()) >= 15
    assert int((t.uy.abs() > t.lim_y).sum()) >= 15
    assert int((active & (op * 255 <= 1)).sum()) >= 30
    assert int(((s[:, 1] == s[:, 2]) & (s[:, 0] > s[:, 1])).sum()) >= 20
    assert int((active & (s[:, 0] == s[:, 1])
                & (s[:, 1] == s[:, 2])).sum()) >= 20
    assert bool((lv.quat[~active] == 0).all())
    assert int((radius > 0).sum()) > 100 and int(radius[~active].sum()) == 0
    assert bool((ext[op * 255 <= 1] == 0).all())


def test_render_goes_through_the_function(monkeypatch):
    lv, active, cam = branch_scene(dtype=torch.float32)
    arr = Camera(colmap_id=0, idx=0, image_name="v", R=np.eye(3),
                 T=np.array([0.25, -0.5, 0.75]), fovx=0.9, fovy=0.7,
                 width=W, height=H).arrays("cpu", pixels=False)
    params = lv.map(lambda x: x.requires_grad_(True))
    state = new_state(params, active, 3)
    calls = []
    for name in ("preprocess_torch", "preprocess_backward_torch"):
        fn = getattr(PF, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(PF, name, counted)
    out = RD.render(state, arr, RD.RenderConfig(W, H, ch_sem=2),
                    torch.zeros(3), 3)
    loss = out["render"].sum() + out["depth"].sum()
    grads = torch.autograd.grad(loss, list(params.as_dict().values()))
    assert calls == ["preprocess_torch", "preprocess_backward_torch"]
    assert all(bool(torch.isfinite(x).all()) for x in grads)
    assert float(grads[0].abs().sum()) > 0
    calls.clear()
    RD.render_stats(state, arr, RD.RenderConfig(W, H))
    assert calls == ["preprocess_torch"]


def test_plain_backward_zeros_what_the_features_do_not_read():
    lv, active, cam = branch_scene(dtype=torch.float32)
    var = PF.Variant(W, H, None, 0, True, 1.0)
    g = torch.randn((lv.xyz.shape[0], PF.feature_dim(0)),
                    generator=torch.Generator().manual_seed(3))
    grads = PF.preprocess_backward(g, lv, cam, var)
    # no SH: zero colour; no semantic column: no obj_dc gradient
    assert grads.obj_dc is None
    assert not grads.f_dc.any() and not grads.f_rest.any()
    assert grads.f_rest.shape == lv.f_rest.shape
    assert grads.xyz.abs().sum() > 0 and grads.quat.abs().sum() > 0
    with pytest.raises(ValueError):
        PF.preprocess_backward(g[:, :-1], lv, cam, var)
    with pytest.raises(ValueError):
        PF.preprocess_backward(g.double(), lv, cam, var)


def test_preprocess_refuses_what_the_kernel_does_not_take():
    lv, active, cam = branch_scene(dtype=torch.float32)
    var = PF.Variant(W, H, 3, 2, True, 1.0)
    PF.preprocess_forward(lv, active, cam, var)
    bad = [replace(lv, xyz=lv.xyz.t().contiguous().t()),      # strided
           replace(lv, quat=lv.quat.double()),
           replace(lv, obj_dc=lv.obj_dc[:, :, :1].contiguous())]
    for b in bad:
        with pytest.raises(ValueError):
            PF.preprocess_forward(b, active, cam, var)
    with pytest.raises(ValueError):
        PF.preprocess_forward(lv, active, cam[:36], var)
    with pytest.raises(ValueError):
        PF.preprocess_forward(lv, active.to(torch.uint8), cam, var)
    with pytest.raises(ValueError):
        PF.preprocess_forward(replace(lv, f_rest=lv.f_rest[:, :8]
                                      .contiguous()), active, cam, var)
    with pytest.raises(ValueError):
        PF.preprocess_forward(lv, active, cam, var._replace(ch_sem=9))
