"""The losses this slice ports, and the side networks' optimizer, against
the JAX package on the same numpy inputs: the opacity entropy, the normal
curvature, the scale-and-shift-invariant depth loss, the semantic cross
entropy and the SSIM's plain version (also against the float64 separable
reference of its kernels), each value at rtol 1e-5 and its gradient at
atol 1e-5 max|g|;
labels outside the classes; the SSI loss on an empty mask (the port's
gradient is finite and zero where the JAX one is NaN); Adam against
optax.adam(eps=1e-15).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import ssim_images, ssim_reference
from vcr_gaus_tpu.train import losses as JL
from vcr_gaus_tpu_torch.train import losses as L
from vcr_gaus_tpu_torch.train.side_nets import Adam


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def value_and_grad_both(jfn, fn, x, *rest):
    """(port value, JAX value, port gradient, JAX gradient) of a scalar
    loss in its first argument."""
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(x), *(
        jnp.asarray(r) for r in rest))
    t = torch.tensor(x, requires_grad=True)
    v = fn(t, *(torch.as_tensor(np.asarray(r)) for r in rest))
    (g,) = torch.autograd.grad(v, t)
    return float(v), float(jv), g.numpy(), np.asarray(jg)


def assert_loss_close(v, jv, g, jg):
    assert v == pytest.approx(jv, rel=1e-5, abs=1e-12)
    scale = float(np.abs(jg).max())
    assert scale > 0
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-5 * scale)


def unit_normals(rng, *shape):
    v = rng.normal(size=shape + (3,)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("masked", [False, True])
def test_entropy_loss_matches_jax(masked):
    rng = np.random.default_rng(0)
    op = rng.uniform(0.001, 0.999, 300).astype(np.float32)
    op[:5] = [0.0, 1.0, 0.5, 1e-7, 1 - 1e-7]
    mask = rng.uniform(size=300) > 0.3
    if masked:
        out = value_and_grad_both(
            lambda o, m: JL.entropy_loss(o, m),
            lambda o, m: L.entropy_loss(o, m), op, mask)
    else:
        out = value_and_grad_both(JL.entropy_loss, L.entropy_loss, op)
    assert_loss_close(*out)


def test_normal2curv_matches_jax():
    rng = np.random.default_rng(1)
    n = unit_normals(rng, 13, 17)
    mask = (rng.uniform(size=(13, 17, 1)) > 0.3).astype(np.float32)
    w = rng.uniform(size=(13, 17, 1)).astype(np.float32)
    got = L.normal2curv(torch.tensor(n), torch.tensor(mask))
    want = JL.normal2curv(jnp.asarray(n), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the trainer's use: |curv|.mean(), weighted to give every pixel a
    # distinct gradient
    out = value_and_grad_both(
        lambda x, m, w: (jnp.abs(JL.normal2curv(x, m)) * w).mean(),
        lambda x, m, w: (torch.abs(L.normal2curv(x, m)) * w).mean(),
        n, mask, w)
    assert_loss_close(*out)


def ssi_inputs(seed, shape=(24, 31)):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.5, 4.0, shape).astype(np.float32)
    target = (0.3 * pred + rng.normal(0, 0.05, shape)).astype(np.float32)
    mask = (rng.uniform(size=shape) > 0.35).astype(np.float32)
    return pred, target, mask


@pytest.mark.parametrize("alpha,scales,batched",
                         [(0.5, 1, False), (0.5, 3, False), (0.0, 1, True)])
def test_ssi_depth_loss_matches_jax(alpha, scales, batched):
    shape = (2, 24, 31) if batched else (24, 31)
    pred, target, mask = ssi_inputs(2, shape)
    out = value_and_grad_both(
        lambda p, t, m: JL.scale_and_shift_invariant_depth_loss(
            p, t, m, alpha=alpha, scales=scales),
        lambda p, t, m: L.scale_and_shift_invariant_depth_loss(
            p, t, m, alpha=alpha, scales=scales),
        pred, target, mask)
    assert out[0] > 0
    assert_loss_close(*out)


def test_ssi_depth_loss_empty_mask():
    """A camera without a depth prior: the mask is empty. Both values are
    0; the JAX gradient is NaN there (observed, the JAX package stays as
    it is), the port's is finite and zero."""
    pred, target, _ = ssi_inputs(3)
    empty = np.zeros_like(pred)
    v, jv, g, jg = value_and_grad_both(
        JL.scale_and_shift_invariant_depth_loss,
        L.scale_and_shift_invariant_depth_loss, pred, target, empty)
    assert v == jv == 0.0
    assert np.isnan(jg).all()
    assert np.isfinite(g).all() and not g.any()


def test_semantic_cross_entropy_matches_jax():
    """Labels in [0, num_cls) and outside it (a 255 mask, a negative): an
    outside label has a zero one-hot row, adds 0 and counts in the mean."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 11, 14)).astype(np.float32)
    labels = rng.integers(0, 3, (11, 14)).astype(np.int32)
    labels[0, :5] = 255
    labels[1, :2] = -1
    out = value_and_grad_both(
        lambda x, y: JL.semantic_cross_entropy(x, y, 3),
        lambda x, y: L.semantic_cross_entropy(x, y, 3), logits, labels)
    assert_loss_close(*out)
    # the outside pixels' logits get no gradient
    assert not out[2][:, 0, :5].any() and not out[2][:, 1, :2].any()
    inside = labels.copy()
    inside[0, :5] = inside[1, :2] = 0
    full = L.semantic_cross_entropy(torch.tensor(logits), torch.tensor(inside),
                                    3)
    assert float(full) > out[0]


@pytest.mark.parametrize("shape", [(3, 7, 13), (1, 9, 5), (2, 17, 11),
                                   (3, 24, 31), (1, 4, 40)])
def test_ssim_matches_jax_and_separable_reference(shape):
    """The plain (banded-matrix) SSIM on CPU tensors against the JAX
    package's and against the float64 direct separable 11-tap blur with
    the closed-form gradient of csrc/ssim.cu (``chip_smoke
    .ssim_reference``), on odd shapes, some under the window: value and
    gradient of img1."""
    img1, img2 = ssim_images(shape, seed=sum(shape))
    out = value_and_grad_both(JL.ssim, L.ssim, img1, img2)
    assert_loss_close(*out)
    want_v, want_g = ssim_reference(torch.tensor(img1), torch.tensor(img2))
    assert_loss_close(out[0], float(want_v), out[2], want_g.numpy())


def test_adam_matches_optax():
    """Five steps of optax.adam(lr, eps=1e-15) and the port's Adam from
    the same gradients: parameters, moments and count."""
    rng = np.random.default_rng(5)
    params = [rng.normal(size=(4, 3)).astype(np.float32),
              rng.normal(size=(7,)).astype(np.float32)]
    tx = optax.adam(1e-3, eps=1e-15)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.tensor(p) for p in params]
    opt = Adam(tp, 1e-3)
    for k in range(5):
        grads = [rng.normal(size=p.shape).astype(np.float32) * 10 ** -k
                 for p in params]
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.tensor(g) for g in grads])
    assert opt.count == int(jstate[0].count) == 5
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    for mine, theirs in ((opt.mu, jstate[0].mu), (opt.nu, jstate[0].nu)):
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=0)
