"""The port's appearance network and semantic classifier against the JAX
package's flax modules, with the flax weights carried across
(``load_flax``): the appearance transform at atol 1e-5 (its embedding
gradient at 1e-5 max|g|), the classifier's logits at atol 1e-6; the pixel
shuffle and the align-corners resize alone; the weight mapping both ways;
the port's own initialization.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcr_gaus_tpu.models import appearance as JAPP
from vcr_gaus_tpu_torch.models import appearance as APP


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_pixel_shuffle_and_resize_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7, 12)).astype(np.float32)          # (H, W, C)
    want = np.asarray(JAPP.pixel_shuffle(jnp.asarray(x), 2))
    got = torch.nn.PixelShuffle(2)(torch.tensor(x).permute(2, 0, 1)[None])
    np.testing.assert_array_equal(got[0].permute(1, 2, 0).numpy(), want)
    for oh, ow in ((10, 14), (3, 4), (9, 20)):
        want = np.asarray(JAPP.bilinear_resize(jnp.asarray(x), oh, ow))
        got = APP.bilinear_resize(torch.tensor(x).permute(2, 0, 1)[None],
                                  oh, ow)[0].permute(1, 2, 0).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("height,width", [(64, 64), (72, 100)])
def test_appearance_transform_matches_jax(height, width):
    """The transform of one view's render: its crop box, the corrected
    crop, and the gradient of a weighted sum of it in the embeddings."""
    rng = np.random.default_rng(1)
    emb, params = JAPP.init_appearance(jax.random.PRNGKey(3), 4, height,
                                       width)
    # embeddings of order 1 so that they move the map
    emb = jnp.asarray(rng.normal(size=emb.shape).astype(np.float32))
    image = rng.uniform(size=(3, height, width)).astype(np.float32)
    wts = rng.uniform(size=(3, height // 32 * 32, width // 32 * 32)
                      ).astype(np.float32)

    def jloss(e):
        out, box = JAPP.appearance_transform(params, e, jnp.asarray(image), 2)
        return jnp.sum(out * wts), (out, box)

    (_, (want, jbox)), jg = jax.value_and_grad(jloss, has_aux=True)(emb)
    net = APP.load_flax(APP.AppearanceNetwork(), numpy_tree(params))
    t_emb = torch.tensor(np.asarray(emb), requires_grad=True)
    got, box = APP.appearance_transform(net, t_emb, torch.tensor(image),
                                        torch.tensor(2))
    assert box == tuple(int(v) for v in jbox)
    assert box == APP.crop_box(height, width)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    (g,) = torch.autograd.grad((got * torch.tensor(wts)).sum(), t_emb)
    jg = np.asarray(jg)
    assert not g[[0, 1, 3]].any() and np.abs(jg[2]).max() > 0
    np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())


def test_semantic_classifier_matches_jax():
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(2, 9, 13)).astype(np.float32)
    clf = JAPP.SemanticClassifier(3)
    variables = clf.init(jax.random.PRNGKey(0), jnp.zeros((2, 8, 8)))
    variables = jax.tree.map(
        lambda v: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)),
        variables)
    want = np.asarray(clf.apply(variables, jnp.asarray(feat)))
    port = APP.load_flax(APP.SemanticClassifier(2, 3), numpy_tree(variables))
    got = port(torch.tensor(feat)).detach().numpy()
    assert got.shape == want.shape == (3, 9, 13)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_weight_mapping_round_trips():
    """flax -> port -> flax gives the flax arrays back exactly; the conv
    kernels go HWIO -> OIHW and the dense kernel (in, out) -> (out, in)."""
    _, params = JAPP.init_appearance(jax.random.PRNGKey(4), 2, 64, 96)
    flax = numpy_tree(params)
    net = APP.load_flax(APP.AppearanceNetwork(), flax)
    assert net.conv0.weight.shape == (256, 67, 3, 3)
    back = APP.to_flax(net)
    assert jax.tree.structure(back) == jax.tree.structure(flax)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(flax)):
        np.testing.assert_array_equal(a, b)
    moments = APP.from_flax_tensors(net, flax, "cpu")
    assert set(moments) == set(net.parameters())
    for a, b in zip(jax.tree.leaves(APP.to_flax(net, moments)),
                    jax.tree.leaves(flax)):
        np.testing.assert_array_equal(a, b)
    clf = APP.SemanticClassifier(2, 2)
    dense = APP.to_flax(clf)["params"]["Dense_0"]
    np.testing.assert_array_equal(dense["kernel"],
                                  clf.dense.weight.detach().numpy().T)


def test_port_init_is_seeded():
    """The port draws its own weights from the generator it is given:
    embeddings N(0, 1e-4), lecun-normal kernels, zero biases."""
    emb, net = APP.init_appearance(500, torch.Generator().manual_seed(0))
    emb2, net2 = APP.init_appearance(500, torch.Generator().manual_seed(0))
    torch.testing.assert_close(emb, emb2, rtol=0, atol=0)
    torch.testing.assert_close(net.conv0.weight, net2.conv0.weight, rtol=0,
                               atol=0)
    assert emb.shape == (500, 64)
    assert float(emb.std()) == pytest.approx(1e-4, rel=0.05)
    std = float(net.conv0.weight.std())
    assert std == pytest.approx(1 / np.sqrt(67 * 9), rel=0.05)
    assert not net.conv0.bias.any()
    clf = APP.init_classifier(2, 2, torch.Generator().manual_seed(0))
    assert clf.dense.weight.shape == (2, 2) and not clf.dense.bias.any()
