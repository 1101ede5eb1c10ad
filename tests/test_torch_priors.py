"""The port's depth and mask priors against the JAX package's, which reads
them with OpenCV: depth from .npz and 16-bit .png, masks from RGB, RGBA,
palette and greyscale PNGs (OpenCV's channel 0 of BGR is the blue
channel), each at the image's size and resized (bilinear for depth,
nearest for masks), the mask's ``name[1:]`` fallback, and whole scenes in
the host and lazy modes.

Depth is exactly equal when not resized and within 1e-5 of OpenCV's
resize relative to its range (1e-5 absolute for depths in [0, 1)); masks
are exactly equal.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from fixtures import write_colmap_scene
from vcr_gaus_tpu.data import scene as JS
from vcr_gaus_tpu_torch.data import scene as S

W, H = 64, 48
NATIVE, RESIZED = (H, W), (37, 51)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def write_depth(base, stem, kind, shape, seed=0):
    """A depth prior in ``kind`` ("npz": float32 in [0, 1); "png16": 16-bit
    integers) of ``shape``; returns its largest value."""
    rng = np.random.default_rng(seed)
    os.makedirs(base, exist_ok=True)
    if kind == "npz":
        d = rng.uniform(0, 1, shape).astype(np.float32)
        np.savez(os.path.join(base, stem + ".npz"), d)
    else:
        d = rng.integers(0, 65536, shape).astype(np.uint16)
        Image.fromarray(d).save(os.path.join(base, stem + ".png"))
        assert Image.open(os.path.join(base, stem + ".png")).mode in (
            "I;16", "I")
    return float(d.max())


def write_mask(path, kind, shape, seed=0):
    """A label PNG of ``kind``: colour PNGs hold different labels in each
    channel, so that reading the wrong one shows."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lab = rng.integers(0, 4, shape + (4,)).astype(np.uint8)
    if kind == "rgb":
        img = Image.fromarray(lab[..., :3], "RGB")
    elif kind == "rgba":
        img = Image.fromarray(lab, "RGBA")
    elif kind == "palette":
        img = Image.fromarray(lab[..., 0], "P")
        img.putpalette([v for i in range(256)
                        for v in (i % 7, 3 * i % 11, 5 * i % 13)])
    else:
        img = Image.fromarray(lab[..., 0], "L")
    img.save(path)


@pytest.mark.parametrize("shape", [NATIVE, RESIZED],
                         ids=["native", "resized"])
@pytest.mark.parametrize("kind", ["npz", "png16"])
def test_depth_prior_equals_jax(tmp_path, kind, shape):
    base = str(tmp_path / "depths")
    top = write_depth(base, "img_000", kind, shape)
    got = S._load_aux(base, "img_000.png", "depth", (W, H))
    want = JS._load_aux(base, "img_000.png", "depth", (W, H))
    assert got.shape == want.shape == (H, W)
    assert got.dtype == want.dtype == np.float32
    if shape == NATIVE:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * top)


@pytest.mark.parametrize("shape", [NATIVE, RESIZED],
                         ids=["native", "resized"])
@pytest.mark.parametrize("kind", ["rgb", "rgba", "palette", "grey"])
def test_mask_prior_equals_jax(tmp_path, kind, shape):
    base = str(tmp_path / "masks")
    write_mask(os.path.join(base, "img_000.png"), kind, shape)
    got = S._load_aux(base, "img_000.png", "mask", (W, H))
    want = JS._load_aux(base, "img_000.png", "mask", (W, H))
    assert got.shape == want.shape == (H, W)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if kind in ("rgb", "rgba"):
        # the blue channel: PIL's channel 2
        raw = np.asarray(Image.open(os.path.join(base, "img_000.png")))
        if shape == NATIVE:
            np.testing.assert_array_equal(got, raw[..., 2])


def test_prior_lookup_rules_equal_jax(tmp_path):
    """The mask's fallback to ``name[1:]``, absent priors, and the lazy
    mode's path probes."""
    base = str(tmp_path / "masks")
    write_mask(os.path.join(base, "mg_001.png"), "grey", NATIVE)
    for name in ("img_001.png", "img_002.png"):
        got = S._load_aux(base, name, "mask", (W, H))
        want = JS._load_aux(base, name, "mask", (W, H))
        assert (got is None) == (want is None) == (name == "img_002.png")
        if got is not None:
            np.testing.assert_array_equal(got, want)
        assert S._aux_exists(base, name, "mask") == JS._aux_exists(
            base, name, "mask")
    dbase = str(tmp_path / "depths")
    write_depth(dbase, "img_003", "png16", NATIVE)
    for name in ("img_003.png", "img_004.png"):
        for kind in ("depth", "normal"):
            assert S._aux_exists(dbase, name, kind) == JS._aux_exists(
                dbase, name, kind)
            got = S._load_aux(dbase, name, kind, (W, H))
            assert (got is None) == (JS._load_aux(dbase, name, kind, (W, H))
                                     is None)


@pytest.mark.parametrize("data_device", ["host", "lazy"])
def test_scene_priors_equal_jax(tmp_path, data_device):
    """A whole scene: the depth prior of every other view (npz, then
    16-bit png, at the image's size and not), a mask of every kind."""
    root = str(tmp_path / "scene")
    write_colmap_scene(root, n_cams=4, n_pts=100, width=W, height=H)
    kinds = ["rgb", "rgba", "palette", "grey"]
    for i in range(4):
        stem = f"img_{i:03d}"
        if i % 2 == 0:
            write_depth(os.path.join(root, "dep"), stem,
                        ["npz", "png16"][i // 2], [NATIVE, RESIZED][i // 2],
                        seed=i)
        write_mask(os.path.join(root, "masks", stem + ".png"), kinds[i],
                   [NATIVE, RESIZED][i % 2], seed=i)
    kw = dict(load_depth=True, load_mask=True, depth_folder="dep",
              data_device=data_device)
    got = S.load_scene_info(root, **kw)
    want = JS.load_scene_info(root, **kw)
    for i, (gc, wc) in enumerate(zip(got.train_cameras, want.train_cameras)):
        ga, wa = gc.arrays("cpu"), wc.arrays()
        assert bool(ga.has_depth) == bool(wa.has_depth) == (i % 2 == 0)
        assert bool(ga.has_mask) and bool(wa.has_mask)
        np.testing.assert_array_equal(ga.mask.numpy(), np.asarray(wa.mask))
        np.testing.assert_allclose(ga.depth.numpy(), np.asarray(wa.depth),
                                   rtol=0, atol=1e-5 * 65535)
        if i == 0:
            np.testing.assert_array_equal(ga.depth.numpy(),
                                          np.asarray(wa.depth))
