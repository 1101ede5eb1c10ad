"""The port's training panels against the JAX package's: the same numpy
inputs give the same u8 images, exactly."""

import numpy as np
import pytest
from PIL import Image

from vcr_gaus_tpu.train import visualization as JVZ
from vcr_gaus_tpu_torch.train import visualization as VZ

H, W, S = 12, 20, 3


def render_out(seed, full):
    rng = np.random.default_rng(seed)

    def unit(*shape):
        v = rng.normal(size=shape).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    out = {"render": rng.uniform(-0.1, 1.1, (3, H, W)).astype(np.float32),
           "depth": rng.uniform(0.5, 4.0, (H, W)).astype(np.float32),
           "alpha": rng.uniform(0, 1, (H, W)).astype(np.float32),
           "normal": unit(H, W, 3), "est_normal": unit(H, W, 3)}
    if full:
        out.update(render_sem=rng.normal(size=(S, H, W)).astype(np.float32),
                   distortion=rng.uniform(0, 1e-3, (H, W)).astype(np.float32),
                   depth_var=rng.uniform(0, 1e-2, (H, W)).astype(np.float32))
    return out, rng


@pytest.mark.parametrize("full", [False, True])
def test_panel_images_match_jax(full):
    out, rng = render_out(0, full)
    kw = {}
    if full:
        kw = dict(gt_image=rng.uniform(0, 1, (3, H, W)).astype(np.float32),
                  gt_normal=np.moveaxis(render_out(1, False)[0]["normal"],
                                        -1, 0),
                  exp_t=0.05, num_cls=S,
                  gt_mask=rng.integers(0, S, (H, W)),
                  trans_image=rng.uniform(0, 1, (3, H, W)).astype(np.float32))
    got = VZ.panel_images(out, **kw)
    want = JVZ.panel_images(out, **kw)
    assert sorted(got) == sorted(want)
    if full:
        assert {"normal_gt", "normal_cos", "sem", "trans"} <= set(got)
    for k in want:
        assert got[k].dtype == np.uint8
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_save_panels_match_jax(tmp_path):
    out, rng = render_out(2, False)
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    got = VZ.save_panels(str(tmp_path / "port"), "iter_000001", out, gt)
    want = JVZ.save_panels(str(tmp_path / "jax"), "iter_000001", out, gt)
    got, want = (np.asarray(Image.open(p)) for p in (got, want))
    assert got.shape == (H, 5 * W, 3)
    np.testing.assert_array_equal(got, want)
