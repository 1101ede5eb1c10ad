"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need a CUDA card (a kernel has no CPU mode) and skip without one. The
file imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import pytest
import torch

from chip_smoke import (BWD_SATURATED, compare_backward, compare_kernel,
                        compare_stats, saturated_scene, splat_scene)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("depth_mode", ["traditional", "intersection"])
@pytest.mark.parametrize("ch_sem", [0, 3, 8])
def test_rasterize_fwd_matches_plain(cuda, depth_mode, ch_sem):
    feats, radius, cam = splat_scene(n=400, seed=ch_sem, ch_sem=ch_sem,
                                     width=72, height=40)
    # compare_kernel holds every channel to atol 2e-4, rtol 1e-3 and the
    # batch counts to exact equality
    err, _, _ = compare_kernel(feats, radius, cam, 72, 40, ch_sem, depth_mode,
                               cuda)
    assert len(err) == 9 + ch_sem


def test_rasterize_fwd_early_stop(cuda):
    feats, radius, cam = saturated_scene()
    _, batches, held = compare_kernel(feats, radius, cam, 40, 24, 0,
                                      "traditional", cuda)
    assert bool((batches < held).any())


def test_rasterize_fwd_launch_count(cuda):
    from vcr_gaus_tpu_torch.ops import rasterize as R
    feats, radius, cam = splat_scene(seed=9)
    R.reset_launch_counts()
    compare_kernel(feats, radius, cam, 40, 24, 0, "traditional", cuda)
    assert R.LAUNCHES["rasterize_fwd"] == 1


@pytest.mark.parametrize("depth_mode", ["traditional", "intersection"])
@pytest.mark.parametrize("ch_sem", [0, 3, 8])
def test_rasterize_bwd_matches_plain(cuda, depth_mode, ch_sem):
    feats, radius, cam = splat_scene(n=400, seed=ch_sem, ch_sem=ch_sem,
                                     width=72, height=40)
    # compare_backward holds each column group of the (N, 16+S) gradient to
    # atol 2e-3 times the group's max|g|, rtol 2e-3
    compare_backward(feats, radius, cam, 72, 40, ch_sem, depth_mode, cuda)


def test_rasterize_bwd_saturated(cuda):
    feats, radius, cam = saturated_scene()
    compare_backward(feats, radius, cam, 40, 24, 0, "traditional", cuda,
                     tol=BWD_SATURATED)


def test_rasterize_bwd_through_autograd(cuda):
    from vcr_gaus_tpu_torch.ops import rasterize as R
    feats, radius, cam = splat_scene(seed=11)
    f = torch.tensor(feats, device=cuda, requires_grad=True)
    dummy = torch.zeros((f.shape[0], 2), device=cuda, requires_grad=True)
    R.reset_launch_counts()
    img, _ = R.rasterize_image(f, dummy, f.detach()[:, :2],
                               torch.tensor(radius, device=cuda),
                               f.detach()[:, 6], torch.tensor(cam, device=cuda),
                               40, 24, 0, "intersection")
    img.square().sum().backward()
    assert dict(R.LAUNCHES) == {"rasterize_fwd": 1, "rasterize_bwd": 1}
    assert bool(torch.isfinite(f.grad).all()) and float(dummy.grad.sum()) > 0


def test_rasterize_fwd_rejects_mixed_devices(cuda):
    from vcr_gaus_tpu_torch.ops import binning as B
    from vcr_gaus_tpu_torch.ops import rasterize as R
    feats, radius, cam = splat_scene(seed=10)
    f = torch.tensor(feats, device=cuda)
    binn = B.bin_gaussians(f[:, :2], torch.tensor(radius, device=cuda),
                           f[:, 6], 40, 24)
    with pytest.raises(ValueError):
        R.rasterize_forward(f, binn, torch.tensor(cam), 40, 24, 0,
                            "traditional")


@pytest.mark.parametrize("case", ["traditional_72x40", "intersection_72x40",
                                  "ragged_40x24", "all_culled_40x24"])
def test_rasterize_stats_matches_plain(cuda, case):
    w, h = (72, 40) if case.endswith("72x40") else (40, 24)
    feats, radius, _ = splat_scene(n=400 if w == 72 else 60,
                                   seed=len(case), width=w, height=h)
    if case.startswith("all_culled"):
        radius = radius * 0
    # compare_stats holds the hit counts to exact equality and the
    # importance to atol 2e-4, rtol 1e-3
    err, _, _ = compare_stats(feats, radius, w, h, cuda)
    assert err <= 2e-4


def test_rasterize_stats_saturated_and_ragged(cuda):
    feats, radius, cam = saturated_scene()
    _, batches, held = compare_stats(feats, radius, 40, 24, cuda)
    assert bool((batches.cpu() < held.cpu()).any())
    # on the ragged bottom row the forward kernel stops, the stats walk not
    feats[:, 1] += 16.0
    _, fwd_batches, fwd_held = compare_kernel(feats, radius, cam, 40, 24, 0,
                                              "traditional", cuda)
    _, batches, _ = compare_stats(feats, radius, 40, 24, cuda)
    assert int(fwd_batches[3]) < int(fwd_held[3]) == int(batches[3])


def test_render_stats_launches_the_kernel(cuda):
    import numpy as np

    from vcr_gaus_tpu_torch.data.cameras import Camera
    from vcr_gaus_tpu_torch.models.gaussians import create_from_pcd
    from vcr_gaus_tpu_torch.ops import rasterize as R
    from vcr_gaus_tpu_torch.render.renderer import RenderConfig, render_stats

    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-1, 1, 200), rng.uniform(-1, 1, 200),
                    rng.uniform(3, 6, 200)], 1).astype(np.float32)
    state = create_from_pcd(pts, rng.uniform(0, 1, (200, 3)), 256, 3,
                            device=cuda)
    cam = Camera(colmap_id=0, idx=0, image_name="v", R=np.eye(3),
                 T=np.zeros(3), fovx=0.9, fovy=0.7, width=64, height=48)
    R.reset_launch_counts()
    count, imp = render_stats(state, cam.arrays(cuda, pixels=False),
                              RenderConfig(width=64, height=48))
    assert dict(R.LAUNCHES) == {"rasterize_stats": 1}
    assert float(count[:200].sum()) > 0 and float(imp[200:].abs().sum()) == 0
