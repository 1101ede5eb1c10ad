"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need a CUDA card (a kernel has no CPU mode) and skip without one. The
file imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import pytest
import torch

from chip_smoke import compare_kernel, saturated_scene, splat_scene


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
