"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need a CUDA card (a kernel has no CPU mode) and skip without one. The
file imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import pytest
import torch

from chip_smoke import (BWD_SATURATED, compare_backward, compare_kernel,
                        compare_probe, compare_stats, saturated_scene,
                        splat_scene, threshold_scene)
from vcr_gaus_tpu_torch.ops import microprobe as M

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


@pytest.mark.parametrize("depth_mode", ["traditional", "intersection"])
def test_rasterize_ragged_edges(cuda, depth_mode):
    # 45x29: the last tile column and row hold 13 pixels, so the pixel map
    # has threads whose two pixels lie one inside and one outside the image
    feats, radius, cam = splat_scene(n=250, seed=13, ch_sem=2, width=45,
                                     height=29)
    compare_kernel(feats, radius, cam, 45, 29, 2, depth_mode, cuda)
    compare_backward(feats, radius, cam, 45, 29, 2, depth_mode, cuda)


@pytest.mark.parametrize("depth_mode", ["traditional", "intersection"])
def test_rasterize_dead_pair_threshold(cuda, depth_mode):
    # pairs within 4e-3 of the alpha threshold on both sides of the
    # kernels' dead-pair threshold: every channel at the forward tolerance
    # and the batch counts exactly (compare_kernel), and the gradients
    seed = 14 if depth_mode == "traditional" else 15
    feats, radius, cam = threshold_scene(seed=seed)
    compare_kernel(feats, radius, cam, 45, 29, 0, depth_mode, cuda)
    compare_backward(feats, radius, cam, 45, 29, 0, depth_mode, cuda)


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


def test_rasterize_stats_dead_pair_threshold(cuda):
    # pairs within 4e-3 of the alpha threshold on both sides of the
    # kernel's dead-pair threshold, on a ragged 45x29 image: the hit counts
    # exactly equal, the importance at atol 2e-4, rtol 1e-3
    feats, radius, _ = threshold_scene()
    err, _, _ = compare_stats(feats, radius, 45, 29, cuda)
    assert err <= 2e-4


@pytest.mark.parametrize("seed", [13, 16])
def test_rasterize_stats_ragged_edges(cuda, seed):
    # 45x29: the last tile column and row hold 13 pixels, so the pixel map
    # has threads whose two pixels lie one inside and one outside the image
    feats, radius, _ = splat_scene(n=250, seed=seed, width=45, height=29)
    err, _, _ = compare_stats(feats, radius, 45, 29, cuda)
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


def probe_inputs(device, n_tiles=4, chunks=6):
    return [torch.from_numpy(a).to(device)
            for a in M.probe_inputs(n_tiles, chunks, seed=2)]


@pytest.mark.parametrize("variant", list(M.VARIANTS))
def test_kernel_microprobe_matches_plain(cuda, variant):
    ins = probe_inputs(cuda)
    # compare_probe holds each channel to atol 2e-4 times its own max|value|
    # and rtol 1e-3
    compare_probe(M.microprobe(*ins, **M.VARIANTS[variant]),
                  M.microprobe_torch(*ins, **M.toggles_of(variant)))


def test_kernel_microprobe_uneven_tiles(cuda):
    # tiles of 0, 2 and 6 chunks, one range starting mid-matrix
    feats, starts, counts = probe_inputs(cuda)
    starts = torch.tensor([0, 1536, 4608, 3072], dtype=torch.int32,
                          device=cuda)
    counts = torch.tensor([1536, 0, 512, 1536], dtype=torch.int32,
                          device=cuda)
    for name in ("full", "full_d6", "full_d4_g512", "dma_u6"):
        compare_probe(M.microprobe(feats, starts, counts, **M.VARIANTS[name]),
                      M.microprobe_torch(feats, starts, counts,
                                         **M.toggles_of(name)))


def test_kernel_microprobe_rejects_ragged(cuda):
    feats, starts, counts = probe_inputs(cuda)
    counts[0] -= 1
    with pytest.raises(ValueError):
        M.microprobe(feats, starts, counts, **M.VARIANTS["full"])
    with pytest.raises(ValueError):
        M.microprobe(feats, starts + 64, counts + 1, **M.VARIANTS["dma_only"])


def test_kernel_microprobe_launch_count(cuda):
    from vcr_gaus_tpu_torch.ops import rasterize as R
    ins = probe_inputs(cuda, n_tiles=2)
    R.reset_launch_counts()
    M.microprobe(*ins, **M.VARIANTS["full"])
    assert dict(R.LAUNCHES) == {"kernel_microprobe": 1}
    M.microprobe_torch(*ins, **M.toggles_of("full"))
    M.microprobe(*ins, **M.VARIANTS["no_exp"])
    assert dict(R.LAUNCHES) == {"kernel_microprobe": 2}
