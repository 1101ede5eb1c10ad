"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need a CUDA card (a kernel has no CPU mode) and skip without one. The
file imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import os

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


def sphere_depths(n_views=4, w=96, h=72, r=0.5):
    """Analytic z-depth of a sphere of radius r at the origin from ring
    cameras at distance 3: (depth (H,W), row-vector viewmatrix, intr)."""
    import numpy as np

    fx, fy = w / (2 * np.tan(0.4)), h / (2 * np.tan(0.325))
    ys, xs = np.mgrid[0:h, 0:w] + 0.5
    dirs = np.stack([(xs - w / 2) / fx, (ys - h / 2) / fy, np.ones_like(xs)],
                    -1)
    views = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        pos = np.array([3 * np.cos(ang), 0.5, 3 * np.sin(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        view = np.eye(4, dtype=np.float32)
        view[:3, :3], view[:3, 3] = R, -R @ pos
        d_world = dirs @ R                      # z-unit rays in the world
        b = 2 * (d_world @ pos)
        c = pos @ pos - r * r
        a = np.sum(d_world * d_world, -1)
        disc = b * b - 4 * a * c
        t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a),
                     0)
        views.append((t.astype(np.float32), view.T.copy(),
                      np.array([fx, fy, w / 2, h / 2], np.float32)))
    return views


def test_tsdf_integrate_on_card_matches_cpu(cuda, monkeypatch):
    import numpy as np

    from vcr_gaus_tpu_torch.meshing import tsdf as T

    monkeypatch.setattr(T, "SLAB_VOXELS", 20_000)      # several slabs
    grids = {dev: T.create_grid(np.zeros(3), 0.7, 0.02, device=dev)
             for dev in ("cpu", cuda)}
    for depth, view, intr in sphere_depths():
        for dev, grid in grids.items():
            T.integrate(grid, torch.from_numpy(depth).to(dev),
                        torch.from_numpy(view).to(dev),
                        torch.from_numpy(intr).to(dev))
    cpu, card = grids["cpu"], grids[cuda]
    assert int((cpu.weight > 0).sum()) > 5000
    differ = ((card.weight.cpu() != cpu.weight)
              | ((card.tsdf.cpu() - cpu.tsdf).abs() > 1e-5))
    assert int(differ.sum()) <= 1e-4 * differ.numel()


def test_nn_and_downsample_on_card_match_scipy(cuda):
    import numpy as np
    from scipy.spatial import cKDTree

    from vcr_gaus_tpu_torch.evaluation import geometry as GE

    rng = np.random.default_rng(0)
    d = rng.normal(size=(40_000, 3))
    target = 300 * d / np.linalg.norm(d, axis=1, keepdims=True) + 600
    query = target[:20_000] + rng.normal(scale=2.0, size=(20_000, 3))
    query[:200] += 80                               # beyond max_dist
    want = cKDTree(target).query(query)[0]
    np.testing.assert_allclose(GE.nn_distances(query, target, device=cuda),
                               want, rtol=1e-12, atol=0)
    capped = GE.nn_distances(query, target, max_dist=20.0, device=cuda)
    near = want < 20.0
    np.testing.assert_allclose(capped[near], want[near], rtol=1e-12, atol=0)
    assert (capped[~near] >= 20.0).all()
    # the greedy downsample's point set, bit for bit
    pts = np.concatenate([target, target[:5000] + 0.1])
    np.testing.assert_array_equal(
        GE.radius_downsample(pts, 2.0, device=cuda),
        GE.radius_downsample(pts, 2.0, device="cpu"))


def shell_state(device, n=4000, ch_sem=0, seed=0):
    """A state of ``n`` Gaussians on a sphere shell of radius 1.5 at z = 4
    and its box (trans, scale)."""
    import numpy as np

    from vcr_gaus_tpu_torch.models.gaussians import create_from_pcd

    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    pts = (1.5 * d / np.linalg.norm(d, axis=1, keepdims=True)
           + [0.0, 0.0, 4.0]).astype(np.float32)
    state = create_from_pcd(pts, rng.uniform(0, 1, (n, 3)), 2 * n, 3,
                            ch_sem, device=device)
    return state, np.array([0.0, 0.0, 4.0], np.float32), np.full(
        3, 1.65, np.float32)


def test_rasterize_stats_on_box_view(cuda):
    """K3 on 512x512 views at a 2.5 rad field of view from the random box
    cameras, as a densify of the TNT recipe renders them: hit counts
    exactly, importance at the forward tolerance."""
    from chip_smoke import FWD, stats_inputs
    from vcr_gaus_tpu_torch.data.box_cameras import sample_box_cameras
    from vcr_gaus_tpu_torch.ops import binning as B
    from vcr_gaus_tpu_torch.ops import rasterize as R
    from vcr_gaus_tpu_torch.render.renderer import RenderConfig

    state, trans, scale = shell_state(cuda)
    cams = sample_box_cameras(200, trans, scale, sample_mode="random",
                              size=512, seed=20, device=cuda)
    assert len(cams) == 198
    rcfg = RenderConfig(width=512, height=512)
    hits = 0
    for cam in (cams[0], cams[100]):                # a top and a side view
        feats, binn, w, h = stats_inputs(state, cam, rcfg)
        got = R.rasterize_stats(feats, binn, w, h)
        want, _ = R.composite_tiles_stats_torch(
            feats, binn.sorted_gid, binn.tile_starts, binn.tile_counts,
            B.tile_grid(w, h)[0], w, h)
        assert torch.equal(got[:, 0], want[:, 0])
        torch.testing.assert_close(got[:, 1], want[:, 1], **FWD)
        hits += int((got[:, 0] > 0).sum())
    assert hits > 0


def test_tnt_step_on_card_matches_cpu(cuda):
    """One step of the TNT recipe (the appearance network, two semantic
    channels, the classifier; entropy and mono_depth on) at 64x64 on the
    card and on the CPU from the same state, side networks and camera:
    every loss at rtol 1e-4, each parameter group's first Adam moment (0.1
    of its gradient) at 2e-3 of its largest, the side networks' too."""
    import os

    import numpy as np

    from vcr_gaus_tpu_torch.config import Config
    from vcr_gaus_tpu_torch.data.cameras import Camera
    from vcr_gaus_tpu_torch.render.renderer import RenderConfig
    from vcr_gaus_tpu_torch.train import trainer as T
    from vcr_gaus_tpu_torch.train.side_nets import SideNets

    cfg = Config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "tnt", "base.yaml"))
    weights = {**T.recipe_weights(cfg), "entropy": 0.01, "mono_depth": 0.01}
    rng = np.random.default_rng(1)
    nrm = rng.normal(size=(3, 64, 64)).astype(np.float32)
    view = Camera(colmap_id=0, idx=1, image_name="v", R=np.eye(3),
                  T=np.zeros(3), fovx=0.9, fovy=0.9, width=64, height=64,
                  image=rng.uniform(0, 1, (3, 64, 64)).astype(np.float32),
                  normal=nrm / np.linalg.norm(nrm, axis=0),
                  depth=rng.uniform(0.1, 1, (64, 64)).astype(np.float32),
                  mask=rng.integers(0, 2, (64, 64)).astype(np.int32))
    out = []
    for dev in ("cpu", cuda):
        state, trans, scale = shell_state(dev, n=2000, ch_sem=2)
        nets = SideNets(cfg, 3, 2, 2, torch.Generator().manual_seed(0),
                        torch.device(dev))
        step = T.make_train_step(cfg, RenderConfig(64, 64, ch_sem=2,
                                                   depth_mode="intersection",
                                                   mask_depth_thr=0.8),
                                 weights, 3.0, trans, scale, 2)
        new, losses, _ = step(state, view.arrays(dev),
                              torch.tensor([0.1, 0.2, 0.3], device=dev),
                              1e-3, 3, T.Gates(*(True,) * 5), nets)
        out.append((new, losses, nets.state_dict()))
    (cpu, l_cpu, n_cpu), (card, l_card, n_card) = out
    assert set(l_card) == set(l_cpu) >= {"semantic", "entropy", "mono_depth"}
    for k, v in l_cpu.items():
        assert float(l_card[k]) == pytest.approx(float(v), rel=1e-4,
                                                 abs=1e-7), k
    for k, want in cpu.adam.mu.as_dict().items():
        if want.numel():
            got = getattr(card.adam.mu, k).cpu()
            scale_g = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=2e-3,
                                       atol=2e-3 * scale_g)
    for name in ("app_opt", "cls_opt"):
        for got, want in zip(leaves(n_card[name]["mu"]),
                             leaves(n_cpu[name]["mu"])):
            scale_g = float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=2e-3,
                                       atol=2e-3 * scale_g)


def leaves(tree) -> list:
    """The arrays of a tree of dicts and tuples, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def test_tnt_geometry_on_card_matches_host(cuda):
    """The TNT evaluation's point work on the card against the CPU and
    scipy: the voxel downsample's voxels and order, the nearest-neighbour
    index, ICP, the polygon crop and the F1."""
    import numpy as np
    from scipy.spatial import cKDTree

    from vcr_gaus_tpu_torch.evaluation import geometry as GE
    from vcr_gaus_tpu_torch.evaluation import tnt_official as TO

    rng = np.random.default_rng(0)
    d = rng.normal(size=(60_000, 3))
    gt = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    pred = (gt[:30_000] + rng.normal(scale=0.004, size=(30_000, 3))
            + [0.01, 0.0, -0.01]).astype(np.float32)
    for pts, voxel in ((gt, 0.01), (pred.astype(np.float64), 0.03)):
        np.testing.assert_allclose(GE.voxel_downsample(pts, voxel, cuda),
                                   GE.voxel_downsample(pts, voxel, "cpu"),
                                   rtol=1e-12, atol=0)
    dist, idx = GE.nearest_neighbours(pred, gt, device=cuda)
    want_d, want_i = cKDTree(gt).query(pred)
    np.testing.assert_allclose(dist, want_d, rtol=1e-12, atol=0)
    d2 = cKDTree(gt).query(pred, k=2)[0]
    unique = d2[:, 1] > d2[:, 0]
    np.testing.assert_array_equal(idx[unique], want_i[unique])
    np.testing.assert_allclose(
        GE.icp_refine(pred[::3], gt[::4], max_corr=0.05, device=cuda),
        GE.icp_refine(pred[::3], gt[::4], max_corr=0.05, device="cpu"),
        rtol=0, atol=1e-9)
    crop = {"orthogonal_axis": "Z", "axis_min": -0.5, "axis_max": 0.7,
            "bounding_polygon": [[-1, -1, 0], [0.8, -0.7, 0], [0.5, 0.9, 0],
                                 [-0.6, 0.4, 0]]}
    np.testing.assert_array_equal(TO.crop_polygon_volume(gt, crop, cuda),
                                  TO.crop_polygon_volume(gt, crop, "cpu"))
    faces = np.zeros((0, 3), np.int64)
    on_card = GE.tnt_f1(pred, faces, gt, 0.03, 0.01, run_icp=True,
                        device=cuda)
    on_cpu = GE.tnt_f1(pred, faces, gt, 0.03, 0.01, run_icp=True,
                       device="cpu")
    for k in ("Prec", "Recal", "F-score"):
        assert on_card[k] == on_cpu[k], k
    assert on_card["F-score"] > 0.9


def test_render_flythrough_launches_the_kernel_per_frame(cuda, tmp_path):
    import numpy as np

    from vcr_gaus_tpu_torch.data.cameras import Camera
    from vcr_gaus_tpu_torch.ops import rasterize as R
    from vcr_gaus_tpu_torch.render.renderer import RenderConfig
    from vcr_gaus_tpu_torch.utils.render_paths import render_flythrough

    state, _, _ = shell_state(cuda)
    cams = []
    for i in range(6):
        ang = 2 * np.pi * i / 6
        c = np.array([0.3 * np.cos(ang), 0.3 * np.sin(ang), 0.0])
        cams.append(Camera(colmap_id=i, idx=i, image_name=f"v{i}",
                           R=np.eye(3), T=-c, fovx=0.9, fovy=0.7, width=64,
                           height=48))
    R.reset_launch_counts()
    out = render_flythrough(state, cams, RenderConfig(width=64, height=48),
                            str(tmp_path / "fly.mp4"), n_frames=5)
    assert dict(R.LAUNCHES) == {"rasterize_fwd": 5}
    assert os.path.exists(out)


# --- across cards (skip with fewer than two) ---------------------------------

DP_ITERS = 6


def dp_overrides(scene, logdir, camera_batch):
    """The DTU recipe over DP_ITERS steps: densify after 3 and 6 (its box
    mask over 3 training views), the LightGaussian prune at 5, a save and a
    checkpoint at 6."""
    import json as _json
    ov = {"logdir": logdir, "model.source_path": scene,
          "optim.iterations": DP_ITERS, "optim.densify_from_iter": 1,
          "optim.densification_interval": 3, "optim.prune.iterations": [5],
          "optim.densify_large.sample_cams.num": 3,
          "train.test_iterations": [], "train.save_iterations": [DP_ITERS],
          "train.checkpoint_iterations": [DP_ITERS],
          "tpu.capacity": 1 << 16, "tpu.camera_batch": camera_batch}
    return [f"--{k}={_json.dumps(v) if isinstance(v, list) else v}"
            for k, v in ov.items()]


def dp_train(scene, logdir, camera_batch, device):
    """The Trainer over DP_ITERS steps on ``device``: (state arrays, the
    losses per step, the host log, the device the state lives on)."""
    from vcr_gaus_tpu_torch.config import Config
    from vcr_gaus_tpu_torch.models.convert import state_to_arrays
    from vcr_gaus_tpu_torch.train.trainer import Trainer

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config(os.path.join(repo, "configs", "dtu", "base.yaml"),
                 overrides=dp_overrides(scene, logdir, camera_batch))
    tr = Trainer(cfg, device=device)
    hist = tr.train(log_every=1)
    return (state_to_arrays(tr.state), hist, tr.host_log,
            str(tr.state.params.xyz.device))


def _dp_rank(rank, world, store, scene, out, device_type):
    """One rank of the camera-DP run: cuda:<rank> under NCCL (gloo on the
    CPU); its results pickled under ``out``."""
    import pickle

    from vcr_gaus_tpu_torch.parallel import dp

    dev = (torch.device("cuda", rank) if device_type == "cuda"
           else torch.device("cpu"))
    dp.init_process_group(rank, world, f"file://{store}", dev)
    try:
        res = dp_train(scene, os.path.join(out, f"log{rank}"), 2 * world,
                       dev)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


def run_camera_dp(tmp_path, world, device_type):
    """Every rank's (state, history, host log, device) after the camera-DP
    run at camera_batch 2 x world, and the scene it trained."""
    import pickle

    from chip_smoke import write_train_scene

    if device_type == "cuda":
        from vcr_gaus_tpu_torch.ops import cuda_build
        cuda_build.build_all()        # once, before the ranks start
    scene = write_train_scene(str(tmp_path), 20_000, 160, 120, 6)
    out = tmp_path / "ranks"
    out.mkdir()
    torch.multiprocessing.spawn(
        _dp_rank, args=(world, str(tmp_path / "store"), scene, str(out),
                        device_type), nprocs=world)
    ranks = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, scene


def test_camera_dp_across_cards(cuda, tmp_path):
    """Camera-DP over every card (NCCL, one rank a card, 2 views a rank a
    step): the ranks' states identical bit for bit after two densifies and
    a prune (rank 0's state broadcast after each), each rank's state on its
    own card, rank 0 alone writing, the first step's losses equal to one
    process's at the same camera batch."""
    import numpy as np

    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more CUDA cards")
    ranks, scene = run_camera_dp(tmp_path, world, "cuda")
    for r, (_, hist, log, dev) in enumerate(ranks):
        assert dev == f"cuda:{r}"
        assert len(hist) == DP_ITERS
        assert [(e["iter"], e["action"]) for e in log] == [
            (3, "densify"), (5, "prune"), (6, "densify")]
    state0 = ranks[0][0]
    for state, hist, _, _ in ranks[1:]:
        for a, b in zip(leaves(state), leaves(state0)):
            np.testing.assert_array_equal(a, b)
        assert hist == ranks[0][1]
    prune = ranks[0][2][1]
    assert prune["n_after"] < prune["n_before"]
    assert (tmp_path / "ranks" / "log0" / f"chkpnt{DP_ITERS}.npz").exists()
    assert not any((tmp_path / "ranks" / f"log{r}").exists()
                   for r in range(1, world))
    _, single, _, _ = dp_train(scene, str(tmp_path / "single"), 2 * world,
                               torch.device("cuda", 0))
    for k, v in single[0].items():
        if k not in ("iter", "n_active"):
            assert ranks[0][1][0][k] == pytest.approx(v, rel=1e-5), k


def test_scene_dispatch_across_cards(cuda, tmp_path):
    """One small scene a card, trained in threads: each closure gets its
    own card and its state lives there."""
    from chip_smoke import write_train_scene
    from vcr_gaus_tpu_torch.parallel import dp

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    scenes = [write_train_scene(str(tmp_path / f"s{i}"), 5_000, 96, 72, 4,
                                seed=i) for i in range(n)]

    def make(i):
        def fn(dev):
            out = dp_train(scenes[i], str(tmp_path / f"log{i}"), 1, dev)
            return str(dev), out[3], [h["total"] for h in out[1]]
        return fn

    res = dp.scene_dispatch([make(i) for i in range(n)],
                            [torch.device("cuda", i) for i in range(n)],
                            parallel=True)
    assert sorted(d for d, _, _ in res) == [f"cuda:{i}" for i in range(n)]
    for handed, lives, losses in res:
        assert handed == lives
        assert len(losses) == DP_ITERS
        assert all(v == v and abs(v) < float("inf") for v in losses)
