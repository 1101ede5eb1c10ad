"""Binning's kernels (``csrc/binning.cu`` through ``ops/binning.py``)
against the plain chain ``bin_gaussians_torch``.

On the card (``cuda`` marker; they skip without one) the kernels' Binning
equals the plain chain's, run on the same card tensors, in every field and
dtype: the per-tile gid order, the tile ranges, the entry and binned
counts. On the CPU: a CPU tensor takes the plain chain and counts no
kernel binning, the wrapper's input checks, and the kernels' 32-bit key
against the plain chain's int64 key. The file imports no JAX, so the card's
cases run where only the port is installed:

    python -m pytest --noconftest tests/test_torch_binning_kernel.py -q
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vcr_gaus_tpu_torch.ops import binning as B
from vcr_gaus_tpu_torch.ops import cuda_build
from vcr_gaus_tpu_torch.ops import rasterize as R
from vcr_gaus_tpu_torch.utils import tracing


def scene(n, width, height, seed=0, ext=False, margin=48.0, max_r=40,
          culled=0.2):
    """Binning's inputs, as numpy: mean2d (n, 2) float32 over the image and
    ``margin`` pixels beyond each edge, radius (n,) int32 with a share
    ``culled`` of zeros, depth_z (n,) float32 in [0.2, 50), and, with
    ``ext``, extents (n, 2) float32 up to the radius, a few of them 0."""
    rng = np.random.default_rng(seed)
    mean2d = np.stack([rng.uniform(-margin, width + margin, n),
                       rng.uniform(-margin, height + margin, n)],
                      1).astype(np.float32)
    radius = rng.integers(1, max_r + 1, n).astype(np.int32)
    radius[rng.uniform(size=n) < culled] = 0
    depth = rng.uniform(0.2, 50.0, n).astype(np.float32)
    extents = None
    if ext:
        extents = (radius[:, None] * rng.uniform(0.0, 1.0, (n, 2))).astype(
            np.float32)
        extents[rng.uniform(size=(n, 2)) < 0.05] = 0.0
    return mean2d, radius, depth, extents


def tensors(device, mean2d, radius, depth, extents):
    return (torch.tensor(mean2d, device=device),
            torch.tensor(radius, device=device),
            torch.tensor(depth, device=device),
            None if extents is None else torch.tensor(extents, device=device))


def assert_same(got: B.Binning, want: B.Binning) -> None:
    for name in ("sorted_gid", "tile_starts", "tile_counts"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == torch.int32, name
        assert a.shape == b.shape, name
        assert torch.equal(a.cpu(), b.cpu()), name
    assert got.num_entries == want.num_entries
    assert got.num_binned == want.num_binned
    assert got.overflow is want.overflow is False


# --- CPU --------------------------------------------------------------------

@pytest.mark.parametrize("ext", [False, True])
def test_cpu_tensors_take_the_plain_chain(monkeypatch, ext):
    def refused(*args):
        raise AssertionError("a CPU tensor reached the kernels")

    monkeypatch.setattr(B, "_bin_kernels", refused)
    m, r, d, e = tensors("cpu", *scene(500, 72, 40, seed=3, ext=ext))
    cuda_build.LAUNCHES.clear()
    got = B.bin_gaussians(m, r, d, 72, 40, extents=e)
    assert cuda_build.LAUNCHES["binning"] == 0
    assert got.num_entries > 0
    assert_same(got, B.bin_gaussians_torch(m, r, d, 72, 40, extents=e))


@pytest.mark.parametrize("path", ["image", "entry_stats"])
def test_cpu_views_count_no_kernel_binning(path):
    """Both callers count ``render.binning.kernel`` 0 a view on the CPU."""
    m, r, d, e = tensors("cpu", *scene(200, 40, 24, seed=4, ext=True))
    feats = torch.zeros((200, 14))
    feats[:, :2] = m
    feats[:, 6] = d
    cam = torch.tensor([50.0, 50.0, 20.0, 12.0, 0.0, 0.0, 0.0, 0.0])
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.step(1, "cpu"):
            if path == "image":
                R.rasterize_image(feats, torch.zeros((200, 2)), m, r, d, cam,
                                  40, 24, 0, "traditional", extents=e)
            else:
                R.rasterize_entry_stats(feats, m, r, d, 40, 24, extents=e)
    (record,) = tracing.steps(1)
    assert record["render.binning.kernel"] == [0]


def key32(tile_id: torch.Tensor, depth_z: torch.Tensor,
          db: int) -> torch.Tensor:
    """The kernels' sort key, ``(tile << db) | (depth bits >> (32 - db))``
    in uint32 arithmetic (``csrc/binning.cu``'s expansion), as int32 tensors
    hold it (the same 32 bits)."""
    bits = depth_z.to(torch.float32).contiguous().view(torch.int32)
    # a logical shift of the pattern: int32's >> copies the sign bit
    dq = (bits >> (32 - db)) & ((1 << db) - 1)
    return (tile_id.to(torch.int32) << db) | dq


@pytest.mark.parametrize("grid", [(40, 24), (512, 512), (1600, 1200),
                                  (4096, 2160)])
def test_key32_is_the_plain_key(grid):
    """The kernels' uint32 key, as int32 tensors hold it, read unsigned, is
    the plain chain's int64 key, also where its top bit is set: a tile past
    half of the key's tile range, or a depth pattern with the sign bit."""
    n_tx, n_ty = B.tile_grid(*grid)
    num_tiles = n_tx * n_ty
    db = B.depth_key_bits(num_tiles)
    rng = np.random.default_rng(num_tiles)
    tile = torch.tensor(np.concatenate([
        [0, num_tiles - 1], rng.integers(0, num_tiles, 4000)]))
    depth = torch.tensor(np.concatenate([
        [0.2, 50.0, -0.5, -1e30, 0.0, -0.0, np.inf],
        rng.uniform(-100.0, 100.0, 3995)]).astype(np.float32))
    bits = depth.view(torch.int32)
    plain = (tile << db) | ((bits.to(torch.int64) & 0xFFFFFFFF) >> (32 - db))
    got = key32(tile, depth, db)
    assert got.dtype == torch.int32
    assert torch.equal(got.to(torch.int64) & 0xFFFFFFFF, plain)
    if num_tiles > 1 << (31 - db):
        assert bool((plain >= 1 << 31).any())


@pytest.mark.parametrize("bad", ["mean2d_f64", "mean2d_3col", "radius_i64",
                                 "radius_f32", "radius_shape", "depth_shape",
                                 "ext_f64", "ext_shape"])
def test_kernel_inputs_are_checked(bad):
    m, r, d, e = tensors("cpu", *scene(50, 40, 24, ext=True))
    B._check_kernel_inputs(m, r, d, e)
    B._check_kernel_inputs(m, r, d.double(), None)
    args = {"mean2d_f64": (m.double(), r, d, e),
            "mean2d_3col": (torch.cat([m, d[:, None]], 1), r, d, e),
            "radius_i64": (m, r.long(), d, e),
            "radius_f32": (m, r.float(), d, e),
            "radius_shape": (m, r[:-1], d, e),
            "depth_shape": (m, r, d[:, None], e),
            "ext_f64": (m, r, d, e.double()),
            "ext_shape": (m, r, d, e[:, :1])}[bad]
    with pytest.raises(ValueError):
        B._check_kernel_inputs(*args)


# --- the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the binning kernels have no CPU mode")
    return torch.device("cuda")


def check_card(device, width, height, mean2d, radius, depth, extents=None,
               strided=False):
    """Bin on the card with the kernels and with the plain chain; assert
    every field equal and one launch; return the kernels' Binning."""
    m, r, d, e = tensors(device, mean2d, radius, depth, extents)
    if strided:
        # mean2d as a column slice of packed rows (the wrapper copies it)
        rows = torch.zeros((m.shape[0], 14), device=device)
        rows[:, :2] = m
        m = rows[:, :2]
    cuda_build.LAUNCHES.clear()
    got = B.bin_gaussians(m, r, d, width, height, extents=e)
    assert cuda_build.LAUNCHES["binning"] == 1
    want = B.bin_gaussians_torch(m, r, d, width, height, extents=e)
    torch.cuda.synchronize()
    assert_same(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_card_random_scenes(cuda, seed, ext):
    got = check_card(cuda, 200, 136, *scene(6000, 200, 136, seed=seed,
                                             ext=ext), strided=seed == 2)
    assert got.num_entries > 6000


@pytest.mark.cuda
def test_card_shared_depth_is_stable(cuda):
    """Many Gaussians on one quantized depth (and many on one exact depth)
    keep their expansion order within each tile."""
    m, r, d, _ = scene(5000, 64, 48, seed=6, culled=0.05)
    d[:] = np.float32(3.0)
    d[::3] = np.nextafter(np.float32(3.0), np.float32(4.0))
    got = check_card(cuda, 64, 48, m, r, d)
    assert int(got.tile_counts.min()) > 500


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True])
def test_card_rectangles_clamped_at_every_edge(cuda, ext):
    """Means on, inside and outside each edge and corner, some radii wider
    than the image: every rectangle clamped on some side."""
    w, h = 45, 29
    xs = np.array([-70, -16, -0.5, 0, 0.5, 15.99, 16, 22.5, 44, 44.99, 45,
                   45.5, 61, 120], np.float32)
    ys = np.array([-70, -16, -0.5, 0, 0.5, 15.99, 16, 28, 28.99, 29, 29.5,
                   45, 100], np.float32)
    mx, my = np.meshgrid(xs, ys)
    mean2d = np.stack([mx.ravel(), my.ravel()], 1)
    mean2d = np.concatenate([mean2d] * 4).astype(np.float32)
    n = mean2d.shape[0]
    radius = np.repeat(np.array([1, 7, 30, 200], np.int32), n // 4)
    depth = np.random.default_rng(7).uniform(0.2, 9.0, n).astype(np.float32)
    extents = None
    if ext:
        extents = np.stack([radius * 0.5, radius * 1.5], 1).astype(np.float32)
    got = check_card(cuda, w, h, mean2d, radius, depth, extents)
    assert got.num_binned < n


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 700])
def test_card_every_gaussian_culled(cuda, n):
    m, r, d, _ = scene(n, 40, 24, seed=8)
    got = check_card(cuda, 40, 24, m, r * 0, d)
    assert got.num_entries == got.num_binned == 0
    assert int(got.tile_counts.sum()) == 0 and got.tile_starts.shape == (6,)


@pytest.mark.cuda
def test_card_full_width_keys_pass_the_sign_bit(cuda):
    """1600 x 1200: 7,500 tiles and 19 depth bits, so every tile from 4,096
    on has the key's top bit set."""
    got = check_card(cuda, 1600, 1200, *scene(200_000, 1600, 1200, seed=9,
                                               max_r=60, ext=True))
    n_tx, n_ty = B.tile_grid(1600, 1200)
    assert B.depth_key_bits(n_tx * n_ty) == 19
    assert int(got.tile_counts[4096:].sum()) > 0


@pytest.mark.cuda
def test_card_box_view_with_a_crowded_tile(cuda):
    """A TNT box view of 512 x 512 with 40,000 Gaussians inside one tile
    beside a sparse scene."""
    m, r, d, e = scene(20_000, 512, 512, seed=10, ext=True)
    rng = np.random.default_rng(11)
    crowd = np.stack([rng.uniform(130.5, 141.5, 40_000),
                      rng.uniform(258.5, 269.5, 40_000)], 1)
    m = np.concatenate([m, crowd]).astype(np.float32)
    r = np.concatenate([r, np.full(40_000, 3, np.int32)])
    d = np.concatenate([d, rng.uniform(0.2, 2.0, 40_000)]).astype(np.float32)
    e = np.concatenate([e, np.full((40_000, 2), 2.0, np.float32)])
    got = check_card(cuda, 512, 512, m, r, d, e)
    assert int(got.tile_counts.max()) >= 40_000


@pytest.mark.cuda
def test_card_one_readback_a_call(cuda):
    """One device-to-host copy a call (the entry count), read from a
    profiler trace of a binned view."""
    m, r, d, e = tensors(cuda, *scene(20_000, 400, 300, seed=12, ext=True))
    B.bin_gaussians(m, r, d, 400, 300, extents=e)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        B.bin_gaussians(m, r, d, 400, 300, extents=e)
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()]
    dtoh = [n for n in names if "Memcpy DtoH" in n]
    assert len(dtoh) == 1, names


@pytest.mark.cuda
def test_card_views_count_kernel_binning(cuda):
    m, r, d, e = tensors(cuda, *scene(500, 40, 24, seed=13, ext=True))
    feats = torch.zeros((500, 14), device=cuda)
    feats[:, :2] = m
    feats[:, 6] = d
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.step(1, cuda):
            R.rasterize_entry_stats(feats, m, r, d, 40, 24, extents=e)
    (record,) = tracing.steps(1)
    assert record["render.binning.kernel"] == [1]
