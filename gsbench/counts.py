"""The work a training step needs, counted from the cell's shapes and the
benchmark's own plain projection and binning of the step's inputs, and the
chip's peaks.

Operations are float32 operations, each add, multiply, compare, min, abs,
divide and exp counting one. The per-pair counts of the compositing
kernels are chip_smoke.py's (a (pixel, entry) pair of a batch a tile
composited: the offsets, the power and its test; past the test the exp,
the opacity and the alpha test; a live pair its blend). Bytes count each
input read once and each output written once. Whatever implements the
step, these counts stay the same for the same inputs.
"""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))

# compositing forward (K1), per pair: every pair, past the power test, live
OPS_PAIR, OPS_POWER_PASS = 12, 3
OPS_LIVE, OPS_LIVE_SEM, OPS_LIVE_INTERSECT = 20, 2, 8
# compositing backward (K2), per live pair (every pair and the tests as in
# the forward)
OPS_BWD_LIVE, OPS_BWD_LIVE_SEM, OPS_BWD_LIVE_INTERSECT = 83, 5, 18
# per active Gaussian and step: projection (the view and clip transforms
# 36, the quaternion and rotation 40, the Jacobian and 2D covariance 60,
# conic, eigenvalue, radius and extents 30), SH at degree 3 (the basis 40,
# 16 x 3 multiply-adds 96, the direction 10), the normal (rotation 30, its
# sign and camera transform 20), packing 5: 367 forward, twice that for
# the backward
OPS_GAUSS_FWD = 367
OPS_GAUSS_BWD = 2 * OPS_GAUSS_FWD
# Adam, per parameter element: two moments (6), the bias corrections, the
# square root, the divide and the update (6)
OPS_ADAM = 12
# per pixel and step, forward: the post-processing (normalize 10, the
# depth moments 8, the normals from depth 40), L1 on 3 channels (9), SSIM
# on 3 channels as an 11-tap separable window (5 blurs x 2 passes x 22 +
# 30 for the map, each channel), the normal losses (60), the curvature
# (40), the edge-aware distortion and depth variance (40); the semantic
# head per channel and class (4) and its cross entropy per class (10);
# twice the forward for the backward
OPS_PIXEL_FWD = 10 + 8 + 40 + 9 + 3 * (5 * 2 * 22 + 30) + 60 + 40 + 40
OPS_SEM_CLS, OPS_CE_CLS = 4, 10


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def k1(c: dict, width: int, height: int, nfeat: int, ch_sem: int,
       mode: str) -> tuple[int, int]:
    """(operations, bytes) of compositing one view forward, from
    ``render.census``'s counts: the pairs' work; the entries' ids, each
    composited Gaussian's feature row, the tile ranges read once and the
    image written once."""
    ops = (OPS_PAIR * c["pairs"] + OPS_POWER_PASS * c["power_pass"]
           + (OPS_LIVE + OPS_LIVE_SEM * ch_sem
              + OPS_LIVE_INTERSECT * (mode == "intersection")) * c["live"])
    nbytes = (4 * c["entries"] + 4 * nfeat * c["rows"] + 8 * c["tiles"]
              + height * width * 4 * (9 + ch_sem))
    return ops, nbytes


def k2(c: dict, width: int, height: int, nfeat: int, ch_sem: int,
       mode: str) -> tuple[int, int]:
    """(operations, bytes) of compositing one view backward: the pairs'
    work; the ids, feature rows and tile ranges read once, the image and
    its gradient read once, the composited Gaussians' gradient rows (the
    features and the two |d mean2d| columns) written once."""
    ops = (OPS_PAIR * c["pairs"] + OPS_POWER_PASS * c["power_pass"]
           + (OPS_BWD_LIVE + OPS_BWD_LIVE_SEM * ch_sem
              + OPS_BWD_LIVE_INTERSECT * (mode == "intersection"))
           * c["live"])
    nbytes = (4 * c["entries"] + 4 * nfeat * c["rows"] + 8 * c["tiles"]
              + 2 * height * width * 4 * (9 + ch_sem)
              + 4 * c["rows"] * (nfeat + 2))
    return ops, nbytes


def appearance_ops(width: int, height: int) -> int:
    """Forward operations of the appearance network on a view: 2 x 9 x
    cin x cout a pixel of each 3x3 convolution at its resolution (the crop
    to a multiple of 32, downsampled 32x, then four 2x pixel-shuffle blocks
    and a 2x resize)."""
    h, w = height // 32 * 32, width // 32 * 32
    px = h * w
    convs = [(67, 256, 1 / 1024), (64, 128, 1 / 256), (32, 64, 1 / 64),
             (16, 32, 1 / 16), (8, 16, 1 / 4), (16, 16, 1.0), (16, 3, 1.0)]
    return int(sum(2 * 9 * ci * co * px * f for ci, co, f in convs))


def step_ops(c: dict, width: int, height: int, nfeat: int, ch_sem: int,
             mode: str, n_active: int, params_per_gaussian: int,
             num_cls: int, appearance: bool) -> int:
    """Operations one training step on one view needs: both compositing
    passes, the per-Gaussian work of the active Gaussians and their Adam,
    the per-pixel work of the losses, and the side networks."""
    px = width * height
    ops = (k1(c, width, height, nfeat, ch_sem, mode)[0]
           + k2(c, width, height, nfeat, ch_sem, mode)[0]
           + n_active * (OPS_GAUSS_FWD + OPS_GAUSS_BWD
                         + OPS_ADAM * params_per_gaussian)
           + 3 * px * (OPS_PIXEL_FWD
                       + (OPS_SEM_CLS * ch_sem + OPS_CE_CLS) * num_cls
                       * (ch_sem > 0)))
    if appearance:
        ops += 3 * appearance_ops(width, height)
    return int(ops)


def roofline_s(ops: int, nbytes: int, p: dict) -> float:
    """The least time the chip could take: the larger of the operations
    over the float32 peak and the bytes over the memory peak ``p``."""
    return max(ops / p["fp32_flops"], nbytes / p["hbm_bytes_per_s"])
