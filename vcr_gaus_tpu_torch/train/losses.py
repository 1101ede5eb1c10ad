"""Losses (vcr_gaus_tpu/train/losses.py): those of every recipe in
``configs/`` (L1, SSIM, the normal losses, the opacity entropy, the
scale-and-shift-invariant depth loss, the normal curvature, the edge-aware
distortion, the semantic cross entropy) and the depth moments. Images are
(C, H, W) float32. On CUDA tensors the SSIM and its gradient are the
hand-written kernels ``csrc/ssim.cu``; CPU tensors take the plain version,
the JAX package's banded matrix products."""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..ops import cuda_build


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - gt).mean()


def entropy_loss(opacity, mask=None):
    """Binary entropy of the opacities, averaged over the Gaussians ``mask``
    selects (over all without one)."""
    e = (-opacity * torch.log(opacity + 1e-6)
         - (1 - opacity) * torch.log(1 - opacity + 1e-6))
    if mask is None:
        return e.mean()
    m = mask.to(e.dtype)
    return torch.sum(e * m) / torch.clamp_min(torch.sum(m), 1.0)


def monosdf_normal_loss(normal_pred, normal_gt, weight=None):
    """L1 + cosine normal consistency over (..., 3) normals, with an
    optional per-point weight (...)."""
    if weight is None:
        weight = 1.0
    l1 = (weight * torch.abs(normal_pred - normal_gt).sum(-1)).mean()
    cos = (weight * (1.0 - torch.sum(normal_pred * normal_gt, -1))).mean()
    return l1 + cos


def masked_monosdf_normal_loss(normal_pred, normal_gt, mask, weight=None):
    """monosdf loss averaged over the pixels ``mask`` selects; 0 when the
    mask is empty."""
    if weight is None:
        weight = torch.ones(normal_pred.shape[:-1], dtype=normal_pred.dtype,
                            device=normal_pred.device)
    m = mask.to(normal_pred.dtype)
    denom = torch.clamp_min(m.sum(), 1.0)
    l1 = torch.sum(m * weight * torch.abs(normal_pred - normal_gt).sum(-1)
                   ) / denom
    cos = torch.sum(m * weight * (1.0 - torch.sum(normal_pred * normal_gt,
                                                  -1))) / denom
    return torch.where(mask.sum() > 0, l1 + cos, 0.0)


def cos_weight(render_normal, gt_normal, exp_t: float = 1.0):
    """Confidence weight exp((cos - 1) / exp_t), detached."""
    cos = torch.sum(render_normal * gt_normal, -1)
    if exp_t > 0:
        cos = torch.exp((cos - 1.0) / exp_t)
    else:
        cos = torch.ones_like(cos)
    return cos.detach()


def normal2curv(normal, mask):
    """4-neighbour normal curvature magnitude: normal (H,W,3), mask (H,W,1)
    float -> (H,W,1). The borders repeat the edge (``jnp.pad`` mode
    "edge", replicate padding on (1, C, H, W))."""
    def pad(x):
        x = x.permute(2, 0, 1)[None]
        return torch.nn.functional.pad(x, (1, 1, 1, 1), mode="replicate"
                                       )[0].permute(1, 2, 0)

    n = pad(normal)
    m = pad(mask.to(torch.float32))
    n_c = n[1:-1, 1:-1] * m[1:-1, 1:-1]
    n_u = (n[:-2, 1:-1] - n_c) * m[:-2, 1:-1]
    n_l = (n[1:-1, :-2] - n_c) * m[1:-1, :-2]
    n_b = (n[2:, 1:-1] - n_c) * m[2:, 1:-1]
    n_r = (n[1:-1, 2:] - n_c) * m[1:-1, 2:]
    curv = (n_u + n_l + n_b + n_r) * mask
    return torch.abs(curv).sum(-1, keepdim=True)


def _safe_div(num, den):
    """num / den, and 0 where den == 0 with a zero gradient there (the JAX
    package's where(den == 0, 0, num / den) has a NaN gradient there)."""
    empty = den == 0
    return torch.where(empty, 0.0, num / torch.where(empty, 1.0, den))


def _compute_scale_and_shift(prediction, target, mask):
    """Closed-form least-squares scale and shift per image; (B, H, W)."""
    a_00 = torch.sum(mask * prediction * prediction, (1, 2))
    a_01 = torch.sum(mask * prediction, (1, 2))
    a_11 = torch.sum(mask, (1, 2))
    b_0 = torch.sum(mask * prediction * target, (1, 2))
    b_1 = torch.sum(mask * target, (1, 2))
    det = a_00 * a_11 - a_01 * a_01
    return (_safe_div(a_11 * b_0 - a_01 * b_1, det),
            _safe_div(-a_01 * b_0 + a_00 * b_1, det))


def _ssi_mse(prediction, target, mask):
    M = torch.sum(mask, (1, 2))
    res = prediction - target
    image_loss = torch.sum(mask * res * res, (1, 2))
    return _safe_div(torch.sum(image_loss), torch.sum(2 * M))


def _ssi_gradient(prediction, target, mask):
    M = torch.sum(mask, (1, 2))
    diff = (prediction - target) * mask
    grad_x = torch.abs(diff[:, :, 1:] - diff[:, :, :-1]) * (
        mask[:, :, 1:] * mask[:, :, :-1])
    grad_y = torch.abs(diff[:, 1:, :] - diff[:, :-1, :]) * (
        mask[:, 1:, :] * mask[:, :-1, :])
    image_loss = torch.sum(grad_x, (1, 2)) + torch.sum(grad_y, (1, 2))
    return _safe_div(torch.sum(image_loss), torch.sum(M))


def scale_and_shift_invariant_depth_loss(prediction, target, mask=None,
                                         alpha: float = 0.5, scales: int = 1):
    """MiDaS scale-and-shift-invariant loss: the target is remapped to
    target * 50 + 0.5, the prediction aligned to it per image by least
    squares, then the masked MSE plus alpha times the multi-scale gradient
    matching. Inputs (H, W) or (B, H, W). On an empty mask the value is 0,
    as in the JAX package, and so is the gradient (NaN there)."""
    if prediction.ndim == 2:
        prediction = prediction[None]
        target = target[None]
        if mask is not None and mask.ndim == 2:
            mask = mask[None]
    target = target * 50.0 + 0.5
    if mask is None:
        mask = torch.ones_like(target)
    mask = mask.to(prediction.dtype)
    scale, shift = _compute_scale_and_shift(prediction, target, mask)
    pred_ssi = scale[:, None, None] * prediction + shift[:, None, None]
    total = _ssi_mse(pred_ssi, target, mask)
    if alpha > 0:
        for s in range(scales):
            step = 2 ** s
            total = total + alpha * _ssi_gradient(
                pred_ssi[:, ::step, ::step], target[:, ::step, ::step],
                mask[:, ::step, ::step])
    return total


def semantic_cross_entropy(logits, labels, num_cls: int):
    """Pixel cross entropy normalized by log(num_cls): logits (num_cls, H,
    W), labels (H, W) int. A label outside [0, num_cls) has a zero one-hot
    row, as ``jax.nn.one_hot`` gives: it adds 0 and counts in the mean."""
    lp = torch.log_softmax(logits, dim=0)
    classes = torch.arange(num_cls, device=labels.device)
    onehot = (labels[None] == classes[:, None, None]).to(lp.dtype)
    ce = -(onehot * lp).sum(0).mean()
    return ce / math.log(num_cls)


def edge_aware_distortion_map(gt_image, distortion_map):
    """Down-weight the (H,W) distortion map at the edges of the (3,H,W)
    image by exp(-max |grad I|), with a zero border."""
    c = gt_image[:, 1:-1, 1:-1]
    g_l = torch.mean(torch.abs(c - gt_image[:, 1:-1, :-2]), 0)
    g_r = torch.mean(torch.abs(c - gt_image[:, 1:-1, 2:]), 0)
    g_t = torch.mean(torch.abs(c - gt_image[:, :-2, 1:-1]), 0)
    g_b = torch.mean(torch.abs(c - gt_image[:, 2:, 1:-1]), 0)
    max_grad = torch.maximum(torch.maximum(g_l, g_r), torch.maximum(g_t, g_b))
    w = torch.nn.functional.pad(torch.exp(-max_grad), (1, 1, 1, 1))
    return distortion_map * w


SSIM_WINDOW = 11
SSIM_SIGMA = 1.5


def ssim_window() -> np.ndarray:
    """The normalised 1-D gaussian window, float32 (the band matrices'
    taps, the kernels' too)."""
    x = np.arange(SSIM_WINDOW) - SSIM_WINDOW // 2
    g = np.exp(-(x ** 2) / (2 * SSIM_SIGMA ** 2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _band_matrix(n: int, device: torch.device) -> torch.Tensor:
    """(n, n) symmetric banded blur matrix equal to a same-(zero-)padded 1-D
    gaussian convolution along an axis of length n, kept on ``device`` so
    that a training step uploads nothing."""
    g = ssim_window()
    pad = SSIM_WINDOW // 2
    B = np.zeros((n, n), np.float32)
    for k in range(-pad, pad + 1):
        idx = np.arange(max(0, -k), min(n, n - k))
        B[idx, idx + k] = g[k + pad]
    return torch.from_numpy(B).to(device)


def ssim_torch(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """``ssim``'s plain version: the separable window applied as two
    float32 matrix products against banded matrices, as in the JAX
    package; float32 matrix products stay full precision on the card (no
    TF32) by default."""
    h, w = img1.shape[-2:]
    By = _band_matrix(h, img1.device)
    Bx = _band_matrix(w, img1.device)

    def blur(x):
        return By.T @ x @ Bx

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()


def _check_ssim(img1: torch.Tensor, img2: torch.Tensor) -> None:
    """What the SSIM kernels take: two contiguous float32 (C, H, W) images
    of one shape on one CUDA device, no gradient for ``img2``."""
    for name, x in (("img1", img1), ("img2", img2)):
        if x.device != img1.device or x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}, img1 on "
                             f"{img1.device}: both must be on one CUDA "
                             "device")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous float32 tensor, "
                             f"got {x.dtype} (contiguous="
                             f"{x.is_contiguous()})")
    if img1.ndim != 3 or img1.shape != img2.shape or not img1.numel():
        raise ValueError(f"expected two non-empty (C, H, W) images of one "
                         f"shape, got {tuple(img1.shape)} and "
                         f"{tuple(img2.shape)}")
    if img2.requires_grad:
        raise ValueError("the SSIM kernels give no gradient for img2 (the "
                         "ground truth)")


def ssim_forward(img1: torch.Tensor, img2: torch.Tensor,
                 maps: bool) -> tuple:
    """The forward kernel: (the mean SSIM, a 0-dim tensor, and the
    backward's three (C, H, W) maps, or None without ``maps``)."""
    c, h, w = img1.shape
    dev = img1.device
    lib = _ssim_lib()
    partial = torch.empty(lib.vcr_ssim_blocks(c, h, w), dtype=torch.float32,
                          device=dev)
    value = torch.empty((), dtype=torch.float32, device=dev)
    out = [torch.empty_like(img1) for _ in range(3)] if maps else None
    with torch.cuda.device(dev):
        err = lib.vcr_ssim_fwd(
            img1.data_ptr(), img2.data_ptr(), c, h, w, _ssim_taps(),
            partial.data_ptr(), value.data_ptr(),
            *([m.data_ptr() for m in out] if maps else [0] * 3),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssim_fwd launch failed: cudaError {err}")
    cuda_build.LAUNCHES["ssim_fwd"] += 1
    return value, out


def ssim_backward(g: torch.Tensor, img1: torch.Tensor, img2: torch.Tensor,
                  dm: torch.Tensor, ds1: torch.Tensor,
                  ds12: torch.Tensor) -> torch.Tensor:
    """The backward kernel: dL/dimg1 from the upstream gradient ``g`` (one
    float32 on the images' device, read there) and the forward's maps."""
    c, h, w = img1.shape
    if g.numel() != 1 or g.dtype != torch.float32 or g.device != img1.device:
        raise ValueError(f"g must be one float32 on {img1.device}")
    g = g.contiguous()
    grad = torch.empty_like(img1)
    dev = img1.device
    with torch.cuda.device(dev):
        err = _ssim_lib().vcr_ssim_bwd(
            g.data_ptr(), dm.data_ptr(), ds1.data_ptr(), ds12.data_ptr(),
            img1.data_ptr(), img2.data_ptr(), c, h, w, _ssim_taps(),
            grad.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssim_bwd launch failed: cudaError {err}")
    cuda_build.LAUNCHES["ssim_bwd"] += 1
    return grad


@functools.cache
def _ssim_taps():
    return (ctypes.c_float * SSIM_WINDOW)(*ssim_window().tolist())


@functools.cache
def _ssim_lib() -> ctypes.CDLL:
    lib = cuda_build.load("ssim")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vcr_ssim_blocks.argtypes = [i] * 3
    lib.vcr_ssim_blocks.restype = ctypes.c_longlong
    lib.vcr_ssim_fwd.argtypes = [p, p, i, i, i] + [p] * 6 + [p]
    lib.vcr_ssim_fwd.restype = ctypes.c_int
    lib.vcr_ssim_bwd.argtypes = [p] * 6 + [i] * 3 + [p, p, p]
    lib.vcr_ssim_bwd.restype = ctypes.c_int
    return lib


class _SSIM(torch.autograd.Function):
    """Forward = the forward kernel, which also writes the backward's three
    maps where ``maps``; backward = the backward kernel over them."""

    @staticmethod
    def forward(ctx, img1, img2, maps):
        value, out = ssim_forward(img1, img2, maps)
        if maps:
            ctx.save_for_backward(img1, img2, *out)
        return value

    @staticmethod
    def backward(ctx, g):
        return ssim_backward(g, *ctx.saved_tensors), None, None


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM with an 11x11 sigma-1.5 gaussian window and same-(zero-)
    padding, per channel, of two (C, H, W) float32 images, differentiable
    in ``img1``. On CUDA tensors the hand-written kernels
    ``csrc/ssim.cu`` (``vcr_ssim_fwd``, ``vcr_ssim_bwd``) compute it, or
    it raises (``_check_ssim``); only CPU tensors take the plain version
    ``ssim_torch``."""
    if img1.device.type == "cpu" and img2.device.type == "cpu":
        return ssim_torch(img1, img2)
    _check_ssim(img1, img2)
    return _SSIM.apply(img1, img2,
                       img1.requires_grad and torch.is_grad_enabled())


def distortion_from_moments(w_sum, wd_sum, wd2_sum):
    """Pairwise depth distortion per pixel, each unordered pair once:
    sum_{i<j} w_i w_j (d_i - d_j)^2 = S0 S2 - S1^2."""
    return w_sum * wd2_sum - wd_sum * wd_sum


def depth_var_from_moments(w_sum, wd_sum, wd2_sum, eps: float = 1e-8):
    """Alpha-normalized depth variance E[d^2] - E[d]^2."""
    mean = wd_sum / (w_sum + eps)
    mean2 = wd2_sum / (w_sum + eps)
    return torch.clamp_min(mean2 - mean * mean, 0.0)
