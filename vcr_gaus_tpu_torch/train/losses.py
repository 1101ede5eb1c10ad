"""Losses (vcr_gaus_tpu/train/losses.py): those of the DTU and reconstruct
recipes, SSIM and the depth moments. Entropy, the scale-and-shift-invariant
depth loss, normal2curv and the semantic cross entropy come with the
recipes that use them. Images are (C, H, W) float32."""

from __future__ import annotations

import functools

import numpy as np
import torch


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - gt).mean()


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


@functools.lru_cache(maxsize=8)
def _band_matrix(n: int, window_size: int, sigma: float,
                 device: torch.device) -> torch.Tensor:
    """(n, n) symmetric banded blur matrix equal to a same-(zero-)padded 1-D
    gaussian convolution along an axis of length n, kept on ``device`` so
    that a training step uploads nothing."""
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    pad = window_size // 2
    B = np.zeros((n, n), np.float32)
    for k in range(-pad, pad + 1):
        idx = np.arange(max(0, -k), min(n, n - k))
        B[idx, idx + k] = g[k + pad]
    return torch.from_numpy(B).to(device)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM with an 11x11 sigma-1.5 gaussian window and same-padding,
    per channel. The separable window is applied as two float32 matrix
    products against banded matrices, as in the JAX package; float32
    matrix products stay full precision on the card (no TF32) by default."""
    h, w = img1.shape[-2:]
    By = _band_matrix(h, window_size, 1.5, img1.device)
    Bx = _band_matrix(w, window_size, 1.5, img1.device)

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


def distortion_from_moments(w_sum, wd_sum, wd2_sum):
    """Pairwise depth distortion per pixel, each unordered pair once:
    sum_{i<j} w_i w_j (d_i - d_j)^2 = S0 S2 - S1^2."""
    return w_sum * wd2_sum - wd_sum * wd_sum


def depth_var_from_moments(w_sum, wd_sum, wd2_sum, eps: float = 1e-8):
    """Alpha-normalized depth variance E[d^2] - E[d]^2."""
    mean = wd_sum / (w_sum + eps)
    mean2 = wd2_sum / (w_sum + eps)
    return torch.clamp_min(mean2 - mean * mean, 0.0)
