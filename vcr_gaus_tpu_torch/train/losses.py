"""The losses the render path needs (vcr_gaus_tpu/train/losses.py): SSIM
and the depth moments. The training losses wait for the training slice.
Images are (C, H, W) float32."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _band_matrix_np(n: int, window_size: int, sigma: float) -> np.ndarray:
    """(n, n) symmetric banded blur matrix equal to a same-(zero-)padded 1-D
    gaussian convolution along an axis of length n."""
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    pad = window_size // 2
    B = np.zeros((n, n), np.float32)
    for k in range(-pad, pad + 1):
        idx = np.arange(max(0, -k), min(n, n - k))
        B[idx, idx + k] = g[k + pad]
    return B


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM with an 11x11 sigma-1.5 gaussian window and same-padding,
    per channel. The separable window is applied as two float32 matrix
    products against banded matrices, as in the JAX package; float32
    matrix products stay full precision on the card (no TF32) by default."""
    h, w = img1.shape[-2:]
    By = torch.as_tensor(_band_matrix_np(h, window_size, 1.5)).to(img1.device)
    Bx = torch.as_tensor(_band_matrix_np(w, window_size, 1.5)).to(img1.device)

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
