"""The recipes' losses in plain PyTorch: a frozen copy of the port's
arithmetic for the losses the two benchmark recipes weigh (L1, SSIM with
an 11x11 sigma-1.5 window, the scale and opacity terms, the normal losses,
the curvature, the edge-aware distortion and depth variance, the semantic
cross entropy). Images are (C, H, W). Imports nothing of the program."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Gates(NamedTuple):
    mono_normal: bool
    depth_normal: bool
    curv: bool
    consistent_normal: bool
    close_depth: bool


def gates(optim: dict, it: int) -> Gates:
    return Gates(it > optim["normal_from_iter"],
                 it > optim["dnormal_from_iter"],
                 it > optim["curv_from_iter"],
                 it > optim["consistent_normal_from_iter"],
                 it > optim["close_depth_from_iter"])


def l1_loss(pred, gt):
    return torch.abs(pred - gt).mean()


def entropy_loss(opacity, mask):
    e = (-opacity * torch.log(opacity + 1e-6)
         - (1 - opacity) * torch.log(1 - opacity + 1e-6))
    m = mask.to(e.dtype)
    return torch.sum(e * m) / torch.clamp_min(torch.sum(m), 1.0)


def monosdf_normal_loss(normal_pred, normal_gt):
    l1 = torch.abs(normal_pred - normal_gt).sum(-1).mean()
    cos = (1.0 - torch.sum(normal_pred * normal_gt, -1)).mean()
    return l1 + cos


def masked_monosdf_normal_loss(normal_pred, normal_gt, mask, weight):
    m = mask.to(normal_pred.dtype)
    denom = torch.clamp_min(m.sum(), 1.0)
    l1 = torch.sum(m * weight * torch.abs(normal_pred - normal_gt).sum(-1)
                   ) / denom
    cos = torch.sum(m * weight * (1.0 - torch.sum(normal_pred * normal_gt,
                                                  -1))) / denom
    return torch.where(mask.sum() > 0, l1 + cos, 0.0)


def cos_weight(render_normal, gt_normal, exp_t: float):
    cos = torch.sum(render_normal * gt_normal, -1)
    if exp_t > 0:
        cos = torch.exp((cos - 1.0) / exp_t)
    else:
        cos = torch.ones_like(cos)
    return cos.detach()


def normal2curv(normal, mask):
    def pad(x):
        x = x.permute(2, 0, 1)[None]
        return torch.nn.functional.pad(x, (1, 1, 1, 1), mode="replicate"
                                       )[0].permute(1, 2, 0)

    n = pad(normal)
    m = pad(mask.to(normal.dtype))
    n_c = n[1:-1, 1:-1] * m[1:-1, 1:-1]
    n_u = (n[:-2, 1:-1] - n_c) * m[:-2, 1:-1]
    n_l = (n[1:-1, :-2] - n_c) * m[1:-1, :-2]
    n_b = (n[2:, 1:-1] - n_c) * m[2:, 1:-1]
    n_r = (n[1:-1, 2:] - n_c) * m[1:-1, 2:]
    curv = (n_u + n_l + n_b + n_r) * mask
    return torch.abs(curv).sum(-1, keepdim=True)


def semantic_cross_entropy(logits, labels, num_cls: int):
    lp = torch.log_softmax(logits, dim=0)
    classes = torch.arange(num_cls, device=labels.device)
    onehot = (labels[None] == classes[:, None, None]).to(lp.dtype)
    return -(onehot * lp).sum(0).mean() / math.log(num_cls)


def edge_aware_distortion_map(gt_image, distortion_map):
    c = gt_image[:, 1:-1, 1:-1]
    g_l = torch.mean(torch.abs(c - gt_image[:, 1:-1, :-2]), 0)
    g_r = torch.mean(torch.abs(c - gt_image[:, 1:-1, 2:]), 0)
    g_t = torch.mean(torch.abs(c - gt_image[:, :-2, 1:-1]), 0)
    g_b = torch.mean(torch.abs(c - gt_image[:, 2:, 1:-1]), 0)
    max_grad = torch.maximum(torch.maximum(g_l, g_r), torch.maximum(g_t, g_b))
    w = torch.nn.functional.pad(torch.exp(-max_grad), (1, 1, 1, 1))
    return distortion_map * w


def _window(window_size: int, sigma: float) -> np.ndarray:
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(img1, img2, window_size: int = 11):
    """Mean SSIM, 11x11 gaussian window of sigma 1.5, zero same-padding,
    per channel: the separable window as two 1-D convolutions."""
    g = torch.tensor(_window(window_size, 1.5), dtype=img1.dtype,
                     device=img1.device)
    pad = window_size // 2
    c = img1.shape[0]
    wy = g.view(1, 1, -1, 1).expand(c, 1, -1, 1)
    wx = g.view(1, 1, 1, -1).expand(c, 1, 1, -1)

    def blur(x):
        x = torch.nn.functional.conv2d(x[None], wy, padding=(pad, 0), groups=c)
        return torch.nn.functional.conv2d(x, wx, padding=(0, pad),
                                          groups=c)[0]

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()


def crop_box(height: int, width: int):
    h = height // 32 * 32
    w = width // 32 * 32
    return height // 2 - h // 2, width // 2 - w // 2, h, w


def compute_losses(out: dict, gt, gt_normal_chw, labels, params: dict,
                   active, inside, weights: dict, g: Gates, exp_t: float,
                   num_cls: int, appearance=None, view_idx: int = 0):
    """(total, {name: value}) of the recipe's weighted losses."""
    losses = {}
    if appearance is not None:
        transformed, (top, left, h, w) = appearance(out["render"], view_idx)
        losses["l1"] = l1_loss(transformed, gt[:, top:top + h, left:left + w])
    else:
        losses["l1"] = l1_loss(out["render"], gt)
    losses["ssim"] = 1.0 - ssim(out["render"], gt)
    scaling = torch.exp(params["log_scale"])
    if weights.get("l1_scale", 0) > 0:
        m = (active & inside).to(scaling.dtype)
        losses["l1_scale"] = (torch.sum(torch.amin(scaling, -1) * m)
                              / torch.clamp_min(m.sum(), 1.0))
    if weights.get("entropy", 0) > 0:
        losses["entropy"] = entropy_loss(
            torch.sigmoid(params["logit_opacity"])[:, 0], active & inside)
    gt_normal = gt_normal_chw.permute(1, 2, 0)
    if weights.get("mono_normal", 0) > 0 and g.mono_normal:
        losses["mono_normal"] = monosdf_normal_loss(out["normal"], gt_normal)
    if weights.get("depth_normal", 0) > 0 and g.depth_normal:
        w_conf = cos_weight(out["normal"].detach(), gt_normal, exp_t)
        losses["depth_normal"] = masked_monosdf_normal_loss(
            out["est_normal"], gt_normal, out["mask"], w_conf)
        if weights.get("curv", 0) > 0 and g.curv:
            curv = normal2curv(out["est_normal"],
                               out["mask"][..., None].to(gt.dtype))
            losses["curv"] = torch.abs(curv).mean()
    if weights.get("consistent_normal", 0) > 0 and g.consistent_normal:
        losses["consistent_normal"] = monosdf_normal_loss(out["est_normal"],
                                                          out["normal"])
    if weights.get("distortion", 0) > 0 and g.close_depth:
        losses["distortion"] = edge_aware_distortion_map(
            gt, out["distortion"]).mean()
    if weights.get("depth_var", 0) > 0 and g.close_depth:
        losses["depth_var"] = edge_aware_distortion_map(
            gt, out["depth_var"]).mean()
    if weights.get("semantic", 0) > 0:
        losses["semantic"] = semantic_cross_entropy(out["render_sem"], labels,
                                                    num_cls)
    total = torch.zeros((), dtype=gt.dtype, device=gt.device)
    for name, w in weights.items():
        if name in losses:
            total = total + w * losses[name]
    return total, losses
