"""Training visualization panels (vcr_gaus_tpu/train/visualization.py),
numpy only: the reference's render / depth / normal / D-normal / cos-weight /
semantic panels, as {suffix: (H, W, 3) u8} images (``panel_images``) and as
one PNG strip per view under ``logdir/vis`` (``save_panels``, which
``Trainer.run_test`` calls). ``panel_images`` is the metric writers' image
input. The inputs are numpy arrays (the trainer moves its render outputs to
the host)."""

from __future__ import annotations

import os

import numpy as np


def _to_u8(img):
    return (np.clip(np.asarray(img, np.float32), 0, 1) * 255).astype(np.uint8)


def colorize_depth(depth, mask=None):
    """Normalized turbo-ish depth map (H,W) -> (H,W,3) u8."""
    d = np.asarray(depth, np.float32)
    m = np.asarray(mask) if mask is not None else d > 0
    if m.any():
        lo, hi = np.percentile(d[m], 2), np.percentile(d[m], 98)
    else:
        lo, hi = 0.0, 1.0
    t = np.clip((d - lo) / max(hi - lo, 1e-9), 0, 1)
    r = np.clip(1.5 - np.abs(2.0 * t - 1.5), 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * t - 1.0), 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * t - 0.5), 0, 1)
    rgb = np.stack([r, g, b], -1)
    rgb[~m] = 0
    return (rgb * 255).astype(np.uint8)


def colorize_normal(normal_hw3):
    """Camera-space normal (H,W,3) in [-1,1] -> u8."""
    return _to_u8((np.asarray(normal_hw3) + 1.0) / 2.0)


def semantic_palette(labels, num_cls: int):
    """(H,W) int labels -> color image (tools/visualization.py palette)."""
    rng = np.random.default_rng(0)
    palette = rng.integers(40, 255, (max(num_cls, 2), 3)).astype(np.uint8)
    palette[0] = np.array([20, 20, 20], np.uint8)   # background
    return palette[np.clip(np.asarray(labels), 0, num_cls - 1)]


def panel_images(render_out: dict, gt_image=None, gt_normal=None,
                 exp_t: float = 0.01, num_cls: int = 0,
                 gt_mask=None, trans_image=None) -> dict:
    """Build the reference's wandb image-panel dict (log_wandb_images,
    trainer.py:452-494) as {suffix: (H,W,3) u8}: render|gt strip, depth,
    inv_depth, normal, normal_gt, normal_cos, est_normal, sem, trans.
    Suffixes match the reference tags modulo the `vis/{mode}` prefix the
    caller adds."""
    out = {}
    render = _to_u8(np.asarray(render_out["render"]).transpose(1, 2, 0))
    if gt_image is not None:
        gt = _to_u8(np.asarray(gt_image).transpose(1, 2, 0))
        out[""] = np.concatenate([render, gt], axis=0)
    else:
        out[""] = render
    depth = np.asarray(render_out["depth"], np.float32)
    alpha = np.asarray(render_out["alpha"])
    out["depth"] = colorize_depth(depth, alpha > 0.5)
    out["inv_depth"] = colorize_depth(depth.max() - depth, alpha > 0.5)
    normal = np.asarray(render_out["normal"])          # (H,W,3) in [-1,1]
    out["normal"] = colorize_normal(normal)
    if gt_normal is not None:
        gtn = np.asarray(gt_normal)
        if gtn.shape[0] == 3:
            gtn = gtn.transpose(1, 2, 0)
        out["normal_gt"] = colorize_normal(gtn)
        # confidence weight cos_weight = exp((cos-1)/exp_t) in [0,1]
        cos = np.sum(normal * gtn, axis=-1)
        w = np.exp(np.clip((cos - 1.0) / max(exp_t, 1e-6), -50, 0))
        out["normal_cos"] = np.repeat(
            (np.clip(w, 0, 1) * 255).astype(np.uint8)[..., None], 3, -1)
    if "est_normal" in render_out:
        out["est_normal"] = colorize_normal(
            np.asarray(render_out["est_normal"]))
    if num_cls and "render_sem" in render_out:
        labels = np.argmax(np.asarray(render_out["render_sem"]), axis=0)
        sem = semantic_palette(labels, num_cls)
        if gt_mask is not None:
            sem = np.concatenate(
                [sem, semantic_palette(np.asarray(gt_mask), num_cls)],
                axis=0)
        out["sem"] = sem
    if "distortion" in render_out:
        out["distortion"] = colorize_depth(
            np.asarray(render_out["distortion"], np.float32))
    if "depth_var" in render_out:
        out["depth_var"] = colorize_depth(
            np.asarray(render_out["depth_var"], np.float32))
    if trans_image is not None:
        out["trans"] = _to_u8(np.asarray(trans_image).transpose(1, 2, 0))
    return out


def save_panels(out_dir: str, tag: str, render_out: dict, gt_image=None,
                num_cls: int = 0) -> str:
    """Write a horizontal strip [gt | render | depth | normal | est_normal
    (| semantic)] for one view."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    cols = []
    if gt_image is not None:
        cols.append(_to_u8(np.asarray(gt_image).transpose(1, 2, 0)))
    cols.append(_to_u8(np.asarray(render_out["render"]).transpose(1, 2, 0)))
    alpha = np.asarray(render_out["alpha"])
    cols.append(colorize_depth(render_out["depth"], alpha > 0.5))
    cols.append(colorize_normal(render_out["normal"]))
    cols.append(colorize_normal(render_out["est_normal"]))
    if num_cls and "render_sem" in render_out:
        labels = np.argmax(np.asarray(render_out["render_sem"]), axis=0)
        cols.append(semantic_palette(labels, num_cls))
    strip = np.concatenate(cols, axis=1)
    path = os.path.join(out_dir, f"{tag}.png")
    Image.fromarray(strip).save(path)
    return path
