"""Novel-view-synthesis metrics + render sweeps (vcr_gaus_tpu/evaluation/
nvs.py). PSNR and SSIM; LPIPS waits until converted VGG weights are in the
repository."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..train.losses import ssim as _ssim
from ..utils.device import resolve_device


def psnr(img: np.ndarray, gt: np.ndarray) -> float:
    mse = np.mean((np.asarray(img, np.float64)
                   - np.asarray(gt, np.float64)) ** 2)
    return float(-10.0 * np.log10(mse + 1e-12))


def ssim(img, gt, device: str | torch.device = "cuda") -> float:
    dev = resolve_device(device)
    return float(_ssim(torch.as_tensor(np.asarray(img, np.float32)).to(dev),
                       torch.as_tensor(np.asarray(gt, np.float32)).to(dev)))


def _to_u8(x: np.ndarray) -> np.ndarray:
    # round (not floor) so gt/ and renders/ share the same quantizer
    return (np.clip(x, 0, 1).transpose(1, 2, 0) * 255 + 0.5).astype(np.uint8)


def render_sets(state, cameras, rcfg, bg, out_dir: str, sh_degree: int = 3,
                scene_extent: float = 1e9, save_gt: bool = True,
                device: str | torch.device = "cuda") -> None:
    """Render a camera list to renders/ + gt/ PNG pairs. Only the u8 image
    crosses back to the host."""
    from PIL import Image

    from ..render.renderer import render
    dev = resolve_device(device)
    os.makedirs(os.path.join(out_dir, "renders"), exist_ok=True)
    if save_gt:
        os.makedirs(os.path.join(out_dir, "gt"), exist_ok=True)
    bg = torch.as_tensor(np.asarray(bg, np.float32)).to(dev)
    for i, cam in enumerate(cameras):
        arr = cam.arrays(dev)
        out = render(state, arr, rcfg, bg, sh_degree,
                     scene_extent=scene_extent)
        rgb = torch.clamp(out["render"], 0, 1)
        img = torch.round(rgb.permute(1, 2, 0) * 255).to(torch.uint8)
        Image.fromarray(img.cpu().numpy()).save(
            os.path.join(out_dir, "renders", f"{i:05d}.png"))
        if save_gt:
            Image.fromarray(_to_u8(arr.image.cpu().numpy())).save(
                os.path.join(out_dir, "gt", f"{i:05d}.png"))


def evaluate_dir(out_dir: str, device: str | torch.device = "cuda") -> dict:
    """PSNR/SSIM over saved renders vs gt; writes results.json and
    per_view.json."""
    from PIL import Image
    rdir = os.path.join(out_dir, "renders")
    gdir = os.path.join(out_dir, "gt")
    per_view: dict[str, dict] = {}
    for n in sorted(os.listdir(rdir)):
        r = np.asarray(Image.open(os.path.join(rdir, n)),
                       np.float32).transpose(2, 0, 1) / 255.0
        g = np.asarray(Image.open(os.path.join(gdir, n)),
                       np.float32).transpose(2, 0, 1) / 255.0
        per_view[n] = {"psnr": psnr(r, g), "ssim": ssim(r, g, device)}
    results = {
        "PSNR": float(np.mean([v["psnr"] for v in per_view.values()])),
        "SSIM": float(np.mean([v["ssim"] for v in per_view.values()])),
    }
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    with open(os.path.join(out_dir, "per_view.json"), "w") as f:
        json.dump(per_view, f, indent=2)
    return results
