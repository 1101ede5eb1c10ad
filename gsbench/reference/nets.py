"""The side networks of the TNT recipe in plain PyTorch: the decoupled
appearance network (a per-image 64-d embedding tiled onto the 32x
downsampled centre crop, a 3x3 convolution to 256 channels, four
pixel-shuffle upsample blocks, a bilinear 2x, two 3x3 convolutions and a
sigmoid, multiplied with the crop) and the 1x1 semantic classifier, with
optax's Adam (eps 1e-15, float32 bias corrections). The benchmark draws
their weights from the seed (``init_weights``) and hands the same to the
program. Imports nothing of the program."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

EMBED_DIM = 64


class UpsampleBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.shuffle = nn.PixelShuffle(2)
        self.conv = nn.Conv2d(cin // 4, cout, 3, padding=1)

    def forward(self, x):
        return F.relu(self.conv(self.shuffle(x)))


class AppearanceNetwork(nn.Module):
    """Its parameters, in ``parameters()`` order: conv0, the four blocks'
    convolutions, conv1, conv2 (weight, bias each)."""

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv2d(3 + EMBED_DIM, 256, 3, padding=1)
        self.up = nn.ModuleList([UpsampleBlock(256, 128),
                                 UpsampleBlock(128, 64),
                                 UpsampleBlock(64, 32),
                                 UpsampleBlock(32, 16)])
        self.conv1 = nn.Conv2d(16, 16, 3, padding=1)
        self.conv2 = nn.Conv2d(16, 3, 3, padding=1)

    def forward(self, x):
        x = F.relu(self.conv0(x))
        for blk in self.up:
            x = blk(x)
        x = F.interpolate(x, size=(x.shape[-2] * 2, x.shape[-1] * 2),
                          mode="bilinear", align_corners=True)
        x = F.relu(self.conv1(x))
        return torch.sigmoid(self.conv2(x))


class Classifier(nn.Module):
    def __init__(self, ch_sem: int, num_cls: int):
        super().__init__()
        self.dense = nn.Linear(ch_sem, num_cls)

    def forward(self, feat_chw):
        return self.dense(feat_chw.permute(1, 2, 0)).permute(2, 0, 1)


def crop_box(height: int, width: int):
    h = height // 32 * 32
    w = width // 32 * 32
    return height // 2 - h // 2, width // 2 - w // 2, h, w


class SideNets:
    """The appearance network with its embeddings and the classifier, each
    present when the recipe trains it, built from ``weights``
    (``init_weights``' lists) in ``dtype`` on ``device``."""

    def __init__(self, weights: dict, ch_sem: int, num_cls: int, device,
                 dtype=torch.float32):
        self.app = self.emb = self.cls = None
        self.groups = []                 # (leaves, lr) per Adam
        if weights.get("app") is not None:
            self.app = AppearanceNetwork().to(device, dtype)
            with torch.no_grad():
                for p, w in zip(self.app.parameters(), weights["app"]):
                    p.copy_(w)
            self.emb = weights["emb"].to(device, dtype).clone()
            self.emb.requires_grad_(True)
            self.groups.append(([self.emb, *self.app.parameters()],
                                weights["app_lr"]))
        if weights.get("cls") is not None:
            self.cls = Classifier(ch_sem, num_cls).to(device, dtype)
            with torch.no_grad():
                for p, w in zip(self.cls.parameters(), weights["cls"]):
                    p.copy_(w)
            self.groups.append((list(self.cls.parameters()),
                                weights["cls_lr"]))
        self.opt = [Adam(leaves, lr) for leaves, lr in self.groups]

    def leaves(self) -> list:
        return [p for leaves, _ in self.groups for p in leaves]

    def appearance(self, image, view_idx: int):
        top, left, h, w = crop_box(*image.shape[1:])
        crop = image[:, top:top + h, left:left + w]
        down = F.interpolate(crop[None], size=(h // 32, w // 32),
                             mode="bilinear", align_corners=True)
        emb = self.emb[view_idx]
        emb_map = emb[None, :, None, None].expand(1, emb.shape[0], h // 32,
                                                  w // 32)
        mapping = self.app(torch.cat([down, emb_map], dim=1))[0]
        return mapping * crop, (top, left, h, w)

    def step(self, grads: list) -> None:
        i = 0
        for opt in self.opt:
            n = len(opt.params)
            opt.step(grads[i:i + n])
            i += n


class Adam:
    """optax.adam(lr, eps=1e-15) on a list of tensors, in place."""

    def __init__(self, params, lr: float, b1=0.9, b2=0.999, eps=1e-15):
        self.params, self.lr, self.b1, self.b2, self.eps = (
            params, float(lr), b1, b2, eps)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads) -> None:
        self.count += 1
        c = np.float32(self.count)
        bc1 = float(np.float32(1) - np.power(np.float32(self.b1), c))
        bc2 = float(np.float32(1) - np.power(np.float32(self.b2), c))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.copy_((1 - self.b1) * g + self.b1 * m)
            v.copy_((1 - self.b2) * (g * g) + self.b2 * v)
            p.add_((m / bc1) / (torch.sqrt(v / bc2) + self.eps) * -self.lr)


def init_weights(n_images: int, ch_sem: int, num_cls: int, appearance: bool,
                 gen: torch.Generator, device, app_lr: float, cls_lr: float):
    """The side networks' starting weights, drawn from ``gen`` on
    ``device``: embeddings N(0, 1e-4), lecun-normal kernels (variance
    1/fan_in), zero biases; lists in ``parameters()`` order."""
    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    out = {"app": None, "cls": None, "app_lr": app_lr, "cls_lr": cls_lr}
    if appearance:
        out["emb"] = normal((n_images, EMBED_DIM), 1e-4)
        ws = []
        for p in AppearanceNetwork().parameters():
            if p.ndim == 4:
                ws.append(normal(tuple(p.shape), 1.0 / np.sqrt(p[0].numel())))
            else:
                ws.append(torch.zeros(tuple(p.shape), device=device))
        out["app"] = ws
    if ch_sem:
        out["cls"] = [normal((num_cls, ch_sem), 1.0 / np.sqrt(ch_sem)),
                      torch.zeros(num_cls, device=device)]
    return out
