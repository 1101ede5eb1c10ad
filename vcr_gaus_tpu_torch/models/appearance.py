"""Decoupled appearance network and semantic classifier
(vcr_gaus_tpu/models/appearance.py), as ``torch.nn`` modules.

Appearance: a per-image 64-d embedding is tiled onto a 32x-downsampled
centre crop of the rendered image; a CNN with four pixel-shuffle upsample
blocks and a final bilinear 2x gives a full-resolution 3-channel
multiplicative map in (0, 1). Semantic classifier: a 1x1 map (a dense layer
over the channels) from the rasterized semantic features to class logits.
The convolutions run without TF32 (the trainer also holds the backward to
that).

Parameters also travel in the JAX package's flax layout (nested dicts of
numpy under ``params``: ``Conv_0``, ``UpsampleBlock_{0..3}/Conv_0``,
``Conv_1``, ``Conv_2``; ``Dense_0``): ``load_flax`` and ``to_flax`` map a
conv kernel HWIO <-> OIHW and a dense kernel (in, out) <-> a Linear weight
(out, in).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

EMBED_DIM = 64


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """align_corners=True bilinear resize of a (N, C, H, W) tensor."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class UpsampleBlock(nn.Module):
    """Pixel shuffle (torch's channel order, as the JAX ``pixel_shuffle``),
    a 3x3 convolution, ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.shuffle = nn.PixelShuffle(2)
        self.conv = _conv3(cin // 4, cout)

    def forward(self, x):
        return F.relu(self.conv(self.shuffle(x)))


class AppearanceNetwork(nn.Module):
    """(N, 3 + 64, H/32, W/32) -> multiplicative map (N, 3, H, W) in
    (0, 1)."""

    def __init__(self, in_ch: int = 3 + EMBED_DIM, out_ch: int = 3):
        super().__init__()
        self.conv0 = _conv3(in_ch, 256)
        self.up = nn.ModuleList([UpsampleBlock(256, 128),
                                 UpsampleBlock(128, 64),
                                 UpsampleBlock(64, 32),
                                 UpsampleBlock(32, 16)])
        self.conv1 = _conv3(16, 16)
        self.conv2 = _conv3(16, out_ch)

    def forward(self, x):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            x = F.relu(self.conv0(x))
            for blk in self.up:
                x = blk(x)
            x = bilinear_resize(x, x.shape[-2] * 2, x.shape[-1] * 2)
            x = F.relu(self.conv1(x))
            return torch.sigmoid(self.conv2(x))

    def flax_convs(self) -> dict[str, nn.Conv2d]:
        """The flax module path of each convolution."""
        convs = {"Conv_0": self.conv0, "Conv_1": self.conv1,
                 "Conv_2": self.conv2}
        for i, blk in enumerate(self.up):
            convs[f"UpsampleBlock_{i}/Conv_0"] = blk.conv
        return convs


class SemanticClassifier(nn.Module):
    """(S, H, W) semantic features -> (num_cls, H, W) logits."""

    def __init__(self, ch_sem: int, num_cls: int):
        super().__init__()
        self.dense = nn.Linear(ch_sem, num_cls)

    def forward(self, feat_chw):
        return self.dense(feat_chw.permute(1, 2, 0)).permute(2, 0, 1)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """Normal of variance 1/fan_in (flax's default kernel init, without its
    truncation), drawn from ``gen``."""
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=gen) / np.sqrt(fan_in))


def init_appearance(num_images: int, gen: torch.Generator,
                    device: str | torch.device = "cpu",
                    embed_std: float = 1e-4):
    """(embeddings (num_images, 64) ~ N(0, embed_std), network), drawn from
    ``gen``: lecun-normal kernels, zero biases."""
    emb = embed_std * torch.randn((num_images, EMBED_DIM), generator=gen)
    net = AppearanceNetwork()
    for conv in net.flax_convs().values():
        _lecun_normal_(conv.weight, conv.weight[0].numel(), gen)
        nn.init.zeros_(conv.bias)
    return emb.to(device), net.to(device)


def init_classifier(ch_sem: int, num_cls: int, gen: torch.Generator,
                    device: str | torch.device = "cpu") -> SemanticClassifier:
    clf = SemanticClassifier(ch_sem, num_cls)
    _lecun_normal_(clf.dense.weight, ch_sem, gen)
    nn.init.zeros_(clf.dense.bias)
    return clf.to(device)


def _layers(module: nn.Module) -> dict[str, nn.Module]:
    if isinstance(module, AppearanceNetwork):
        return module.flax_convs()
    return {"Dense_0": module.dense}


def _to_flax_kernel(layer: nn.Module, w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 1, 0) if isinstance(layer, nn.Conv2d) else w.T


def _from_flax_kernel(layer: nn.Module, k: np.ndarray) -> np.ndarray:
    return k.transpose(3, 2, 0, 1) if isinstance(layer, nn.Conv2d) else k.T


def _lookup(tree: dict, path: str) -> dict:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def load_flax(module: nn.Module, variables: dict) -> nn.Module:
    """Copy flax variables (``{"params": {...}}`` of numpy arrays) into the
    module's parameters, in place; returns the module."""
    with torch.no_grad():
        for path, layer in _layers(module).items():
            leaf = _lookup(variables["params"], path)
            layer.weight.copy_(torch.as_tensor(np.ascontiguousarray(
                _from_flax_kernel(layer, np.asarray(leaf["kernel"])))))
            layer.bias.copy_(torch.as_tensor(np.asarray(leaf["bias"])))
    return module


def to_flax(module: nn.Module, tensors: dict | None = None) -> dict:
    """The module's parameters (or ``tensors``, the same names' tensors of
    another pytree such as an Adam moment) in the flax layout, as numpy."""
    out: dict = {}
    for path, layer in _layers(module).items():
        node = out
        for key in path.split("/"):
            node = node.setdefault(key, {})
        for name in ("weight", "bias"):
            p = getattr(layer, name)
            t = p if tensors is None else tensors[p]
            a = t.detach().cpu().numpy().copy()     # a snapshot, not a view
            node["kernel" if name == "weight" else "bias"] = (
                np.ascontiguousarray(_to_flax_kernel(layer, a))
                if name == "weight" else a)
    return {"params": out}


def from_flax_tensors(module: nn.Module, variables: dict,
                      device) -> dict[nn.Parameter, torch.Tensor]:
    """Flax-layout arrays (e.g. an Adam moment) as tensors keyed by the
    module's parameter they belong to."""
    out = {}
    for path, layer in _layers(module).items():
        leaf = _lookup(variables["params"], path)
        out[layer.weight] = torch.as_tensor(np.ascontiguousarray(
            _from_flax_kernel(layer, np.asarray(leaf["kernel"]))),
            device=device)
        out[layer.bias] = torch.as_tensor(np.asarray(leaf["bias"]),
                                          device=device)
    return out


def crop_box(height: int, width: int) -> tuple[int, int, int, int]:
    """(top, left, h, w) of the centred crop to a multiple of 32."""
    h = height // 32 * 32
    w = width // 32 * 32
    return height // 2 - h // 2, width // 2 - w // 2, h, w


def appearance_transform(net: AppearanceNetwork, embeddings: torch.Tensor,
                         image: torch.Tensor, view_idx):
    """The appearance-corrected L1 pathway: centre-crop the (3, H, W) image
    to a multiple of 32, downsample it 32x (bilinear, align_corners), concat
    the view's embedding, run the network, multiply with the crop. Returns
    (transformed crop (3, h, w), (top, left, h, w))."""
    emb = embeddings[view_idx]
    top, left, h, w = crop_box(*image.shape[1:])
    crop = image[:, top:top + h, left:left + w]
    down = bilinear_resize(crop[None], h // 32, w // 32)
    emb_map = emb[None, :, None, None].expand(1, emb.shape[0], h // 32,
                                              w // 32)
    mapping = net(torch.cat([down, emb_map], dim=1))[0]      # (3, h, w)
    return mapping * crop, (top, left, h, w)
