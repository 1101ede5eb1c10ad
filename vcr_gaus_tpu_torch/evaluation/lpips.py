"""LPIPS (vgg) in PyTorch, the port's copy of
vcr_gaus_tpu/evaluation/lpips_jax.py: VGG16 features at relu{1_2, 2_2, 3_3,
4_3, 5_3}, unit-normalized over channels, squared differences weighted by
the LPIPS linear heads, averaged over the image and summed over stages.

No weights ship with the repository. They load from files the user
supplies:
  * one combined ``.npz`` written by ``scripts/convert_lpips.py`` (holds
    both the vgg convolutions and the linear heads; set ``$LPIPS_WEIGHTS``
    or pass ``--lpips_weights`` to ``python -m
    vcr_gaus_tpu_torch.render_eval``), or
  * ``$LPIPS_VGG_PATH`` (torchvision vgg16 state_dict, ``.pth`` or ``.npz``
    with ``features.N.weight/bias`` keys) plus ``$LPIPS_LIN_PATH`` (the
    LPIPS v0.1 vgg heads, keys ``lin{i}.model.1.weight``).
``LPIPS_WEIGHTS=placeholder`` generates deterministic random weights
(``write_placeholder_weights``, the same arrays the JAX package writes),
which exercise the whole column but are no perceptual metric; results
computed with them are flagged ``LPIPS_placeholder``.

The convolutions are ``torch.nn.functional.conv2d`` in full float32: cuDNN
would run them in TF32 on the card by default, so the call turns that off.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

# conv layer indices of torchvision vgg16.features, grouped by stage
_STAGES = [(0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28)]
# (out_ch, in_ch) of every conv layer, keyed by torchvision features index
_CONV_CH = {0: (64, 3), 2: (64, 64), 5: (128, 64), 7: (128, 128),
            10: (256, 128), 12: (256, 256), 14: (256, 256),
            17: (512, 256), 19: (512, 512), 21: (512, 512),
            24: (512, 512), 26: (512, 512), 28: (512, 512)}
_STAGE_CH = [64, 128, 256, 512, 512]
# LPIPS input scaling layer (ScalingLayer of the reference networks)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
PLACEHOLDER_KEY = "__placeholder__"


def _load_state(path: str) -> dict[str, np.ndarray]:
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(v) for k, v in z.items()}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def load_weights(vgg_path: str, lin_path: str | None = None):
    """-> (convs per stage [[(W, b), ...], ...], lins [w]) as numpy arrays.
    With ``lin_path`` None, ``vgg_path`` must be a combined file holding
    both key families (the ``scripts/convert_lpips.py`` output)."""
    vgg = _load_state(vgg_path)
    lin = _load_state(lin_path) if lin_path else vgg
    stages = []
    for stage in _STAGES:
        convs = []
        for i in stage:
            w = vgg.get(f"features.{i}.weight")
            if w is None:                      # plain vgg16 dumps
                w, b = vgg[f"{i}.weight"], vgg[f"{i}.bias"]
            else:
                b = vgg[f"features.{i}.bias"]
            convs.append((np.asarray(w, np.float32),
                          np.asarray(b, np.float32)))
        stages.append(convs)
    lins = []
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in lin:
                lins.append(np.asarray(lin[key], np.float32).reshape(-1))
                break
        else:
            raise KeyError(f"lin{i} weights not found in {lin_path}")
    return stages, lins


def write_placeholder_weights(path: str, seed: int = 0) -> str:
    """Write deterministic random weights in the combined ``.npz`` format,
    tagged ``__placeholder__``: He-initialised convolutions and positive
    linear heads, drawn from ``np.random.default_rng(seed)`` in the JAX
    package's order, so both packages write the same arrays. Not the
    pretrained metric: its scores only exercise the column."""
    rng = np.random.default_rng(seed)
    out: dict[str, np.ndarray] = {PLACEHOLDER_KEY: np.asarray(1)}
    for i, (co, ci) in _CONV_CH.items():
        std = float(np.sqrt(2.0 / (ci * 9)))
        out[f"features.{i}.weight"] = rng.normal(
            scale=std, size=(co, ci, 3, 3)).astype(np.float32)
        out[f"features.{i}.bias"] = np.zeros(co, np.float32)
    for i, c in enumerate(_STAGE_CH):
        out[f"lin{i}.model.1.weight"] = np.abs(
            rng.normal(scale=0.1, size=(1, c, 1, 1))).astype(np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **out)
    return path


def placeholder_path() -> str:
    """Where ``LPIPS_WEIGHTS=placeholder`` writes the generated file."""
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "vcr_gaus_tpu_torch", "lpips_placeholder.npz")


class LPIPS(nn.Module):
    """The LPIPS(vgg) distance of two (3, H, W) images in [0, 1], on
    ``device``. Calling it returns a 0-d float32 tensor."""

    def __init__(self, vgg_path: str, lin_path: str | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        stages, lins = load_weights(vgg_path, lin_path)
        self.n_convs = [len(c) for c in stages]
        for s, convs in enumerate(stages):
            for k, (w, b) in enumerate(convs):
                self.register_buffer(f"w{s}_{k}", torch.from_numpy(w).to(dev))
                self.register_buffer(f"b{s}_{k}", torch.from_numpy(b).to(dev))
        for s, w in enumerate(lins):
            self.register_buffer(f"lin{s}", torch.from_numpy(w).to(dev))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).to(dev))
        self.register_buffer("scale", torch.from_numpy(_SCALE).to(dev))
        self.is_placeholder = False
        if vgg_path.endswith(".npz"):
            with np.load(vgg_path) as z:
                self.is_placeholder = PLACEHOLDER_KEY in z

    def _features(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = (2.0 * x - 1.0 - self.shift[:, None, None]) \
            / self.scale[:, None, None]
        out = []
        for s, n in enumerate(self.n_convs):
            for k in range(n):
                x = F.relu(F.conv2d(x, getattr(self, f"w{s}_{k}"),
                                    getattr(self, f"b{s}_{k}"), padding=1))
            out.append(x / torch.sqrt(torch.sum(x * x, 1, keepdim=True)
                                      + 1e-10))
            x = F.max_pool2d(x, 2)
        return out

    @torch.no_grad()
    def forward(self, img, gt) -> torch.Tensor:
        dev = self.shift.device
        pair = torch.stack([torch.as_tensor(np.asarray(a, np.float32))
                            if not isinstance(a, torch.Tensor) else a.float()
                            for a in (img, gt)]).to(dev)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            feats = self._features(pair)
        dist = torch.zeros((), device=dev)
        for s, f in enumerate(feats):
            d = (f[0] - f[1]) ** 2
            dist = dist + torch.mean(torch.sum(
                getattr(self, f"lin{s}")[:, None, None] * d, 0))
        return dist

    @staticmethod
    def maybe(vgg_path: str | None, lin_path: str | None = None,
              device: str | torch.device = "cuda"):
        """The combined-file form (``lin_path`` falsy) or the two-file
        form; None where a file is missing."""
        if vgg_path and os.path.exists(vgg_path):
            if not lin_path:
                return LPIPS(vgg_path, device=device)
            if os.path.exists(lin_path):
                return LPIPS(vgg_path, lin_path, device=device)
        return None

    @staticmethod
    def from_env(device: str | torch.device = "cuda"):
        """``$LPIPS_WEIGHTS`` (a combined ``.npz``, or ``placeholder``,
        which generates the placeholder file once), else the
        ``$LPIPS_VGG_PATH`` + ``$LPIPS_LIN_PATH`` pair; None without
        weights."""
        combined = os.environ.get("LPIPS_WEIGHTS")
        if combined == "placeholder":
            p = placeholder_path()
            if not os.path.exists(p):
                write_placeholder_weights(p)
            return LPIPS(p, device=device)
        if combined:
            return LPIPS.maybe(combined, device=device)
        return LPIPS.maybe(os.environ.get("LPIPS_VGG_PATH"),
                           os.environ.get("LPIPS_LIN_PATH"), device=device)
