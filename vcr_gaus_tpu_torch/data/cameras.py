"""Camera objects: host-side construction + a tensor view
(vcr_gaus_tpu/data/cameras.py).

A Camera is a frozen host dataclass; ``Camera.arrays(device)`` gives the
``CameraArrays`` of tensors that ``render`` consumes. ``viewmatrix`` and
``projmatrix`` are ROW-VECTOR (transposed/GLM) 4x4s; points transform as
``p_hom @ M``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils import graphics as G
from ..utils.device import resolve_device


class CameraArrays(NamedTuple):
    """One camera as tensors, field for field as the JAX package's."""
    viewmatrix: torch.Tensor     # (4,4) row-vector world->cam
    projmatrix: torch.Tensor     # (4,4) row-vector world->clip
    cam_center: torch.Tensor     # (3,)
    intr: torch.Tensor           # (4,) fx, fy, cx, cy
    tanfov: torch.Tensor         # (2,) tanfovx, tanfovy
    image: torch.Tensor          # (3,H,W) in [0,1]
    normal: torch.Tensor         # (3,H,W) mono normal prior (zeros if absent)
    depth: torch.Tensor          # (H,W) mono depth prior (zeros if absent)
    mask: torch.Tensor           # (H,W) int32 semantic labels (0=background)
    has_normal: torch.Tensor     # () bool
    has_depth: torch.Tensor      # () bool
    has_mask: torch.Tensor       # () bool
    idx: torch.Tensor            # () int32 appearance-embedding index


@dataclass(frozen=True)
class Camera:
    """Host camera."""
    colmap_id: int
    idx: int
    image_name: str
    R: np.ndarray                # (3,3) c2w rotation (COLMAP w2c transposed)
    T: np.ndarray                # (3,) w2c translation
    fovx: float
    fovy: float
    width: int
    height: int
    image: np.ndarray | None = None      # (3,H,W) f32 or u8 (u8 = /255)
    normal: np.ndarray | None = None     # (3,H,W) f32 or f16
    depth: np.ndarray | None = None      # (H,W) f32
    mask: np.ndarray | None = None       # (H,W) int
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0
    # lazy residency: zero-arg decoders keyed by image/normal/depth/mask,
    # called on each arrays() call, nothing cached
    loaders: dict[str, Callable[[], np.ndarray]] | None = None

    @property
    def world_view_transform(self) -> np.ndarray:
        return G.world_to_view(self.R, self.T, self.trans, self.scale).T

    @property
    def projection_matrix(self) -> np.ndarray:
        return G.projection_matrix(self.znear, self.zfar, self.fovx,
                                   self.fovy).T

    @property
    def full_proj_transform(self) -> np.ndarray:
        return self.world_view_transform @ self.projection_matrix

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(self.world_view_transform.T)[:3, 3]

    @property
    def intrinsics(self) -> np.ndarray:
        """(4,) fx, fy, cx, cy with the principal point at the center."""
        return np.array([
            G.fov2focal(self.fovx, self.width),
            G.fov2focal(self.fovy, self.height),
            self.width / 2.0, self.height / 2.0], np.float32)

    def _component(self, kind: str):
        arr = getattr(self, kind)
        if arr is None and self.loaders and kind in self.loaders:
            arr = self.loaders[kind]()
        return arr

    def arrays(self, device: str | torch.device = "cuda") -> CameraArrays:
        """The float32 tensors of this camera on ``device``. A u8 image is
        moved as u8 and divided by 255 there."""
        dev = resolve_device(device)
        h, w = self.height, self.width
        img = self._component("image")
        normal = self._component("normal")
        depth = self._component("depth")
        mask = self._component("mask")

        def f32(a):
            return torch.tensor(np.asarray(a), device=dev).to(torch.float32)

        if img is None:
            image = torch.zeros((3, h, w), dtype=torch.float32, device=dev)
        elif img.dtype == np.uint8:
            image = torch.tensor(img, device=dev).to(torch.float32) / 255.0
        else:
            image = f32(img)
        tanfov = np.array([math.tan(self.fovx / 2), math.tan(self.fovy / 2)],
                          np.float32)
        return CameraArrays(
            viewmatrix=f32(self.world_view_transform.astype(np.float32)),
            projmatrix=f32(self.full_proj_transform.astype(np.float32)),
            cam_center=f32(self.camera_center.astype(np.float32)),
            intr=f32(self.intrinsics),
            tanfov=f32(tanfov),
            image=image,
            normal=(f32(normal) if normal is not None else
                    torch.zeros((3, h, w), dtype=torch.float32, device=dev)),
            depth=(f32(depth) if depth is not None else
                   torch.zeros((h, w), dtype=torch.float32, device=dev)),
            mask=(torch.tensor(np.asarray(mask, np.int32), device=dev)
                  if mask is not None else
                  torch.zeros((h, w), dtype=torch.int32, device=dev)),
            has_normal=torch.tensor(normal is not None, device=dev),
            has_depth=torch.tensor(depth is not None, device=dev),
            has_mask=torch.tensor(mask is not None, device=dev),
            idx=torch.tensor(self.idx, dtype=torch.int32, device=dev),
        )
