"""Camera objects: host-side construction + a tensor view
(vcr_gaus_tpu/data/cameras.py).

A Camera is a frozen host dataclass; ``Camera.arrays(device)`` gives the
``CameraArrays`` of tensors that ``render`` consumes. ``viewmatrix`` and
``projmatrix`` are ROW-VECTOR (transposed/GLM) 4x4s; points transform as
``p_hom @ M``. ``Camera.pin_memory`` moves a camera's pixel arrays into
page-locked host memory, from which ``arrays(device, stream=s)`` copies them
to the card without blocking, on the stream ``s``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils import graphics as G
from ..utils.device import resolve_device

# the pixel arrays a camera may hold, and ``pin_memory`` moves
PIXELS = ("image", "normal", "depth", "mask")
# the geometry's float32 words in a camera's packed upload, in order; the
# appearance index (int32) and the three has_* flags (bool) follow them
_GEOMETRY = (("viewmatrix", (4, 4)), ("projmatrix", (4, 4)),
             ("cam_center", (3,)), ("intr", (4,)), ("tanfov", (2,)))
_GEOMETRY_BYTES = 4 * sum(math.prod(s) for _, s in _GEOMETRY)


def upload(a: np.ndarray, device: torch.device,
           stream: torch.cuda.Stream | None = None) -> torch.Tensor:
    """A copy of ``a`` on ``device``, laid out as ``a`` is. Without
    ``stream``, a blocking copy. With ``stream`` (which must be current), a
    non-blocking copy on it from page-locked memory: ``a``'s own where it is
    page-locked (``Camera.pin_memory``), else a page-locked copy of it from
    PyTorch's caching host allocator, which keeps that copy until the
    transfer has read it."""
    if stream is None:
        return torch.tensor(a, device=device)
    src = torch.from_numpy(a) if a.flags.writeable else torch.tensor(a)
    if not src.is_pinned():
        src = src.pin_memory()
    return torch.empty_like(src, device=device).copy_(src, non_blocking=True)


def _pinned(a: np.ndarray) -> np.ndarray:
    """A copy of ``a`` in one page-locked buffer, its axes laid out in
    ``a``'s order (a reader's (3, H, W) view of an (H, W, 3) image keeps its
    (H, W, 3) buffer), as a numpy view that keeps the buffer alive."""
    order = sorted(range(a.ndim), key=lambda i: -a.strides[i])
    buf = torch.empty(a.nbytes, dtype=torch.uint8, pin_memory=True).numpy()
    out = buf.view(a.dtype).reshape([a.shape[i] for i in order]).transpose(
        np.argsort(order))
    out[...] = a
    return out


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

    def pin_memory(self) -> Camera:
        """This camera with its resident pixel arrays copied into
        page-locked host memory, one buffer an array, each at its dtype and
        in its layout; the pageable arrays go with the old camera."""
        return dataclasses.replace(self, **{
            k: _pinned(getattr(self, k)) for k in PIXELS
            if getattr(self, k) is not None})

    def arrays(self, device: str | torch.device = "cuda",
               pixels: bool = True,
               stream: torch.cuda.Stream | None = None) -> CameraArrays:
        """The float32 tensors of this camera on ``device``. A u8 image is
        moved as u8 and divided by 255 there. ``pixels=False`` reads no
        image or prior and carries 1x1 placeholders, for the consumers of
        the geometry alone (the stats sweeps). The geometry, the appearance
        index and the has_* flags travel as one packed buffer, of which the
        fields are views. With ``stream`` every copy and conversion runs on
        that CUDA stream and no copy blocks (``upload``); the tensors are
        allocated on it."""
        dev = resolve_device(device)
        h, w = self.height, self.width
        if pixels:
            img = self._component("image")
            normal = self._component("normal")
            depth = self._component("depth")
            mask = self._component("mask")
        else:
            h = w = 1
            img = normal = depth = mask = None
        tanfov = np.array([math.tan(self.fovx / 2), math.tan(self.fovy / 2)],
                          np.float32)
        # the properties' values, the world-to-view transform formed once
        wv = self.world_view_transform
        packed = np.zeros(_GEOMETRY_BYTES + 8, np.uint8)
        packed[:_GEOMETRY_BYTES] = np.concatenate([
            wv.ravel(), (wv @ self.projection_matrix).ravel(),
            np.linalg.inv(wv.T)[:3, 3], self.intrinsics,
            tanfov]).astype(np.float32).view(np.uint8)
        at = _GEOMETRY_BYTES
        packed[at:at + 4] = np.array([self.idx], np.int32).view(np.uint8)
        packed[at + 4:at + 7] = [normal is not None, depth is not None,
                                 mask is not None]

        def up(a):
            return upload(np.asarray(a), dev, stream)

        def f32(a):
            return up(a).to(torch.float32)

        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            small = up(packed)
            words = small[:_GEOMETRY_BYTES].view(torch.float32)
            geometry, k = {}, 0
            for name, shape in _GEOMETRY:
                n = math.prod(shape)
                geometry[name] = words[k:k + n].view(shape)
                k += n
            flags = small[at + 4:at + 7].view(torch.bool)
            if img is None:
                image = torch.zeros((3, h, w), dtype=torch.float32,
                                    device=dev)
            else:
                # contiguous on the device, where the scene readers' arrays
                # are (H, W, 3) ones transposed: the SSIM kernels take no
                # strides. A u8 image is laid out anew by its conversion; a
                # float32 one would be aliased by it, so ``contiguous``
                # copies it on the device
                image = up(img).to(
                    torch.float32, memory_format=torch.contiguous_format
                ).contiguous()
                if img.dtype == np.uint8:
                    image = image / 255.0
            return CameraArrays(
                **geometry,
                image=image,
                normal=(f32(normal) if normal is not None else
                        torch.zeros((3, h, w), dtype=torch.float32,
                                    device=dev)),
                depth=(f32(depth) if depth is not None else
                       torch.zeros((h, w), dtype=torch.float32, device=dev)),
                mask=(up(np.asarray(mask, np.int32)) if mask is not None else
                      torch.zeros((h, w), dtype=torch.int32, device=dev)),
                has_normal=flags[0], has_depth=flags[1], has_mask=flags[2],
                idx=small[at:at + 4].view(torch.int32)[0],
            )
