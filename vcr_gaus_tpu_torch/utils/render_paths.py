"""Fly-through render paths and video export (vcr_gaus_tpu/utils/
render_paths.py, after the reference's tools/render_utils.py): the PCA
normalisation of the camera poses, an elliptical path around the scene,
and the video writer's fallback chain (mp4, then GIF, then a PNG frame
directory). The pose algebra is host numpy, as in the JAX package; each
frame of ``render_flythrough`` goes through the port's renderer, so on a
CUDA state it launches the forward compositing kernel once.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data.cameras import Camera


def poses_c2w(cameras: list[Camera]) -> np.ndarray:
    """(N, 4, 4) camera-to-world matrices."""
    out = []
    for c in cameras:
        w2c = c.world_view_transform.T           # column convention
        out.append(np.linalg.inv(w2c))
    return np.stack(out)


def transform_poses_pca(poses: np.ndarray):
    """Align the principal axes of the camera positions with the world axes
    and rescale into [-1, 1]. Returns (transformed poses, the 4x4 transform
    applied)."""
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    centered = t - t_mean
    eigval, eigvec = np.linalg.eig(centered.T @ centered)
    inds = np.argsort(eigval)[::-1]
    rot = eigvec[:, inds].T.real
    if np.linalg.det(rot) < 0:
        rot = np.diag(np.array([1, 1, -1])) @ rot
    transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
    poses_rec = unpad_poses(transform @ pad_poses(poses))
    # flip so that the mean camera's y axis points down the world's y
    if poses_rec.mean(axis=0)[2, 1] < 0:
        poses_rec = unpad_poses(
            np.diag(np.array([1, -1, -1, 1])) @ pad_poses(poses_rec))
        transform = np.diag(np.array([1, -1, -1, 1])) @ np.concatenate(
            [transform, np.array([[0, 0, 0, 1.0]])], 0)
    else:
        transform = np.concatenate([transform,
                                    np.array([[0, 0, 0, 1.0]])], 0)
    scale = 1.0 / np.max(np.abs(poses_rec[:, :3, 3]))
    poses_rec[:, :3, 3] *= scale
    transform = np.diag(np.array([scale] * 3 + [1.0])) @ transform
    return poses_rec, transform


def pad_poses(p):
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p):
    return p[..., :3, :4]


def generate_ellipse_path(poses: np.ndarray, n_frames: int = 120,
                          z_variation: float = 0.0, z_phase: float = 0.0):
    """An elliptical path around the scene at the cameras' height, from
    (N, 3, 4) PCA-normalised poses. Returns (n_frames, 3, 4) c2w poses
    looking at the centre."""
    center = np.percentile(poses[:, :3, 3], 50, axis=0) * np.array([1, 1, 0])
    offset = center + np.array([0, 0, poses[:, 2, 3].mean()])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)

    theta = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    positions = np.stack([
        center[0] + sc[0] * np.cos(theta),
        center[1] + sc[1] * np.sin(theta),
        offset[2] + z_variation * sc[2] * np.sin(theta + 2 * np.pi * z_phase),
    ], axis=-1)

    out = []
    up = np.array([0.0, 0.0, 1.0])
    for pos in positions:
        fwd = center + np.array([0, 0, offset[2]]) - pos
        fwd = fwd / max(np.linalg.norm(fwd), 1e-9)
        right = np.cross(fwd, up)
        right /= max(np.linalg.norm(right), 1e-9)
        u = np.cross(right, fwd)
        c2w = np.eye(4)[:3]
        c2w[:, 0] = right
        c2w[:, 1] = -u
        c2w[:, 2] = fwd
        c2w[:, 3] = pos
        out.append(c2w)
    return np.stack(out)


def path_to_cameras(path_c2w: np.ndarray, inv_transform: np.ndarray,
                    template: Camera) -> list[Camera]:
    """Map path poses back to the original world and wrap them as Cameras
    of the template's intrinsics and size, without images or priors (nor
    the template's loaders of them)."""
    cams = []
    for i, c2w34 in enumerate(path_c2w):
        c2w = np.concatenate([c2w34, np.array([[0, 0, 0, 1.0]])], 0)
        c2w = inv_transform @ c2w
        # inv_transform carries the PCA 1/scale: re-orthonormalise
        R = c2w[:3, :3]
        R = R / np.linalg.norm(R, axis=0, keepdims=True)
        c2w[:3, :3] = R
        w2c = np.linalg.inv(c2w)
        cams.append(dataclasses.replace(
            template, colmap_id=i, idx=i, image_name=f"path_{i:04d}",
            R=w2c[:3, :3].T, T=w2c[:3, 3], image=None, normal=None,
            depth=None, mask=None, loaders=None))
    return cams


def write_video(path: str, frames: list[np.ndarray], fps: int = 30) -> str:
    """(H, W, 3) uint8 frames -> an mp4 at ``path``; an animated GIF beside
    it when imageio has no ffmpeg backend; a directory of PNG frames when
    that fails too or imageio is absent (zlib level 1, the frames encoded
    in threads: PIL releases the interpreter lock while it encodes).
    Returns the path written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio
    except ImportError:
        imageio = None
        print("[write_video] imageio absent: writing PNG frames", flush=True)
    if imageio is not None:
        try:
            with imageio.get_writer(path, fps=fps) as w:
                for f in frames:
                    w.append_data(f)
            return path
        except Exception:
            pass
        gif = os.path.splitext(path)[0] + ".gif"
        try:
            imageio.mimsave(gif, frames, duration=1.0 / fps, loop=0)
            return gif
        except Exception:
            pass
    from PIL import Image
    frame_dir = os.path.splitext(path)[0] + "_frames"
    os.makedirs(frame_dir, exist_ok=True)

    def save(i):
        Image.fromarray(frames[i]).save(
            os.path.join(frame_dir, f"{i:05d}.png"), compress_level=1)

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for done in [pool.submit(save, i) for i in range(len(frames))]:
            done.result()
    return frame_dir


def render_flythrough(state, cameras: list[Camera], rcfg, out_path: str,
                      n_frames: int = 120, sh_degree: int = 3,
                      scene_extent: float = 1e9, fps: int = 30) -> str:
    """Train cameras -> PCA-normalised ellipse path -> a rendered video on
    the device of the state's tensors. Returns the path written."""
    from ..render.renderer import render

    dev = state.params.xyz.device
    poses = pad_poses(poses_c2w(cameras)[:, :3, :4])
    poses_rec, transform = transform_poses_pca(poses)
    path = generate_ellipse_path(poses_rec, n_frames)
    cams = path_to_cameras(path, np.linalg.inv(transform), cameras[0])
    bg = torch.zeros(3, device=dev)
    frames = []
    with torch.no_grad():
        for cam in cams:
            out = render(state, cam.arrays(dev), rcfg, bg, sh_degree,
                         scene_extent=scene_extent)
            # numpy's clip, scale and truncation, on the device
            frames.append((out["render"].clamp(0, 1).permute(1, 2, 0) * 255)
                          .to(torch.uint8).cpu().numpy())
    return write_video(out_path, frames, fps)
