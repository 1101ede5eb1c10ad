"""An interactive orbit camera for viewers, the port's copy of
vcr_gaus_tpu/render/orbit.py: orbit, pan and zoom state giving the view,
projection and intrinsics. Host math in numpy (rotation-vector
exponentials by Rodrigues' formula)."""

from __future__ import annotations

import numpy as np


def _rotvec_to_matrix(v: np.ndarray) -> np.ndarray:
    """Rodrigues' formula: rotation vector (axis * angle) -> 3x3 matrix."""
    theta = np.linalg.norm(v)
    if theta < 1e-12:
        return np.eye(3)
    k = v / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


class OrbitCamera:
    def __init__(self, width: int, height: int, radius: float = 2.0,
                 fovy_deg: float = 60.0, near: float = 0.01,
                 far: float = 100.0):
        self.W = width
        self.H = height
        self.radius = radius
        self.fovy = np.deg2rad(fovy_deg)
        self.near = near
        self.far = far
        self.center = np.zeros(3, np.float32)
        self.rot = np.eye(3)
        self.up = np.array([0.0, 1.0, 0.0], np.float32)

    @property
    def fovx(self) -> float:
        return 2 * np.arctan(np.tan(self.fovy / 2) * self.W / self.H)

    @property
    def pose(self) -> np.ndarray:
        """Camera-to-world (OpenGL convention: the camera backs off along
        +z)."""
        res = np.eye(4, dtype=np.float32)
        res[2, 3] = self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    @property
    def campos(self) -> np.ndarray:
        return self.pose[:3, 3]

    @property
    def view(self) -> np.ndarray:
        return np.linalg.inv(self.pose)

    @property
    def perspective(self) -> np.ndarray:
        y = np.tan(self.fovy / 2)
        aspect = self.W / self.H
        n, f = self.near, self.far
        return np.array(
            [[1 / (y * aspect), 0, 0, 0],
             [0, -1 / y, 0, 0],
             [0, 0, -(f + n) / (f - n), -(2 * f * n) / (f - n)],
             [0, 0, -1, 0]], np.float32)

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.H / (2 * np.tan(self.fovy / 2))
        return np.array([focal, focal, self.W // 2, self.H // 2], np.float32)

    @property
    def mvp(self) -> np.ndarray:
        return self.perspective @ self.view

    def orbit(self, dx: float, dy: float) -> None:
        side = self.rot[:3, 0]
        rx = _rotvec_to_matrix(self.up * np.radians(-0.05 * dx))
        ry = _rotvec_to_matrix(side * np.radians(-0.05 * dy))
        self.rot = rx @ ry @ self.rot

    def scale(self, delta: float) -> None:
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx: float, dy: float, dz: float = 0.0) -> None:
        self.center = self.center + 0.0005 * (
            self.rot @ np.array([-dx, -dy, dz], np.float32))
