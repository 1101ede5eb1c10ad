"""The SIBR remote viewer's socket bridge, the port's copy of
vcr_gaus_tpu/render/network_gui.py, with the same protocol:
length-prefixed (4 bytes, little-endian) JSON camera messages in; raw RGB
u8 bytes of the frame out, then a length-prefixed verify string. The
viewer's view matrix comes row-major with its y and z columns negated
against the renderer's convention, its projection with the y column
negated.

Inside a training loop (``port > 0``):

    gui = NetworkGUI("127.0.0.1", port, device)
    req = gui.poll()
    if req is not None and req.camera is not None:
        gui.send_image(render(state, req.camera, ...)["render"], verify)
"""

from __future__ import annotations

import json
import math
import socket
from dataclasses import dataclass

import numpy as np
import torch

from ..data.cameras import CameraArrays


@dataclass
class ViewerRequest:
    camera: CameraArrays | None
    do_training: bool = True
    keep_alive: bool = True
    scaling_modifier: float = 1.0


def request_camera(msg: dict, device: torch.device) -> CameraArrays:
    """The message's camera as tensors on ``device``: the matrices, centre,
    intrinsics and tangents computed in float32 numpy as the JAX package
    does; zero image and priors, no prior flags, index 0."""
    w, h = msg["resolution_x"], msg["resolution_y"]
    view = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
    view[:, 1] *= -1
    view[:, 2] *= -1
    proj = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
    proj[:, 1] *= -1
    fovx, fovy = msg["fov_x"], msg["fov_y"]
    fx = w / (2 * math.tan(fovx / 2))
    fy = h / (2 * math.tan(fovy / 2))
    host = dict(
        viewmatrix=view, projmatrix=proj,
        cam_center=np.linalg.inv(view.T)[:3, 3].astype(np.float32),
        intr=np.array([fx, fy, w / 2, h / 2], np.float32),
        tanfov=np.array([math.tan(fovx / 2), math.tan(fovy / 2)],
                        np.float32))
    f32 = dict(dtype=torch.float32, device=device)
    false = torch.tensor(False, device=device)
    return CameraArrays(
        **{k: torch.as_tensor(v, device=device) for k, v in host.items()},
        image=torch.zeros((3, h, w), **f32),
        normal=torch.zeros((3, h, w), **f32),
        depth=torch.zeros((h, w), **f32),
        mask=torch.zeros((h, w), dtype=torch.int32, device=device),
        has_normal=false, has_depth=false, has_mask=false,
        idx=torch.tensor(0, dtype=torch.int32, device=device))


class NetworkGUI:
    """A non-blocking listener on ``host:port`` that serves one viewer at a
    time; request cameras are built on ``device``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn = None

    def close(self) -> None:
        for s in (self.conn, self.listener):
            if s is not None:
                s.close()
        self.conn = None

    def _try_connect(self):
        try:
            self.conn, addr = self.listener.accept()
            self.conn.settimeout(None)
            print(f"viewer connected: {addr}")
        except (BlockingIOError, socket.timeout):
            pass

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer closed mid-message")
            buf += chunk
        return buf

    def _read_msg(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def poll(self) -> ViewerRequest | None:
        """Non-blocking: a request when a viewer message is pending, else
        None (also when the viewer has disconnected)."""
        if self.conn is None:
            self._try_connect()
            if self.conn is None:
                return None
        try:
            self.conn.setblocking(False)
            peek = self.conn.recv(1, socket.MSG_PEEK)
            if not peek:
                self.conn = None
                return None
        except (BlockingIOError, socket.timeout):
            return None
        finally:
            if self.conn is not None:
                self.conn.setblocking(True)
        msg = self._read_msg()
        if msg["resolution_x"] == 0 or msg["resolution_y"] == 0:
            return ViewerRequest(camera=None,
                                 do_training=bool(msg.get("train", True)),
                                 keep_alive=bool(msg.get("keep_alive", True)))
        return ViewerRequest(camera=request_camera(msg, self.device),
                             do_training=bool(msg["train"]),
                             keep_alive=bool(msg["keep_alive"]),
                             scaling_modifier=float(msg["scaling_modifier"]))

    def send_image(self, img_chw: torch.Tensor, verify: str) -> None:
        """A (3,H,W) float frame in [0,1]: clipped and converted to u8 on its
        device (truncating, as the JAX package's numpy cast), its (H,W,3)
        bytes copied to the host and sent, then the verify string."""
        if self.conn is None:
            return
        u8 = (img_chw.clamp(0, 1) * 255).to(torch.uint8).permute(1, 2, 0)
        self.conn.sendall(u8.contiguous().cpu().numpy().tobytes())
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))
