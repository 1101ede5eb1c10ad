"""The viewer bridge of the port (vcr_gaus_tpu_torch/render/network_gui.py,
render/orbit.py and the trainer's pump) against the JAX package's: the
SIBR protocol over a loopback socket; the request's camera field for field
against JAX ``NetworkGUI.poll`` on the same message at atol 1e-6;
``OrbitCamera`` after a scripted orbit, zoom and pan at atol 1e-6; the
trainer's frame at 32x16 and scaling modifier 0.7 from the JAX Trainer's
state, its bytes at most 1 level from the JAX pump's on at most 0.1% of the
pixels; the pause, resume and disconnect semantics with a scripted GUI;
one forward render per frame; the pump once an iteration."""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from fixtures import write_colmap_scene
from vcr_gaus_tpu.render import network_gui as JG
from vcr_gaus_tpu.render.orbit import OrbitCamera as JOrbit
from vcr_gaus_tpu_torch.models.convert import state_from_arrays
from vcr_gaus_tpu_torch.ops import rasterize as R
from vcr_gaus_tpu_torch.render import network_gui as G
from vcr_gaus_tpu_torch.render.orbit import OrbitCamera

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(REPO, "configs", "config_base.yaml")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def message(w, h, view=None, proj=None, train=True, sm=1.0, fovx=0.8,
            fovy=0.6):
    """A SIBR viewer message; ``view``/``proj`` in the viewer's convention
    (row-major, columns negated as the viewer sends them)."""
    eye = np.eye(4).reshape(-1).tolist()
    return {"resolution_x": w, "resolution_y": h, "train": train,
            "fov_y": fovy, "fov_x": fovx, "z_near": 0.01, "z_far": 100.0,
            "shs_python": False, "rot_scale_python": False,
            "keep_alive": True, "scaling_modifier": sm,
            "view_matrix": eye if view is None else view,
            "view_projection_matrix": eye if proj is None else proj}


class Client:
    """A viewer on a thread: sends ``msgs`` one after the other, reading
    a frame (``w*h*3`` bytes and the verify string) after each message
    with a camera."""

    def __init__(self, port, msgs):
        self.port, self.msgs = port, msgs
        self.frames, self.verify = [], []
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()

    def recv(self, s, n):
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError
            buf += chunk
        return buf

    def run(self):
        with socket.create_connection(("127.0.0.1", self.port)) as s:
            for msg in self.msgs:
                data = json.dumps(msg).encode()
                s.sendall(len(data).to_bytes(4, "little") + data)
                w, h = msg["resolution_x"], msg["resolution_y"]
                if w and h:
                    self.frames.append(self.recv(s, w * h * 3))
                    n = int.from_bytes(self.recv(s, 4), "little")
                    self.verify.append(self.recv(s, n).decode())

    def join(self):
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def wait_poll(gui):
    for _ in range(400):
        req = gui.poll()
        if req is not None:
            return req
        time.sleep(0.02)
    raise AssertionError("no request arrived")


def test_network_gui_roundtrip():
    gui = G.NetworkGUI("127.0.0.1", 0, "cpu")
    try:
        client = Client(gui.listener.getsockname()[1], [message(16, 8)])
        req = wait_poll(gui)
        assert req.camera is not None and req.do_training
        assert req.camera.intr.shape == (4,)
        assert req.camera.image.shape == (3, 8, 16)
        img = torch.linspace(-0.5, 1.5, 3 * 8 * 16).reshape(3, 8, 16)
        gui.send_image(img, "ok")
        client.join()
        assert client.verify == ["ok"]
        want = (np.clip(img.numpy(), 0, 1) * 255).astype(np.uint8)
        assert client.frames[0] == want.transpose(1, 2, 0).tobytes()
    finally:
        gui.close()


def test_request_camera_matches_jax_poll():
    """A non-square request with a rotated view: the port's camera equals
    the one JAX's poll builds from the same message."""
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    view = np.eye(4)
    view[:3, :3], view[3, :3] = q, rng.normal(size=3)
    proj = rng.normal(size=(4, 4))
    msg = message(40, 24, view.reshape(-1).tolist(),
                  proj.reshape(-1).tolist(), sm=0.5, fovx=1.1, fovy=0.7)
    reqs = []
    for gui in (JG.NetworkGUI("127.0.0.1", 0),
                G.NetworkGUI("127.0.0.1", 0, "cpu")):
        client = Client(gui.listener.getsockname()[1],
                        [dict(msg, resolution_x=0), msg])
        first = wait_poll(gui)
        assert first.camera is None and first.do_training
        reqs.append(wait_poll(gui))
        gui.send_image(np.zeros((3, 24, 40), np.float32) if len(reqs) == 1
                       else torch.zeros(3, 24, 40), "v")
        client.join()
        gui.listener.close()
    want, got = reqs
    assert got.scaling_modifier == want.scaling_modifier == 0.5
    assert got.do_training == want.do_training
    assert got.keep_alive == want.keep_alive
    for name in want.camera._fields:
        w = np.asarray(getattr(want.camera, name))
        g = getattr(got.camera, name)
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu", name
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=name)


def test_orbit_camera_matches_jax():
    want, got = JOrbit(640, 480, radius=3.0), OrbitCamera(640, 480,
                                                           radius=3.0)
    for cam in (want, got):
        cam.orbit(100.0, 30.0)
        cam.scale(2)
        cam.pan(10, -5, 2)
        cam.orbit(-40.0, 12.5)
    for name in ("pose", "campos", "view", "perspective", "intrinsics",
                 "mvp", "rot", "center", "fovx", "radius"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    R_ = got.rot
    np.testing.assert_allclose(R_ @ R_.T, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(got.view @ got.pose, np.eye(4), atol=1e-6)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The JAX Trainer and the port's on one scene, the port's state the
    JAX Trainer's (random SH coefficients of every degree) carried across
    by models/convert."""
    import jax.numpy as jnp

    from test_torch_train import jax_state_arrays
    from vcr_gaus_tpu.config import Config as JConfig
    from vcr_gaus_tpu.train.trainer import Trainer as JTrainer
    from vcr_gaus_tpu_torch.config import Config
    from vcr_gaus_tpu_torch.train.trainer import Trainer

    root = tmp_path_factory.mktemp("viewer")
    scene = str(root / "scene")
    write_colmap_scene(scene, n_cams=3, n_pts=120, width=48, height=32)
    ov = ["--model.resolution=1", "--model.depth_type=traditional",
          "--tpu.capacity=256", f"--model.source_path={scene}"]
    jtr = JTrainer(JConfig(BASE, overrides=ov + [f"--logdir={root / 'j'}"]))
    ptr = Trainer(Config(BASE, overrides=ov + [f"--logdir={root / 'p'}"]),
                  device="cpu")
    rng = np.random.default_rng(6)
    p = jtr.state.params
    jtr.state = jtr.state._replace(params=p._replace(
        f_rest=jnp.asarray(rng.normal(scale=0.2, size=p.f_rest.shape),
                           jnp.float32),
        log_scale=p.log_scale + jnp.asarray(
            rng.uniform(-0.5, 0.5, p.log_scale.shape), jnp.float32)))
    ptr.state = state_from_arrays(jax_state_arrays(jtr.state), "cpu")
    return jtr, ptr


def scene_message(ptr, w, h, sm, train=True):
    """The port scene's first camera as the viewer sends it."""
    cam = ptr.scene.train_cameras[0]
    arr = cam.arrays("cpu")
    view = arr.viewmatrix.numpy().copy()
    view[:, 1:3] *= -1
    proj = arr.projmatrix.numpy().copy()
    proj[:, 1] *= -1
    return message(w, h, view.reshape(-1).tolist(),
                   proj.reshape(-1).tolist(), train=train, sm=sm,
                   fovx=cam.fovx, fovy=cam.fovy)


def serve(tr, gui, msgs):
    """``msgs`` through ``gui`` as the trainer's viewer; the pump runs
    until the client has its frames."""
    tr._gui = gui
    client = Client(gui.listener.getsockname()[1], msgs)
    want = sum(1 for m in msgs if m["resolution_x"])
    for _ in range(600):
        tr._gui_pump()
        if len(client.frames) == want:
            break
        time.sleep(0.02)
    client.join()
    return client


def test_pump_frame_matches_jax(trainers, monkeypatch):
    jtr, ptr = trainers
    calls = []
    fwd = R.rasterize_forward

    def counting(*a, **k):
        calls.append(1)
        return fwd(*a, **k)

    monkeypatch.setattr(R, "rasterize_forward", counting)
    msg = scene_message(ptr, 32, 16, 0.7)
    frames = []
    for tr, gui in ((jtr, JG.NetworkGUI("127.0.0.1", 0)),
                    (ptr, G.NetworkGUI("127.0.0.1", 0, "cpu"))):
        try:
            client = serve(tr, gui, [msg, msg])
        finally:
            gui.close() if hasattr(gui, "close") else gui.listener.close()
            tr._gui = None
        assert client.verify == [tr.cfg.model.source_path] * 2
        assert client.frames[0] == client.frames[1]
        frames.append(np.frombuffer(client.frames[0], np.uint8).reshape(
            16, 32, 3).astype(np.int16))
    assert len(calls) == 2                   # one forward render a frame
    want, got = frames
    assert want.max() > 0 and len(np.unique(want)) > 8
    diff = np.abs(got - want).max(-1)
    assert diff.max() <= 1
    assert (diff > 0).sum() <= 0.001 * diff.size
    # the modifier shrinks the splats: the frame at 1.0 differs
    one = ptr.gui_frame(G.request_camera(msg, torch.device("cpu")), 1.0)
    assert ptr._gui_rcfgs.keys() == {(32, 16)}
    u8 = (one.clamp(0, 1) * 255).to(torch.uint8).permute(1, 2, 0).numpy()
    assert not np.array_equal(u8, got.astype(np.uint8))


class ScriptedGUI:
    """poll() answers from a script, then None; connected until told."""

    def __init__(self, script):
        self.script = list(script)
        self.conn = object()
        self.sent = 0

    def poll(self):
        return self.script.pop(0) if self.script else None

    def send_image(self, img, verify):
        self.sent += 1


def test_pump_pause_resume_disconnect(trainers):
    _, ptr = trainers
    pause = G.ViewerRequest(camera=None, do_training=False, keep_alive=True)
    resume = G.ViewerRequest(camera=None, do_training=True, keep_alive=True)
    cam = G.request_camera(message(8, 8), torch.device("cpu"))
    paused_frame = G.ViewerRequest(camera=cam, do_training=False,
                                   keep_alive=True)
    try:
        gui = ScriptedGUI([pause, None, None, paused_frame, None, resume])
        ptr._gui = gui
        ptr._gui_pump()                  # consumes through the resume
        assert not gui.script and not ptr._gui_paused and gui.sent == 1
        # nothing pending and not paused: returns at once
        ptr._gui_pump()
        # a viewer that drops while paused releases the pump
        gui = ScriptedGUI([pause, None])
        orig = gui.poll

        def poll_then_drop():
            r = orig()
            if r is None:
                gui.conn = None
            return r
        gui.poll = poll_then_drop
        ptr._gui = gui
        ptr._gui_pump()
        assert ptr._gui_paused and gui.conn is None
    finally:
        ptr._gui, ptr._gui_paused = None, False


def test_train_pumps_once_an_iteration(trainers, monkeypatch):
    _, ptr = trainers
    calls = []
    monkeypatch.setattr(ptr, "_gui_pump", lambda: calls.append(
        ptr.iteration))
    saved = dict(vars(ptr))
    start = ptr.iteration
    try:
        ptr.train(max_iters=start + 3, log_every=100)
    finally:
        vars(ptr).update(saved)
    assert calls == [start, start + 1, start + 2]
