"""The port's debug hooks and the keys it must not drop silently, as
tests/test_trainer_extras.py holds the JAX Trainer's: ``train.debug_from``
turns on anomaly detection and the per-step finite checks from its
iteration on, ``detect_anomaly`` for the whole run, and a positive
``port`` (the viewer bridge, not ported) raises at construction."""

import json
import os

import pytest
import torch

from fixtures import write_colmap_scene
from vcr_gaus_tpu_torch.config import Config
from vcr_gaus_tpu_torch.train import trainer as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(REPO, "configs", "config_base.yaml")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("debug_scene"))
    write_colmap_scene(root, n_cams=3, n_pts=150, width=48, height=32)
    return root


def config(scene, logdir, **more):
    ov = {"logdir": str(logdir), "model.source_path": scene,
          "model.resolution": 1, "model.depth_type": "traditional",
          "tpu.capacity": 256, "optim.densify_from_iter": 10_000, **more}
    return Config(BASE, overrides=[
        f"--{k}={json.dumps(v) if isinstance(v, list) else v}"
        for k, v in ov.items()])


@pytest.fixture
def anomaly_reset():
    before = torch.is_anomaly_enabled()
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(before)


def test_debug_from_enables_anomaly_detection(scene_dir, tmp_path, capsys,
                                              anomaly_reset):
    torch.autograd.set_detect_anomaly(False)
    tr = T.Trainer(config(scene_dir, tmp_path, **{"train.debug_from": 2}),
                   device="cpu")
    tr.train_step()
    assert not tr._debug_on and not torch.is_anomaly_enabled()
    tr.train_step()                   # iteration 1 < debug_from: still off
    assert not tr._debug_on
    tr.train_step()                   # enables at iteration >= 2
    assert tr._debug_on and torch.is_anomaly_enabled()
    assert tr.iteration == 3
    assert ("[debug] NaN tracing + per-step finite checks enabled from "
            "iteration 2") in capsys.readouterr().out
    with pytest.raises(FloatingPointError, match="iteration"):
        tr._debug_check({"total": float("nan")})
    with pytest.raises(FloatingPointError, match="'l1' at iteration 3"):
        tr._debug_check({"total": torch.tensor(1.0),
                         "l1": torch.tensor(float("inf"))})
    tr._debug_check({"total": torch.tensor(0.5)})


def test_debug_check_is_off_before_debug_from(scene_dir, tmp_path,
                                              anomaly_reset):
    tr = T.Trainer(config(scene_dir, tmp_path), device="cpu")
    assert tr._debug_from == -1
    tr.train_step()
    assert not tr._debug_on
    tr._debug_check({"total": float("nan")})       # nothing checks it


def test_detect_anomaly_turns_on_for_the_run(scene_dir, tmp_path,
                                             anomaly_reset):
    torch.autograd.set_detect_anomaly(False)
    tr = T.Trainer(config(scene_dir, tmp_path, detect_anomaly=True),
                   device="cpu")
    assert torch.is_anomaly_enabled()
    losses, _ = tr.train_step()
    assert torch.isfinite(losses["total"])


def test_port_raises_naming_the_viewer(scene_dir, tmp_path):
    with pytest.raises(NotImplementedError, match="viewer"):
        T.Trainer(config(scene_dir, tmp_path, port=6009), device="cpu")
    # the default (-1) trains
    T.Trainer(config(scene_dir, tmp_path / "ok", port=-1), device="cpu")
