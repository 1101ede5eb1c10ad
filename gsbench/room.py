"""The room of an indoor capture: the cameras stand inside it.

Y up, the room an axis-aligned box of ``half_extents`` around ``center``.
The furniture and the views' poses are laid out on the host from the
configuration's ``layout_seed`` (a few dozen numbers), so every run holds
the same room, as a capture is of one room; the run's seed draws the
Gaussians on the device and the views' images. In ``count`` random
slots of ``capacity`` (the slot rule and the generator's salt are
``population.py``'s, as are the colours, the SH rest coefficients, the
random rotations, the one opacity and the N(0, 0.05^2) jitter of the
log-scales), two parts:

- the shell: ``shell.count`` Gaussians on the room's six faces, each face
  drawing its share by area;
- the furniture: ``furniture.count`` on the faces of ``furniture.boxes``
  axis-aligned boxes, each face by area. A box's sides are uniform in
  ``side``; the first ``boxes - raised`` stand on the floor, the others are
  raised by up to ``raise_max``; their centres lie ``wall_clearance`` or
  more from the walls.

Each part is isotropic at ``scale_mult`` times its own mean spacing (the
square root of its area over its count). The views stand in the free
space, ``clearance`` or more from every face and box, at heights in
``y_range``, each looking along a horizontal direction drawn uniformly,
tilted down by ``tilt_deg``; fovy follows fovx from the aspect. The
views named in ``test`` (by index) are meta.json's ``test`` list, the
others its ``train`` list; meta.json's box is the room, ``box_margin``
times its half-extents (the margin the port gives a box it bounds by
points), so that the walls lie inside it. Both the program and the
reference receive exactly these tensors (drawn again for each), nothing
derived from them.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from . import scene as SC
from .population import PARAM_NAMES, SH_C0, generator

# the host draws' salt, beside population.py's device streams (1 the
# population, 2 the images, 3 the side networks)
LAYOUT_SALT = 4
# uniform draws a furniture layout offers the views' centres
CANDIDATES = 16384


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng((int(seed) * 1_000_003 + LAYOUT_SALT)
                                 % (1 << 63))


def furniture(room: dict, rng: np.random.Generator) -> np.ndarray:
    """(boxes, 2, 3) float64: each box's low and high corner."""
    half = np.asarray(room["half_extents"], np.float64)
    c = np.asarray(room["center"], np.float64)
    f = room["furniture"]
    n, raised = int(f["boxes"]), int(f["raised"])
    lo_side, hi_side = f["side"]
    side = rng.uniform(lo_side, hi_side, (n, 3))
    reach = half[[0, 2]] - float(f["wall_clearance"])
    mid = rng.uniform(-reach, reach, (n, 2))
    lift = np.where(np.arange(n) >= n - raised,
                    rng.uniform(0.0, float(f["raise_max"]), n), 0.0)
    bottom = -half[1] + lift
    lo = np.stack([mid[:, 0] - side[:, 0] / 2, bottom,
                   mid[:, 1] - side[:, 2] / 2], 1)
    hi = lo + side
    return np.stack([lo, hi], 1) + c


def _faces(lo: np.ndarray, hi: np.ndarray):
    """(origin, e1, e2) (6 B, 3) of the boxes' faces: a point of a face is
    origin + u e1 + v e2, u and v in [0, 1]."""
    d = hi - lo
    o, a, b = [], [], []
    for ax in range(3):
        u, v = (ax + 1) % 3, (ax + 2) % 3
        eu = np.zeros_like(lo)
        ev = np.zeros_like(lo)
        eu[:, u], ev[:, v] = d[:, u], d[:, v]
        for side in (lo, hi):
            org = lo.copy()
            org[:, ax] = side[:, ax]
            o.append(org)
            a.append(eu)
            b.append(ev)
    return np.concatenate(o), np.concatenate(a), np.concatenate(b)


def _box_distance(p: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(points,) the distance of each point of ``p`` (points, 3) from the
    nearest box."""
    gap = np.maximum(np.maximum(boxes[None, :, 0] - p[:, None],
                                p[:, None] - boxes[None, :, 1]), 0.0)
    return np.linalg.norm(gap, axis=2).min(1)


def furnished(room: dict, views: dict, rng: np.random.Generator):
    """(boxes, centres (count, 3)): the furniture and each view's centre,
    drawn uniformly from the free space. The centres are the first
    ``count`` of ``CANDIDATES`` uniform draws that lie ``clearance`` or
    more from every box; where fewer do, the furniture is drawn again."""
    half = np.asarray(room["half_extents"], np.float64)
    c = np.asarray(room["center"], np.float64)
    clear = float(views["clearance"])
    y0, y1 = views["y_range"]
    lo = np.array([-half[0] + clear, y0, -half[2] + clear]) + c
    hi = np.array([half[0] - clear, y1, half[2] - clear]) + c
    if not (np.all(lo < hi) and c[1] - half[1] + clear <= lo[1]
            and hi[1] <= c[1] + half[1] - clear):
        raise ValueError("the views' heights leave no free space")
    n = int(views["count"])
    for _ in range(1000):
        boxes = furniture(room, rng)
        p = rng.uniform(lo, hi, (CANDIDATES, 3))
        free = p[_box_distance(p, boxes) >= clear]
        if len(free) >= n:
            return boxes, free[:n]
    raise ValueError("no free space for the views in the room")


def look(forward: np.ndarray, center: np.ndarray):
    """(qvec, tvec) world-to-camera of a camera at ``center`` looking
    along ``forward`` (x right, y down in the image, z forward)."""
    z = forward / np.linalg.norm(forward)
    down = np.array([0.0, -1.0, 0.0])
    y = down - (down @ z) * z
    y /= np.linalg.norm(y)
    R = np.stack([np.cross(y, z), y, z])
    return SC.rotmat_to_qvec(R), -R @ center


def layout(cfg_bench: dict) -> dict:
    """The host's draws from ``layout_seed``: the furniture boxes and each
    view's pose."""
    room, views = cfg_bench["room"], cfg_bench["views"]
    rng = _rng(int(cfg_bench["layout_seed"]))
    boxes, centers = furnished(room, views, rng)
    t0, t1 = (math.radians(float(t)) for t in views["tilt_deg"])
    poses = []
    for p in centers:
        yaw = rng.uniform(0.0, 2 * math.pi)
        tilt = rng.uniform(t0, t1)
        fwd = np.array([math.cos(tilt) * math.cos(yaw), -math.sin(tilt),
                        math.cos(tilt) * math.sin(yaw)])
        poses.append(look(fwd, p))
    return {"boxes": boxes, "centers": centers, "poses": poses}


def make_population(cfg_bench: dict, sh_degree: int, ch_sem: int, seed: int,
                    device) -> tuple[dict, torch.Tensor]:
    """(params {name: (capacity, ...) float32}, active (capacity,) bool)."""
    room, pop = cfg_bench["room"], cfg_bench["population"]
    boxes = layout(cfg_bench)["boxes"]
    gen = generator(seed, 1, device)
    n_sh = int(room["shell"]["count"])
    n_fu = int(room["furniture"]["count"])
    n, cap = int(pop["count"]), int(pop["capacity"])
    if n != n_sh + n_fu:
        raise ValueError("the shell and the furniture are the population")
    k = (sh_degree + 1) ** 2 - 1
    half = np.asarray(room["half_extents"], np.float64)
    c = np.asarray(room["center"], np.float64)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def on_faces(lo, hi, m):
        """``m`` points on the faces of the boxes lo-hi by area, and the
        log of ``scale_mult`` times their mean spacing."""
        o, a, b = _faces(lo, hi)
        area = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
        f32 = torch.float32
        o, a, b = (torch.tensor(x, dtype=f32, device=device)
                   for x in (o, a, b))
        face = torch.multinomial(torch.tensor(area, dtype=f32, device=device),
                                 m, replacement=True, generator=gen)
        u, v = rand(m, 1), rand(m, 1)
        xyz = o[face] + u * a[face] + v * b[face]
        s = math.log(float(pop["scale_mult"]) * math.sqrt(area.sum() / m))
        return xyz, torch.full((m, 3), s, device=device)

    shell, shell_s = on_faces((c - half)[None], (c + half)[None], n_sh)
    fu, fu_s = on_faces(boxes[:, 0], boxes[:, 1], n_fu)
    op = float(pop["opacity"])
    dense = {
        "xyz": torch.cat([shell, fu]),
        "f_dc": ((rand(n, 1, 3) - 0.5) / SH_C0),
        "f_rest": 0.1 * randn(n, k, 3),
        "log_scale": torch.cat([shell_s, fu_s]) + 0.05 * randn(n, 3),
        "quat": randn(n, 4),
        "logit_opacity": torch.full((n, 1), math.log(op / (1 - op)),
                                    device=device),
        "obj_dc": (rand(n, 1, ch_sem) - 0.5) / SH_C0,
    }
    slots = torch.randperm(cap, generator=gen, device=device)[:n]
    params = {}
    for name in PARAM_NAMES:
        a = dense[name]
        full = torch.zeros((cap,) + tuple(a.shape[1:]), dtype=torch.float32,
                           device=device)
        full[slots] = a
        params[name] = full
    active = torch.zeros(cap, dtype=torch.bool, device=device)
    active[slots] = True
    return params, active


def split(views: dict) -> tuple[list, list]:
    """(train, test) view indices: meta.json's lists."""
    test = sorted(int(i) for i in views["test"])
    return [i for i in range(int(views["count"])) if i not in test], test


def make_views(cfg_bench: dict, want_normal: bool, seed: int, device):
    """(views, fovx, fovy): each view's pose, its image and its normal
    prior, drawn as ``scene.make_views`` draws them."""
    views = cfg_bench["views"]
    w, h = int(views["width"]), int(views["height"])
    fovx = float(views["fovx"])
    fovy = 2 * math.atan(math.tan(fovx / 2) * h / w)
    gen = generator(seed, 2, device)
    f32 = torch.float32
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=f32),
                            torch.arange(w, device=device, dtype=f32),
                            indexing="ij")
    out = []
    for i, (q, t) in enumerate(layout(cfg_bench)["poses"]):
        ph = torch.rand(6, generator=gen, device=device) * (2 * math.pi)
        img = torch.stack([0.5 + 0.2 * torch.sin(xx / 230.0 + ph[c])
                           * torch.cos(yy / 170.0 + ph[3 + c])
                           for c in range(3)])
        image = (255 * img).to(torch.uint8).cpu().numpy()
        normal = None
        if want_normal:
            nrm = torch.randn((3, h, w), generator=gen, device=device)
            nrm = nrm / torch.linalg.vector_norm(nrm, dim=0, keepdim=True)
            normal = nrm.to(torch.float16).cpu().numpy()
        out.append(SC.View(f"view_{i:03d}", q, t, image, normal, None))
    return out, fovx, fovy


def make_scene(cfg: dict, seed: int, root: str, device,
               weights: dict) -> SC.Scene:
    """Write the room's views under ``root`` (``scene.write_scene``: the
    COLMAP model, the images, the priors and an init cloud, which the run
    replaces, on a sphere inside the room), then meta.json: the room's box
    and the train and test lists."""
    b = cfg["bench"]
    room, views = b["room"], b["views"]
    if "semantic" in weights:
        raise ValueError("the room's views carry no label maps")
    vs, fovx, fovy = make_views(
        b, "mono_normal" in weights or "depth_normal" in weights, seed,
        device)
    half = np.asarray(room["half_extents"], np.float64)
    init = {"shell_center": list(room["center"]),
            "shell_radius": 0.5 * float(half.min())}
    sc = SC.write_scene(root, vs, int(views["width"]), int(views["height"]),
                        fovx, fovy, init, cfg["model"]["normal_folder"],
                        int(b["init_points"]), seed)
    train, test = split(views)
    trans = [float(x) for x in room["center"]]
    scale = (float(room["box_margin"]) * half).tolist()
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump({"trans": trans, "scale": scale,
                   "train": [vs[i].name for i in train],
                   "test": [vs[i].name for i in test]}, f)
    return sc._replace(trans=trans, scale=scale)
