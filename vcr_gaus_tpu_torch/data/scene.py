"""Scene loading: COLMAP / Blender readers (vcr_gaus_tpu/data/scene.py).

Images stay u8 on the host ((3,H,W) uint8, lossless for PNG/JPEG sources),
normal priors f16, depth priors f32 and masks int32;
``Camera.arrays(device)`` turns them into tensors on the device per use.
The priors are read with numpy and PIL as the JAX package reads them with
OpenCV: a 16-bit depth PNG keeps its integers, a colour mask PNG gives its
blue channel (OpenCV's channel 0, BGR), a palette PNG the blue value of
each index's colour.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.knn import remove_radius_outlier
from ..utils import colmap as CM
from ..utils import graphics as G
from ..utils.ply import read_points_ply, write_points_ply
from .cameras import Camera


@dataclass
class SceneInfo:
    points: np.ndarray               # (N,3)
    colors: np.ndarray               # (N,3) in [0,1]
    train_cameras: list[Camera]
    test_cameras: list[Camera]
    translate: np.ndarray            # nerf++ recenter
    radius: float                    # cameras_extent
    ply_path: str
    trans: np.ndarray                # meta.json box transform (3,) or (4,4)
    scale: np.ndarray                # meta.json box scale (3,) or scalar
    first_name: str = ""


def nerfpp_norm(cams: list[Camera]) -> tuple[np.ndarray, float]:
    """Center/radius from the camera centers."""
    centers = np.stack([c.camera_center for c in cams], axis=0)
    center = centers.mean(0)
    diagonal = np.linalg.norm(centers - center, axis=1).max()
    return -center, float(diagonal * 1.1)


def bound_by_points(xyz: np.ndarray):
    """Box when meta.json is absent: trans = centroid, scale = 1.1 max|xyz|."""
    center = xyz.mean(axis=0)
    radius = np.abs(xyz).max(0) * 1.1
    return center.astype(np.float32), radius.astype(np.float32)


def _load_image(path: str, resolution: tuple[int, int]) -> np.ndarray:
    """(3,H,W) uint8."""
    from PIL import Image
    img = Image.open(path)
    if img.size != resolution:
        img = img.resize(resolution)
    return np.asarray(img.convert("RGB"), np.uint8).transpose(2, 0, 1)


def _resolve_resolution(orig_w: int, orig_h: int, resolution: int,
                        resolution_scale: float = 1.0) -> tuple[int, int]:
    """-1 = auto (cap width at 1600), 1/2/4/8 = integer downscale, else the
    target width."""
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def _resize_bilinear(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W) or (C, H, W) float32 resized by half-pixel bilinear
    interpolation without antialiasing (OpenCV's INTER_LINEAR)."""
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    t = t[None, None] if t.ndim == 2 else t[None]
    out = torch.nn.functional.interpolate(t, size=(h, w), mode="bilinear",
                                          align_corners=False,
                                          antialias=False)[0]
    return (out[0] if arr.ndim == 2 else out).numpy()


def _resize_nearest(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W) resized as OpenCV's INTER_NEAREST: source index
    floor(dst / (dst_size / src_size)) in double precision."""
    sh, sw = arr.shape
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(
        np.int64), sh - 1)
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(
        np.int64), sw - 1)
    return arr[ys][:, xs]


def _read_png(path: str) -> np.ndarray:
    """A PNG's samples as OpenCV's IMREAD_UNCHANGED gives them, with the
    colour channels in RGB(A) order: 16-bit greyscale stays uint16, a
    palette expands to its colours."""
    from PIL import Image
    with Image.open(path) as img:
        if img.mode == "P":
            img = img.convert("RGB")
        return np.asarray(img)


def _load_aux(base: str, name: str, kind: str,
              resolution: tuple[int, int]) -> np.ndarray | None:
    """The prior of image ``name`` under ``base``, resized to
    ``resolution`` (W, H) when it differs, or None when absent: depth
    (H, W) float32 from ``<stem>.npz`` (``arr_0``) or a (16-bit) ``.png``;
    normal (3, H, W) float16 from ``<stem>.npz`` ((3,H,W) or (H,W,3)); mask
    (H, W) int32 from ``<stem>.png``, else from ``name[1:]``, the first
    letter dropped as the reference's reader does. A colour mask gives its
    blue channel (PIL's channel 2; a grey-alpha one its grey)."""
    stem = os.path.splitext(name)[0]
    w, h = resolution
    if kind in ("depth", "normal"):
        npz = os.path.join(base, stem + ".npz")
        png = os.path.join(base, stem + ".png")
        if os.path.exists(npz):
            with np.load(npz) as z:
                arr = z["arr_0"].astype(np.float32)
        elif kind == "depth" and os.path.exists(png):
            arr = _read_png(png).astype(np.float32)
        else:
            return None
        if kind == "normal":
            if arr.shape[0] != 3:
                arr = arr.transpose(2, 0, 1)
            if arr.shape[1:] != (h, w):
                arr = _resize_bilinear(arr, h, w)
            # float16 as the JAX package keeps it (the priors ship as f16)
            return arr.astype(np.float16)
        if arr.shape[:2] != (h, w):
            arr = _resize_bilinear(arr, h, w)
        return arr
    if kind == "mask":
        p = os.path.join(base, stem + ".png")
        if not os.path.exists(p):
            p = os.path.join(base, name[1:])
        if not os.path.exists(p):
            return None
        m = _read_png(p)
        if m.ndim == 3:
            m = m[..., 2] if m.shape[2] >= 3 else m[..., 0]
        if m.shape != (h, w):
            m = _resize_nearest(m, h, w)
        return m.astype(np.int32)
    return None


def _aux_exists(base: str, name: str, kind: str) -> bool:
    """Whether ``_load_aux`` would find a file, by path probes only (the
    lazy mode's has_* flags)."""
    stem = os.path.splitext(name)[0]
    if kind in ("depth", "normal"):
        if os.path.exists(os.path.join(base, stem + ".npz")):
            return True
        return kind == "depth" and os.path.exists(
            os.path.join(base, stem + ".png"))
    if kind == "mask":
        return (os.path.exists(os.path.join(base, stem + ".png"))
                or os.path.exists(os.path.join(base, name[1:])))
    return False


def read_colmap_scene(
    path: str,
    images_dir: str = "images",
    eval_split: bool = False,
    llffhold: int = 8,
    ratio: float = 0.0,
    use_meta_split: bool = False,
    load_depth: bool = False,
    load_normal: bool = False,
    load_mask: bool = False,
    normal_folder: str = "normals",
    depth_folder: str = "depths",
    resolution: int = -1,
    filter_pcd: bool = True,
    data_device: str = "host",
) -> SceneInfo:
    """data_device: 'host' keeps u8 images and the priors in host RAM;
    'lazy' keeps only their paths and decodes on each use. The priors of
    image ``x.png`` live beside the image folder: ``<normal_folder>/x.npz``,
    ``<depth_folder>/x.npz`` (or ``x.png``) and ``masks/x.png``."""
    colmap_dir = os.path.join(path, "sparse/0")
    if not os.path.exists(colmap_dir):
        colmap_dir = os.path.join(path, "sparse")
    try:
        extr = CM.read_images_binary(os.path.join(colmap_dir, "images.bin"))
        intr = CM.read_cameras_binary(os.path.join(colmap_dir, "cameras.bin"))
    except FileNotFoundError:
        extr = CM.read_images_text(os.path.join(colmap_dir, "images.txt"))
        intr = CM.read_cameras_text(os.path.join(colmap_dir, "cameras.txt"))

    img_root = os.path.join(path, images_dir)
    cams = []
    for key in extr:
        e = extr[key]
        ic = intr[e.camera_id]
        R = CM.qvec_to_rotmat(e.qvec).T
        T = np.asarray(e.tvec)
        if ic.model == "SIMPLE_PINHOLE":
            fovx = G.focal2fov(ic.params[0], ic.width)
            fovy = G.focal2fov(ic.params[0], ic.height)
        elif ic.model == "PINHOLE":
            fovx = G.focal2fov(ic.params[0], ic.width)
            fovy = G.focal2fov(ic.params[1], ic.height)
        else:
            raise ValueError(f"unsupported camera model {ic.model} "
                             "(undistort with COLMAP first)")
        name = os.path.basename(e.name)
        res = _resolve_resolution(ic.width, ic.height, resolution)
        img_path = os.path.join(img_root, name)
        aux_bases = {"depth": img_root.replace("images", depth_folder),
                     "normal": img_root.replace("images", normal_folder),
                     "mask": img_root.replace("images", "masks")}
        wanted = {"depth": load_depth, "normal": load_normal,
                  "mask": load_mask}
        specs = {"image": lambda p=img_path, r=res: _load_image(p, r)}
        for kind, base in aux_bases.items():
            if wanted[kind]:
                specs[kind] = (lambda b=base, n=name, r=res, k=kind:
                               _load_aux(b, n, k, r))
        if data_device == "lazy":
            # path probes only, so the has_* flags are known without decoding
            loaders = {k: fn for k, fn in specs.items()
                       if k == "image" or _aux_exists(aux_bases[k], name, k)}
            eager = {}
        else:
            loaders = None
            eager = {k: v for k, v in ((k, fn()) for k, fn in specs.items())
                     if v is not None}
        cams.append(Camera(
            colmap_id=ic.id, idx=0, image_name=os.path.splitext(name)[0],
            R=R, T=T, fovx=fovx, fovy=fovy, width=res[0], height=res[1],
            image=eager.get("image"), depth=eager.get("depth"),
            normal=eager.get("normal"), mask=eager.get("mask"),
            loaders=loaders))
    cams.sort(key=lambda c: c.image_name)

    # meta.json box normalization
    meta_path = os.path.join(path, "meta.json")
    pts_xyz = pts_rgb = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        trans = np.array(meta["trans"], np.float32)
        scale = np.array(meta["scale"], np.float32)
    else:
        meta = {}
        pts_xyz, pts_rgb = _read_points(colmap_dir)
        trans, scale = bound_by_points(pts_xyz)
        with open(meta_path, "w") as f:
            json.dump({"trans": trans.tolist(), "scale": scale.tolist()}, f,
                      indent=4)

    if ratio > 0:
        len_train = int(len(cams) * ratio)
        hold = len(cams) // len_train
        train_idx = set(i * hold for i in range(len_train))
        train = [cams[i] for i in sorted(train_idx)]
        test = [cams[i] for i in range(len(cams)) if i not in train_idx]
    elif eval_split:
        if use_meta_split and "test" in meta:
            train = [c for c in cams if c.image_name in meta["train"]]
            test = [c for c in cams if c.image_name in meta["test"]]
        else:
            train = [c for i, c in enumerate(cams) if i % llffhold != 0]
            test = [c for i, c in enumerate(cams) if i % llffhold == 0]
    else:
        train, test = cams, []

    translate, radius = nerfpp_norm(train)

    # init point cloud (PLY cache with box + outlier filtering)
    ply_path = os.path.join(colmap_dir, "points3D.ply")
    if not os.path.exists(ply_path):
        if pts_xyz is None:
            pts_xyz, pts_rgb = _read_points(colmap_dir)
        if filter_pcd:
            pts_xyz, pts_rgb = filter_point_cloud(trans, scale, pts_xyz,
                                                  pts_rgb)
        write_points_ply(ply_path, pts_xyz, pts_rgb)
    points, colors, _ = read_points_ply(ply_path)

    # stable appearance-embedding indices
    train = [dataclasses.replace(c, idx=i) for i, c in enumerate(train)]
    test = [dataclasses.replace(c, idx=len(train) + i)
            for i, c in enumerate(test)]

    first_name = (test[0] if eval_split and test else cams[0]).image_name
    return SceneInfo(points=points, colors=colors, train_cameras=train,
                     test_cameras=test, translate=translate, radius=radius,
                     ply_path=ply_path, trans=trans, scale=scale,
                     first_name=first_name)


def _read_points(colmap_dir: str):
    bin_path = os.path.join(colmap_dir, "points3D.bin")
    if os.path.exists(bin_path):
        xyz, rgb, _ = CM.read_points3d_binary(bin_path)
    else:
        xyz, rgb, _ = CM.read_points3d_text(
            os.path.join(colmap_dir, "points3D.txt"))
    return xyz, rgb.astype(np.float64) / 255.0


def filter_point_cloud(trans, scale, xyz, rgb, nb_points=5, radius=0.1):
    """Radius-outlier removal of the points inside the 1.5x box, by
    ``ops.knn.remove_radius_outlier`` on the host (the JAX package's
    counts: exact up to ``knn.EXACT_MAX_N`` points, its Morton windows
    above); points outside pass through."""
    trans = np.asarray(trans, np.float32)
    x = np.asarray(xyz, np.float32)
    if trans.ndim == 1:
        pts_norm = (x - trans) / scale
    else:
        pts_norm = (x @ trans[:3, :3].T + trans[:3, 3]) / scale
    inside = np.all(np.abs(pts_norm) < 1.5, axis=-1)
    if inside.sum() < 10:
        return xyz, rgb
    keep_inside = remove_radius_outlier(
        torch.as_tensor(x[inside]), nb_points, radius).numpy()
    if keep_inside.mean() < 0.1:
        # the radius is tuned for dense COLMAP clouds; on sparse clouds it
        # would discard everything, so skip rather than destroy the init
        return xyz, rgb
    keep = np.ones(len(xyz), bool)
    keep[np.where(inside)[0][~keep_inside]] = False
    return xyz[keep], rgb[keep]


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = True,
                       extension: str = ".png") -> SceneInfo:
    """NeRF-synthetic reader (transforms_{train,test}.json)."""
    from PIL import Image

    def read_split(fname, idx0):
        with open(os.path.join(path, fname)) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        cams = []
        for i, frame in enumerate(contents["frames"]):
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1                     # OpenGL -> COLMAP axes
            w2c = np.linalg.inv(c2w)
            R = w2c[:3, :3].T
            T = w2c[:3, 3]
            img_path = os.path.join(path, frame["file_path"] + extension)
            img = Image.open(img_path)
            data = np.asarray(img.convert("RGBA"), np.float32) / 255.0
            bg = np.ones(3) if white_background else np.zeros(3)
            rgb = data[..., :3] * data[..., 3:] + bg * (1 - data[..., 3:])
            fovy = G.focal2fov(G.fov2focal(fovx, img.size[0]), img.size[1])
            cams.append(Camera(
                colmap_id=i, idx=idx0 + i,
                image_name=os.path.splitext(os.path.basename(img_path))[0],
                R=R, T=T, fovx=fovx, fovy=fovy,
                width=img.size[0], height=img.size[1],
                image=rgb.transpose(2, 0, 1).astype(np.float32)))
        return cams

    train = read_split("transforms_train.json", 0)
    test = read_split("transforms_test.json", len(train))
    if not eval_split:
        train = train + test
        test = []
    translate, radius = nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        from ..utils.sh import sh_to_rgb
        rng = np.random.default_rng(0)
        xyz = rng.random((100_000, 3)) * 2.6 - 1.3
        cols = sh_to_rgb(rng.random((100_000, 3)) / 255.0)
        write_points_ply(ply_path, xyz, cols)
    points, colors, _ = read_points_ply(ply_path)
    trans, scale = bound_by_points(points)
    return SceneInfo(points=points, colors=colors, train_cameras=train,
                     test_cameras=test, translate=translate, radius=radius,
                     ply_path=ply_path, trans=trans, scale=scale,
                     first_name=train[0].image_name)


def load_scene_info(source_path: str, **kwargs) -> SceneInfo:
    """Dispatch by directory layout."""
    if os.path.exists(os.path.join(source_path, "sparse")):
        return read_colmap_scene(source_path, **kwargs)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        blender_keys = {"white_background", "eval_split", "extension"}
        kw = {k: v for k, v in kwargs.items() if k in blender_keys}
        return read_blender_scene(source_path, **kw)
    raise ValueError(f"could not recognize scene type at {source_path}")


def camera_to_json(idx: int, cam: Camera) -> dict:
    """The ``cameras.json`` entry of a camera (the 3DGS layout)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = cam.R.T
    Rt[:3, 3] = cam.T
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    return {
        "id": idx, "img_name": cam.image_name,
        "width": cam.width, "height": cam.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [r.tolist() for r in c2w[:3, :3]],
        "fy": G.fov2focal(cam.fovy, cam.height),
        "fx": G.fov2focal(cam.fovx, cam.width),
    }
