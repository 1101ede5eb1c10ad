"""NVS render + metrics CLI, the port's counterpart of the root
``render_eval.py`` (same flags, plus ``--device``):

  python -m vcr_gaus_tpu_torch.render_eval --cfg_path output/run/config.yaml \
      [--skip_train] [--skip_test] [--iteration N] [--lpips_weights W.npz] \
      [--device cuda|cpu]

Loads ``point_cloud/iteration_<N>/point_cloud.ply`` beside the config,
renders every view of the scene's train and test splits to
``<split>/ours_<N>/{renders,gt}`` and prints PSNR/SSIM per split, and LPIPS
where weights are given (``--lpips_weights`` sets ``$LPIPS_WEIGHTS``; the
value ``placeholder`` generates random stand-in weights).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def main(argv: list[str] | None = None) -> dict[str, dict]:
    """Returns {split: {"PSNR": ..., "SSIM": ...[, "LPIPS": ...]}} for the
    rendered splits."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg_path", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--skip_test", action="store_true")
    ap.add_argument("--lpips_weights", default=None,
                    help="combined LPIPS npz from scripts/convert_lpips.py"
                         " (default: $LPIPS_WEIGHTS); adds the LPIPS column")
    ap.add_argument("--device", default="cuda")
    args, overrides = ap.parse_known_args(argv)
    if args.lpips_weights:
        os.environ["LPIPS_WEIGHTS"] = args.lpips_weights

    from .config import Config
    from .data.scene import load_scene_info
    from .evaluation import nvs
    from .models import ply_io
    from .render.renderer import RenderConfig
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = Config(args.cfg_path, overrides=overrides)
    logdir = os.path.dirname(os.path.abspath(args.cfg_path))
    if args.iteration > 0:
        it = args.iteration
    else:
        dirs = glob.glob(os.path.join(logdir, "point_cloud", "iteration_*"))
        it = max(int(os.path.basename(d).split("_")[1]) for d in dirs)
    state = ply_io.load_gaussian_ply(
        os.path.join(logdir, "point_cloud", f"iteration_{it}",
                     "point_cloud.ply"),
        max_sh_degree=cfg.model.sh_degree, device=device)
    info = load_scene_info(cfg.model.source_path,
                           images_dir=cfg.model.images,
                           eval_split=cfg.model.eval,
                           llffhold=cfg.model.llffhold,
                           ratio=cfg.model.ratio,
                           use_meta_split=cfg.model.split,
                           resolution=cfg.model.resolution,
                           data_device=str(getattr(cfg.model, "data_device",
                                                   "host")))
    cam0 = info.train_cameras[0]
    rcfg = RenderConfig(width=cam0.width, height=cam0.height,
                        depth_mode=cfg.model.depth_type, mask_depth_thr=1e9)
    bg = np.array([1, 1, 1] if cfg.model.white_background else [0, 0, 0],
                  np.float32)
    results = {}
    for name, cams, skip in (
            ("train", info.train_cameras, args.skip_train),
            ("test", info.test_cameras, args.skip_test)):
        if skip or not cams:
            continue
        out_dir = os.path.join(logdir, name, f"ours_{it}")
        nvs.render_sets(state, cams, rcfg, bg, out_dir,
                        sh_degree=cfg.model.sh_degree,
                        scene_extent=info.radius, device=device)
        results[name] = nvs.evaluate_dir(out_dir, device=device)
        print(name, results[name])
    return results


if __name__ == "__main__":
    main()
