"""The full NVS evaluation, the port's counterpart of
scripts/full_eval.py (same flags, plus ``--device``): train, render and
score PSNR/SSIM over the 3DGS benchmark suite (Mip-NeRF 360 outdoor and
indoor, Tanks and Temples truck and train, Deep Blending), rendering each
scene at iterations 7000 and 30000. A failed stage is reported and the
others go on; the exit code is 1 when any failed.

  python -m vcr_gaus_tpu_torch.tools.full_eval --mipnerf360 <dir> \
      --tanksandtemples <dir> --deepblending <dir> [--output_path eval] \
      [--skip_training] [--skip_rendering] [--skip_metrics] \
      [--device cuda|cpu] [--dry]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .stages import cli, run

M360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
M360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TNT = ["truck", "train"]
DB = ["drjohnson", "playroom"]
RENDER_ITERATIONS = (7000, 30000)


def scene_jobs(args):
    """(scene, source_dir, config, resolution) per benchmark scene."""
    jobs = []
    for s in M360_OUTDOOR:
        jobs.append((s, os.path.join(args.mipnerf360, s),
                     "configs/360_v2/base.yaml", 4))
    for s in M360_INDOOR:
        jobs.append((s, os.path.join(args.mipnerf360, s),
                     "configs/360_v2/base.yaml", 2))
    for s in TNT:
        jobs.append((s, os.path.join(args.tanksandtemples, s),
                     "configs/tnt/base.yaml", -1))
    for s in DB:
        jobs.append((s, os.path.join(args.deepblending, s),
                     "configs/reconstruct.yaml", -1))
    return jobs


def train_argv(config: str, src: str, logdir: str, resolution: int,
               device: str) -> list[str]:
    argv = [f"--config={config}", f"--model.source_path={src}",
            f"--logdir={logdir}", "--model.eval"]
    if resolution > 0:
        argv.append(f"--model.resolution={resolution}")
    return argv + [f"--device={device}"]


def render_argv(logdir: str, iteration: int, device: str) -> list[str]:
    return [f"--cfg_path={logdir}/config.yaml", f"--iteration={iteration}",
            "--skip_train", f"--device={device}"]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip_training", action="store_true")
    ap.add_argument("--skip_rendering", action="store_true")
    ap.add_argument("--skip_metrics", action="store_true")
    ap.add_argument("--output_path", default="./eval")
    ap.add_argument("--mipnerf360", "-m360", default="")
    ap.add_argument("--tanksandtemples", "-tat", default="")
    ap.add_argument("--deepblending", "-db", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args(argv)

    if not (args.skip_training and args.skip_rendering):
        for flag in ("mipnerf360", "tanksandtemples", "deepblending"):
            if not getattr(args, flag):
                ap.error(f"--{flag} is required unless both training and "
                         "rendering are skipped")
    jobs = scene_jobs(args)
    failures: list = []

    def stage(module, stage_argv):
        cmd = cli(module, stage_argv)
        rc = run(cmd, args.dry)
        if rc:
            print(f"!! stage failed rc={rc}: {' '.join(cmd)}", flush=True)
            failures.append({"cmd": cmd, "returncode": rc})

    if not args.skip_training:
        for scene, src, config, res in jobs:
            stage("train", train_argv(config, src,
                                      os.path.join(args.output_path, scene),
                                      res, args.device))

    if not args.skip_rendering:
        for scene, _, _, _ in jobs:
            for iteration in RENDER_ITERATIONS:
                stage("render_eval", render_argv(
                    os.path.join(args.output_path, scene), iteration,
                    args.device))

    if not args.skip_metrics and not args.dry:
        results = {}
        for scene, _, _, _ in jobs:
            path = os.path.join(args.output_path, scene, "results.json")
            if os.path.isfile(path):
                with open(path) as f:
                    results[scene] = json.load(f)
        print(json.dumps(results, indent=2))

    if failures:
        print(f"!! {len(failures)} stage(s) failed:", flush=True)
        for f in failures:
            print(f"   rc={f['returncode']}: {' '.join(f['cmd'])}",
                  flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
