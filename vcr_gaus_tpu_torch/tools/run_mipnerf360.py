"""Mip-NeRF 360 pipeline, the port's counterpart of
scripts/run_mipnerf360.py (same flags, plus ``--device``): train with the
test split held out -> render the test set -> PSNR/SSIM; then the mean
PSNR. A failed stage stops the run.

  python -m vcr_gaus_tpu_torch.tools.run_mipnerf360 --data_root data/360_v2 \
      --out output/360 [--scenes garden bicycle] [--device cuda|cpu] [--dry]
"""

from __future__ import annotations

import argparse
import json
import os

from .stages import check, cli

SCENES = ["bicycle", "bonsai", "counter", "garden", "kitchen", "room",
          "stump", "flowers", "treehill"]


def train_argv(src: str, logdir: str, iterations: int | None,
               device: str) -> list[str]:
    argv = ["--config=configs/360_v2/base.yaml", f"--model.source_path={src}",
            f"--logdir={logdir}", "--model.eval"]
    if iterations:
        argv.append(f"--optim.iterations={iterations}")
    return argv + [f"--device={device}"]


def render_argv(logdir: str, device: str) -> list[str]:
    return [f"--cfg_path={logdir}/config.yaml", "--skip_train",
            f"--device={device}"]


def main(argv: list[str] | None = None) -> dict:
    """Returns {scene: test-set results} of the scenes scored."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--out", default="output/360")
    ap.add_argument("--scenes", nargs="*", default=SCENES)
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args(argv)

    results = {}
    for scene in args.scenes:
        logdir = os.path.join(args.out, scene)
        src = os.path.join(args.data_root, scene)
        check(cli("train", train_argv(src, logdir, args.iterations,
                                      args.device)), args.dry)
        check(cli("render_eval", render_argv(logdir, args.device)),
              args.dry)
        rj = os.path.join(logdir, "test")
        if os.path.isdir(rj):
            runs = sorted(os.listdir(rj))
            if runs:
                with open(os.path.join(rj, runs[-1], "results.json")) as f:
                    results[scene] = json.load(f)
    if results:
        print(json.dumps({
            "per_scene": results,
            "mean_psnr": sum(r["PSNR"] for r in results.values())
            / len(results)}, indent=2))
    return results


if __name__ == "__main__":
    main()
