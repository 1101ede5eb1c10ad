"""DTU benchmark pipeline, the port's counterpart of scripts/run_dtu.py
(same flags, plus ``--device``): per scan, train -> mesh (TSDF voxel 0.004,
depth cut at 3) -> Chamfer; then the mean Chamfer. A failed stage stops
the run.

  python -m vcr_gaus_tpu_torch.tools.run_dtu --data_root data/dtu \
      --eval_dir data/dtu_eval --out output/dtu [--scans 24 37] \
      [--device cuda|cpu] [--dry] [dotted train overrides]
"""

from __future__ import annotations

import argparse
import json
import os

from .stages import check, cli

SCANS = [24, 37, 40, 55, 63, 65, 69, 83, 97, 105, 106, 110, 114, 118, 122]


def train_argv(src: str, logdir: str, iterations: int | None,
               overrides: list[str], device: str) -> list[str]:
    argv = ["--config=configs/dtu/base.yaml", f"--model.source_path={src}",
            f"--logdir={logdir}"]
    if iterations:
        argv.append(f"--optim.iterations={iterations}")
    return argv + overrides + [f"--device={device}"]


def mesh_argv(logdir: str, voxel: float, device: str) -> list[str]:
    return [f"--cfg_path={logdir}/config.yaml", f"--voxel_size={voxel}",
            "--max_depth=3", "--prob_thr=0.15", "--num_cluster=1",
            f"--device={device}"]


def eval_argv(logdir: str, eval_dir: str, scan: int,
              device: str) -> list[str]:
    return ["dtu", f"--ply_path={logdir}/ours.ply",
            f"--dataset_dir={eval_dir}", f"--scan={scan}",
            f"--device={device}"]


def main(argv: list[str] | None = None) -> dict:
    """Returns {scan: Chamfer results} of the scans scored."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--eval_dir", required=True)
    ap.add_argument("--out", default="output/dtu")
    ap.add_argument("--scans", type=int, nargs="*", default=SCANS)
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--voxel_size", type=float, default=0.004,
                    help="TSDF voxel")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dry", action="store_true")
    # unrecognized dotted overrides (--a.b=c) pass through to train
    args, train_overrides = ap.parse_known_args(argv)

    results = {}
    for scan in args.scans:
        logdir = os.path.join(args.out, f"scan{scan}")
        src = os.path.join(args.data_root, f"scan{scan}")
        check(cli("train", train_argv(src, logdir, args.iterations,
                                      train_overrides, args.device)),
              args.dry)
        # the check_finish gate
        if not args.dry and not os.path.isdir(
                os.path.join(logdir, "point_cloud")):
            raise SystemExit(f"check_finish: no point_cloud/ for scan{scan}")
        check(cli("depth2mesh", mesh_argv(logdir, args.voxel_size,
                                          args.device)), args.dry)
        check(cli("eval_geometry", eval_argv(logdir, args.eval_dir, scan,
                                             args.device)), args.dry)
        rj = os.path.join(logdir, "results.json")
        if os.path.exists(rj):
            with open(rj) as f:
                results[scan] = json.load(f)
    if results:
        mean = sum(r["overall"] for r in results.values()) / len(results)
        print(json.dumps({"per_scan": results, "mean_chamfer": mean},
                         indent=2))
    return results


if __name__ == "__main__":
    main()
