"""Tanks and Temples pipeline, the port's counterpart of scripts/run_tnt.py
(same flags, plus ``--device``): per scene, train -> mesh with the voxel
ladder (each failed rung, such as ``depth2mesh``'s exit 3 on a grid above
``--max_voxels``, retried at the next, coarser voxel) -> F1 at the scene's
tau with ICP; then the mean F1 over the scenes scored.

  python -m vcr_gaus_tpu_torch.tools.run_tnt --data_root data/tnt \
      --gt_root data/tnt_gt --out output/tnt [--scenes Barn Truck] \
      [--device cuda|cpu] [--dry] [dotted train overrides]
"""

from __future__ import annotations

import argparse
import json
import os

from .stages import REPO, cli, run

SCENES = ["Barn", "Caterpillar", "Courthouse", "Ignatius", "Meetingroom",
          "Truck"]
# per-scene tau of the TNT toolbox
TAU = {"Barn": 0.01, "Caterpillar": 0.005, "Courthouse": 0.025,
       "Ignatius": 0.003, "Meetingroom": 0.01, "Truck": 0.005}
VOXEL_LADDER = [0.002, 0.004, 0.006, 0.01, 0.02]


def train_argv(config: str, src: str, logdir: str, iterations: int | None,
               overrides: list[str], device: str) -> list[str]:
    argv = [f"--config={config}", f"--model.source_path={src}",
            f"--logdir={logdir}"]
    if iterations:
        argv.append(f"--optim.iterations={iterations}")
    return argv + overrides + [f"--device={device}"]


def mesh_argv(logdir: str, voxel: float, max_voxels: int | None,
              device: str) -> list[str]:
    """depth2mesh's flags of the recipe: every third view, depth cut at 8,
    alpha 0.3, no cluster filter."""
    argv = [f"--cfg_path={logdir}/config.yaml", f"--voxel_size={voxel}",
            "--split=3", "--max_depth=8", "--prob_thr=0.3", "--num_cluster=0"]
    if max_voxels:
        argv.append(f"--max_voxels={max_voxels}")
    return argv + [f"--device={device}"]


def eval_argv(logdir: str, gt_path: str, tau: float,
              device: str) -> list[str]:
    return ["tnt", f"--ply_path={logdir}/ours.ply", f"--gt_path={gt_path}",
            f"--threshold={tau}", "--icp", f"--device={device}"]


def main(argv: list[str] | None = None) -> dict:
    """Returns {scene: metrics} of the scenes scored."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--gt_root", required=True)
    ap.add_argument("--out", default="output/tnt")
    ap.add_argument("--scenes", nargs="*", default=SCENES)
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--voxel_ladder", type=float, nargs="*",
                    default=VOXEL_LADDER,
                    help="voxel sizes tried in order until meshing "
                         "succeeds")
    ap.add_argument("--max_voxels", type=int, default=None,
                    help="forwarded to depth2mesh (grid-size abort)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dry", action="store_true")
    # unrecognized dotted overrides (--a.b=c) pass through to train
    args, train_overrides = ap.parse_known_args(argv)

    results = {}
    for scene in args.scenes:
        logdir = os.path.join(args.out, scene)
        src = os.path.join(args.data_root, scene)
        scene_cfg = f"configs/tnt/{scene}.yaml"
        if not os.path.exists(os.path.join(REPO, scene_cfg)):
            scene_cfg = "configs/tnt/base.yaml"
        if run(cli("train", train_argv(scene_cfg, src, logdir,
                                       args.iterations, train_overrides,
                                       args.device)), args.dry):
            print(f"TRAIN FAILED: {scene}")
            continue
        # the check_finish gate
        if not args.dry and not os.path.isdir(
                os.path.join(logdir, "point_cloud")):
            print(f"check_finish FAILED: no point_cloud/ for {scene}")
            continue
        # the voxel ladder: the first rung that meshes ends it
        if not any(run(cli("depth2mesh", mesh_argv(
                logdir, vs, args.max_voxels, args.device)), args.dry) == 0
                   for vs in args.voxel_ladder):
            print(f"MESH FAILED: {scene}")
            continue
        run(cli("eval_geometry", eval_argv(
            logdir, os.path.join(args.gt_root, scene, scene + ".ply"),
            TAU.get(scene, 0.01), args.device)), args.dry)
        mt = os.path.join(logdir, "metrics.txt")
        if os.path.exists(mt):
            with open(mt) as f:
                results[scene] = {k: float(v) for k, v in
                                  (ln.split(": ") for ln in f)}
    if results:
        mean_f1 = sum(r["F-score"] for r in results.values()) / len(results)
        print(json.dumps({"per_scene": results, "mean_f1": mean_f1},
                         indent=2))
    return results


if __name__ == "__main__":
    main()
