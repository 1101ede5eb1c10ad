"""ScanNet++ multi-scene pipeline, the port's counterpart of
scripts/run_scannetpp.py (same flags, plus ``--device``): per scene, train
(configs/scannetpp/base.yaml) -> mesh (TSDF voxel 1.5e-2) -> NVS metrics;
then the mean PSNR over the scenes scored.

  python -m vcr_gaus_tpu_torch.tools.run_scannetpp --data_root \
      data/scannetpp [--scenes 0a5c013435 ...] [--parallel 4 | \
      --in_process 4] [--device cuda|cpu] [--dry] [dotted train overrides]

Two multi-device modes, one scene per device, share-nothing:
  --parallel N     one subprocess chain per scene, holding a card of a pool
                   of N for the whole scene through CUDA_VISIBLE_DEVICES;
  --in_process N   every scene trains inside this process, concurrently,
                   one per device of cuda:0..N-1 (N CPU slots with
                   ``--device cpu``) through parallel.dp.scene_dispatch;
                   the mesh and eval stages then chain as subprocesses.
A scene whose stage fails, or whose training leaves no point_cloud/ (the
check_finish gate), is skipped.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import time
from concurrent.futures import ThreadPoolExecutor

from .stages import REPO, cli, run

CONFIG = "configs/scannetpp/base.yaml"


def stage_cmds(scene: str, src: str, logdir: str, iterations: int | None,
               overrides: list[str], device: str, skip_train: bool = False,
               voxel_size: float = 0.015) -> list[list[str]]:
    """train, depth2mesh and render_eval of one scene (mesh and eval alone
    with ``skip_train``)."""
    train = [f"--config={CONFIG}", f"--model.source_path={src}",
             f"--logdir={logdir}"]
    if iterations:
        train.append(f"--optim.iterations={iterations}")
    train += list(overrides) + [f"--device={device}"]
    mesh = [f"--cfg_path={logdir}/config.yaml", f"--voxel_size={voxel_size}",
            f"--device={device}"]
    eval_ = [f"--cfg_path={logdir}/config.yaml", f"--device={device}"]
    cmds = [cli("depth2mesh", mesh), cli("render_eval", eval_)]
    return cmds if skip_train else [cli("train", train)] + cmds


def run_scene(scene: str, src: str, logdir: str, iterations: int | None,
              dry: bool, device: str, card_pool: queue.Queue | None = None,
              overrides: list[str] = (), skip_train: bool = False,
              voxel_size: float = 0.015) -> bool:
    """One scene's stages, holding a card from ``card_pool`` (if any) for
    the whole scene: drawn when the scene starts, so that no two scenes'
    subprocesses share a card."""
    env = None
    card = None
    if card_pool is not None:
        card = card_pool.get()
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(card))
    try:
        for cmd in stage_cmds(scene, src, logdir, iterations, list(overrides),
                              device, skip_train, voxel_size):
            rc = run(cmd, dry, label=f"[{scene}] ", env=env)
            if rc:
                print(f"[{scene}] stage failed ({rc}); aborting scene",
                      flush=True)
                return False
            # the check_finish gate
            if not dry and cmd[2] == "vcr_gaus_tpu_torch.train" and \
                    not os.path.isdir(os.path.join(logdir, "point_cloud")):
                print(f"[{scene}] check_finish: no point_cloud/", flush=True)
                return False
        return True
    finally:
        if card_pool is not None:
            card_pool.put(card)


def train_scenes_in_process(jobs, iterations: int | None, n_devices: int,
                            overrides: list[str], device: str
                            ) -> dict[str, bool]:
    """Train every scene inside this process, one scene per device of the
    first ``n_devices`` (``cuda:i``, or ``n_devices`` CPU slots),
    concurrently through ``scene_dispatch``. Returns {scene: ok}."""
    import torch

    from ..config import Config
    from ..parallel import dp
    from ..train.trainer import Trainer

    def make(scene, src, logdir):
        def fn(dev):
            try:
                ovr = [f"--model.source_path={src}", f"--logdir={logdir}"]
                if iterations:
                    ovr.append(f"--optim.iterations={iterations}")
                cfg = Config(os.path.join(REPO, CONFIG),
                             overrides=ovr + list(overrides))
                os.makedirs(logdir, exist_ok=True)
                cfg.save(os.path.join(logdir, "config.yaml"))
                trainer = Trainer(cfg, device=dev)
                trainer.train()
                trainer.save()
                trainer.finalize()
                print(f"[{scene}] trained in-process on device "
                      f"{trainer.state.params.xyz.device}", flush=True)
                # the check_finish gate
                if not os.path.isdir(os.path.join(logdir, "point_cloud")):
                    print(f"[{scene}] check_finish: no point_cloud/",
                          flush=True)
                    return False
                return True
            except Exception as e:                      # noqa: BLE001
                print(f"[{scene}] TRAIN FAILED in-process: {e!r}",
                      flush=True)
                return False
        return fn

    if torch.device(device).type == "cuda":
        devs = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devs = [torch.device(device)] * n_devices
    print(f"in-process scene-DP over {len(devs)} devices: "
          f"{[str(d) for d in devs]}", flush=True)
    t0 = time.time()
    oks = dp.scene_dispatch([make(*j) for j in jobs], devs, parallel=True)
    print(f"in-process train phase: {len(jobs)} scenes in "
          f"{time.time() - t0:.1f}s", flush=True)
    return {j[0]: ok for j, ok in zip(jobs, oks)}


def main(argv: list[str] | None = None) -> dict:
    """Returns {"per_scene": {scene: NVS results}, "ok": {scene: bool}}
    and, when a scene was scored, "mean_psnr"."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--out", default="output/scannetpp")
    ap.add_argument("--scenes", nargs="*", default=None,
                    help="default: every subdirectory of data_root")
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--parallel", type=int, default=0,
                    help="concurrent scenes, one per card (0 = sequential)")
    ap.add_argument("--voxel_size", type=float, default=0.015,
                    help="TSDF voxel (recipe default 1.5e-2)")
    ap.add_argument("--in_process", type=int, default=0, metavar="N",
                    help="train all scenes inside this process over N "
                         "devices (parallel.dp.scene_dispatch), then chain "
                         "the mesh and eval subprocesses")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dry", action="store_true")
    # unrecognized dotted overrides (--a.b=c) pass through to train
    args, overrides = ap.parse_known_args(argv)
    bad = [o for o in overrides if not o.startswith("--")]
    if bad:
        ap.error(f"unrecognized arguments: {bad}")

    scenes = args.scenes or sorted(
        d for d in os.listdir(args.data_root)
        if os.path.isdir(os.path.join(args.data_root, d)))
    jobs = [(scene, os.path.join(args.data_root, scene),
             os.path.join(args.out, scene)) for scene in scenes]

    if args.in_process > 0 and not args.dry:
        trained = train_scenes_in_process(jobs, args.iterations,
                                          args.in_process, overrides,
                                          args.device)
        ok = {}
        for s, src, ld in jobs:        # mesh and eval of each trained scene
            ok[s] = trained.get(s, False) and run_scene(
                s, src, ld, args.iterations, args.dry, args.device,
                overrides=overrides, skip_train=True,
                voxel_size=args.voxel_size)
    elif args.parallel > 1 and not args.dry:
        pool: queue.Queue = queue.Queue()
        for card in range(args.parallel):
            pool.put(card)
        with ThreadPoolExecutor(max_workers=args.parallel) as ex:
            futs = {ex.submit(run_scene, s, src, ld, args.iterations,
                              args.dry, args.device, pool, overrides, False,
                              args.voxel_size): s
                    for s, src, ld in jobs}
            ok = {futs[f]: f.result() for f in futs}
    else:
        ok = {s: run_scene(s, src, ld, args.iterations, args.dry,
                           args.device, overrides=overrides,
                           voxel_size=args.voxel_size)
              for s, src, ld in jobs}

    results = {}
    for scene, _, logdir in jobs:
        for root, _, files in os.walk(logdir):
            if "results.json" in files:
                with open(os.path.join(root, "results.json")) as f:
                    results[scene] = json.load(f)
    out = {"per_scene": results, "ok": ok}
    if results:
        out["mean_psnr"] = (sum(r.get("PSNR", 0) for r in results.values())
                            / len(results))
    print(json.dumps(out, indent=2, default=str))
    return out


if __name__ == "__main__":
    main()
