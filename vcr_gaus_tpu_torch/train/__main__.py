"""Training CLI, the port's counterpart of the root ``train.py``:

  python -m vcr_gaus_tpu_torch.train --config=configs/dtu/base.yaml \\
      --model.source_path=data/dtu/scan24 --logdir=output/dtu/scan24 \\
      [--device cuda|cpu] [--seed N] [--wandb] [--optim.iterations=N] \
      [other dotted overrides]

Runs the recipe's schedule to ``optim.iterations`` (densify, opacity
resets, the LightGaussian prune, test sweeps, PLY and checkpoint saves, the
final importance dump), saves the PLY beside the saved ``config.yaml`` and
prints the final PSNR/L1 (and mIoU with the semantic head) over the train
split, then closes the metric writers (``VCR_TB=1``: TensorBoard under
``<logdir>/tb``; ``VCR_WANDB=1``: wandb). Every recipe of ``configs/``
trains: DTU, Mip-NeRF 360, ``reconstruct.yaml`` with its random box cameras,
ScanNet++ and Tanks and Temples with the appearance network and the
semantic head.
``--train.start_checkpoint=<logdir>/chkpnt<it>.npz`` resumes from a
checkpoint written by either package, at the iteration after it.
``--seed`` is parsed and dropped, as the root ``train.py`` does: the run's
seed stays the YAML's ``seed``. ``--wandb`` sets ``VCR_WANDB=1``.
``--tpu.camera_batch=k`` averages k views a step.

Launched by ``torchrun`` (``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` set),
each process joins the process group (NCCL on ``cuda:<LOCAL_RANK>``, gloo
with ``--device cpu``) and trains its share of each camera batch, which
must be a multiple of the world size; rank 0 alone writes:

  torchrun --nproc_per_node=4 -m vcr_gaus_tpu_torch.train \
      --config=configs/dtu/base.yaml --model.source_path=... \
      --logdir=... --tpu.camera_batch=4
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv: list[str] | None = None):
    """Returns the Trainer after training, saving and evaluating."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="accepted and ignored, as by the root train.py")
    ap.add_argument("--wandb", action="store_true",
                    help="sets VCR_WANDB=1 for the metric writer")
    args, overrides = ap.parse_known_args(argv)
    if args.wandb:
        os.environ["VCR_WANDB"] = "1"

    from ..config import Config
    from ..parallel import dp
    from ..utils.device import resolve_device
    from .trainer import Trainer

    device = resolve_device(args.device)
    launched = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if launched:
        if device.type == "cuda":
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", "0")))
        dp.init_process_group(int(os.environ["RANK"]),
                              int(os.environ["WORLD_SIZE"]), "env://",
                              device)
    try:
        cfg = Config(args.config, overrides=overrides)
        if not cfg.logdir:
            raise SystemExit("set --logdir")
        main_rank = dp.world()[0] == 0
        if main_rank:
            os.makedirs(cfg.logdir, exist_ok=True)
            cfg.save(os.path.join(cfg.logdir, "config.yaml"))
            cfg.print_config()

        trainer = Trainer(cfg, device=device)
        trainer._print(f"scene: {len(trainer.scene.train_cameras)} train "
                       f"cams, {len(trainer.scene.points)} init points, "
                       f"capacity {trainer.state.capacity}")
        trainer.train()
        if main_rank:
            trainer.save()
            metrics = trainer.evaluate(
                max_cams=int(getattr(cfg.tpu, "eval_max_cams", 0) or 0))
            print("final:", metrics, flush=True)
            trainer.finalize()
        dp.barrier()
    finally:
        if launched:
            torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
