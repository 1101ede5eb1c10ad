"""Training CLI, the port's counterpart of the root ``train.py``:

  python -m vcr_gaus_tpu_torch.train --config=configs/dtu/base.yaml \\
      --model.source_path=data/dtu/scan24 --logdir=output/dtu/scan24 \\
      [--device cuda|cpu] [--seed N] [--wandb] [--optim.iterations=N] \
      [other dotted overrides]

Runs the recipe's schedule to ``optim.iterations`` (densify, opacity
resets, the LightGaussian prune, test sweeps, PLY and checkpoint saves, the
final importance dump), saves the PLY beside the saved ``config.yaml`` and
prints the final PSNR/L1 over the train split.
``--train.start_checkpoint=<logdir>/chkpnt<it>.npz`` resumes from a
checkpoint written by either package, at the iteration after it.
``--seed`` is parsed and dropped, as the root ``train.py`` does: the run's
seed stays the YAML's ``seed``. ``--wandb`` sets ``VCR_WANDB=1``.
"""

from __future__ import annotations

import argparse
import os


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
    from ..utils.device import resolve_device
    from .trainer import Trainer

    device = resolve_device(args.device)
    cfg = Config(args.config, overrides=overrides)
    if not cfg.logdir:
        raise SystemExit("set --logdir")
    os.makedirs(cfg.logdir, exist_ok=True)
    cfg.save(os.path.join(cfg.logdir, "config.yaml"))
    cfg.print_config()

    trainer = Trainer(cfg, device=device)
    print(f"scene: {len(trainer.scene.train_cameras)} train cams, "
          f"{len(trainer.scene.points)} init points, "
          f"capacity {trainer.state.capacity}", flush=True)
    trainer.train()
    trainer.save()
    metrics = trainer.evaluate(
        max_cams=int(getattr(cfg.tpu, "eval_max_cams", 0) or 0))
    print("final:", metrics, flush=True)
    return trainer


if __name__ == "__main__":
    main()
