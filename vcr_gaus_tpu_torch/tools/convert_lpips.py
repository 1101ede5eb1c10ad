"""Convert torchvision VGG16 weights and the LPIPS v0.1 linear heads into
one ``.npz`` that ``evaluation.lpips.LPIPS`` loads, the port's counterpart
of scripts/convert_lpips.py (same flags, keys and checks, plus
``--device`` for the self-test):

  * ``--vgg``: a torchvision vgg16 state_dict (``.pth`` or ``.npz`` with
    ``features.N.weight/bias`` keys, or a plain ``N.weight/bias`` dump);
  * ``--lin``: the LPIPS v0.1 vgg heads (keys ``lin{i}.model.1.weight``,
    or the pip package's ``lins.{i}.model.1.weight``).

The output holds the canonical keys (``features.N.weight/bias``,
``lin{i}.model.1.weight``); point ``$LPIPS_WEIGHTS`` at it, or pass
``--lpips_weights`` to ``python -m vcr_gaus_tpu_torch.render_eval``.

  python -m vcr_gaus_tpu_torch.tools.convert_lpips --vgg vgg16.pth \
      --lin lpips_v0.1_vgg.pth --out weights/lpips_vgg.npz \
      [--selftest] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..evaluation.lpips import _STAGE_CH, _STAGES, _load_state


def convert(vgg_path: str, lin_path: str, out_path: str) -> dict:
    """Writes the combined ``.npz`` at ``out_path`` and returns its arrays.
    The heads are stored as their absolute values, as LPIPS applies abs
    at load."""
    vgg = _load_state(vgg_path)
    lin = _load_state(lin_path)
    out: dict[str, np.ndarray] = {}

    for si, stage in enumerate(_STAGES):
        for i in stage:
            for suffix in ("weight", "bias"):
                for key in (f"features.{i}.{suffix}", f"{i}.{suffix}"):
                    if key in vgg:
                        out[f"features.{i}.{suffix}"] = np.asarray(
                            vgg[key], np.float32)
                        break
                else:
                    raise KeyError(
                        f"vgg16 features.{i}.{suffix} not in {vgg_path} "
                        f"(keys: {sorted(vgg)[:5]}...)")
        w = out[f"features.{stage[-1]}.weight"]
        if w.shape[0] != _STAGE_CH[si]:
            raise ValueError(
                f"stage {si} out-channels {w.shape[0]} != {_STAGE_CH[si]} "
                f"— is {vgg_path} really a torchvision vgg16 state_dict?")

    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in lin:
                v = np.asarray(lin[key], np.float32).reshape(-1)
                break
        else:
            raise KeyError(f"lin{i} head not in {lin_path} "
                           f"(keys: {sorted(lin)})")
        if v.shape[0] != _STAGE_CH[i]:
            raise ValueError(f"lin{i} width {v.shape[0]} != {_STAGE_CH[i]}")
        if (v < 0).any():
            v = np.abs(v)
        out[f"lin{i}.model.1.weight"] = v

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **out)
    return out


def main(argv: list[str] | None = None) -> dict:
    """Returns the converted arrays."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--vgg", required=True,
                    help="torchvision vgg16 state_dict (.pth or .npz)")
    ap.add_argument("--lin", required=True,
                    help="LPIPS v0.1 vgg linear heads (.pth or .npz)")
    ap.add_argument("--out", default="weights/lpips_vgg.npz")
    ap.add_argument("--selftest", action="store_true",
                    help="load the result and score a test pair")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    out = convert(args.vgg, args.lin, args.out)
    n_params = sum(v.size for v in out.values())
    print(f"wrote {args.out}: {len(out)} arrays, {n_params:,} params")

    if args.selftest:
        from ..evaluation.lpips import LPIPS
        fn = LPIPS(args.out, device=device)
        rng = np.random.default_rng(0)
        a = rng.uniform(0, 1, (3, 64, 64)).astype(np.float32)
        d_same = float(fn(a, a))
        d_diff = float(fn(a, 1.0 - a))
        print(f"selftest: d(x,x)={d_same:.6f} d(x,1-x)={d_diff:.4f}")
        assert d_same < 1e-6 and d_diff > d_same
    print(f"use: export LPIPS_WEIGHTS={os.path.abspath(args.out)}")
    return out


if __name__ == "__main__":
    main()
