"""The benchmark of vcr_gaus_tpu_torch: one run of one cell.

    python3 gsbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` it prints the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, as the last line of standard output (one
JSON object), and the numbers its check compared, each beside its limit, as
the last lines of standard error. It needs as many CUDA cards as the cell
asks for and exits with 2 without one; it exits with 3 if JAX or the JAX
package was loaded. Kernel builds stay in ``build/`` of the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the checkout's root, not this folder, leads the import path, so that the
# harness is the package ``gsbench`` and shadows no standard module
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or os.curdir) != HERE]
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vcr_gaus_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gsbench import harness

    w = next((x for x in harness.manifest()["workloads"]
              if x["name"] == args.workload), None)
    if w is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"the cell needs {w['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": w["chips"],
              "memory_peak_bytes": res.pop("memory_peak_bytes")}
    if args.trace:
        device["busy_s"] = res.pop("busy_s")
        device["window_s"] = res.pop("window_s")
    out = {"correct": res.pop("correct"), "attempted": res.pop("attempted"),
           "failed": res.pop("failed"), "metrics": res.pop("metrics"),
           "device": device}
    if "breakdown" in res:
        out["breakdown"] = res.pop("breakdown")
    checks = res.pop("checks")
    out.update(res)
    out["card"] = harness.card()
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
