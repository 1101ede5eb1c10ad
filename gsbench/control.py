"""The readings the check's limits are set from, at a cell's own size.

    python3 gsbench/control.py --workload <name> --seeds <n,n,...> [--faults 1]

For each seed, as the driver of the cell's traffic gives them: the check's
numbers of the program's sound run against the plain reference (the lower
readings), of the control (the reference itself computed in the precision
below the configuration's, put in the program's place) and, with
``--faults 1``, of the program with each fault of ``faults.py`` planted;
with the raw readings under ``raw``. One JSON line a seed. The benchmark's
own runs do not run it.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or os.curdir) != HERE]
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402

import torch  # noqa: E402

from gsbench import harness as H  # noqa: E402


def readings(workload: str, seed: int, device, with_faults: bool,
             overrides=None) -> dict:
    """The cell's driver's readings on ``seed`` (see its
    ``control_readings``)."""
    c = H.cell(workload, overrides=overrides)
    tmp = tempfile.mkdtemp(prefix="gsbench-")
    try:
        out = {"workload": workload, "seed": seed}
        out.update(H.load_driver(c.traffic["kind"]).control_readings(
            c, seed, device, with_faults, tmp))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), "cuda",
                                  bool(args.faults))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
