"""Time the forward-loop microprobe's variants on the card, the port's
counterpart of scripts/kernel_microprobe.py:

  python -m vcr_gaus_tpu_torch.tools.kernel_microprobe [--variants a,b]
      [--device cuda|cpu] [--out FILE] [--n-tiles N] [--chunks C]

The defaults are the protocol shape: 1900 tiles of 6 chunks of 256 entries,
the inputs made from seed 0 as the script makes them. Each variant of
``ops/microprobe.VARIANTS`` is launched once untimed (the first launch
builds the kernels), then timed with CUDA events, one launch per variant
in turn, 5 times, and its best time is kept, as the script does.
Printed, one JSON line per variant: ``ms``, ``n_chunks``, ``us_per_chunk``
(the script's summary), the share of its pairs that are live
(``live_share``; the kernel skips the others), the share of warp steps
(one entry for the kernel's warp of an 8x8 patch, 2 pixels a thread) with
a live lane (``warp_live_share``) and of the entries on which the busiest
warp of a tile's chunk has one (``busiest_warp_live_share``), the same two
for warps of one 32-pixel row, a thread per pixel, the kernel's map before
(``rows_warp_live_share``, ``rows_busiest_warp_live_share``), its FP32
operations per pair, the least time the card could take for its work
(``bound_ms``, H100 SXM peaks) and ``x_bound``. With ``--device cpu`` the
plain version runs and its host time is ``cpu_ms``; the device metrics are
null. The whole result, every timing included, is written to ``--out``
only.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time

import torch

from ..ops import microprobe as M
from ..utils.device import resolve_device

REPS = 5
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def pair_ops(use_depth, use_tri, use_dacc, use_exp, use_alpha,
             **_) -> tuple[int, int, int]:
    """FP32 operations of kernel_microprobe.cu's loop body (each add, mul,
    compare, min, abs, divide, expf and log1pf counted as one): (for every
    pair, more past the power test, more for a live pair). With use_alpha:
    dx, dy (2), the power (9) and its test (1); past the test e^power and
    the opacity (2; 3 for the linear alpha) and the alpha test (1); a live
    pair's min (1), then as every pair without use_alpha: lg (2 with
    log1p, else 1), the prefix (1), the weight (3), w times rows 6..11 and
    their sums (12), the depth ray . n, clamp and divide (8), w d, w d^2
    and their sums (4)."""
    body = ((2 if use_exp and use_alpha else 1) + int(use_tri) + 3
            + 12 * int(use_dacc) + 8 * int(use_depth) + 4)
    if not use_alpha:
        return 1 + body, 0, 0          # alpha = 0.001 op on every pair
    return 12, 3 + int(not use_exp), 1 + body


def rows_read(use_depth, use_dacc, use_alpha, **_) -> int:
    """Feature rows the variant's function reads: the alpha's 0..5 (only
    the opacity, row 5, without use_alpha), the depth row 6, the normal
    7..9 (use_depth), rows 6..11 (use_dacc)."""
    rows = set(range(6)) if use_alpha else {5}
    rows |= {6}
    if use_depth:
        rows |= {7, 8, 9}
    if use_dacc:
        rows |= set(range(6, 12))
    return len(rows)


def bound(toggles: dict, census: dict, n_tiles: int, entries: int) -> dict:
    """The least time the card could take for one variant's work: the
    larger of its operations over the FP32 peak and its bytes (the rows it
    reads of every entry once, the tile ranges, the (n_tiles, 1024, 10)
    output written once) over the HBM peak."""
    pairs, past, live = (census[k] for k in ("pairs", "past_power", "live"))
    every, more_past, more_live = pair_ops(**toggles)
    chunks = entries // toggles["Gc"]
    # + one add per (pixel, chunk): the chunk's last prefix
    ops = every * pairs + more_past * past + more_live * live + chunks * M.P
    nbytes = (4 * rows_read(**toggles) * entries + 8 * n_tiles
              + 4 * M.OUT_CH * M.P * n_tiles)
    flop_s, byte_s = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return dict(ops=ops, ops_per_pair=ops / max(pairs, 1),
                bound_ms=1e3 * max(flop_s, byte_s),
                bound_by="operations" if flop_s >= byte_s else "bytes")


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not available"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _time_ms(fn, on_card: bool) -> float:
    if not on_card:
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main(argv: list[str] | None = None) -> dict:
    """Returns the result that ``--out`` receives: the shape, the card,
    every timing (``reps``) and the per-variant ``summary``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(M.VARIANTS),
                    help="comma list of variant names")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON here")
    ap.add_argument("--n-tiles", type=int, default=M.N_TILES)
    ap.add_argument("--chunks", type=int, default=M.CHUNKS)
    args = ap.parse_args(argv)
    sel = [v for v in args.variants.split(",") if v]
    unknown = [v for v in sel if v not in M.VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {list(M.VARIANTS)}")

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    feats, starts, counts = (torch.from_numpy(a).to(device) for a in
                             M.probe_inputs(args.n_tiles, args.chunks))
    fns = {name: (lambda t=M.toggles_of(name):
                  M.microprobe(feats, starts, counts, **t)) for name in sel}
    for fn in fns.values():
        fn()
    reps = {name: [] for name in sel}
    for _ in range(REPS):
        for name, fn in fns.items():
            reps[name].append(_time_ms(fn, on_card))

    entries = int(counts.to(torch.int64).sum())
    censuses = {}
    summary = {}
    for name in sel:
        tg = M.toggles_of(name)
        key = (tg["use_exp"], tg["use_alpha"])
        if key not in censuses:
            censuses[key] = M.pair_census(feats, starts, counts,
                                          use_exp=key[0], use_alpha=key[1])
        c = censuses[key]
        n_chunks = entries // tg["Gc"]
        b = bound(tg, c, args.n_tiles, entries)
        best = min(reps[name])
        row = dict(ms=None, n_chunks=n_chunks, us_per_chunk=None,
                   live_share=c["live"] / max(c["pairs"], 1))
        for pre, out in (("patch_", ""), ("", "rows_")):
            row[f"{out}warp_live_share"] = (c[f"{pre}warp_steps_live"]
                                            / max(c[f"{pre}warp_steps"], 1))
            row[f"{out}busiest_warp_live_share"] = (
                c[f"{pre}busiest_warp_live_steps"] / max(entries, 1))
        row.update(**b, x_bound=None)
        if on_card:
            row.update(ms=best, us_per_chunk=best * 1e3 / n_chunks,
                       x_bound=best / b["bound_ms"])
        else:
            row["cpu_ms"] = best
        summary[name] = row
    res = dict(shape=f"{args.n_tiles} tiles x {args.chunks} chunks x "
                     f"G{M.G} P{M.P}",
               pairs=entries * M.P,
               device=(torch.cuda.get_device_name(device) if on_card
                       else "cpu"),
               card=card_line() if on_card else None, reps=reps,
               summary=summary)
    for name, row in summary.items():
        print(json.dumps({"variant": name, **row}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
