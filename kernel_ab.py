#!/usr/bin/env python3
"""Time the port's stats kernel (K3) and forward-loop microprobe (K4) against
other builds of them, on the same inputs, in one process on one card.

    python3 kernel_ab.py NAME=DIR[:DEF,...] [NAME=DIR[:DEF,...] ...]

Each NAME builds DIR/rasterize_stats.cu and DIR/kernel_microprobe.cu,
whichever exist, with the port's nvcc flags (ops/cuda_build.py), DIR and
then csrc/ on the include path, and -D for each DEF. DIR may hold the
kernels of an earlier commit (``git archive <rev>
vcr_gaus_tpu_torch/csrc | tar -x -C DIR --strip-components=2``) or a copy
with switches; a build must keep the C entry points ``vcr_rasterize_stats``
and ``vcr_kernel_microprobe``. Then, against the in-tree kernels
(``in_tree``), every build launched the same way, straight through its C
entry point:

  K3  on the inputs of the first view of phase host_loop's densify at 20
      (chip_smoke.py's run, cut at iteration 20): each build's hit counts
      against the plain version's (exact) and its largest importance error;
      every build timed in turns (CUDA events, the median of ``--iters``
      launches a turn, ``--turns`` turns in alternating order; the least
      and the median of the turns are printed); then the same timing on the
      view's heaviest tile alone and on its 1584 heaviest tiles alone;
  K4  every variant at the protocol shape, each build first held against
      the plain version on 8 tiles x 6 chunks at chip_smoke.compare_probe's
      tolerance; then `full` on 1 tile and on 264 tiles.

One JSON line per measurement, after the card's name and power limit. A
build that holds a kernel to a different function (a switch that drops
work) is timed all the same and marked by ``counts_equal`` false or by a
failed probe check (``probe_ok``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("rasterize_stats", "kernel_microprobe")


def build(specs: list[str]) -> dict[str, dict[str, ctypes.CDLL]]:
    """name -> {kernel: the loaded library} for every NAME=DIR[:DEF,...]."""
    from vcr_gaus_tpu_torch.ops import cuda_build

    out_dir = os.path.join(REPO, "build", "kernel_ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for spec in specs:
        name, rest = spec.split("=", 1)
        src_dir, _, defs = rest.partition(":")
        for kernel in SOURCES:
            src = os.path.join(src_dir, kernel + ".cu")
            if not os.path.exists(src):
                continue
            so = os.path.join(out_dir, f"lib{name}_{kernel}.so")
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                   *[f"-D{d}" for d in defs.split(",") if d],
                   f"-I{src_dir}", f"-I{cuda_build.CSRC}", "-o", so, src]
            procs[name, kernel] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    # the in-tree kernels through the same ctypes launch as the others: the
    # wrappers' checks (a copy of the tile ranges to the host) would add to
    # their time alone
    libs = {"in_tree": {k: cuda_build.load(k) for k in SOURCES}}
    for (name, kernel), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {kernel}:\n{log}")
        emit(build=name, kernel=kernel, ptxas=[
            ln.strip() for ln in log.splitlines() if "Used" in ln])
        libs.setdefault(name, {})[kernel] = ctypes.CDLL(so)
    return libs


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def turns(fns: dict, n: int, iters: int) -> dict[str, list[float]]:
    """Each fn timed in ``n`` turns, the order reversed every other turn;
    returns name -> [least, median] of the turns' medians, in ms."""
    import torch
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    res = {k: [] for k in fns}
    names = list(fns)
    for t in range(n):
        for k in (names if t % 2 == 0 else names[::-1]):
            times = []
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fns[k]()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            res[k].append(statistics.median(times))
    return {k: [min(v), statistics.median(v)] for k, v in res.items()}


def densify_view_inputs(device, n_gauss=1_000_000, width=1600, height=1200):
    """(feats, binning, width, height) of the first stats launch of phase
    host_loop's run: the first view of the densify at 20."""
    import torch

    import chip_smoke as CS
    from vcr_gaus_tpu_torch.ops import binning as B
    from vcr_gaus_tpu_torch.ops import rasterize as R
    from vcr_gaus_tpu_torch.train.__main__ import main as train_main

    captured = []
    wrapped = R.rasterize_stats

    def spy(feats, binn, w, h):
        if not captured:
            captured.append((feats.clone(), B.Binning(*(
                t.clone() if torch.is_tensor(t) else t for t in binn)), w, h))
        return wrapped(feats, binn, w, h)

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        scene = CS.write_train_scene(root, n_gauss, width, height, 8)
        R.rasterize_stats = spy
        try:
            train_main(CS.host_loop_args(scene, device, 20, 1 << 21) + [
                f"--logdir={os.path.join(root, 'run')}",
                "--train.checkpoint_iterations=[]"])
        finally:
            R.rasterize_stats = wrapped
    return captured[0]


def ab_stats(libs, device, n_turns, iters) -> None:
    import torch

    from vcr_gaus_tpu_torch.ops import binning as B
    from vcr_gaus_tpu_torch.ops import rasterize as R

    feats, binn, w, h = densify_view_inputs(device)
    n_tx, n_ty = B.tile_grid(w, h)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launcher(lib):
        fn = lib.vcr_rasterize_stats
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, i, i, i, i, p, p]
        fn.restype = ctypes.c_int

        def call(b=binn):
            out = torch.zeros((feats.shape[0], 2), device=device)
            err = fn(feats.data_ptr(), feats.shape[1], b.sorted_gid.data_ptr(),
                     b.tile_starts.data_ptr(), b.tile_counts.data_ptr(), n_tx,
                     n_ty, w, h, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return out
        return call

    fns = {name: launcher(k["rasterize_stats"])
           for name, k in libs.items() if "rasterize_stats" in k}
    want, _ = R.composite_tiles_stats_torch(
        feats, binn.sorted_gid, binn.tile_starts, binn.tile_counts, n_tx, w, h)
    for name, fn in fns.items():
        got = fn()
        emit(k3_check=name, counts_equal=torch.equal(got[:, 0], want[:, 0]),
             imp_max_abs_err=float((got[:, 1] - want[:, 1]).abs().max()))
    tc = binn.tile_counts
    emit(k3_view=dict(entries=binn.num_entries, tiles=tc.numel(),
                      nonempty_tiles=int((tc > 0).sum()),
                      max_tile_entries=int(tc.max()),
                      median_tile_entries=float(tc[tc > 0].float().median())),
         k3_densify_20_ms=turns(fns, n_turns, iters))
    order = torch.argsort(tc, descending=True)
    for top in (1, 1584):
        only = torch.zeros_like(tc)
        only[order[:top]] = tc[order[:top]]
        heavy = binn._replace(tile_counts=only)
        emit(k3_heaviest_tiles=top, entries=int(only.sum()),
             ms=turns({k: (lambda fn=fn: fn(heavy)) for k, fn in fns.items()},
                      max(2, n_turns // 2), iters))


def ab_probe(libs, device, n_turns, iters) -> None:
    import torch

    import chip_smoke as CS
    from vcr_gaus_tpu_torch.ops import microprobe as M

    stream = torch.cuda.current_stream(device).cuda_stream

    def launcher(lib):
        fn = lib.vcr_kernel_microprobe
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, p, p] + [i] * 9 + [p, p]
        fn.restype = ctypes.c_int

        def call(feats, starts, counts, tg):
            n = starts.shape[0]
            out = torch.empty((n, M.P, M.OUT_CH), device=device)
            err = fn(feats.data_ptr(), feats.shape[1], starts.data_ptr(),
                     counts.data_ptr(), n, *(int(tg[s]) for s in M._SWITCHES),
                     tg["depth"], tg["Gc"], tg["unroll"], out.data_ptr(),
                     stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return out
        return call

    fns = {name: launcher(k["kernel_microprobe"])
           for name, k in libs.items() if "kernel_microprobe" in k}
    small = [torch.from_numpy(a).to(device) for a in M.probe_inputs(8, 6)]
    for name, fn in fns.items():
        ok = True
        for variant in M.VARIANTS:
            tg = M.toggles_of(variant)
            try:
                CS.compare_probe(fn(*small, tg),
                                 M.microprobe_torch(*small, **tg))
            except AssertionError:
                ok = False
        emit(k4_check=name, probe_ok=ok)
    big = [torch.from_numpy(a).to(device) for a in M.probe_inputs()]
    for variant in M.VARIANTS:
        tg = M.toggles_of(variant)
        emit(k4_variant=variant, ms=turns(
            {k: (lambda fn=fn: fn(*big, tg)) for k, fn in fns.items()},
            n_turns, iters))
    tg = M.toggles_of("full")
    for n in (1, 264):
        sub = [big[0], big[1][:n].contiguous(), big[2][:n].contiguous()]
        emit(k4_full_tiles=n, ms=turns(
            {k: (lambda fn=fn: fn(*sub, tg)) for k, fn in fns.items()},
            n_turns, iters))


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("specs", nargs="+", help="NAME=DIR[:DEF,...]")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build(args.specs)
    device = torch.device("cuda")
    ab_probe(libs, device, args.turns, max(2, args.iters // 2))
    torch.cuda.empty_cache()
    ab_stats(libs, device, args.turns, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
