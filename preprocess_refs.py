#!/usr/bin/env python3
"""Hold the preprocess backward kernel (csrc/preprocess.cu) against three
plain references, per leaf and slot group, without raising, and print for
each reference the largest error over the group's max|g|.

    python3 preprocess_refs.py [--device cuda] [--small] [--out FILE]

The references, all on the same device and inputs:

  closed  ``preprocess_backward_torch``, the closed form in the kernel's
          float32 operation order (what ``chip_smoke.compare_preprocess``
          and tests/test_torch_kernels.py hold the kernel to, at
          ``chip_smoke.PRE_BWD_ATOL`` times max|g|);
  ag32    autograd of the plain forward ``preprocess_torch`` in float32;
  ag64    the same on float64 copies of the inputs, cast back to float32.

Inputs are ``chip_smoke.preprocess_scene``'s slots that reach every branch:
3,000 slots at 64x48 for every variant (SH degree None and 0-3, S 0 and 2,
normals off and on) through the identity camera and a rotated one, then
2^20 slots at 1600x1200 (S 0) and 2^22 at 1600x900 (S 2) through a rotated
camera. Groups are ``chip_smoke.preprocess_groups``; a worst case is keyed
"group.camera" (camera "id" or "rot"). ``--small`` keeps only the 64x48
cases (a rehearsal on the CPU, where the kernel's place is taken by the
closed form itself). ``--out`` writes every reading as JSON.
"""

import argparse
import json
import subprocess

import torch

import chip_smoke as CS
from vcr_gaus_tpu_torch.models.gaussians import GaussianParams
from vcr_gaus_tpu_torch.ops import projection as PF


def autograd_grads(g, lv, cam, var):
    """Autograd of ``preprocess_torch``; zeros where a leaf is not read."""
    leaves = lv.map(lambda x: x.detach().requires_grad_(True))
    active = torch.ones(lv.xyz.shape[0], dtype=torch.bool,
                        device=lv.xyz.device)
    with torch.enable_grad():
        feats = PF.preprocess_torch(leaves, active, cam, var).feats
        inputs = list(leaves.as_dict().values())
        grads = torch.autograd.grad(feats, inputs, g, allow_unused=True)
    return GaussianParams(*(torch.zeros_like(x) if d is None else d
                            for x, d in zip(inputs, grads)))


def readings(n, seed, identity, var, device, s_obj=2, gseed=0) -> dict:
    lv, active, cam = CS.preprocess_scene(
        n, seed=seed, identity=identity, s_obj=s_obj, width=var.width,
        height=var.height)
    lv = lv.map(lambda x: x.to(device))
    active, cam = active.to(device), cam.to(device)
    radius = PF.preprocess_torch(lv, active, cam, var).radius
    nf = PF.feature_dim(var.ch_sem)
    # the first 14+S columns of a (C, 16+S) matrix, as K2 gives it
    g = torch.randn((n, nf + 2), generator=torch.Generator()
                    .manual_seed(gseed)).to(device)[:, :nf]
    got = PF.preprocess_backward(g, lv, cam, var)
    ag64 = autograd_grads(g.double(), lv.map(torch.Tensor.double),
                          cam.double(), var)
    refs = {"closed": PF.preprocess_backward_torch(g, lv, cam, var),
            "ag32": autograd_grads(g, lv, cam, var),
            "ag64": ag64.map(torch.Tensor.float)}
    groups = CS.preprocess_groups(lv, cam, radius)
    rec = {"n": n, "seed": seed, "identity": identity, "var": list(var)}
    for tag, ref in refs.items():
        rec[tag] = {}
        for name, a in got.as_dict().items():
            b = getattr(ref, name)
            if a is None or b is None:
                continue
            for group, rows in groups.items():
                if not bool(rows.any()):
                    continue
                scale = float(b[rows].abs().max())
                err = float((a[rows] - b[rows]).abs().max())
                rec[tag][f"{name}.{group}"] = [err, scale,
                                               err / max(scale, 1e-30)]
    return rec


def worst(cases, tag) -> dict:
    out = {}
    for c in cases:
        cam = "id" if c["identity"] else "rot"
        for key, (err, scale, rel) in c[tag].items():
            leaf, group = key.split(".")
            k = f"{group}.{cam}"
            if rel > out.get(k, [-1.0])[0]:
                out[k] = [rel, err, scale, leaf, c["var"], c["n"]]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = "cpu"
    if args.device.startswith("cuda"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(card, torch.__version__, flush=True)
    cases = []
    for deg in (None, 0, 1, 2, 3):
        for ch in (0, 2):
            for normal in (False, True):
                var = PF.Variant(64, 48, deg, ch, normal, 1.0)
                for identity in (True, False):
                    cases.append(readings(3000, 11 * (deg or 0) + ch,
                                          identity, var, args.device))
    if not args.small:
        for slots, ch, w, h in ((1 << 20, 0, 1600, 1200),
                                (1 << 22, 2, 1600, 900)):
            cases.append(readings(slots, slots, False,
                                  PF.Variant(w, h, 3, ch, True, 1.0),
                                  args.device, s_obj=ch, gseed=slots))
    summary = {tag: worst(cases, tag) for tag in ("closed", "ag32", "ag64")}
    for tag, w in summary.items():
        print(tag, "(largest error / max|g|, error, max|g|, leaf, variant, "
              "slots)")
        for k, v in sorted(w.items()):
            print(" ", k, v)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "worst": summary, "cases": cases}, f)


if __name__ == "__main__":
    main()
