"""Faults planted in the program's timed path, for the check's own tests
and for reading each fault's numbers at a cell's size (``control.py``).
Each is a context manager around a ``Trainer`` whose step it breaks:

- ``unchanged``: the step returns the state it was given;
- ``half_batch``: the losses see the top half of the view's rows alone,
  their means taken over that half;
- ``altered_output``: the compositor's image is altered where it is
  produced (0.01 added to its colour channels);
- ``colour_grad``: the compositing backward's gradient of the Gaussians'
  colours doubled where it is produced (the colour columns of K2's
  output), which reaches the SH coefficients alone.

The cells here run on one chip, so no exchange between chips can be left
out.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "altered_output", "colour_grad")
# the faults read by a run at a cell's size (a state left unchanged reads 1)
PLANTED = FAULTS[1:]
# the colour columns of the packed features, as the compositor lays them out
RGB = slice(11, 14)

# output keys laid out (rows, cols, ...) and (channels, rows, cols)
_HW_FIRST = ("depth", "normal", "est_normal", "alpha", "mask", "depth_var",
             "distortion")
_CHW = ("render", "render_sem")


def _top_half(out: dict, cam):
    h = out["depth"].shape[0] // 2
    o = dict(out)
    for k in _HW_FIRST:
        if k in o:
            o[k] = o[k][:h]
    for k in _CHW:
        if k in o:
            o[k] = o[k][:, :h]
    cam = cam._replace(image=cam.image[:, :h], normal=cam.normal[:, :h],
                       depth=cam.depth[:h], mask=cam.mask[:h])
    return o, cam


@contextlib.contextmanager
def planted(name: str, trainer):
    """``trainer`` with the fault ``name`` in its step, for the block."""
    from vcr_gaus_tpu_torch.ops import rasterize as R
    from vcr_gaus_tpu_torch.train import trainer as T

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    if name == "unchanged":
        step = trainer.step_fn

        def frozen(state, *a, **k):
            _, losses, aux = step(state, *a, **k)
            return state, losses, aux

        trainer.step_fn = frozen
        try:
            yield
        finally:
            trainer.step_fn = step
    elif name == "half_batch":
        orig = T.compute_losses

        def half(out, cam, *a, **k):
            return orig(*_top_half(out, cam), *a, **k)

        T.compute_losses = half
        try:
            yield
        finally:
            T.compute_losses = orig
    elif name == "colour_grad":
        orig = R.rasterize_backward

        def doubled(feats, *a, **k):
            grad = orig(feats, *a, **k)
            grad[:, RGB] *= 2.0
            return grad

        R.rasterize_backward = doubled
        try:
            yield
        finally:
            R.rasterize_backward = orig
    else:
        orig = R.rasterize_image

        def altered(*a, **k):
            img, binn = orig(*a, **k)
            return img + img.new_tensor(
                [0.01] * 3 + [0.0] * (img.shape[0] - 3))[:, None, None], binn

        R.rasterize_image = altered
        try:
            yield
        finally:
            R.rasterize_image = orig
