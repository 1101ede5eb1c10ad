"""The training step's update (``models/gaussians.adam_and_stats``): the
leaf table and scalars its kernel (``csrc/adam.cu``) receives, its plain
path on the CPU, bit for bit the three plain calls it replaces, and the
trainer's step through it, out of place. The kernel itself runs on the
card: ``tests/test_torch_kernels.py -k adam`` and ``chip_smoke.py``'s
phase adam.
"""

import numpy as np
import pytest
import torch

from chip_smoke import ADAM_LRS, adam_inputs, compare_adam, state_tensors
from vcr_gaus_tpu_torch.models import gaussians as GM
from vcr_gaus_tpu_torch.ops import cuda_build
from vcr_gaus_tpu_torch.train import trainer as T

LEAF_WIDTHS = {"xyz": 3, "f_dc": 3, "log_scale": 3, "quat": 4,
               "logit_opacity": 1}


@pytest.mark.parametrize("sh_degree", [0, 3])
@pytest.mark.parametrize("ch_sem", [0, 2])
def test_table_leaves_in_field_order_without_empty_ones(sh_degree, ch_sem):
    params = GM.zeros_params(64, sh_degree, ch_sem, torch.device("cpu"))
    lrs = GM.LearningRates(**ADAM_LRS)
    table = GM.adam_table(params, lrs, 1)
    k = (sh_degree + 1) ** 2 - 1
    widths = {**LEAF_WIDTHS, "f_rest": 3 * k, "obj_dc": ch_sem}
    want = [name for name in params.as_dict() if widths[name]]
    assert [name for name, _, _ in table.leaves] == want
    assert ("f_rest" in want) == (sh_degree > 0)
    assert ("obj_dc" in want) == (ch_sem > 0)
    per_param = lrs.per_param()
    for name, width, lr in table.leaves:
        assert width == widths[name]
        assert type(lr) is np.float32 and lr == np.float32(per_param[name])


@pytest.mark.parametrize("step", [1, 2, 30_000])
def test_table_scalars_are_the_float32_values_of_the_eager_chain(step):
    params = GM.zeros_params(8, 1, 0, torch.device("cpu"))
    sc = GM.adam_table(params, GM.LearningRates(**ADAM_LRS), step).scalars
    assert all(type(v) is np.float32 for v in sc.values())
    f32 = np.float32
    bc1, bc2 = GM.bias_corrections(step)
    assert bc1 == float(f32(1.0) - f32(GM.B1) ** f32(step))
    assert bc2 == float(f32(1.0) - f32(GM.B2) ** f32(step))
    assert (sc["b1"], sc["c1"], sc["b2"], sc["c2"], sc["eps"]) == (
        f32(0.9), f32(0.1), f32(0.999), f32(0.001), f32(1e-15))
    # PyTorch divides a float32 CUDA tensor by a Python float as a
    # multiply by the float32 reciprocal, taken in float32
    assert sc["inv_bc1"] == f32(1.0) / f32(bc1)
    assert sc["inv_bc2"] == f32(1.0) / f32(bc2)
    # a Python float against a float32 tensor is rounded to float32
    x = torch.randn(1000, generator=torch.Generator().manual_seed(step))
    for name, value in (("c1", 1 - GM.B1), ("c2", 1 - GM.B2),
                        ("b1", GM.B1), ("b2", GM.B2)):
        assert torch.equal(x * value, x * float(sc[name])), name


def bits(state) -> dict:
    return {k: v.view(torch.uint8) for k, v in state_tensors(state).items()}


@pytest.mark.parametrize("case", [(300, 3, 2, True), (301, 0, 0, True),
                                  (257, 1, 3, False)])
def test_cpu_path_is_the_three_plain_calls_bit_for_bit(case):
    n, sh, ch_sem, aligned = case
    cpu = torch.device("cpu")
    lrs = GM.LearningRates(**ADAM_LRS)
    launches = cuda_build.LAUNCHES["adam_stats"]
    state, grads, g2d, radii, vis = adam_inputs(n, sh, ch_sem, cpu, seed=n,
                                                aligned=aligned)
    # every output bit for bit, every input unchanged (compare_adam raises)
    got, err, bad = compare_adam(state, grads, lrs, g2d, (24.0, 15.5),
                                 radii, vis)
    assert (err, bad, got.adam.step) == (0.0, 0, 1)
    # the calls the trainer made before the entry point, written out
    want = GM.add_densification_stats(
        GM.adam_step(state, GM.mask_grads(grads, state.active), lrs),
        g2d * torch.tensor([24.0, 15.5]), radii, vis)
    want_bits = bits(want)
    assert all(torch.equal(v, want_bits[k]) for k, v in bits(got).items())
    _, grads, g2d, radii, vis = adam_inputs(n, sh, ch_sem, cpu, seed=n + 1)
    first = got
    got, err, bad = compare_adam(first, grads, lrs, g2d, (24.0, 15.5),
                                 radii, vis)
    assert (err, bad, got.adam.step) == (0.0, 0, 2)
    # the statistics moved on the visible active slots alone
    seen = vis & first.active
    assert bool((got.denom == first.denom + seen.float()).all())
    assert torch.equal(got.max_radii2d[~seen], first.max_radii2d[~seen])
    assert cuda_build.LAUNCHES["adam_stats"] == launches


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from fixtures import write_colmap_scene

    root = str(tmp_path_factory.mktemp("adam_scene"))
    write_colmap_scene(root, n_cams=3, n_pts=150, width=48, height=32)
    return root


def test_trainer_step_takes_the_plain_path_out_of_place(scene_dir, tmp_path,
                                                        monkeypatch):
    from test_torch_debug_hooks import config

    def refused():
        raise AssertionError("the kernel was asked for on the CPU")

    monkeypatch.setattr(GM, "_adam_kernel", refused)
    trainer = T.Trainer(config(scene_dir, tmp_path), device="cpu")
    for _ in range(2):
        before = trainer.state
        kept = {k: v.clone() for k, v in state_tensors(before).items()}
        launches = cuda_build.LAUNCHES["adam_stats"]
        trainer.train_step()
        after = trainer.state
        assert after.adam.step == before.adam.step + 1
        for k, v in state_tensors(before).items():
            assert torch.equal(v, kept[k]), k
        olds = state_tensors(before)
        shared = [k for k, v in state_tensors(after).items()
                  if k != "active" and v.numel()
                  and v.data_ptr() == olds[k].data_ptr()]
        assert not shared
        assert not torch.equal(after.params.xyz, before.params.xyz)
        assert cuda_build.LAUNCHES["adam_stats"] == launches
