"""The legacy argument groups of the port (vcr_gaus_tpu_torch/compat/
arguments.py) against the JAX package's, as tests/test_compat.py holds
those: on the same argv both packages' groups register the same flags and
extract equal GroupParams field for field (``ModelParams.data_device``
defaults to ``cuda`` where the JAX package has ``tpu``, the one default
that differs), equal ``to_overrides``, and ``get_combined_args`` merges
the same ``cfg_args`` into equal Namespaces."""

import os
from argparse import ArgumentParser

import pytest

from vcr_gaus_tpu.compat import arguments as JA
from vcr_gaus_tpu_torch.compat import arguments as PA

ARGVS = {
    "shorthand": ["-s", "data/scene", "--iterations", "7000",
                  "--white_background"],
    "defaults": [],
    "long_flags": ["--source_path", "scene", "--model_path", "out",
                   "--resolution", "2", "--eval", "--sh_degree", "1",
                   "--images", "imgs", "--data_device", "cpu"],
    "short_and_pipeline": ["-m", "runs/a", "-r", "4", "-i", "rgb",
                           "--debug", "--convert_SHs_python",
                           "--densify_grad_threshold", "0.001",
                           "--random_background", "--opacity_lr", "0.1"],
}


def groups(pkg, fill_none=False):
    """A parser with the three groups of ``pkg`` registered."""
    parser = ArgumentParser()
    mp, op, pp = pkg.ModelParams(), pkg.OptimizationParams(), \
        pkg.PipelineParams()
    mp.register(parser, "Loading Parameters", fill_none)
    op.register(parser, "Optimization Parameters", fill_none)
    pp.register(parser, "Pipeline Parameters", fill_none)
    return parser, (mp, op, pp)


def extract_all(pkg, argv, fill_none=False):
    parser, (mp, op, pp) = groups(pkg, fill_none)
    args = parser.parse_args(argv)
    return args, [vars(g.extract(args)) for g in (mp, op, pp)], \
        mp.to_overrides(mp.extract(args))


@pytest.mark.parametrize("fill_none", [False, True])
@pytest.mark.parametrize("case", sorted(ARGVS))
def test_groups_extract_like_jax(case, fill_none):
    argv = ARGVS[case]
    jargs, jgroups, jover = extract_all(JA, argv, fill_none)
    pargs, pgroups, pover = extract_all(PA, argv, fill_none)
    device_given = "--data_device" in argv
    want_args = dict(vars(jargs))
    want_over = dict(jover)
    if not device_given and not fill_none:
        assert (jargs.data_device, pargs.data_device) == ("tpu", "cuda")
        want_args["data_device"] = "cuda"
        jgroups[0]["data_device"] = "cuda"
    assert vars(pargs) == want_args
    assert pgroups == jgroups
    assert pover == want_over
    assert "data_device" not in pover
    if argv and argv[0] == "-s":
        assert pgroups[0]["source_path"] == os.path.abspath("data/scene")


def test_only_data_device_default_differs():
    for name in ("ModelParams", "OptimizationParams", "PipelineParams"):
        want = vars(getattr(JA, name)())
        got = vars(getattr(PA, name)())
        diff = {k for k in want if want[k] != got[k]}
        assert set(got) == set(want)
        assert diff == ({"data_device"} if name == "ModelParams" else set())
    assert PA.ModelParams._CONFIG_KEYS == JA.ModelParams._CONFIG_KEYS
    assert "cuda" in PA.ModelParams.__doc__


@pytest.mark.parametrize("argv", [["--iteration", "7"], [],
                                  ["--iteration", "3", "--skip_train"]])
def test_combined_args_like_jax(tmp_path, argv):
    cfg = {"model": {"sh_degree": 2, "source_path": "x"},
           "optim": {"iterations": 100, "lrs": [0.1, 0.2]},
           "logdir": str(tmp_path), "flag": True, "none": None}
    JA.write_cfg_args(cfg, str(tmp_path))
    with open(tmp_path / "cfg_args") as f:
        jtext = f.read()
    PA.write_cfg_args(cfg, str(tmp_path))
    with open(tmp_path / "cfg_args") as f:
        assert f.read() == jtext

    def parser():
        p = ArgumentParser()
        p.add_argument("--model_path", default=str(tmp_path))
        p.add_argument("--iteration", type=int, default=None)
        p.add_argument("--skip_train", action="store_true")
        return p

    want = JA.get_combined_args(parser(), argv)
    got = PA.get_combined_args(parser(), argv)
    assert vars(got) == vars(want)
    assert got.model_sh_degree == 2 and got.optim_lrs == [0.1, 0.2]
    assert vars(got).get("iteration") == (int(argv[1]) if argv else None)


def test_combined_args_ignores_what_it_cannot_parse(tmp_path):
    """A cfg_args that is not a Namespace repr, or holds a call, is never
    evaluated: the command line alone comes back, in both packages."""
    p = ArgumentParser()
    p.add_argument("--model_path", default=str(tmp_path))
    p.add_argument("--iteration", type=int, default=5)
    for text in ("Namespace(a=__import__('os').getcwd())",
                 "not a namespace", "Namespace(a=1"):
        (tmp_path / "cfg_args").write_text(text)
        got = PA.get_combined_args(p, [])
        assert vars(got) == vars(JA.get_combined_args(p, []))
        assert vars(got) == {"model_path": str(tmp_path), "iteration": 5}
    os.remove(tmp_path / "cfg_args")
    assert vars(PA.get_combined_args(p, ["--iteration", "9"])) == {
        "model_path": str(tmp_path), "iteration": 9}
