"""The port's forward-loop microprobe against the JAX probe of
scripts/kernel_microprobe.py.

The script builds its Pallas kernel inside ``main()``, which also times it
on the chip. The test runs that kernel without editing the script: it
parses the file, executes the ``kernel`` and ``build`` definitions and the
``VARIANTS`` table of ``main()`` at 2 tiles x 2 chunks, with a ``pl`` whose
``pallas_call`` runs in interpret mode and records the callable it makes,
and calls that callable for the whole (tiles, 1024, 16) output. Channels
0..9 are held to atol 2e-4 times the channel's own max|value| and rtol 1e-3
(the no_exp variant reaches ~1e8); the script's channels 10..15 are zero.
"""

import ast
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import compare_probe
from vcr_gaus_tpu_torch.ops import microprobe as M
from vcr_gaus_tpu_torch.tools import kernel_microprobe as KM

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "kernel_microprobe.py")
N_TILES, CHUNKS = 2, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _main_statements(keep):
    """The statements of the script's ``main()`` that ``keep`` accepts, as
    a compiled module."""
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = [n for n in main.body if keep(n)]
    return compile(ast.Module(body=body, type_ignores=[]), SCRIPT, "exec")


class _InterpretPallas:
    """``pl`` with ``pallas_call`` in interpret mode; keeps what it makes."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, *args, **kwargs):
        call = pl.pallas_call(*args, interpret=True, **kwargs)
        self.calls.append(call)
        return call


@functools.cache
def _script():
    """(namespace with the script's kernel, build and VARIANTS, the pl
    stand-in) at N_TILES x CHUNKS."""
    def keep(n):
        if isinstance(n, ast.FunctionDef):
            return n.name in ("kernel", "build")
        return isinstance(n, ast.Assign) and any(
            getattr(t, "id", None) == "VARIANTS" for t in n.targets)

    shim = _InterpretPallas()
    ns = dict(jax=jax, jnp=jnp, pl=shim, pltpu=pltpu, functools=functools,
              TILE=32, P=1024, G=256, F_PAD=24, C_ACC=6, OUT_PAD=16,
              N_TILES=N_TILES, CHUNKS=CHUNKS)
    exec(_main_statements(keep), ns)
    return ns, shim


@functools.cache
def jax_probe(name: str) -> np.ndarray:
    """The script's kernel for variant ``name`` on the script's inputs:
    (N_TILES, 1024, 16) f32."""
    ns, shim = _script()
    ns["build"](**ns["VARIANTS"][name])
    feats, starts, counts = M.probe_inputs(N_TILES, CHUNKS)
    out = shim.calls[-1](jnp.asarray(starts), jnp.asarray(counts),
                         jnp.asarray(feats))
    return np.asarray(out)


def port_inputs():
    return [torch.from_numpy(a) for a in M.probe_inputs(N_TILES, CHUNKS)]


def test_variants_are_the_scripts():
    ns, _ = _script()
    assert list(ns["VARIANTS"]) == list(M.VARIANTS)
    for name, toggles in ns["VARIANTS"].items():
        assert M.toggles_of(name) == {"depth": 2, "Gc": 256, "unroll": 1,
                                      **toggles}


def test_probe_inputs_are_the_scripts():
    names = ("E", "rng", "feats", "starts", "counts")
    ns = dict(np=np, jnp=jnp, N_TILES=3, CHUNKS=2, F_PAD=24, G=256)
    exec(_main_statements(lambda n: isinstance(n, ast.Assign) and any(
        getattr(t, "id", None) in names for t in n.targets)), ns)
    for got, name in zip(M.probe_inputs(3, 2), names[2:]):
        want = np.asarray(ns[name])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", list(M.VARIANTS))
def test_plain_matches_jax(variant):
    want = jax_probe(variant)
    assert want.shape == (N_TILES, M.P, 16)
    assert not want[..., 10:].any()
    got = M.microprobe_torch(*port_inputs(), **M.toggles_of(variant))
    errs = compare_probe(got, torch.from_numpy(want[..., :10].copy()))
    # channel 0 is prev * 0.99 of zeros; every variant fills 1..3
    assert errs[0][1] == 0 and all(scale > 0 for _, scale in errs[1:4])
    if variant in ("full_g128", "full_g512"):
        # the transmittance resets at every chunk: the chunk size changes
        # the function
        assert not np.allclose(want, jax_probe("full"), rtol=1e-3)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    ins = port_inputs()
    torch.testing.assert_close(
        M.microprobe(*ins, **M.VARIANTS["no_exp"]),
        M.microprobe_torch(*ins, **M.toggles_of("no_exp")), rtol=0, atol=0)


def test_live_shares_of_the_probe_inputs():
    ins = [torch.from_numpy(a) for a in M.probe_inputs(1, 6)]
    c = M.pair_census(*ins, use_exp=True, use_alpha=True)
    pairs = c["pairs"]
    assert pairs == 6 * 256 * 1024 and abs(c["live"] / pairs - 0.023) < 1e-3
    # the live pixels lie in the tile's first rows: the warps of those rows
    # take the live body on many entries, the others on none
    assert c["warp_steps"] == pairs // 32
    assert c["live"] / 32 < c["warp_steps_live"] < c["live"]
    assert c["warp_steps_live"] / 32 < c["busiest_warp_live_steps"] <= 6 * 256
    lin = M.pair_census(*ins, use_exp=False, use_alpha=True)
    assert abs(lin["live"] / pairs - 0.299) < 1e-3
    assert M.pair_census(*ins, use_exp=False, use_alpha=False)["live"] == pairs


@pytest.mark.parametrize("case", ["ragged_count", "start_off_128",
                                  "past_the_end", "not_a_variant",
                                  "int64_starts", "meta_device"])
def test_wrapper_rejects(case):
    feats, starts, counts = port_inputs()
    toggles = dict(M.VARIANTS["full"])
    if case == "ragged_count":
        counts[0] -= 1
    elif case == "start_off_128":
        starts[1] += 64
    elif case == "past_the_end":
        starts[1] += 256
    elif case == "not_a_variant":
        toggles["use_exp"] = False
        toggles["unroll"] = 3
    elif case == "int64_starts":
        starts = starts.to(torch.int64)
    else:
        feats, starts, counts = (t.to("meta") for t in (feats, starts, counts))
    with pytest.raises(ValueError):
        M.microprobe(feats, starts, counts, **toggles)


def test_entry_point_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KM.main(["--n-tiles", "1", "--chunks", "1"])


def test_entry_point_on_the_cpu(capsys, tmp_path):
    out = tmp_path / "probe.json"
    res = KM.main(["--device", "cpu", "--n-tiles", "2", "--chunks", "2",
                   "--out", str(out)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["variant"] for ln in lines] == list(M.VARIANTS)
    assert json.loads(out.read_text()) == res
    for ln in lines:
        # a CPU run names no device time
        assert ln["ms"] is None and ln["x_bound"] is None
        assert ln["cpu_ms"] > 0 and ln["bound_by"] == "operations"
    s = res["summary"]
    assert s["full_g512"]["n_chunks"] == 2 and s["full_g128"]["n_chunks"] == 8
    assert s["dma_only"]["live_share"] == 1.0
    # 12 operations for every pair, 3 more past the power test (99.7% of
    # them), 31 more for a live one, and one add per (pixel, chunk)
    full = s["full"]
    assert full["ops_per_pair"] == pytest.approx(
        12 + 3 * 0.997 + 31 * full["live_share"] + 1 / 256, abs=2e-3)
    assert KM.pair_ops(**M.toggles_of("dma_only")) == (9, 0, 0)
