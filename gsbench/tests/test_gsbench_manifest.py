"""BENCHMARK.json against the benchmark's contract, and every file it names
found where the harness looks for it."""

from __future__ import annotations

import json
import os
import re

import pytest
import yaml

from gsbench import harness as H

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return H.manifest()


def test_keys_and_sizes(bench):
    assert set(bench) == KEYS
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p.split("/")
               for p in bench["paths"])
    assert len(bench["command"]) <= 32
    assert 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_and_units(bench):
    entries = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
               + bench["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
                assert "\t" not in e[k]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_its_metrics_move(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        c = H.cell(w["name"], bench)
        mine = {m["name"] for m in c.end_to_end}
        assert "setup_s" in mine and len(mine) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in mine, (w["name"], m["name"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        names = {w["name"] for w in bench["workloads"]}
        assert set(m.get("workloads", names)) <= names


def test_files_found_by_name(bench):
    for c in bench["configs"]:
        path = os.path.join(H.ROOT, c["file"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        with open(path) as f:
            cfg = yaml.safe_load(f)
        assert {"population", "views", "init_points"} <= set(cfg["bench"])
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for w in bench["workloads"]:
        c = H.cell(w["name"], bench)
        driver = H.load_driver(c.traffic["kind"])
        assert c.limits and set(c.limits) <= set(driver.NUMBERS)
        assert all(v > 0 for v in c.limits.values())
    for m in bench["per_layer"]:
        assert callable(H.load_reader(m["name"]))


def test_a_kind_without_a_driver_is_refused():
    with pytest.raises(ValueError, match="no driver"):
        H.load_driver("no_such_kind")


def test_command_stays_inside_paths(bench):
    for word in bench["command"]:
        if "/" in word:
            assert not word.startswith("/") and ".." not in word.split("/")
            assert any(word.startswith(p + "/") for p in bench["paths"])


def test_a_full_check_fits_the_time(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
