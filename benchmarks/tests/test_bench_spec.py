"""BENCHMARK.json against the benchmark's contract, and the harness as
data: every cell, configuration, traffic mix and metric is a file the
harness finds by its name."""

import importlib.util
import json
import os
import re

import pytest

from bench_helpers import BENCH_DIR, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _module(path):
    sp = importlib.util.spec_from_file_location(os.path.basename(path)[:-3].replace(".", "_"), path)
    m = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(m)
    return m


def _line(text, limit=200):
    return isinstance(text, str) and 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes(spec):
    assert set(spec) == KEYS
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert spec["paths"] == ["benchmarks"] and spec["command"] == ["python3", "benchmarks/run.py"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    # a full check of 24 cells (2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s of compile a cell, 1,200 s spare) fits 43,200 s
    assert 1200 + (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 2 * 90 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(spec, section):
    names = [e["name"] for e in spec[section]]
    assert len(names) == len(set(names))
    for e in spec[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_cells_configs_and_traffic_exist(spec):
    configs = {c["name"]: c for c in spec["configs"]}
    used = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert w["config"] in configs, w
        used.add(w["config"])
        assert os.path.exists(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    assert used == set(configs)
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmarks/") and _line(c["source"]) and _line(c["why"])
        with open(os.path.join(REPO, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["source"] == c["source"] and body["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(BENCH_DIR, "drivers", f"{body['driver']}.py"))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_every_metric_moves_what_its_cells_report(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and all("bound" in m and 0 < m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = [w["name"] for w in spec["workloads"]]

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert any(reports(m, cell) for n, m in e2e.items() if n != "setup_s")
        assert any(reports(m, cell) for m in spec["per_layer"])


def test_every_per_layer_metric_has_a_reader(spec):
    """A metric's name, unit, layer, ``moves`` and cells are stated once,
    in BENCHMARK.json; its file under ``metrics/`` holds only the reader."""
    layers = {}
    for m in spec["per_layer"]:
        mod = _module(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py"))
        assert callable(mod.read)
        layers.setdefault(m["layer"], set()).add(m["name"])
    # metrics of one layer give it letter for letter; no two layers differ only in case
    assert len({k.lower() for k in layers}) == len(layers)


def test_at_most_a_quarter_of_cells_on_four_chips(spec):
    four = sum(1 for w in spec["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(spec["workloads"]) // 4)
