"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by name."""

import json
import re

import pytest

from portbench.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = spec.benchmark()
CELLS = [w["name"] for w in B["workloads"]]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= B["run_seconds"] <= 51
    assert B["command"][:2] == ["python3", "portbench/run.py"]
    assert len(json.dumps(B)) <= 64 * 1024
    for p in B["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200, (e["name"], k)
                    assert "\n" not in e[k] and "\t" not in e[k]
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in B[group]]
        assert len(ns) == len(set(ns))
    metrics = [e["name"] for g in ("end_to_end", "per_layer") for e in B[g]]
    assert len(metrics) == len(set(metrics))
    for w in B["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in B["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_four_chip_cells_are_few():
    four = [w for w in B["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(B["workloads"]) // 4)


def test_setup_s_is_reported_everywhere():
    setup = [m for m in B["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    assert setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist(cell):
    c = spec.Cell(cell)
    assert c.config_file.is_file()
    assert c.config_file.with_suffix(".py").is_file()
    assert c.config_file.is_relative_to(spec.BENCH)
    assert c.workload["chips"] == c.chips
    assert c.workload["why"] == c.entry["why"]
    assert c.limits(), "a cell's check compares at least one number"
    assert hasattr(c.entry_module(), "Entry")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_enough(cell):
    c = spec.Cell(cell)
    e2e = [m["name"] for m, _ in c.metrics(False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.metrics(True), "every cell reports a per-layer metric"


def test_every_config_is_used():
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}


def test_per_layer_cells_report_what_they_move():
    for m in B["per_layer"]:
        moved = next(e for e in B["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


def test_layers_are_spelt_alike():
    layers = {m["layer"] for m in B["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)


@pytest.mark.parametrize("metric", [m["name"] for g in ("end_to_end",
                                                        "per_layer")
                                    for m in B[g]])
def test_every_metric_has_a_reader(metric):
    mod = spec.load_module(spec.BENCH / "metrics" / f"{metric}.py", metric)
    assert callable(mod.read)


def test_every_file_is_named():
    """No cell, mix, entry or reader lies unused: each file under those
    folders is named by BENCHMARK.json or by a mix it names."""
    mixes = {w["traffic"] for w in B["workloads"]}
    named = {
        "workloads": {f"{c}.json" for c in CELLS},
        "traffic": {f"{t}.json" for t in mixes},
        "entries": {spec.Cell(c).traffic["entry"] + ".py" for c in CELLS},
        "metrics": {m["name"] + ".py" for g in ("end_to_end", "per_layer")
                    for m in B[g]},
    }
    for folder, names in named.items():
        found = {p.name for p in (spec.BENCH / folder).iterdir()
                 if p.suffix in (".json", ".py")}
        assert found == names, folder
