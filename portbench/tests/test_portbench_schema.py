"""BENCHMARK.json against the benchmark's contract, and every file a cell,
a configuration or a metric is found by."""
import json
import os
import re

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def reports(bench, metric, cell):
    return cell in metric.get("workloads", [w["name"] for w in bench["workloads"]])


def test_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["configs"]) <= 24 and 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert len(bench["command"]) <= 32 and not any(w.startswith("/") or ".." in w
                                                   for w in bench["command"])
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert c["source"].startswith("https://") and c["reduced"] == []
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        names.append(w["name"])
    for kind, keys in (("end_to_end", {"name", "unit", "better", "bound", "source"}),
                       ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for m in bench[kind]:
            assert set(m) - {"workloads"} == keys
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and setup[0]["bound"] == 0.25


def test_every_cell_has_its_files_and_metrics(bench):
    cells = [w["name"] for w in bench["workloads"]]
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(ROOT, "portbench", "limits", w["name"] + ".json"))
        assert any(c["name"] == w["config"] for c in bench["configs"])
        e2e = [m["name"] for m in bench["end_to_end"] if reports(bench, m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(bench, m, w["name"]) for m in bench["per_layer"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", cells)) <= set(cells)


def test_each_per_layer_metric_moves_what_its_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", [w["name"] for w in bench["workloads"]]):
            assert reports(bench, e2e[m["moves"]], cell)
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.setdefault(m["layer"], set()).add(m["name"])
    for m in bench["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
