"""Cells, configurations, traffic mixes, checks and metric readers are
found by name from files, and BENCHMARK.json keeps to the contract's form."""

import json
import re

import pytest

from harness import spec

BENCH = spec.ROOT / "BENCHMARK.json"
DATA = json.loads(BENCH.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in DATA["workloads"]])
def test_cell_loads_by_name(cell):
    c = spec.load_cell(cell)
    assert c.entry["chips"] == 1
    assert (spec.BENCH / "drivers" / f"{c.traffic['driver']}.py").is_file()
    assert all(callable(getattr(c.driver, f)) for f in ("measure", "judge", "control"))
    assert set(spec.load_json(spec.BENCH / "checks" / f"{cell}.json")["numbers"]) == \
        {n for n in c.check["numbers"]}
    e2e = {m.name for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        entry = next(x for x in DATA["per_layer"] if x["name"] == m.name)
        assert entry["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in DATA["end_to_end"] + DATA["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.load_reader(metric))


def test_form():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["paths"] == ["benchmark"] and DATA["command"][1] == "benchmark/run.py"
    assert 10 <= DATA["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in DATA[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (spec.ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in DATA["workloads"])
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert (spec.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in DATA["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in DATA["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)
    for m in DATA["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m["workloads"]) <= {w["name"] for w in DATA["workloads"]}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")
