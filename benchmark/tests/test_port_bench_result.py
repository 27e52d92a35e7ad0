"""A run on the CPU at a tiny size, with the look for a card skipped: the
last line has exactly the contract's keys, and each metric its unit."""

import json

import pytest
import torch

import run as bench_run
from conftest import tiny_corpus, tiny_search

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def line_of(cell, traced=False):
    r = bench_run.execute(cell, 2 ** 31 + 3, 1.0, traced, torch.device("cpu"), 0.0)
    info = {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 0}
    return r, bench_run.result_line(cell, r, info)


@pytest.mark.parametrize("make,name", [(tiny_search, "search-batch-q1000"),
                                       (tiny_corpus, "corpus-web-text")])
def test_last_line_has_the_contract_keys(make, name):
    cell = make(name)
    r, line = line_of(cell)
    assert list(line) == KEYS  # "check" comes last
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m.name for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert line["metrics"][m.name]["unit"] == m.unit and line["metrics"][m.name]["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in line["check"].values())
    json.loads(json.dumps(line))


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_run.main(["--workload", "search-batch-q1000", "--seed", "1",
                           "--seconds", "1", "--trace", "0"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_forbidden_modules_are_named(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "jax", object())
    assert bench_run.forbidden_modules() == ["jax"]
