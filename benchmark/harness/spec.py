"""Find a cell and everything that belongs to it by name.

``BENCHMARK.json`` at the root of the checkout names the cells
(``workloads``), the configurations and the metrics.  Everything else is a
file of its own, found by the name that ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the deployment (the ``file`` of its entry);
* ``traffic/<traffic>.json``: the traffic mix, parameters that the driver
  it names reads;
* ``drivers/<driver>.py``: the driver of a kind of traffic, with
  ``measure`` (set-up and window), ``judge`` (the check) and ``control``;
* ``checks/<cell>.json``: the numbers that decide ``correct`` and their limits;
* ``metrics/<metric>.py``: one reader per metric, ``read(run) -> float | None``.

A later cell, mix, driver or metric is added as files and entries; no
file here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclass
class Metric:
    name: str
    unit: str
    reader: Callable[[Any], Optional[float]]


@dataclass
class Cell:
    name: str
    entry: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    check: Dict[str, Any]
    driver: Any
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)

    @property
    def limits(self) -> Dict[str, float]:
        return {name: float(spec["limit"]) for name, spec in self.check["numbers"].items()}


def load_json(path: Path) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(folder: str, name: str) -> Any:
    """``<folder>/<name>.py``, loaded by file path (a name may hold dots
    and dashes, which a module name cannot)."""
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} file for {name!r} at {path}")
    key = "bench_%s_%s" % (folder, "".join(c if c.isalnum() else "_" for c in name))
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str) -> Callable[[Any], Optional[float]]:
    """``metrics/<name>.py``'s ``read``."""
    return load_module("metrics", name).read


def _applies(metric: Dict[str, Any], cell: str, reported: set) -> bool:
    """A metric with a ``workloads`` list applies to the cells it lists;
    one without applies wherever the end-to-end metric it moves is
    reported (an end-to-end metric without the list applies everywhere)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    check = load_json(BENCH / "checks" / f"{name}.json")
    e2e = [Metric(m["name"], m["unit"], load_reader(m["name"]))
           for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m.name for m in e2e}
    per_layer = [Metric(m["name"], m["unit"], load_reader(m["name"]))
                 for m in bench["per_layer"] if _applies(m, name, reported)]
    driver = load_module("drivers", traffic["driver"])
    return Cell(name, entry, config, traffic, check, driver, e2e, per_layer)


__all__ = ["BENCH", "ROOT", "Cell", "Metric", "load_cell", "load_json", "load_module",
           "load_reader"]
