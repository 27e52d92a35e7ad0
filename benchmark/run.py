#!/usr/bin/env python3
"""Run one cell of the benchmark of ``dewi_tpu_torch`` once, on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout; its configuration, traffic, driver, check and metric readers
are files under ``benchmark/`` found by name (``harness/spec.py``).  The run
builds its inputs and weights from ``--seed``, warms up every shape its
traffic uses (set-up), measures for ``--seconds``, checks what the timed
path produced against the plain reference under ``benchmark/reference/``,
and prints one JSON line as the last line of its standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics read from a profiled
stretch after the window), ``device``, with ``--trace 1`` ``breakdown``,
and last ``check``: each compared number beside its limit, which also
close standard error.

It exits with 2 and prints no result where there is no CUDA card, or fewer
than the cell asks for, and with 3 where ``jax``, ``jaxlib``, ``flax`` or
the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dewi_tpu")


def set_environment() -> None:
    """Build and kernel caches inside the checkout, at fixed paths, so that
    only a cell's first run in a checkout builds; no library loads JAX."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(BENCH), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv: list) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(cell: object, seed: int, seconds: float, traced: bool, device: object,
            t_start: float) -> object:
    """Set-up, window and check of one cell on ``device`` by the driver
    that its traffic names: the ``Run``."""
    run, state = cell.driver.measure(cell, seed, seconds, traced, device, t_start)
    run.notes.extend(forbidden_modules())
    cell.driver.judge(run, cell, seed, device, state)
    return run


def result_line(cell: object, run: object, device_info: dict) -> dict:
    metrics = {}
    for m in (cell.per_layer if run.traced else cell.end_to_end):
        value = m.reader(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    out = {"correct": run.correct(), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": dict(device_info)}
    if run.traced and run.trace is not None:
        out["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps}
    out["check"] = {name: {"value": value, "limit": limit} for name, value, limit in run.checks}
    return out


def main(argv: list = None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    set_environment()
    from harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: the cell needs {need} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = execute(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    loaded = sorted(set(run.notes) | set(forbidden_modules()))
    if loaded:
        print(f"benchmark: the run loaded {loaded}; the port must run without them",
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": need,
            "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = result_line(cell, run, info)
    for name, value, limit in run.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
