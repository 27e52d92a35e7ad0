#!/usr/bin/env python3
"""Readings of a cell's control: the reference in the program's place, one
precision below the deployment's, judged by the cell's own comparison.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

The control is the ``control`` of the driver that the cell's traffic names
(``drivers/<driver>.py``), run on the card at the cell's size.  One JSON
line per seed with each compared number and its limit; the benchmark's own
runs never run this.  The control has to come out not correct: each
line's ``correct`` is false.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from harness.spec import load_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        run = cell.driver.control(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": run.correct(),
                          "check": {n: {"value": v, "limit": lim}
                                    for n, v, lim in run.checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
