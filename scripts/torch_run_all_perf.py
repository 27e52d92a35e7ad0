#!/usr/bin/env python3
"""Run every profiler of the port, one after another, on the card.

    python3 scripts/torch_run_all_perf.py [--skip e2e_images,serving] [--only ...] [--dry-run]

Counterpart of ``scripts/run_all_perf.py``: the ``scripts/torch_*``
profilers as subprocesses, each with its timeout, in the reference's
order (e2e text, e2e images, IVF 1M, the scan breakdown, the IVF recall
curve, serving, sharded signals, tokenize scaling).  A stage that fails
or runs out of time does not stop the rest.  The artifacts go under
``chiprun_out/perf/``.  The reference's last stage, ``bench`` (its
``bench.py``), is left out until the port has a bench of its own; a line
says so.  The reference's wait on a lock file in ``/tmp`` (a convention
of its single-core host) is not ported.  Exits 0 when every stage ran
and exited 0.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = "chiprun_out/perf"

STAGES = [
    ("e2e_text", 900, [sys.executable, "scripts/torch_profile_e2e.py", "--n-docs", "16000",
                       "--output", f"{OUT}/e2e_pipeline.json"]),
    ("e2e_images", 1200, [sys.executable, "scripts/torch_profile_e2e.py", "--n-docs", "8000",
                          "--images", "--image-size", "64", "--clip-image-size", "64",
                          "--skip-object", "--output", f"{OUT}/e2e_pipeline_images.json"]),
    ("ivf_1m", 1800, [sys.executable, "scripts/torch_profile_ivf_1m.py",
                      "--output", f"{OUT}/ivf_clustered_1m.json"]),
    ("scan_breakdown", 900, [sys.executable, "scripts/torch_profile_scan_breakdown.py",
                             "--output", f"{OUT}/scan_breakdown.json"]),
    ("ivf_recall_curve", 3600, [sys.executable, "scripts/torch_profile_ivf_recall_curve.py",
                                "--output", f"{OUT}/ivf_recall_curve.json"]),
    ("serving", 900, [sys.executable, "scripts/torch_profile_serving.py",
                      "--output", f"{OUT}/serving.json"]),
    ("signals_sharded", 900, [sys.executable, "scripts/torch_profile_signals_sharded.py",
                              "--output", f"{OUT}/signals_sharded.json"]),
    ("tokenize_scaling", 600, [sys.executable, "scripts/torch_profile_tokenize_scaling.py",
                               "-o", f"{OUT}/tokenize_ci.json"]),
]
LEFT_OUT = {"bench": "the reference's bench.py stage: the port has no bench yet"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip", default="", help="comma list of stage names")
    ap.add_argument("--only", default="", help="comma list of stage names")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    skip = {s for s in args.skip.split(",") if s}
    only = {s for s in args.only.split(",") if s}

    results = {}
    for name, timeout, cmd in STAGES:
        if name in skip or (only and name not in only):
            print(f"== {name}: skipped", flush=True)
            continue
        print(f"== {name}: {' '.join(cmd)} (timeout {timeout}s)", flush=True)
        if args.dry_run:
            continue
        t0 = time.time()
        try:
            rc = subprocess.run(cmd, cwd=ROOT, timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc = -1
        results[name] = (rc, round(time.time() - t0, 1))
        print(f"== {name}: rc={rc} ({results[name][1]}s)", flush=True)
    for name, why in LEFT_OUT.items():
        print(f"== {name}: left out ({why})", flush=True)
    print("== summary:", results, flush=True)
    return 0 if all(rc == 0 for rc, _ in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
