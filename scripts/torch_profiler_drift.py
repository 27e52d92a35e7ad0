#!/usr/bin/env python3
"""Does ``torch.profiler`` keep every device event as the process ages?

    python3 scripts/torch_profiler_drift.py [--launches 100] [--waits 0,60,120,120]

After each wait (seconds idle, from the first), one bare ``torch.profiler``
session around ``--launches`` back-to-back ``add_`` kernels, counted from
``key_averages``, beside ``launched_kernels`` on the same call (which opens
its session with empty kernels for the profiler to drop, counts those it
dropped, ``lead_lost``, and checks the host's launches against the
device's events).  Writes one JSON row per age to ``--output``; fails
where ``launched_kernels`` misses a launch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launches", type=int, default=100)
    ap.add_argument("--waits", default="0,60,120,120")
    ap.add_argument("--output", default=str(REPO / "chiprun_out" / "profiler_drift.json"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dewi_tpu_torch.utils.device import resolve_device
    from dewi_tpu_torch.utils.profiling import card_line, launched_kernels

    device = resolve_device(None)  # a CUDA device's profiler: no CPU run
    t0 = time.perf_counter()
    x = torch.zeros(1024, device=device)

    def fn() -> None:
        for _ in range(args.launches):
            x.add_(1.0)

    rows = []
    for wait in (float(w) for w in args.waits.split(",")):
        time.sleep(wait)
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(device)
        bare = sum(int(e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        lk = launched_kernels(fn, device)
        row = {"age_s": time.perf_counter() - t0, "launches": args.launches,
               "bare_session_kept": bare, "launched_kernels_ops": lk["ops"],
               "launched_kernels_kept": sum(lk["kernels"].values()),
               "launched_kernels_complete": lk["complete"],
               "launched_kernels_lead_lost": lk["lead_lost"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = {"card": card_line(), "rows": rows}
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(out, indent=2) + "\n")
    ok = all(r["launched_kernels_complete"] and r["launched_kernels_kept"] == args.launches
             for r in rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
