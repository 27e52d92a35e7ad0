#!/usr/bin/env python3
"""Time the two streaming searches of ``dewi_tpu_torch`` over Q.

    python3 scripts/torch_stream_sweep.py [--root DIR] [--errors] [--no-check]

On one CUDA card, at cap 2^20 x 256 with 1,000,000 live rows and k = 10
(the bench protocol's streaming section): ``int8_stream_search`` at Q 1, 2,
4, 8, 16 and 32 and ``stream_search`` at Q 1, 8 and 32, each beside its
bound and its library call (``torch.matmul`` + ``torch.topk``), CUDA-event
medians of 50 (``chip_smoke.stream_cases``), after holding each result
against its plain version (scores within 1e-5, ids equal where the scores
stand apart, ``chip_smoke.compare_topk``).
``--root DIR`` takes the package from another checkout
(``DIR/dewi_tpu_torch``), so that two versions of the kernels can be timed
in turns on the same card: run parent, change, change, parent.
``--no-check`` times without the comparison (for a kernel deliberately
altered to find what a part of it costs).
``--errors`` also holds ``int8_stream_search`` against its plain version
at D 64, 256, 2048 and 8192 (cap 16,384, 16,000 live rows, Q 40, k 32) and
prints the largest score difference.
Prints the card and one JSON line per kernel and Q.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
INT8_Q = (1, 2, 4, 8, 16, 32)
F32_Q = (1, 8, 32)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--errors", action="store_true")
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from dewi_tpu_torch.ops import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    _build.load_library()
    print(json.dumps({"root": str(Path(args.root).resolve()),
                      "nvcc_seconds": _build.build_seconds}), flush=True)

    x = smoke.stream_inputs(1 << 20, smoke.DIM, max(INT8_Q), seed=0)
    for name, qs in (("int8_stream_search", INT8_Q), ("stream_search", F32_Q)):
        for nq in qs:
            kern, plain, lib, nbytes, ops, peak = smoke.stream_cases(
                x, nq, smoke.N_LIVE, smoke.K)[name]
            if not args.no_check:
                smoke.compare_topk(kern(), plain())
            bound_ms, bound_by = smoke.bound(nbytes, ops, peak)
            print(json.dumps({"sweep": name, "Q": nq,
                              "ms": smoke.time_device_ms(kern, 50, 400_000),
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "library_ms": smoke.time_device_ms(lib, 50, 400_000)}),
                  flush=True)
    del x
    torch.cuda.empty_cache()

    if args.errors:
        for d in (64, 256, 2048, 8192):
            x = smoke.stream_inputs(16384, d, 40, seed=d)
            kern, plain = smoke.stream_cases(x, 40, 16000, 32)["int8_stream_search"][:2]
            print(json.dumps({"errors": "int8_stream_search", "D": d,
                              "max_abs_err": smoke.compare_topk(kern(), plain())}), flush=True)
            del x
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
