#!/usr/bin/env python3
"""Time the stage-1 kernels of ``dewi_tpu_torch`` over Q.

    python3 scripts/torch_stage1_sweep.py [--root DIR] [--errors] [--no-check]

On one CUDA card, at cap 2^20 x 256: ``bmax``, ``bmax_t`` and
``scores_matrix`` over int8 and bf16 rows, ``bmax_s8``, ``bmax_s8_t`` and
``scores_matrix_s8`` over int8 rows, ``bmax_s4`` and ``scores_matrix_s4``
over the packed int4 rows of the same corpus, at Q 1, 2, 4, 8, 16 and 32,
each beside its bound (CUDA-event medians of 50,
``chip_smoke.stage1_sweep``), after holding each against its plain
version (the s8 and int4 kernels bit for bit).
``--root DIR`` takes the package from another checkout
(``DIR/dewi_tpu_torch``), so that two versions of the kernels can be timed
in turns on the same card: run parent, change, change, parent.
``--errors`` also prints, at cap 16,384 and D 64, 256, 2048 and 8192 with
32 queries, the largest |kernel - plain| of ``scores_matrix`` and how far
that is from the tolerance of the checks (rtol 1e-5 plus 1e-5 of the
largest |plain|; 1.0 would be at the limit), and asserts that the three s8
and the two int4 kernels equal their plain versions there.  ``--no-check`` times without
the comparison (for a kernel deliberately altered to find what it costs).
Prints the card and one JSON line per row.
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
    from dewi_tpu_torch.ops import cuda_search as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    _build.load_library()
    print(json.dumps({"root": str(Path(args.root).resolve()),
                      "nvcc_seconds": _build.build_seconds}), flush=True)

    s8_kernels = ((cs.bmax_s8, cs.bmax_s8_plain), (cs.bmax_s8_t, cs.bmax_s8_t_plain),
                  (cs.scores_matrix_s8, cs.scores_matrix_s8_plain))
    s4_kernels = ((cs.bmax_s4, cs.bmax_s4_plain),
                  (cs.scores_matrix_s4, cs.scores_matrix_s4_plain))
    x = smoke.kernel_inputs(1 << 20, 256, 32, seed=0)
    for nq in () if args.no_check else smoke.SWEEP_Q:
        q = x["q"][:nq].contiguous()
        for emb, mult in ((x["e8"], x["m8"]), (x["ebf"], x["mbf"])):
            smoke.compare(cs.bmax(emb, mult, x["add"], q),
                          cs.bmax_plain(emb, mult, x["add"], q), 1e-5, 1e-5)
            smoke.compare(cs.scores_matrix(emb, mult, x["add"], q),
                          cs.scores_matrix_plain(emb, mult, x["add"], q), 1e-5, 1e-5)
        q8 = (x["q8"][:nq].contiguous(), x["qs"][:nq].contiguous())
        for rows, mult, kernels in ((x["e8"], x["m8"], s8_kernels),
                                    (x["p4"], x["m4"], s4_kernels)):
            for fn, plain in kernels:
                smoke.compare(fn(rows, mult, x["add"], *q8), plain(rows, mult, x["add"], *q8),
                              0.0, 0.0)
    for key, row in smoke.stage1_sweep(x).items():
        print(json.dumps({"sweep": key, **row}), flush=True)
    del x
    torch.cuda.empty_cache()

    if args.errors:
        for d in (64, 256, 2048, 8192):
            x = smoke.kernel_inputs(16384, d, 32, seed=d)
            for rows, emb, mult in (("int8", x["e8"], x["m8"]), ("bf16", x["ebf"], x["mbf"])):
                got = cs.scores_matrix(emb, mult, x["add"], x["q"])
                want = cs.scores_matrix_plain(emb, mult, x["add"], x["q"])
                torch.cuda.synchronize()
                fin = torch.isfinite(want)
                err = (got - want).abs()[fin]
                lim = 1e-5 * want.abs()[fin] + 1e-5 * want.abs()[fin].max()
                print(json.dumps({"errors": rows, "D": d, "max_abs_err": float(err.max()),
                                  "max_abs_plain": float(want.abs()[fin].max()),
                                  "share_of_tolerance": float((err / lim).max())}),
                      flush=True)
            s8 = (x["e8"], x["m8"], x["add"], x["q8"], x["qs"])
            s4 = (x["p4"], x["m4"], x["add"], x["q8"], x["qs"])
            for fn, plain, inputs in ([(f, p, s8) for f, p in s8_kernels]
                                      + [(f, p, s4) for f, p in s4_kernels]):
                got, want = fn(*inputs), plain(*inputs)
                torch.cuda.synchronize()
                smoke.check(torch.equal(got, want), f"{fn.__name__} differs from plain at D={d}")
                print(json.dumps({"errors": fn.__name__, "D": d, "max_abs_err": 0.0}),
                      flush=True)
            del x
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
