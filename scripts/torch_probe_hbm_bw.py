#!/usr/bin/env python3
"""Measure the card's reachable device-memory rate.

    python3 scripts/torch_probe_hbm_bw.py [--mb 256] [--chain 64] [--reps 5]

Counterpart of ``scripts/probe_hbm_bw.py``: the same read patterns over a
``--mb`` array, each a plain PyTorch call (what this probe measures is
exactly those calls), its ms per call and GB/s beside the share of the
H100's nominal 3.35 TB/s:

  reduce_sum_f32  - ``sum(dtype=float32)`` of an int8 array (read + convert + reduce)
  copy_rw         - ``copy_`` into a second int8 array (2x bytes)
  matvec_bf16     - ``torch.matmul`` of ``[1, D]`` with ``[D, N]`` bf16 rows
  matmul128_bf16  - the same with 128 queries (the ``[128, N]`` output is
                    written too; GB/s counts the rows read, as the reference)

The bf16 rows are a bf16 array of the same ``--mb`` bytes (torch has no
product that reads int8 rows as bf16).  Each row: ``--chain`` back-to-back
calls between two CUDA events, the median of ``--reps`` such windows, with
their spread.  256 MB is five times the card's 50 MB L2, so no window is
served from it; a row above 105% of the nominal rate is a fault of the
method.  ``sanity_chain2x_per_iter_ratio``: ms per call at twice the chain
over ms at the chain (near 1 when a call's time does not depend on the
window).  Writes ``--output`` (JSON).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

NOMINAL_GBPS = 3350.0  # H100 SXM HBM3, NVIDIA's data sheet


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=256)
    ap.add_argument("--chain", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--output", default=str(REPO / "chiprun_out" / "hbm_bw.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from dewi_tpu_torch.utils.device import resolve_device
    from dewi_tpu_torch.utils.profiling import card_line, chained_ms, device_name

    device = resolve_device(args.device)
    n_bytes = args.mb * (1 << 20)
    d = args.dim
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randint(-127, 128, (n_bytes // d, d), dtype=torch.int8, device=device,
                      generator=gen)
    y = torch.empty_like(x)
    xb = torch.randn((n_bytes // (2 * d), d), device=device, generator=gen).to(torch.bfloat16)
    q1 = torch.randn((1, d), device=device, generator=gen).to(torch.bfloat16)
    q128 = torch.randn((128, d), device=device, generator=gen).to(torch.bfloat16)

    rows = {
        "reduce_sum_f32": (lambda: x.sum(dtype=torch.float32), n_bytes),
        "copy_rw": (lambda: y.copy_(x), 2 * n_bytes),
        "matvec_bf16": (lambda: torch.matmul(q1, xb.T), n_bytes),
        "matmul128_bf16": (lambda: torch.matmul(q128, xb.T), n_bytes),
    }
    results = {}
    for name, (fn, nbytes) in rows.items():
        fn()
        ms, _ = chained_ms(fn, device, args.chain, args.reps)
        p50 = statistics.median(ms)
        gbps = nbytes / (p50 * 1e-3) / 1e9
        results[name] = {"ms": p50, "spread_ms": max(ms) - min(ms), "bytes": nbytes,
                         "gbps": gbps, "share_of_nominal": gbps / NOMINAL_GBPS}
        print(f"{name:16s} {json.dumps(results[name])}", flush=True)
    fn = rows["reduce_sum_f32"][0]
    t2 = statistics.median(chained_ms(fn, device, 2 * args.chain, args.reps)[0])
    results["sanity_chain2x_per_iter_ratio"] = t2 / results["reduce_sum_f32"]["ms"]
    if results["sanity_chain2x_per_iter_ratio"] < 0.5:
        print("SANITY FAILED: chain-2x per-iter time halved; not publishing",
              file=sys.stderr)
        return 1

    out = {"device": device_name(device), "card": card_line(), "bytes": n_bytes,
           "chain": args.chain, "reps": args.reps, "nominal_gbps": NOMINAL_GBPS,
           "method": ("CUDA events around --chain back-to-back calls behind a sleep kernel "
                      "that outlasts their queueing; median of --reps windows"),
           "results": results}
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
