#!/usr/bin/env python3
"""Time ``stream_search`` of ``dewi_tpu_torch`` over the CTAs of its grid.

    python3 scripts/torch_stream_chunks.py [CTAS ...]

On one CUDA card, at cap 2^20 x 256 with 1,000,000 live rows and k = 10:
``stream_search`` at Q 1, 8 and 32 for each ``STREAM_CTAS`` given (the
most CTAs of its persistent grid; ``none`` for as many as the card holds at
once, the default; default list 33 66 132 264 none), and
``int8_stream_search``, which the limit does not touch, once beside them,
CUDA-event medians of 30, after holding each result against the plain
version.  Prints the card and one JSON line per CTA limit, with the CTAs
the card holds of each launch.  (``scripts/torch_stream_sweep.py`` times
both over Q.)
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dewi_tpu_torch.ops import cuda_search as cs  # noqa: E402
from dewi_tpu_torch.ops.quantized import quantize_rows  # noqa: E402
from dewi_tpu_torch.ops.similarity import l2_normalize  # noqa: E402

CAP, DIM, LIVE, K, ETA, EP = 1 << 20, 256, 1_000_000, 10, 0.25, 0.1
QS = (1, 8, 32)


def time_ms(fn, reps: int = 30) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(400_000)  # keeps the card busy while the host enqueues
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    limits = [None if a == "none" else int(a) for a in sys.argv[1:]] or [33, 66, 132, 264, None]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    emb = l2_normalize(torch.randn(CAP, DIM, device="cuda", generator=g)).contiguous()
    e8, sc = quantize_rows(emb)
    pay = torch.rand(CAP, 8, device="cuda", generator=g)
    q = l2_normalize(torch.randn(max(QS), DIM, device="cuda", generator=g)).contiguous()
    want = {nq: (cs.stream_search_plain(emb, pay, q[:nq], LIVE, ETA, EP, k=K),
                 cs.int8_stream_search_plain(e8, sc, pay, q[:nq], LIVE, ETA, EP, k=K))
            for nq in QS}
    row = {"int8_stream_search": True}
    for nq in QS:
        qx = q[:nq].contiguous()
        i8 = lambda: cs.int8_stream_search(e8, sc, pay, qx, LIVE, ETA, EP, k=K)  # noqa: E731
        torch.testing.assert_close(i8()[0], want[nq][1][0], rtol=1e-5, atol=1e-5)
        row[f"int8_q{nq}_ms"] = time_ms(i8)
    print(json.dumps(row), flush=True)
    held = {nq: cs._stream_held("stream_search", emb.device, nq, DIM) for nq in QS}
    for limit in limits:
        cs.STREAM_CTAS = limit
        row = {"stream_ctas": limit, "held": held}
        for nq in QS:
            qx = q[:nq].contiguous()
            f32 = lambda: cs.stream_search(emb, pay, qx, LIVE, ETA, EP, k=K)  # noqa: E731
            torch.testing.assert_close(f32()[0], want[nq][0][0], rtol=1e-5, atol=1e-5)
            row[f"f32_q{nq}_ms"] = time_ms(f32)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
