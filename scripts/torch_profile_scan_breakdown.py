#!/usr/bin/env python3
"""Decompose the port's 1M-doc quantized search into its stages.

    python3 scripts/torch_profile_scan_breakdown.py [--n-docs 1048576] [--dim 256]
        [--m 80] [--chain 64] [--reps 6] [--sweep-blocks 4096,16384,32768]

Counterpart of ``scripts/profile_scan_breakdown.py``, with its rows and
row names, each stage timed alone on the card: ``--chain`` back-to-back
calls (fewer where a window would pass 512 device operations, which the
card's launch queue must hold) between two CUDA events, behind a sleep
kernel that outlasts the host's queueing of the window, so that the events
bracket the card's work, as the reference's loop in one dispatch does; the
median of ``--reps`` windows in ms per call, their spread, the host's ms to
queue one call (``host_ms``, what an eager caller waits for where it is the
larger), and the effective GB/s over the bytes the reference charges the
row (``refine``, which the reference charges none, over the rows and
payloads it gathers).

* stage 1 through ``dewi_tpu_torch.ops.cuda_search``: ``scores_pallas_bf16``
  (``scores_matrix`` over the int8 rows), ``scores_pallas_s8``
  (``scores_matrix_s8``), ``bmax_s8`` and one ``bmax_s8_b<block>`` row per
  other ``--sweep-blocks`` block (the block the fused route streams: one
  that is not a multiple of 16,384 rows takes the corpus-major
  ``bmax_s8_t``, as ``quantized_search`` routes it), ``scores_pallas_s4`` and
  ``bmax_s4`` over the packed int4 rows (half the bytes).  Where
  ``kernel_takes`` refuses the dim, the row runs the plain version and says
  so (``route``);
* the library calls: ``scores_xla_bf16`` (``torch.matmul`` in bf16 over a
  bf16 copy of the int8 rows, so twice the bytes) and ``scores_xla_s8``
  (``torch._int_mm``, the query padded to 32 rows);
* ``select_approx`` and ``select_exact`` over a ``[1, cap]`` f32 row: the
  port has no ``approx_max_k``, its select is ``torch.topk``
  (``ops/quantized.py``), so both rows are that one call, timed once
  (``select_exact`` says ``same_as``);
* ``refine`` (gather m f32 rows, product, re-rank, top 10), the batched
  rows at Q=128 and the full Q=1 rows through ``quantized_search`` with the
  reference's flags (``approx_select`` has no counterpart and is dropped,
  which makes ``full_two_stage_exact_select`` the same call as
  ``full_two_stage``, filled from it with ``same_as``),
  ``batched128_invmem_topk`` through ``int8_stream_search`` (four launches
  of 32 queries), and the exact rows over the bf16 store through
  ``fused_search``.

Every row also lists the device operations of one extra call
(``torch.profiler`` names and their summed device ms, with
``kernels_complete``: each launch, copy and fill the host issued showed on
the device; ``profile_lead_lost``: the leading events the profiler
dropped, ``launched_kernels``) and the launches counted by
``cuda_search``.  ``l2_resident``: the row's bytes fit the card's 50 MB
L2, so its windows read them from L2 after the first call (the select and
refine rows); the rows that stream the corpus (256 MB at 1M x 256) do
not.  ``full_two_stage_top10`` holds that row's answer for the first
query, which ``chip_smoke.py`` holds against ``DewiIndex(backend="int8",
int8_queries=True)`` on the same corpus (``make_inputs``).  Writes
``--output`` (JSON).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

ETA, EP, K = 0.25, 0.1, 10     # the reference's re-rank weights and k
L2_BYTES = 50 * (1 << 20)      # H100 L2
HBM_BYTES_PER_S = 3.35e12      # H100 SXM nominal
WINDOW_LAUNCHES = 512          # device operations in one timed window at most


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--chain", type=int, default=64)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--m", type=int, default=80)
    ap.add_argument("--sweep-blocks", default="4096,16384,32768")
    ap.add_argument("--output", default=str(REPO / "chiprun_out" / "scan_breakdown.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap.parse_args(argv)


def make_inputs(n: int, d: int, device, m: int = 80) -> dict:
    """The breakdown's corpus and queries, from seed 0: unit f32 rows drawn
    on ``device``, their int8 codes, ``|normal|`` payloads and the queries
    drawn on the host in the reference's order."""
    import torch

    from dewi_tpu_torch.ops.quantized import quantize_rows

    gen = torch.Generator(device=device).manual_seed(0)
    emb = torch.randn((n, d), device=device, generator=gen)
    emb = emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True)
    e8, scales = quantize_rows(emb)
    rng = np.random.default_rng(0)
    pay = torch.from_numpy(np.abs(rng.normal(size=(n, 8))).astype(np.float32)).to(device)
    q0 = torch.from_numpy(rng.normal(size=(1, d)).astype(np.float32)).to(device)
    row = torch.from_numpy(rng.normal(size=(1, n)).astype(np.float32)).to(device)
    cand = torch.from_numpy(rng.integers(0, n, size=(1, m))).to(device)
    qb = torch.from_numpy(rng.normal(size=(128, d)).astype(np.float32)).to(device)
    return {
        "emb": emb, "e8": e8, "scales": scales, "sqn": torch.sum(emb * emb, dim=1),
        "pay": pay, "mult": 0.75 * scales,
        "add": ETA * pay[:, 0] + EP * 0.5 * (pay[:, 1] + pay[:, 3]),
        "q0": q0 / torch.linalg.vector_norm(q0), "row": row, "cand": cand,
        "qb": qb / torch.linalg.vector_norm(qb, dim=1, keepdim=True),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from dewi_tpu_torch.ops import cuda_search as cs
    from dewi_tpu_torch.ops.quantized import quantize_rows, quantize_rows_int4, quantized_search
    from dewi_tpu_torch.ops.similarity import fused_search
    from dewi_tpu_torch.utils.device import resolve_device
    from dewi_tpu_torch.utils.profiling import (card_line, chained_ms, device_name,
                                                launched_kernels)

    device = resolve_device(args.device)
    n, d, m = args.n_docs, args.dim, args.m
    if n % cs.BMAX_BLOCK:
        raise ValueError(f"--n-docs must be a multiple of {cs.BMAX_BLOCK}")
    x = make_inputs(n, d, device, m)
    e8, mult, add, q0 = x["e8"], x["mult"], x["add"], x["q0"]
    e4, _ = quantize_rows_int4(x["emb"])
    corpus_bytes = n * d
    results: dict = {}

    on_card = device.type == "cuda"

    def takes(kind: str) -> bool:
        return on_card and cs.kernel_takes(kind, d, device)

    def pick(kernel, plain, ok: bool):
        # On the CPU the wrapper runs its plain version by itself.
        return kernel if ok or not on_card else plain

    def row(name: str, fn, read_bytes: int, route=None, batch: int = 0, **extra) -> None:
        out = fn()  # warm-up
        if isinstance(out, tuple):
            out = out[0]
        if not bool(torch.isfinite(out).any()):
            raise RuntimeError(f"{name}: no finite value in the result")
        before = dict(cs.launch_counts)
        prof = launched_kernels(fn, device)
        # launches a call (launched_kernels runs fn again where a profile
        # came out incomplete)
        launches = {k: (v - before[k]) // max(prof["calls"], 1)
                    for k, v in cs.launch_counts.items() if v > before[k]}
        # A window's launches must fit the card's queue (chained_ms); the
        # count is the host's, which the profiler always keeps.
        ops = prof["ops"]
        chain = max(2, min(args.chain, WINDOW_LAUNCHES // ops)) if ops else args.chain
        ms, host_ms = chained_ms(fn, device, chain, args.reps)
        p50 = statistics.median(ms)
        rec = {"p50_ms": p50, "spread_ms": max(ms) - min(ms), "chain": chain,
               "host_ms": host_ms, "read_bytes": read_bytes,
               "gbps": read_bytes / (p50 * 1e-3) / 1e9,
               "l2_resident": read_bytes <= L2_BYTES,
               "kernels": prof["kernels"], "device_ms": prof["device_ms"],
               "kernels_complete": prof["complete"], "profile_lead_lost": prof["lead_lost"],
               "launches": launches}
        if route is not None:
            rec["route"] = "kernel" if route else "plain"
        if batch:
            rec["per_query_us"] = p50 / batch * 1e3
        rec.update(extra)
        results[name] = rec
        print(f"{name:34s} {json.dumps({k: rec[k] for k in ('p50_ms', 'gbps', 'chain')})} "
              f"launches {rec['launches']}", flush=True)

    def same(name: str, as_name: str, **extra) -> None:
        # A reference row that is the same call in the port: its numbers
        # are that row's, not measured again.
        results[name] = {**results[as_name], "same_as": as_name, **extra}

    # ---- stage 1: each kernel alone (the plain version where the dim is refused)
    k8, k_s8, k_s4 = takes("int8"), takes("s8"), takes("s4")
    row("scores_pallas_bf16",
        lambda: pick(cs.scores_matrix, cs.scores_matrix_plain, k8)(e8, mult, add, q0),
        corpus_bytes, route=k8)

    def quantized_query(kernel, plain, rows=e8, ok=k_s8):
        # s8-query stage 1: the query is quantized inside the timed call
        fn = pick(kernel, plain, ok)

        def call():
            qi, qs = quantize_rows(q0)
            return fn(rows, mult, add, qi, qs)
        return call

    row("scores_pallas_s8", quantized_query(cs.scores_matrix_s8, cs.scores_matrix_s8_plain),
        corpus_bytes, route=k_s8)
    row("bmax_s8", quantized_query(cs.bmax_s8, cs.bmax_s8_plain), corpus_bytes, route=k_s8)
    for blk in (int(b) for b in args.sweep_blocks.split(",") if b):
        if blk == cs.BMAX_BLOCK or n % blk:
            continue
        # quantized_search's layout gate for a fused stream block
        corpus_major = (blk // cs.BLOCKMAX_SUB) % cs.BLOCKMAX_SUB != 0 and blk != n
        kernel, plain = ((cs.bmax_s8_t, cs.bmax_s8_t_plain) if corpus_major
                         else (cs.bmax_s8, cs.bmax_s8_plain))
        row(f"bmax_s8_b{blk}", quantized_query(kernel, plain), corpus_bytes, route=k_s8,
            layout="corpus-major (bmax_s8_t)" if corpus_major else "query-major (bmax_s8)")
    row("scores_pallas_s4", quantized_query(cs.scores_matrix_s4, cs.scores_matrix_s4_plain, e4, k_s4),
        corpus_bytes // 2, route=k_s4)
    row("bmax_s4", quantized_query(cs.bmax_s4, cs.bmax_s4_plain, e4, k_s4), corpus_bytes // 2, route=k_s4)

    # ---- the library calls over the same rows
    e8b = e8.to(torch.bfloat16)
    row("scores_xla_bf16",
        lambda: torch.matmul(q0.to(torch.bfloat16), e8b.T).float() * mult + add,
        2 * corpus_bytes, note="torch.matmul over a bf16 copy of the int8 rows")
    q_pad = torch.zeros((32, d), dtype=torch.int8, device=device)

    def int_mm():
        qi, qs = quantize_rows(q0)
        q_pad[:1] = qi
        acc = torch._int_mm(q_pad, e8.T)[:1].float()
        return acc * (qs[:, None] * mult) + add

    row("scores_xla_s8", int_mm, corpus_bytes, note="torch._int_mm, the query padded to 32")
    del e8b

    # ---- selection over a resident [1, cap] score row
    note = "the port has no approx_max_k: its select is torch.topk (ops/quantized.py)"
    row("select_approx", lambda: torch.topk(x["row"], m, dim=1)[0], n * 4, note=note)
    same("select_exact", "select_approx")

    # ---- refine over m candidates
    def refine():
        c = x["cand"]
        sim = torch.einsum("qd,qmd->qm", q0, x["emb"][c])
        adj = 0.75 * sim + 0.25 * x["pay"][c][..., 0]
        return torch.topk(adj, K, dim=1)[0]

    row("refine", refine, m * (4 * d + 4 * 8), note="bytes: the gathered rows and payloads")

    def qsearch(queries, **flags):
        return lambda: quantized_search(
            e8, x["scales"], x["emb"], x["sqn"], x["pay"], queries, n, ETA, EP, k=K, m=m,
            normalize=True, int8_queries=True, **flags)

    # ---- batched Q=128
    qb = x["qb"]
    row("batched128_two_stage", qsearch(qb), corpus_bytes, batch=128)
    row("batched128_blockmax_scoregather", qsearch(qb, blockmax_select=True),
        corpus_bytes, batch=128)
    row("batched128_blockmax_bf16", qsearch(qb, blockmax_select=True, bf16_scores=True),
        corpus_bytes, batch=128)
    kern = k_s8 or not on_card
    row("batched128_fused_chunked",
        qsearch(qb, kernel_stage1=kern, blockmax_select=True, fused_bmax=True),
        4 * corpus_bytes, route=k_s8, batch=128)  # 4 groups x one corpus pass
    k_stream = k8 and cs.stream_queries_per_launch("int8_stream_search", d) > 0
    stream = pick(cs.int8_stream_search, cs.int8_stream_search_plain, k_stream)
    row("batched128_invmem_topk",
        lambda: stream(e8, x["scales"], x["pay"], qb, n, ETA, EP, k=K), corpus_bytes,
        route=k_stream, batch=128)

    # ---- the full Q=1 path
    row("full_two_stage", qsearch(q0, kernel_stage1=kern), corpus_bytes, route=k_s8)
    row("full_two_stage_blockmax", qsearch(q0, kernel_stage1=kern, blockmax_select=True),
        corpus_bytes, route=k_s8)
    row("full_two_stage_blockmax_fused",
        qsearch(q0, kernel_stage1=kern, blockmax_select=True, fused_bmax=True),
        corpus_bytes, route=k_s8)
    same("full_two_stage_exact_select", "full_two_stage",
         note="approx_select has no counterpart: the same call as full_two_stage")
    s, ids = qsearch(q0, kernel_stage1=kern)()

    # ---- the exact tier over a bf16 store
    emb_b16 = x["emb"].to(torch.bfloat16)
    kb = takes("bf16")
    kb_or_cpu = kb or not on_card

    def exact(queries, **kw):
        return lambda: fused_search(emb_b16, x["sqn"], x["pay"], queries, n, ETA, EP, k=K,
                                    normalize=True, **kw)

    b16 = n * d * 2
    row("exact_bf16_xla_topk", exact(q0), b16)
    row("exact_bf16_xla_blockmax", exact(q0, blockmax_select=True), b16)
    row("exact_bf16_pallas_topk", exact(q0, kernel_scores=kb_or_cpu), b16, route=kb)
    row("exact_bf16_pallas_blockmax", exact(q0, kernel_scores=kb_or_cpu, blockmax_select=True),
        b16, route=kb)
    row("exact_bf16_pallas_blockmax_fused",
        exact(q0, kernel_scores=kb_or_cpu, blockmax_select=True, fused_bmax=True), b16,
        route=kb)
    row("exact_bf16_batched128_topk", exact(qb), b16, batch=128)
    row("exact_bf16_batched128_blockmax", exact(qb, blockmax_select=True), b16, batch=128)

    out = {
        "n_docs": n, "dim": d, "m": m, "chain": args.chain, "reps": args.reps,
        "device": device_name(device), "card": card_line() if on_card else None,
        "method": ("CUDA events around back-to-back calls (--chain, fewer where a window "
                   "would pass 512 device operations) behind a sleep kernel that outlasts "
                   "their queueing; median of --reps windows"),
        "hbm_floor_ms_at_3350gbps": corpus_bytes / HBM_BYTES_PER_S * 1e3,
        "results": results,
        "full_two_stage_top10": {"ids": ids[0].tolist(), "scores": s[0].tolist()},
    }
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps({k: v for k, v in out.items() if k != "results"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
