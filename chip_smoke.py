#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dewi_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the search kernels from ``dewi_tpu_torch/csrc`` with nvcc (into
``dewi_tpu_torch/_build/``) and drives the port's main paths through their
public entry points:

1. the card, the versions and the kernel build time;
2. each of the ten CUDA kernels against its plain PyTorch version on the
   card.  The eight stage-1 kernels at the main path's shape (cap 2^20,
   D 256, Q 1 and 32), a ragged one (cap 65,536, D 64, Q 5) and a wide one
   (cap 16,384, D 2048, Q 40, which takes two launches), with their times
   beside their bounds at Q 1 and 32; the s8 and int4 kernels must match
   bit for bit, and the corpus-major kernels must equal the query-major
   ones transposed.  The eight stage-1 kernels are also timed at Q 1, 2,
   4, 8, 16 and 32, each time beside its bound (``bmax``, ``bmax_t`` and
   ``scores_matrix`` over int8 and bf16 rows, ``bmax_s8``, ``bmax_s8_t``
   and ``scores_matrix_s8`` over int8 rows, ``bmax_s4`` and
   ``scores_matrix_s4`` over the packed int4 rows of the same corpus), and
   at Q=32 ``scores_matrix`` and ``scores_matrix_s8`` with bf16 output
   beside ``torch.matmul`` and ``torch._int_mm`` of the same operands.  The
   two streaming searches at cap 65,536 x 64 and at 2^20 x 256 with
   1,000,000 live rows, Q 1, 8, 32 and 40 (two launches), k 10, and with
   fewer live rows than k: scores within 1e-5, ids equal where scores
   differ, times beside bounds and library calls at Q 1, 8 and 32;
3. the README quick start at its own size (10k docs x 768, cosine):
   scorer fit + score, ``set_dewi_scores``, ``build``, ``search``, a
   save/load round trip and an eta sweep, checked against numpy; then
   four indexes at dims their kernels do not take (int8 at D 100, with and
   without int8 queries, int4 at D 48, exact bf16 at D 100; 33,000 docs,
   so capacity 65,536): each searched at Q 5 and 40 with no kernel
   launched, equal to the same index with ``use_pallas=False``;
4. the bench protocol at 1M docs x 256 (cap 2^20), k=10, through
   ``DewiIndex``: exact f32 (the recall reference), exact bf16, int8, int4,
   int4 without block-max selection, and int8 with int8 queries, unfused
   and fused; Q=1 latency, batched ms/query at Q=1000 and recall@10 vs f32
   exact over 1000 queries, plus the scorer's fit-and-score rate on the
   [1M, 7] signal matrix; then ``quantized_search`` on the int8-query
   index's arrays with a 4096-row stream block, the corpus-major route,
   held equal to the query-major route;
5. serving: ``SearchServer`` over the int8-query index, 64 client threads
   in a process of their own (``--serve-clients``, started by this
   script) sending ``POST /search`` (and one ``/search_batch``), every
   answer held against a direct ``search_batch``;
6. the streaming searches as the bench protocol calls them: on the int8
   tier's f32 store, codes and scales, ``stream_search`` at Q 1 and 8
   (each timed beside ``fused_search`` on the same store) and
   ``int8_stream_search`` at Q 1, 8 and 32, recall@10 against exact f32
   asserted;
7. the IVF tier: ``IVFIndex(nlist=1024, nprobe=32)`` filled through
   ``attach_device`` from tensors made on the card, cold and warm build,
   both probe implementations timed, recall@10 on the random corpus held
   to a floor, and on a clustered 200k corpus (512 Gaussian modes,
   ``nlist=512``) asserted >= 0.99;
8. one JSON line with every kernel's launches, error and times.

Every check raises on failure, so the script exits non-zero without a
result line.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_OPS_PER_S = 989e12     # dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12    # dense int8 tensor-core peak
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores
N_DOCS, DIM, K, N_QUERIES = 1_000_000, 256, 10, 1000
ETA, EP = 0.25, 0.1         # bench.py's re-rank weights
RECALL_BLOCK = 128
TIER_KERNEL = {             # tier -> the stage-1 kernel its main path runs
    "exact_bf16": "scores_matrix",
    "int8": "bmax",
    "int4": "bmax_s4",
    "int4_unfused": "scores_matrix_s4",
    "int8_s8_unfused": "scores_matrix_s8",
    "int8_s8": "bmax_s8",
}
REPLACES = {
    "bmax_s4": "dewi_tpu/ops/pallas_search.py:661",
    "scores_matrix_s4": "dewi_tpu/ops/pallas_search.py:470",
    "bmax": "dewi_tpu/ops/pallas_search.py:559",
    "scores_matrix": "dewi_tpu/ops/pallas_search.py:309",
    "bmax_s8": "dewi_tpu/ops/pallas_search.py:609",
    "scores_matrix_s8": "dewi_tpu/ops/pallas_search.py:378",
    "bmax_t": "dewi_tpu/ops/pallas_search.py:740",
    "bmax_s8_t": "dewi_tpu/ops/pallas_search.py:793",
    "stream_search": "dewi_tpu/ops/pallas_search.py:129",
    "int8_stream_search": "dewi_tpu/ops/pallas_search.py:239",
}
STREAM_KERNELS = ("stream_search", "int8_stream_search")
SWEEP_Q = (1, 2, 4, 8, 16, 32)   # query counts of the tensor-core kernels' sweep
N_LIVE = 1_000_000          # live rows of the streaming kernels' main shape
# IVF on unclustered data is not a >= 0.99 tier in general (the reference's
# own recall curve says so).  On this corpus the re-rank terms lead the
# ranking and the DEWI tier holds their leaders, so the configuration read
# 1.0 on an H100; the floor leaves a margin for another random stream.
IVF_RANDOM_RECALL_FLOOR = 0.95
CORPUS_MAJOR_BLOCK = 4096   # a stream block that is not a multiple of 16384 rows
N_CLIENTS = 64


def log(*args: object) -> None:
    print(*args, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def sync() -> None:
    torch.cuda.synchronize()


def time_device_ms(fn, reps: int = 50, lead_cycles: int = 2_000_000) -> float:
    """Median device time of ``fn`` by CUDA events.  A sleep kernel ahead of
    each start event keeps the device busy while the host enqueues, so the
    events bracket device work and not Python overhead."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(lead_cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---- phase 2: kernels against their plain versions ------------------------


def kernel_inputs(cap: int, d: int, nq: int, seed: int) -> dict:
    """Inputs as the main path hands them to the kernels: quantized rows of a
    normalized corpus, folded mult/add with the padding rows at -inf."""
    from dewi_tpu_torch.ops.quantized import quantize_rows, quantize_rows_int4
    from dewi_tpu_torch.ops.similarity import l2_normalize

    g = torch.Generator(device="cuda").manual_seed(seed)
    emb = l2_normalize(torch.randn(cap, d, device="cuda", generator=g))
    e8, s8 = quantize_rows(emb)
    p4, s4 = quantize_rows_int4(emb)
    q = l2_normalize(torch.randn(nq, d, device="cuda", generator=g))
    q8, qs = quantize_rows(q)
    pay = torch.rand(cap, 8, device="cuda", generator=g)
    live = torch.arange(cap, device="cuda") < cap - cap // 20
    add = torch.where(live, ETA * pay[:, 0] + EP * 0.5 * (pay[:, 1] + pay[:, 3]),
                      torch.full_like(pay[:, 0], float("-inf")))
    return dict(ebf=emb.to(torch.bfloat16), e8=e8, p4=p4, q=q, q8=q8, qs=qs,
                m8=(1 - ETA) * s8, m4=(1 - ETA) * s4, mbf=torch.full_like(s8, 1 - ETA),
                add=add)


def stage1_cost(cap: int, d: int, nq: int, row_bytes: int, s8_queries: bool,
                out_bytes: int) -> tuple:
    """(bytes, operations, ops peak) of a stage-1 call: the rows, mult and
    add read once, the queries (f32, or s8 with an f32 scale each) read
    once, ``out_bytes`` written once; 2 operations per query and element."""
    q_bytes = nq * d + 4 * nq if s8_queries else 4 * nq * d
    return (cap * row_bytes + 8 * cap + q_bytes + out_bytes, 2.0 * nq * cap * d,
            INT8_OPS_PER_S if s8_queries else BF16_OPS_PER_S)


def bound(nbytes: float, ops: float, peak: float) -> tuple:
    """The least time in ms of that work on this card, and what sets it."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def kernel_cases(x: dict) -> dict:
    """kernel name -> (kernel call, plain call, library call or None, rtol,
    atol fraction of max |ref|, bytes moved, operations, ops peak).

    Library yardsticks: ``torch.matmul`` of the bf16 operands for the
    float-query kernels; ``torch._int_mm`` (int8 x int8 -> int32) for the s8
    kernels, with the queries zero-padded to 32 rows, since it needs more
    than 16 rows and a multiple of 8 columns.  Neither applies the epilogue."""
    from dewi_tpu_torch.ops import cuda_search as cs

    cap, d = x["e8"].shape
    nq = x["q"].shape[0]
    qbf, ebf_t = x["q"].to(torch.bfloat16), x["ebf"].T
    e8bf = x["e8"].to(torch.bfloat16)
    e8bf_t = e8bf.T
    q8_pad = torch.zeros((max(32, -(-nq // 8) * 8), d), dtype=torch.int8, device="cuda")
    q8_pad[:nq] = x["q8"]
    s8 = (x["e8"], x["m8"], x["add"], x["q8"], x["qs"])
    s4 = (x["p4"], x["m4"], x["add"], x["q8"], x["qs"])
    bmax_out, full_out = 4 * nq * cap // 128, 4 * nq * cap
    return {
        "bmax_s8": (lambda: cs.bmax_s8(*s8), lambda: cs.bmax_s8_plain(*s8),
                    lambda: torch._int_mm(q8_pad, x["e8"].T), 0.0, 0.0,
                    *stage1_cost(cap, d, nq, d, True, bmax_out)),
        "scores_matrix_s8": (lambda: cs.scores_matrix_s8(*s8),
                             lambda: cs.scores_matrix_s8_plain(*s8),
                             lambda: torch._int_mm(q8_pad, x["e8"].T), 0.0, 0.0,
                             *stage1_cost(cap, d, nq, d, True, full_out)),
        "bmax_t": (lambda: cs.bmax_t(x["e8"], x["m8"], x["add"], x["q"]),
                   lambda: cs.bmax_t_plain(x["e8"], x["m8"], x["add"], x["q"]),
                   lambda: torch.matmul(e8bf, qbf.T), 1e-5, 1e-5,
                   *stage1_cost(cap, d, nq, d, False, bmax_out)),
        "bmax_s8_t": (lambda: cs.bmax_s8_t(*s8), lambda: cs.bmax_s8_t_plain(*s8),
                      lambda: torch._int_mm(x["e8"], q8_pad.T), 0.0, 0.0,
                      *stage1_cost(cap, d, nq, d, True, bmax_out)),
        "bmax_s4": (lambda: cs.bmax_s4(*s4), lambda: cs.bmax_s4_plain(*s4), None, 0.0, 0.0,
                    *stage1_cost(cap, d, nq, d // 2, True, bmax_out)),
        "scores_matrix_s4": (lambda: cs.scores_matrix_s4(*s4),
                             lambda: cs.scores_matrix_s4_plain(*s4), None, 0.0, 0.0,
                             *stage1_cost(cap, d, nq, d // 2, True, full_out)),
        "bmax": (lambda: cs.bmax(x["e8"], x["m8"], x["add"], x["q"]),
                 lambda: cs.bmax_plain(x["e8"], x["m8"], x["add"], x["q"]),
                 lambda: torch.matmul(qbf, e8bf_t), 1e-5, 1e-5,
                 *stage1_cost(cap, d, nq, d, False, bmax_out)),
        "scores_matrix": (lambda: cs.scores_matrix(x["ebf"], x["mbf"], x["add"], x["q"]),
                          lambda: cs.scores_matrix_plain(x["ebf"], x["mbf"], x["add"], x["q"]),
                          lambda: torch.matmul(qbf, ebf_t), 1e-5, 1e-5,
                          *stage1_cost(cap, d, nq, 2 * d, False, full_out)),
    }


def compare(got: torch.Tensor, want: torch.Tensor, rtol: float, atol_frac: float) -> float:
    sync()
    got, want = got.float(), want.float()
    check(torch.equal(torch.isneginf(got), torch.isneginf(want)), "-inf pattern differs")
    fin = torch.isfinite(want)
    err = (got - want).abs()[fin]
    scale = want.abs()[fin].max()
    bad = err > rtol * want.abs()[fin] + atol_frac * scale
    check(not bool(bad.any()), f"kernel disagrees: max abs err {float(err.max())}")
    return float(err.max())


def stage1_sweep(x: dict, reps: int = 50) -> dict:
    """The eight stage-1 kernels at each Q of ``SWEEP_Q``: ``bmax``,
    ``bmax_t`` and ``scores_matrix`` over the int8 and the bf16 rows of
    ``x``, ``bmax_s8``, ``bmax_s8_t`` and ``scores_matrix_s8`` over its int8
    rows, ``bmax_s4`` and ``scores_matrix_s4`` over its packed int4 rows.
    Keyed ``kernel/rows``, each ``{"ms": {Q: CUDA-event median},
    "bound_ms": {Q: least time}}``.  At the largest Q also ``scores_matrix``
    over bf16 rows and ``scores_matrix_s8`` with ``out_dtype=torch.bfloat16``
    beside ``torch.matmul`` and ``torch._int_mm`` of the same operands (the
    one writes the same bf16 ``[Q, cap]``, the other int32)."""
    from dewi_tpu_torch.ops import cuda_search as cs

    cap, d = x["e8"].shape
    add = x["add"]
    out: dict = {}

    def sweep(key: str, call, row_bytes: int, s8: bool, out_bytes_per_query: int,
              nqs=SWEEP_Q) -> None:
        row = out[key] = {"ms": {}, "bound_ms": {}}
        for nq in nqs:
            row["ms"][nq] = time_device_ms(lambda: call(nq), reps, 400_000)
            row["bound_ms"][nq] = bound(*stage1_cost(cap, d, nq, row_bytes, s8,
                                                     nq * out_bytes_per_query))[0]

    qf = {nq: x["q"][:nq].contiguous() for nq in SWEEP_Q}
    q8 = {nq: (x["q8"][:nq].contiguous(), x["qs"][:nq].contiguous()) for nq in SWEEP_Q}
    corpora = {"int8": (x["e8"], x["m8"], d), "bf16": (x["ebf"], x["mbf"], 2 * d)}
    for name, fn, per_q in (("bmax", cs.bmax, 4 * cap // 128),
                            ("bmax_t", cs.bmax_t, 4 * cap // 128),
                            ("scores_matrix", cs.scores_matrix, 4 * cap)):
        for rows, (emb, mult, row_bytes) in corpora.items():
            sweep(f"{name}/{rows}", lambda nq: fn(emb, mult, add, qf[nq]), row_bytes, False,
                  per_q)
    for name, fn, per_q in (("bmax_s8", cs.bmax_s8, 4 * cap // 128),
                            ("bmax_s8_t", cs.bmax_s8_t, 4 * cap // 128),
                            ("scores_matrix_s8", cs.scores_matrix_s8, 4 * cap)):
        sweep(f"{name}/int8", lambda nq: fn(x["e8"], x["m8"], add, *q8[nq]), d, True, per_q)
    for name, fn, per_q in (("bmax_s4", cs.bmax_s4, 4 * cap // 128),
                            ("scores_matrix_s4", cs.scores_matrix_s4, 4 * cap)):
        sweep(f"{name}/int4", lambda nq: fn(x["p4"], x["m4"], add, *q8[nq]), d // 2, True,
              per_q)

    last = SWEEP_Q[-1:]
    qbf, ebf_t = qf[last[0]].to(torch.bfloat16), x["ebf"].T
    bf16 = torch.bfloat16
    sweep("scores_matrix/bf16/bf16_out",
          lambda nq: cs.scores_matrix(x["ebf"], x["mbf"], add, qf[nq], out_dtype=bf16),
          2 * d, False, 2 * cap, last)
    sweep("torch.matmul/bf16/bf16_out", lambda nq: torch.matmul(qbf, ebf_t), 2 * d, False,
          2 * cap, last)
    sweep("scores_matrix_s8/int8/bf16_out",
          lambda nq: cs.scores_matrix_s8(x["e8"], x["m8"], add, *q8[nq], out_dtype=bf16),
          d, True, 2 * cap, last)
    sweep("torch._int_mm/int8/int32_out", lambda nq: torch._int_mm(q8[nq][0], x["e8"].T),
          d, True, 4 * cap, last)
    return out


def phase_kernels() -> dict:
    from dewi_tpu_torch.ops import cuda_search as cs

    out = {name: {"max_abs_err": 0.0} for name in REPLACES if name not in STREAM_KERNELS}
    for cap, d, nq in ((1 << 20, DIM, 1), (1 << 20, DIM, 32), (65536, 64, 5),
                       (16384, 2048, 40)):
        x = kernel_inputs(cap, d, nq, seed=cap + nq)
        cases = kernel_cases(x)
        for name, (kern, plain, lib, rtol, atol, nbytes, ops, peak) in cases.items():
            got = kern()
            err = compare(got, plain(), rtol, atol)
            if name.endswith("_t"):  # corpus-major = query-major transposed
                twin = cases[name[:-2]][0]()
                sync()
                check(torch.equal(got, twin.T), f"{name} != {name[:-2]} transposed "
                      f"(cap={cap} D={d} Q={nq})")
            rec = out[name]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if cap != 1 << 20:
                continue
            ms = time_device_ms(kern, reps=50, lead_cycles=400_000)
            plain_ms = time_device_ms(plain, reps=10)
            lib_ms = time_device_ms(lib, reps=50, lead_cycles=400_000) if lib else None
            bound_ms, bound_by = bound(nbytes, ops, peak)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms, bytes=nbytes, rtol=rtol, atol_of_max=atol)
            log(f"kernel {name} cap={cap} D={d} Q={nq}: " + json.dumps(row))
            if nq == 1:  # the Q=1 search's shape goes into the kernels line
                rec.update(row)
            else:        # ... and the full launch of 32 queries beside it
                rec.update(q32_ms=ms, q32_plain_ms=plain_ms, q32_bound_ms=bound_ms,
                           q32_bound_by=bound_by, q32_library_ms=lib_ms)
        if (cap, nq) == (1 << 20, SWEEP_Q[-1]):
            for key, row in stage1_sweep(x).items():
                log(f"sweep {key} cap={cap} D={d} ms and bound by Q: " + json.dumps(row))
        del x
        torch.cuda.empty_cache()
    log("kernel max_abs_err vs plain (all shapes; tolerance rtol + atol_of_max x max|plain|): " +
        json.dumps({k: v["max_abs_err"] for k, v in out.items()}))
    cs.reset_launch_counts()
    return out


def stream_inputs(cap: int, d: int, nq: int, seed: int) -> dict:
    """A normalized f32 corpus, its int8 codes and scales as the int8 tier
    makes them, random payloads and normalized queries."""
    from dewi_tpu_torch.ops.quantized import quantize_rows
    from dewi_tpu_torch.ops.similarity import l2_normalize

    g = torch.Generator(device="cuda").manual_seed(seed)
    emb = l2_normalize(torch.randn(cap, d, device="cuda", generator=g)).contiguous()
    e8, sc = quantize_rows(emb)
    pay = torch.rand(cap, 8, device="cuda", generator=g)
    q = l2_normalize(torch.randn(nq, d, device="cuda", generator=g)).contiguous()
    return dict(emb=emb, e8=e8, sc=sc, pay=pay, q=q)


def compare_topk(got, want, tol: float = 1e-5) -> float:
    """Streaming search against its plain version: the -3.4e38 slots in the
    same places with id 0, scores within ``tol`` (relative and absolute),
    ids equal wherever the plain scores stand further apart than that."""
    sync()
    (s, i), (s_ref, i_ref) = got, want
    check(s.shape == s_ref.shape and i.dtype == torch.int32, "stream: output shape or dtype")
    empty = s_ref == -3.4e38
    check(torch.equal(s == -3.4e38, empty) and bool((i[empty] == 0).all()),
          "stream: empty slots differ")
    err = (s - s_ref).abs()
    lim = tol + tol * s_ref.abs()
    check(bool((err <= lim)[~empty].all()), f"stream: scores differ by {float(err.max())}")
    gap_hi = torch.full_like(s_ref, float("inf"))
    gap_hi[:, 1:] = s_ref[:, :-1] - s_ref[:, 1:]
    gap_lo = torch.full_like(s_ref, float("inf"))
    gap_lo[:, :-1] = s_ref[:, :-1] - s_ref[:, 1:]
    clear = (gap_hi > 2 * lim) & (gap_lo > 2 * lim) & ~empty
    check(torch.equal(i[clear], i_ref[clear]), "stream: ids differ where scores are apart")
    return float(err[~empty].max()) if bool((~empty).any()) else 0.0


def stream_cases(x: dict, nq: int, n_valid: int, k: int) -> dict:
    """kernel name -> (kernel call, plain call, library call, bytes, ops).

    Library yardstick: ``torch.matmul`` for the same product (f32 operands,
    or the bf16 query and the int8 rows as bf16) plus ``torch.topk(k)`` over
    ``[Q, cap]``; it applies neither the re-rank nor the mask.  Bytes count
    what the run needs: the tiles that hold live rows."""
    from dewi_tpu_torch.ops import cuda_search as cs

    cap, d = x["emb"].shape
    q = x["q"][:nq].contiguous()
    rows = min(-(-n_valid // 128) * 128, cap)
    qbf, e8bf_t = q.to(torch.bfloat16), x["e8"].to(torch.bfloat16).T
    args = (x["pay"], q, n_valid, ETA, EP)
    out = 8 * nq * k
    return {
        "stream_search": (
            lambda: cs.stream_search(x["emb"], *args, k=k),
            lambda: cs.stream_search_plain(x["emb"], *args, k=k),
            lambda: torch.topk(torch.matmul(q, x["emb"].T), k, dim=1),
            rows * (4 * d + 32) + 4 * nq * d + out, 2.0 * nq * rows * d, F32_OPS_PER_S),
        "int8_stream_search": (
            lambda: cs.int8_stream_search(x["e8"], x["sc"], *args, k=k),
            lambda: cs.int8_stream_search_plain(x["e8"], x["sc"], *args, k=k),
            lambda: torch.topk(torch.matmul(qbf, e8bf_t).float(), k, dim=1),
            rows * (d + 4 + 32) + 4 * nq * d + out, 2.0 * nq * rows * d, BF16_OPS_PER_S),
    }


def phase_stream_kernels() -> dict:
    """Kernels 9 and 10 against their plain versions; their times at the
    bench's shape, Q 1, 8 and 32.  ``stream_search``'s Q=1 row and
    ``int8_stream_search``'s Q=8 row (the only shape the bench gives it) go
    into the kernels line, the Q=32 rows beside them."""
    from dewi_tpu_torch.ops import cuda_search as cs

    out = {name: {"max_abs_err": 0.0} for name in STREAM_KERNELS}
    line_q = {"stream_search": 1, "int8_stream_search": 8}
    shapes = ((65536, 64, 5, 65000, K, False), (65536, 64, 3, 4, K, False),
              (1 << 20, DIM, 1, N_LIVE, K, True), (1 << 20, DIM, 8, N_LIVE, K, True),
              (1 << 20, DIM, 32, N_LIVE, K, True), (1 << 20, DIM, 40, N_LIVE, K, False),
              (1 << 20, DIM, 8, 7, K, False))
    x, x_cap = None, 0
    for cap, d, nq, n_valid, k, timed in shapes:
        if cap != x_cap:
            del x
            torch.cuda.empty_cache()
            x, x_cap = stream_inputs(cap, d, 40, seed=cap), cap
        for name, (kern, plain, lib, nbytes, ops, peak) in stream_cases(x, nq, n_valid,
                                                                         k).items():
            before = cs.launch_counts[name]
            err = compare_topk(kern(), plain())
            check(cs.launch_counts[name] - before == -(-nq // cs.MAX_QUERIES),
                  f"{name}: launches at Q={nq}")
            rec = out[name]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if not timed:
                continue
            ms = time_device_ms(kern, reps=50, lead_cycles=400_000)
            plain_ms = time_device_ms(plain, reps=5)
            lib_ms = time_device_ms(lib, reps=50, lead_cycles=400_000)
            bound_ms, bound_by = bound(nbytes, ops, peak)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms, bytes=nbytes, queries=nq, rtol=1e-5, atol=1e-5)
            log(f"kernel {name} cap={cap} D={d} Q={nq} live={n_valid} k={k}: "
                + json.dumps(row))
            if nq == line_q[name]:
                rec.update(row)
            elif nq == 32:  # the full launch of 32 queries beside it
                rec.update(q32_ms=ms, q32_plain_ms=plain_ms, q32_bound_ms=bound_ms,
                           q32_bound_by=bound_by, q32_library_ms=lib_ms)
    log("stream kernel max_abs_err vs plain (all shapes; tolerance 1e-5 relative + absolute): "
        + json.dumps({k_: v["max_abs_err"] for k_, v in out.items()}))
    cs.reset_launch_counts()
    return out


# ---- phase 3: README quick start -----------------------------------------


def phase_quickstart() -> None:
    from dewi_tpu_torch import DewiIndex, DewiScorer, Payload, Signals, Weights

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    index = DewiIndex(dim=768, space="cosine")
    rows, embs = [], []
    for i in range(10_000):
        sig = Signals(ht_mean=rng.gamma(2, 1.5), ht_q90=rng.gamma(2.5, 1.5),
                      hi_mean=rng.gamma(2, 1), hi_q90=rng.gamma(2.5, 1),
                      I_hat=rng.beta(2, 5), redundancy=rng.beta(1, 4),
                      noise=rng.beta(1, 9))
        rows.append(sig)
        e = rng.normal(size=768).astype(np.float32)
        embs.append(e)
        index.add(f"doc{i}", e, Payload(dewi=0.0, **sig.__dict__))
    scorer = DewiScorer(Weights())
    scorer.fit_stats(rows)
    dewi = scorer.score_batch(rows)
    index.set_dewi_scores(dewi)
    index.build()
    q = rng.normal(size=768).astype(np.float32)
    results = index.search(q, k=10, eta=0.3, entropy_pref=0.5)
    sync()
    log(f"quickstart: 10000 docs x 768 in {time.perf_counter() - t0:.3f} s; top-3 "
        + json.dumps([(d, round(s, 4), round(p.dewi, 4)) for d, s, p in results[:3]]))

    # Reference: numpy float64 over the same rows and scores.
    e = np.stack(embs).astype(np.float64)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    qn = q.astype(np.float64) / np.linalg.norm(q)
    pay = index._backend.store.payload_matrix().astype(np.float64)
    adj = 0.7 * (e @ qn) + 0.3 * pay[:, 0] + 0.5 * 0.5 * (pay[:, 1] + pay[:, 3])
    want = np.argsort(-adj)[:10]
    got_scores = np.array([s for _, s, _ in results])
    check(len(results) == 10 and np.all(np.isfinite(got_scores)), "quickstart: bad results")
    np.testing.assert_allclose(got_scores, adj[want], rtol=1e-5, atol=1e-6)
    check([d for d, _, _ in results] == [f"doc{i}" for i in want], "quickstart: ranking")
    dewi_np = dewi.cpu().numpy()
    check(bool(np.all((dewi_np > 0) & (dewi_np < 1))), "quickstart: DEWI outside (0, 1)")

    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        index.save(tmp)
        again = DewiIndex.load(tmp)
        check([d for d, _, _ in again.search(q, k=10, eta=0.3, entropy_pref=0.5)]
              == [d for d, _, _ in results], "quickstart: save/load changed the ranking")
    means = [float(np.mean([p.dewi for _, _, p in index.search(q, k=10, eta=e_)]))
             for e_ in (0.0, 0.25, 0.5, 0.75, 1.0)]
    check(all(a <= b + 1e-6 for a, b in zip(means, means[1:])) and means[0] < means[-1],
          f"quickstart: eta sweep not rising {means}")
    log("quickstart eta sweep mean top-10 dewi: " + json.dumps([round(m, 4) for m in means]))


def phase_off_grid() -> None:
    """Indexes at dims their stage-1 kernels do not take: the index gates
    route them to the plain route before any launch, so they search
    without raising and launch no kernel, and return what the same index
    with ``use_pallas=False`` returns."""
    from dewi_tpu_torch import DewiIndex
    from dewi_tpu_torch.ops import cuda_search as cs

    rng = np.random.default_rng(3)
    n = 33_000
    ids = [str(i) for i in range(n)]
    pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    for backend, kw, d, kind in (("int8", {}, 100, "int8"),
                                 ("int8", {"int8_queries": True}, 100, "s8"),
                                 ("int4", {}, 48, "s4"),
                                 ("exact", {"dtype": torch.bfloat16}, 100, "bf16")):
        check(not cs.kernel_takes(kind, d, torch.device("cuda")), f"{kind} takes D={d}")
        emb = rng.normal(size=(n, d)).astype(np.float32)
        q = torch.from_numpy(rng.normal(size=(40, d)).astype(np.float32)).cuda()
        idx = DewiIndex(dim=d, backend=backend, **kw)
        plain = DewiIndex(dim=d, backend=backend, use_pallas=False, **kw)
        for ix in (idx, plain):
            ix.add_batch(ids, emb, pay)
            ix.build()
        check(idx._backend.store.capacity == 65536, "off-grid: capacity")
        for nq in (5, 40):
            cs.reset_launch_counts()
            s, i = idx.search_batch(q[:nq], k=K)
            sync()
            launched = sum(cs.launch_counts.values())
            s_p, i_p = plain.search_batch(q[:nq], k=K)
            check(launched == 0, f"off-grid {backend} {kw} D={d}: {launched} launches")
            check(bool(torch.isfinite(s).all()) and s.shape == (nq, K)
                  and torch.equal(s, s_p) and torch.equal(i, i_p),
                  f"off-grid {backend} {kw} D={d} Q={nq}: differs from the plain route")
        log(f"off-grid dim: {backend} {json.dumps({k: str(v) for k, v in kw.items()})} "
            f"D={d}: searched at Q 5 and 40 on the plain route, no launch")
    cs.reset_launch_counts()


# ---- phase 4: bench protocol at 1M x 256 --------------------------------------


def corpus():
    from dewi_tpu_torch.types import PAYLOAD_FIELDS

    g = torch.Generator(device="cuda").manual_seed(0)
    emb = torch.randn(N_DOCS, DIM, device="cuda", generator=g)
    torch.manual_seed(0)  # the gamma sampler draws from the default generator
    sig = torch.distributions.Gamma(torch.full((N_DOCS, 7), 2.0, device="cuda"),
                                    torch.ones((N_DOCS, 7), device="cuda")).sample()
    queries = torch.randn(N_QUERIES, DIM, device="cuda", generator=g)
    check(len(PAYLOAD_FIELDS) == 8, "payload layout")
    return emb, sig, queries


def search_blocks(index, queries: torch.Tensor) -> torch.Tensor:
    ids = [index.search_batch(queries[i:i + RECALL_BLOCK], k=K, eta=ETA, entropy_pref=EP)[1]
           for i in range(0, queries.shape[0], RECALL_BLOCK)]
    return torch.cat(ids)


def device_profile(fn, reps: int) -> dict:
    """Device busy time per call, launches per call and the costliest
    kernels, from ``torch.profiler`` (device time is summed over CUDA kernel
    and memory events; "not measured" when the profiler sees none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in dev)
    if not dev or total_us <= 0:
        return {"device_ms": "not measured"}
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:4]
    return {
        "device_ms": total_us / reps / 1e3,
        "device_ops_per_call": sum(e.count for e in dev) / reps,
        "top": [[e.key[:48], round(e.self_device_time_total / reps / 1e3, 4)] for e in top],
    }


def recall(ids: torch.Tensor, ref: torch.Tensor) -> float:
    hit = (ids[:, :, None] == ref[:, None, :]).any(dim=2)
    return float(hit.float().mean())


def phase_corpus_major(index, queries: torch.Tensor) -> dict:
    """``quantized_search`` on the int8-query index's arrays with a 4096-row
    stream block: the JAX gate sends it to the corpus-major kernels
    (``bmax_s8_t`` with int8 queries, ``bmax_t`` without).  Its results
    must equal the query-major route's."""
    from dewi_tpu_torch.ops import cuda_search as cs
    from dewi_tpu_torch.ops.quantized import quantized_search

    b = index._backend
    emb, sqn, pay, n = b.store.device_arrays()
    launches = {}
    for int8_queries in (True, False):
        for nq in (1, 32):
            args = (b._q_emb, b._q_scales, emb, sqn, pay, queries[:nq], n, ETA, EP)
            kw = dict(k=K, m=80, normalize=True, kernel_stage1=True,
                      int8_queries=int8_queries, blockmax_select=True, fused_bmax=True)
            cs.reset_launch_counts()
            s_t, i_t = quantized_search(*args, kernel_block=CORPUS_MAJOR_BLOCK, **kw)
            sync()
            counts = dict(cs.launch_counts)
            s_q, i_q = quantized_search(*args, **kw)
            sync()
            name = "bmax_s8_t" if int8_queries else "bmax_t"
            check(counts[name] > 0, f"corpus-major route did not launch {name}")
            check(torch.equal(i_t, i_q) and torch.equal(s_t, s_q),
                  f"corpus-major route differs from query-major ({name}, Q={nq})")
            launches[name] = launches.get(name, 0) + counts[name]
            log(f"corpus-major route {name} Q={nq}: launches {counts[name]}, "
                f"equal to the query-major route")
    return launches


def post(port: int, path: str, payload: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def serve_clients(port: int, n_clients: int, query_file: str) -> None:
    """The serving phase's clients, in a process of their own (so that they
    do not share the server's interpreter lock): ``n_clients`` threads
    send one ``POST /search`` per query of ``query_file``; prints the
    answers, each request's latency and the wall time as one JSON line."""
    qh = np.load(query_file)
    answers: list = [None] * len(qh)
    lat: list = [None] * len(qh)

    def client(c: int) -> None:
        for i in range(c, len(qh), n_clients):
            t = time.perf_counter()
            answers[i] = post(port, "/search", {"vector": qh[i].tolist(), "k": K})
            lat[i] = (time.perf_counter() - t) * 1e3

    t0, c0 = time.perf_counter(), os.times()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    c1 = os.times()
    print(json.dumps({"wall_s": time.perf_counter() - t0, "user_s": c1.user - c0.user,
                      "system_s": c1.system - c0.system, "lat_ms": lat,
                      "answers": answers}))


class WorkerSearchTimer:
    """Times each ``search_batch`` that the server's worker thread makes:
    wall time and the thread's own CPU time (``time.thread_time``), so the
    ``dispatch`` stage splits into time the worker computes (or spins in a
    CUDA call) and time it waits (for the interpreter lock)."""

    def __init__(self, index, worker: threading.Thread) -> None:
        self.index, self.worker = index, worker
        self.wall_ms: list = []
        self.cpu_ms: list = []

    def __enter__(self) -> "WorkerSearchTimer":
        search = self.index.search_batch

        def timed(*args, **kw):
            if threading.current_thread() is not self.worker:
                return search(*args, **kw)
            w0, c0 = time.perf_counter(), time.thread_time()
            try:
                return search(*args, **kw)
            finally:
                self.wall_ms.append((time.perf_counter() - w0) * 1e3)
                self.cpu_ms.append((time.thread_time() - c0) * 1e3)

        self.index.search_batch = timed  # shadows the method on this instance
        return self

    def __exit__(self, *exc) -> None:
        del self.index.search_batch

    def summary(self) -> dict:
        wall, cpu = np.asarray(self.wall_ms), np.asarray(self.cpu_ms)
        # The thread CPU clock may tick coarsely (10 ms on some hosts), so
        # only the share summed over all searches is reported.
        return {"searches": len(wall),
                "wall_p50_ms": float(np.percentile(wall, 50)),
                "wall_p95_ms": float(np.percentile(wall, 95)),
                "cpu_share_of_wall": float(cpu.sum() / wall.sum())}


def serve_run(srv, index, qh: np.ndarray, tmp: Path) -> dict:
    """One pass of the client process against ``srv``: the answers, client
    latencies, server stages and the worker's ``search_batch`` timings."""
    srv.batcher.stage_summary(reset=True)
    before = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}/healthz", timeout=60).read())
    c0 = os.times()
    with WorkerSearchTimer(index, srv.batcher._worker) as timer:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--serve-clients",
             str(srv.port), str(N_CLIENTS), str(tmp / "queries.npy")],
            capture_output=True, text=True, timeout=600)
    c1 = os.times()
    check(proc.returncode == 0, f"serve: client process failed: {proc.stderr[-2000:]}")
    clients = json.loads(proc.stdout.strip().splitlines()[-1])
    after = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}/healthz", timeout=60).read())
    queries = after["queries"] - before["queries"]
    dispatches = after["dispatches"] - before["dispatches"]
    lat, wall = clients["lat_ms"], clients["wall_s"]
    return {"answers": clients["answers"], "row": {
        "requests": len(qh), "clients": N_CLIENTS, "qps": len(qh) / wall,
        "client_p50_ms": statistics.median(lat),
        "client_p95_ms": float(np.percentile(lat, 95)),
        "dispatches": dispatches, "mean_batch": queries / max(dispatches, 1),
        # CPU seconds per wall second of each process, user and system.  Only
        # one thread at a time runs Python, so user time near 1 says that
        # process's interpreter lock, not the card, may set the pace.
        "server_user_per_wall": (c1.user - c0.user) / wall,
        "server_system_per_wall": (c1.system - c0.system) / wall,
        "client_user_per_wall": clients["user_s"] / wall,
        "client_system_per_wall": clients["system_s"] / wall,
        "stages": srv.batcher.stage_summary(), "worker_search_batch": timer.summary()}}


def phase_serve(index, queries: torch.Tensor) -> None:
    """``SearchServer`` over the int8-query index: 64 client threads, in a
    separate process, send one ``POST /search`` per seeded query (k=10),
    plus one ``/search_batch``; every answer must equal a direct
    ``search_batch`` of the same query, and every kernel launch must come
    from the batcher's worker thread."""
    from dewi_tpu_torch.ops import cuda_search as cs
    from dewi_tpu_torch.serve import MicroBatcher, SearchServer

    qh = queries.cpu().numpy()
    launch_threads: collections.Counter = collections.Counter()
    launch = cs._launch

    def spy(name: str, *args: object) -> None:
        launch_threads[(name, threading.current_thread().name)] += 1
        launch(name, *args)

    srv = SearchServer(index, port=0)
    srv.start()
    try:
        post(srv.port, "/search", {"vector": qh[0].tolist(), "k": K})  # warm-up
        with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
            np.save(Path(tmp) / "queries.npy", qh)
            cs.reset_launch_counts()
            cs._launch = spy
            run = serve_run(srv, index, qh, Path(tmp))
            batch = post(srv.port, "/search_batch",
                         {"queries": [{"vector": v.tolist(), "k": K} for v in qh[:16]]})
            counts = dict(cs.launch_counts)
    finally:
        cs._launch = launch
        srv.shutdown()
    s, rows = index.search_batch(queries, k=K)
    s, rows = s.cpu().numpy(), rows.cpu().numpy()
    max_diff = 0.0
    answers = run["answers"] + batch["results"]
    check(all(a is not None for a in answers), "serve: a request got no answer")
    for i, a in enumerate(answers):
        j = i if i < len(qh) else i - len(qh)
        check(a["ids"] == [index.doc_ids[r] for r in rows[j]],
              f"serve: request {i} ids differ from direct search")
        max_diff = max(max_diff, float(np.abs(np.asarray(a["scores"]) - s[j]).max()))
    check(max_diff <= 1e-6, f"serve: scores differ from direct search by {max_diff}")
    threads = {t for (name, t) in launch_threads if name == "bmax_s8"}
    check(counts["bmax_s8"] > 0 and threads == {MicroBatcher.WORKER_NAME},
          f"serve: bmax_s8 launches {counts['bmax_s8']} from threads {threads}")
    log("serve: " + json.dumps({**run["row"], "bmax_s8_launches": counts["bmax_s8"],
                                "answers_equal_direct_ids": True,
                                "scores_max_abs_diff": max_diff}))


def phase_stream(index, queries: torch.Tensor, ref_ids: torch.Tensor) -> dict:
    """The bench protocol's streaming section on the int8 tier's arrays: the
    normalized f32 store, the int8 codes and their scales.  ``stream_search``
    at Q 1 and 8 and ``int8_stream_search`` at Q 1, 8 and 32, CUDA-event
    medians of 50,
    each beside ``fused_search`` (block-max selection, as the exact index
    calls it) on the same store; recall@10 of all 1000 queries, in groups of
    32, against exact f32."""
    from dewi_tpu_torch.ops import cuda_search as cs
    from dewi_tpu_torch.ops.similarity import fused_search, l2_normalize

    b = index._backend
    emb, sqn, pay, n = b.store.device_arrays()
    check(emb.dtype == torch.float32 and emb.shape == (1 << 20, DIM), "stream: store")
    qn = l2_normalize(queries).contiguous()
    cs.reset_launch_counts()
    row = {}
    for nq in (1, 8):
        qx = qn[:nq].contiguous()
        row[f"stream_f32_ms_q{nq}"] = time_device_ms(
            lambda: cs.stream_search(emb, pay, qx, n, ETA, EP, k=K, block=8192))
        row[f"fused_search_f32_ms_q{nq}"] = time_device_ms(
            lambda: fused_search(emb, sqn, pay, qx, n, ETA, EP, k=K, normalize=True,
                                 blockmax_select=True))
    for nq in (1, 8, 32):
        qx = qn[:nq].contiguous()
        row[f"stream_int8_ms_q{nq}"] = time_device_ms(
            lambda: cs.int8_stream_search(b._q_emb, b._q_scales, pay, qx, n, ETA, EP, k=K,
                                          block=8192))
    ids_f32, ids_i8 = [], []
    for i in range(0, qn.shape[0], cs.MAX_QUERIES):
        qx = qn[i:i + cs.MAX_QUERIES].contiguous()
        s, ids = cs.stream_search(emb, pay, qx, n, ETA, EP, k=K, block=8192)
        check(bool(torch.isfinite(s).all()) and bool((s > -3.4e38).all())
              and s.shape == (qx.shape[0], K), "stream_search: output")
        ids_f32.append(ids)
        ids_i8.append(cs.int8_stream_search(b._q_emb, b._q_scales, pay, qx, n, ETA, EP, k=K,
                                            block=8192)[1])
    sync()
    counts = dict(cs.launch_counts)
    row["stream_f32_recall_at_10"] = recall(torch.cat(ids_f32).long(), ref_ids)
    row["stream_int8_recall_at_10"] = recall(torch.cat(ids_i8).long(), ref_ids)
    row["launches"] = {k_: counts[k_] for k_ in STREAM_KERNELS}
    log("streaming: " + json.dumps(row))
    # Exact f32 up to rounding ties at rank 10; int8 codes with bf16 queries
    # and no f32 refine.
    check(row["stream_f32_recall_at_10"] >= 0.999,
          f"stream_search recall {row['stream_f32_recall_at_10']} < 0.999")
    check(row["stream_int8_recall_at_10"] >= 0.99,
          f"int8_stream_search recall {row['stream_int8_recall_at_10']} < 0.99")
    for name in STREAM_KERNELS:
        check(counts[name] > 0, f"streaming phase did not launch {name}")
    return row["launches"]


def time_search(index, queries: torch.Tensor) -> dict:
    """Q=1 p50 over 100 searches and batched ms/query at Q=1000 (host clock
    after ``synchronize``), warm."""
    for _ in range(5):
        index.search_batch(queries[:1], k=K, eta=ETA, entropy_pref=EP)
    sync()
    lat = []
    for i in range(100):
        t = time.perf_counter()
        index.search_batch(queries[i:i + 1], k=K, eta=ETA, entropy_pref=EP)
        sync()
        lat.append((time.perf_counter() - t) * 1e3)
    index.search_batch(queries, k=K, eta=ETA, entropy_pref=EP)
    sync()
    t = time.perf_counter()
    s, ids = index.search_batch(queries, k=K, eta=ETA, entropy_pref=EP)
    sync()
    batched = (time.perf_counter() - t) * 1e3 / queries.shape[0]
    check(s.shape == (queries.shape[0], K) and bool(torch.isfinite(s).all())
          and bool((ids >= 0).all()), "ivf: Q=1000 output")
    return {"q1_p50_ms": statistics.median(lat), "batched_ms_per_query": batched,
            "ids": ids}


def phase_ivf(emb: torch.Tensor, pay: torch.Tensor, queries: torch.Tensor,
              ref_ids: torch.Tensor, doc_ids: list) -> None:
    """The bench protocol's IVF section.  The 1M random corpus goes in
    through ``attach_device`` as the tensors made on the card; ``auto``
    resolves to the gather probe here, and both are timed.  Then a clustered
    200k corpus (512 Gaussian modes), where IVF is a >= 0.99 tier."""
    from dewi_tpu_torch import ExactIndex, IVFIndex

    torch.cuda.reset_peak_memory_stats()
    ivf = IVFIndex(dim=DIM, nlist=1024, nprobe=32, dewi_tier=1024, kmeans_iters=8)
    ivf.store.attach_device(doc_ids, emb, pay)
    row = {}
    for label in ("build_cold_s", "build_warm_s"):
        t = time.perf_counter()
        ivf.build()
        sync()
        row[label] = time.perf_counter() - t
    check(ivf._resolved_probe_impl() == "gather", "ivf: auto must pick gather on the card")
    row["bucket_cap"], row["overflow"] = int(ivf._dev[1].shape[1]), int(ivf._dev[10])
    ids = {}
    for impl in ("gather", "scan"):
        ivf.probe_impl = impl
        t = time_search(ivf, queries)
        ids[impl] = t.pop("ids")
        row[impl] = t
    ivf.probe_impl = "auto"
    row["recall_at_10_random_corpus"] = recall(ids["gather"].long(), ref_ids)
    row["scan_ids_equal_gather"] = float((ids["scan"] == ids["gather"]).float().mean())
    row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(ivf.store._host_stale, "ivf: the attached corpus was pulled to the host")
    log("ivf 1M random: " + json.dumps(row))
    check(row["recall_at_10_random_corpus"] >= IVF_RANDOM_RECALL_FLOOR,
          f"ivf: random-corpus recall {row['recall_at_10_random_corpus']}")
    check(row["scan_ids_equal_gather"] >= 0.999, "ivf: scan and gather disagree")
    del ivf, ids
    torch.cuda.empty_cache()

    nc, n_sub = 512, 200_000
    g = torch.Generator(device="cuda").manual_seed(7)
    centers = torch.randn(nc, DIM, device="cuda", generator=g) * 3.0
    labels = torch.randint(0, nc, (n_sub,), device="cuda", generator=g)
    cemb = centers[labels] + torch.randn(n_sub, DIM, device="cuda", generator=g)
    cq = (centers[torch.randint(0, nc, (N_QUERIES,), device="cuda", generator=g)]
          + torch.randn(N_QUERIES, DIM, device="cuda", generator=g))
    cpay, ids_sub = pay[:n_sub].contiguous(), doc_ids[:n_sub]
    t = time.perf_counter()
    civf = IVFIndex(dim=DIM, nlist=512, nprobe=32, dewi_tier=1024, kmeans_iters=8)
    civf.store.attach_device(ids_sub, cemb, cpay)
    civf.build()
    sync()
    build_s = time.perf_counter() - t
    cexact = ExactIndex(dim=DIM)
    cexact.store.attach_device(ids_sub, cemb, cpay)
    cexact.build()
    timing = time_search(civf, cq)
    _, ce = cexact.search_batch(cq, k=K, eta=ETA, entropy_pref=EP)
    rec = recall(timing.pop("ids").long(), ce.long())
    log("ivf 200k clustered: " + json.dumps({"build_s": build_s, **timing,
                                            "recall_at_10": rec}))
    check(rec >= 0.99, f"ivf: clustered recall@10 {rec} < 0.99")


def phase_bench() -> dict:
    from dewi_tpu_torch import DewiIndex, DewiScorer
    from dewi_tpu_torch.ops import cuda_search as cs

    t0 = time.perf_counter()
    emb, sig, queries = corpus()
    scorer = DewiScorer()
    scorer.fit_and_score(sig[:1000])  # warm-up
    sync()
    t1 = time.perf_counter()
    dewi = scorer.fit_and_score(sig)
    sync()
    score_s = time.perf_counter() - t1
    log(f"scorer fit_and_score [{N_DOCS}, 7]: {score_s * 1e3:.3f} ms, "
        f"{N_DOCS / score_s:.0f} docs/s")
    check(bool(torch.isfinite(dewi).all()) and dewi.shape == (N_DOCS,), "scorer output")
    pay = torch.cat([dewi[:, None], sig], dim=1).cpu().numpy()
    emb_h = emb.cpu().numpy()
    del emb
    doc_ids = [str(i) for i in range(N_DOCS)]
    log(f"corpus set-up: {time.perf_counter() - t0:.3f} s")

    tiers = [
        ("exact_f32", "exact", {}),
        ("exact_bf16", "exact", {"dtype": torch.bfloat16}),
        ("int8", "int8", {}),
        ("int4", "int4", {}),
        ("int4_unfused", "int4", {"blockmax_select": False}),
        ("int8_s8_unfused", "int8", {"int8_queries": True, "blockmax_select": False}),
        ("int8_s8", "int8", {"int8_queries": True}),  # last: phases 4b and 5 use it
    ]
    launches = {}
    ref_ids = None
    for tier, backend, kw in tiers:
        tb = time.perf_counter()
        index = DewiIndex(dim=DIM, backend=backend, rerank_eta=ETA, entropy_pref=EP, **kw)
        index.add_batch(doc_ids, emb_h, pay)
        index.build()
        sync()
        build_s = time.perf_counter() - tb
        check(index._backend.store.capacity == 1 << 20, "capacity")

        cs.reset_launch_counts()
        q1 = queries[:1]
        for _ in range(20):
            index.search_batch(q1, k=K)
        sync()
        lat = []
        for i in range(200):
            t = time.perf_counter()
            s, _ = index.search_batch(queries[i:i + 1], k=K)
            sync()
            lat.append((time.perf_counter() - t) * 1e3)
        check(bool(torch.isfinite(s).all()) and s.shape == (1, K), f"{tier}: Q=1 output")
        index.search_batch(queries, k=K)  # warm the Q=1000 route
        sync()
        t = time.perf_counter()
        s, _ = index.search_batch(queries, k=K)
        sync()
        batched_ms = (time.perf_counter() - t) * 1e3 / N_QUERIES
        check(bool(torch.isfinite(s).all()) and s.shape == (N_QUERIES, K),
              f"{tier}: Q=1000 output")
        ids = search_blocks(index, queries)
        prof1 = device_profile(lambda: index.search_batch(q1, k=K), reps=20)
        prof_b = device_profile(lambda: index.search_batch(queries, k=K), reps=2)
        counts = dict(cs.launch_counts)
        if ref_ids is None:
            ref_ids = ids
        rec = recall(ids, ref_ids)
        row = dict(build_s=build_s, q1_p50_ms=statistics.median(lat),
                   q1_p90_ms=float(np.percentile(lat, 90)),
                   batched_ms_per_query=batched_ms, recall_at_10=rec, launches=counts,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"tier {tier}: " + json.dumps(row))
        q1_idle = (1 - prof1["device_ms"] / row["q1_p50_ms"]
                   if isinstance(prof1["device_ms"], float) else "not measured")
        log(f"tier {tier} profile Q=1 (idle share {q1_idle}): {json.dumps(prof1)}")
        log(f"tier {tier} profile Q={N_QUERIES}: {json.dumps(prof_b)}")
        check(rec >= 0.99, f"{tier}: recall@10 {rec} < 0.99")
        if tier in TIER_KERNEL:
            name = TIER_KERNEL[tier]
            check(counts[name] > 0, f"{tier}: kernel {name} was not launched")
            launches[name] = counts[name]
        if tier == "int8":
            launches.update(phase_stream(index, queries, ref_ids))
        if tier == "int8_s8":
            launches.update(phase_corpus_major(index, queries))
            phase_serve(index, queries)
        del index
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    del emb_h
    emb, _, _ = corpus()  # the same seeded tensors, on the card again
    phase_ivf(emb, torch.from_numpy(pay).cuda(), queries, ref_ids, doc_ids)
    return launches


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "unknown"


def main() -> int:
    if sys.argv[1:2] == ["--serve-clients"]:  # the serving phase's client process
        serve_clients(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import dewi_tpu_torch  # noqa: F401  (sets full-f32 matmuls)
    from dewi_tpu_torch.ops import _build

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"kernel build: nvcc {_build.build_seconds:.3f} s, load {time.perf_counter() - t0:.3f} s")

    kernels = phase_kernels()
    kernels.update(phase_stream_kernels())
    phase_quickstart()
    phase_off_grid()
    launches = phase_bench()

    line = []
    for name, rec in kernels.items():
        source = "stream_kernels.cu" if name == "stream_search" else "search_kernels.cu"
        line.append({"name": name, "route": "cuda",
                     "source": f"dewi_tpu_torch/csrc/{source}",
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                     "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                     "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                     # every kernel at 32 queries
                     **{k: rec.get(k) for k in ("q32_ms", "q32_plain_ms", "q32_bound_ms",
                                                "q32_bound_by", "q32_library_ms")}})
    log(json.dumps({"kernels": line}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
