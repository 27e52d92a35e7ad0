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
8. the signal models and estimators at the reference's default widths
   (``gpt2``, ``vit-mae-base``, ``clip-vit-base-patch32``; seeded weights):
   a msgpack save/load round trip of each model, text entropy over 2,048
   synthetic texts across every length bucket plus 8 longer than the
   512-token context (windows), image entropy over 2,048 synthetic uint8
   images made on the card (``DeviceImages``), CLIP ``batch_compute`` on
   the pairs, each with docs/s and peak memory; one batch per model in
   bfloat16 against the same weights in float32 on the card; then 10,000
   docs scored and CLIP-embedded into ``DewiIndex(backend="int8",
   int8_queries=True)`` whose provenance names the saved CLIP checkpoint,
   and 64 text queries through ``SearchServer``, each equal to
   ``encode_texts`` + ``search_batch``, with ``scores_matrix_s8`` launched;
9. the corpus pipeline at the same widths (``DewiPipeline``, the CLIP
   towers from a saved checkpoint): ``process_corpus`` on 16,384 docs
   (texts of 1-500 bytes, 8,192 with a 224-px uint8 image from one dense
   array, 256 planted duplicate pairs) with per-stage seconds, every
   planted doc's redundancy >= 0.99 and the median of the rest below;
   ``build_index_corpus`` into an int8-query index and 64 ``encode_query``
   + ``search`` calls, each equal to ``search_batch``, with ``bmax_s8`` or
   ``scores_matrix_s8`` launched; the first 1,024 docs through the object
   path against the columnar path; ``max_offdiag_similarity`` and
   ``topk_density`` on 262,144 x 512 (TFLOP/s, 512 rows held against
   float64); ``batched_image_noise`` on the 8,192 images on the card
   against the CPU on 256 (``scripts/torch_process_corpus.py`` holds the
   corpus and scan helpers);
10. the command line (``dewi_tpu_torch.cli``) at the same widths, with
   seeded LM, MAE and CLIP checkpoints: 8,192 text files of 1-500 bytes and
   2,048 224-px images as a packed ``.npy``; 256 JPEG files through
   ``pack-images`` against PIL's decode; ``config -o`` (its text equal to
   the emitter's) and the config as JSON with an int8-query index;
   ``process`` through ``cli.main`` (seconds per stage, document loading,
   ``_save_results``, the index build and save, beside phase 9a's; every
   artifact, every ``dewi_score`` in [0, 1], the index loads); 64 text
   queries and one ``.npy`` query through ``search``, each equal to
   ``DewiIndex.load(...).search(pipe.encode_query(q))``; ``eval`` with 256
   of the corpus's own texts against their own documents, recall@10 >= 0.99
   asserted; ``scores_matrix_s8`` launched by both; ``python -m
   dewi_tpu_torch serve`` in a child process answering 32 text, 32 vector
   and one ``/search_batch`` request as ``search`` did; ``sample`` with and
   without ``--submodular``; ``native.available()`` asserted (the JSONL
   codec and the minhash need only ``g++``; without libjpeg the JPEG pool is
   left out, and a line says so);
11. training (``dewi_tpu_torch.training``) at the reference's default
   settings: ``train_lm`` at the ``gpt2`` width (batch 32, seq_len 128, lr
   3e-4) for 60 steps on synthetic texts, ms/step from CUDA events (median
   of steps 11-60), tokens/s, peak memory, the model-FLOP share, the loss
   at steps 1 and 60 (asserted to fall, the step-1 gradient finite), the
   60-step checkpoint in ``TextEntropyEstimator`` (a corpus sentence's mean
   entropy below a fresh model's); three steps of the tiny f32 LM on the
   card against the CPU; ``train_moe_lm`` at the gpt2 width with 4 experts,
   20 steps (CE and aux at the first and last step); ``train_mae`` and
   ``train_clip`` at their base presets, 20 steps each.  After each timed
   run, 5 more steps under ``torch.profiler``: device ms per step and the
   idle share.  No search kernel runs here;
12. the data axis (``dewi_tpu_torch.parallel``) on the one card: (12a) a
   world of one over NCCL, where the sharded exact, int8, int8-query, int4
   and IVF searchers equal the single-device ``DewiIndex`` tiers on the
   bench corpus (scores within 1e-6, ids where scores differ); (12b) four
   ranks sharing the card over gloo (``launch_local``), each holding a
   262,144-row shard and running the stage-1 kernels on it: recall@10
   against exact f32 (>= 0.99, IVF >= 0.95), Q=1 p50, ms/query at Q=1000
   and the all-gathers' share, every rank's launches counted; (12c)
   ``DewiPipeline(mesh=)`` on four ranks over 4,096 docs (half with a
   224-px image) at the default presets against one process (the columns
   and DEWI within phase 9's 1e-2), and ``max_offdiag_similarity_sharded``
   on 262,144 x 512 within 1e-6 of the single-device scan.  Four ranks on
   one card measure the collectives and the shared card, not scaling;
13. the model axis (``parallel.ring``, ``.tp``, ``.sp``, ``.pp``,
   ``shard_expert_params``) at the ``gpt2`` width and depth: (13a) a world
   of one over NCCL, each entry point equal to the plain module in f32;
   (13b) four gloo ranks sharing the card: ring attention at T 4096 (f32
   logits and bf16 NLL against one process's forward), the estimator's
   ring mode (``chip_len`` 1024) against one process's direct forward,
   tensor parallelism (bf16 forward, one f32 ``train_lm`` step against the
   unsharded step), sequence parallelism alone and with TP, the MoE LM
   with one expert a rank, and a 4-stage pipeline (logits, 5
   ``pp_train_step`` steps); each leg's ms beside one process's, the
   collectives' share and peak memory, only the equalities asserted.  No
   kernel launches here;
14. the profilers (``scripts/torch_*``, each ``main(argv)`` in this
   process, their JSON under ``chiprun_out/profilers/``): the memory-rate
   probe over 256 MB (every pattern at most 105% of 3.35 TB/s, or the method
   is at fault), ``torch_profile_index`` at 1M x 256 (1000 queries, 200
   latency samples) for ``exact`` and ``quantized`` (``recall_vs_exact`` >=
   0.99), the scan breakdown at 2^20 x 256 with 3 windows a row (every
   row's profile holding each operation the host issued;
   ``full_two_stage``'s top-10 scores within 1e-5 of
   ``DewiIndex(backend="int8", int8_queries=True)`` on the same corpus, and
   its ids equal wherever the scores differ), the
   serving profiler at 100,000 docs (4, 16 and 64 client processes for 3 s,
   then the overload level, which must shed), ``torch_profile_ivf_1m`` at
   its full size and the recall curve at 262,144 docs with nprobe 1, 8 and
   32 (the recalls in [0, 1] and not falling with nprobe, and
   ``shipped_default_ok`` as its curve gives it); before them the probe's
   read-once reduction (``ops.cuda_probe``, ``csrc/probe_kernels.cu``)
   against its plain version on the 256 MB array (within 1e-6 of
   sum(|x|)), and the probe's ``reduce_sum_f32`` row, which runs it, at
   least 80% of ``copy_rw``'s GB/s in the same run;
15. the integration flow and the signal profilers
   (``scripts/torch_integration_flow.py``, ``torch_profile_e2e``,
   ``torch_profile_signals``, ``torch_profile_signals_sharded``, each
   ``main(argv)`` in this process, their JSON under
   ``chiprun_out/integration/``): the reference's ``tests/test_integration.py``
   flow at its sizes (eight sentences, ``tiny`` presets; signals, scores,
   the quantized index, a text query and eval, sharded exact search as a
   world of one over NCCL, sampling, 40 ``train_lm`` steps, re-scoring),
   with the reference's assertions, the text query also at 8,192 and
   65,536 rows, where it must launch ``scores_matrix`` and ``bmax``; then
   ``torch_profile_e2e`` at ``--model base`` on 2,048 text docs (the object
   path within 1e-2 of the columnar one) and on 512 docs with 64-px images,
   ``torch_profile_signals`` at ``--model base`` (every rate finite and
   positive, each stage's device and host rows within 1e-2 per doc), and
   the sharded profiler as a world of one;
16. one JSON line with every kernel's launches, error and times.

Every check raises on failure, so the script exits non-zero without a
result line.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path
from typing import Optional

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
    # no TPU kernel: the reference's row is one XLA fusion
    "probe_reduce_f32": "none (scripts/probe_hbm_bw.py:113, an XLA fusion)",
}
SOURCE = {"stream_search": "stream_kernels.cu", "probe_reduce_f32": "probe_kernels.cu"}
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

    out = {name: {"max_abs_err": 0.0} for name in REPLACES
           if name not in STREAM_KERNELS + ("probe_reduce_f32",)}
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
    into the kernels line, the Q=32 rows beside them, and
    ``stream_search``'s Q=8 row beside those."""
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
            elif nq in (8, 32):  # the bench's Q=8 and the full launch of 32 beside it
                rec.update({f"q{nq}_{key}": row[key] for key in
                            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
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


def corpus(n: int = N_DOCS, nq: int = N_QUERIES, device: str = "cuda"):
    from dewi_tpu_torch.types import PAYLOAD_FIELDS

    g = torch.Generator(device=device).manual_seed(0)
    emb = torch.randn(n, DIM, device=device, generator=g)
    torch.manual_seed(0)  # the gamma sampler draws from the default generator
    sig = torch.distributions.Gamma(torch.full((n, 7), 2.0, device=device),
                                    torch.ones((n, 7), device=device)).sample()
    queries = torch.randn(nq, DIM, device=device, generator=g)
    check(len(PAYLOAD_FIELDS) == 8, "payload layout")
    return emb, sig, queries


def search_blocks(index, queries: torch.Tensor) -> torch.Tensor:
    ids = [index.search_batch(queries[i:i + RECALL_BLOCK], k=K, eta=ETA, entropy_pref=EP)[1]
           for i in range(0, queries.shape[0], RECALL_BLOCK)]
    return torch.cat(ids)


def device_profile(fn, reps: int, top_n: int = 4) -> dict:
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
    # A user annotation on the device (the optimizer's ``Optimizer.step``
    # range) spans kernels counted on their own: left out.
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    total_us = sum(e.self_device_time_total for e in dev)
    if not dev or total_us <= 0:
        return {"device_ms": "not measured"}
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:top_n]
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
    calls it) on the same store; all 1000 queries through ``stream_search``
    in groups of 32 (CUDA events, median of 5), and their recall@10 and
    ``int8_stream_search``'s against exact f32."""
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
    groups = [qn[i:i + cs.MAX_QUERIES].contiguous()
              for i in range(0, qn.shape[0], cs.MAX_QUERIES)]
    row["stream_f32_ms_all_queries"] = time_device_ms(
        lambda: [cs.stream_search(emb, pay, qx, n, ETA, EP, k=K, block=8192) for qx in groups],
        reps=5)
    ids_f32, ids_i8 = [], []
    for qx in groups:
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


# ---- phase 8: signal models and estimators -----------------------------------

SIGNAL_SEED = 0
N_SIGNAL_DOCS = 2048        # texts, images and pairs per estimator
N_LONG_TEXTS = 8            # texts longer than the 512-token context
N_SERVE_DOCS = 10_000       # the text-query leg's corpus (int8 index, cap 16,384)
N_TEXT_QUERIES = 64
# bfloat16 against float32 on the same weights, one batch per model: the
# per-doc NLL mean and q90 and the MAE losses within 3e-2 relative, the
# CLIP embeddings at cosine >= 0.999 (the bounds the CPU tests hold the
# port's bfloat16 to against the reference's).
BF16_RTOL, BF16_COS = 3e-2, 0.999
def synthetic_texts(n: int, seed: int, lo: int = 1, hi: int = 500) -> list:
    """``n`` texts of random words, byte lengths uniform in ``[lo, hi]``."""
    from torch_process_corpus import synthetic_texts as texts

    return texts(n, seed, lo, hi)


def rel_dev(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def timed_run(fn) -> tuple:
    """``fn()``, its wall seconds to a ``synchronize`` and its peak memory (GB)."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t, torch.cuda.max_memory_allocated() / 1e9


def signal_profile(fn, reps: int = 3) -> dict:
    """Host-clock ms per call (median of ``reps``), the device's busy ms per
    call from the profiler, the idle share between them, and the bound: the
    matmul operations of one call (``FlopCounterMode``, padded rows
    included) over the bf16 tensor-core peak."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    flops = counter.get_total_flops()
    walls = []
    for _ in range(reps):
        _, sec, _ = timed_run(fn)
        walls.append(sec * 1e3)
    prof = device_profile(fn, reps=reps, top_n=6)
    wall = statistics.median(walls)
    busy = prof["device_ms"]
    measured = isinstance(busy, float)
    return {"wall_ms": wall, "idle_share": 1 - busy / wall if measured else "not measured",
            "matmul_flops": flops, "bound_ms": flops / BF16_OPS_PER_S * 1e3,
            "bound_by": "operations",
            "bound_share_of_device": flops / BF16_OPS_PER_S * 1e3 / busy if measured
            else "not measured", **prof}


def checkpoint_round_trip(name: str, model, fresh, path: Path) -> None:
    """``save_params`` then ``load_params`` into a model of another seed:
    every tensor comes back bit for bit."""
    from dewi_tpu_torch.models import registry

    t = time.perf_counter()
    registry.save_params(model, path)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    registry.load_params(fresh, path)
    load_s = time.perf_counter() - t
    want, got = model.state_dict(), fresh.state_dict()
    check(want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want),
          f"signals: {name} checkpoint round trip changed a tensor")
    log(f"signals checkpoint {name}: " + json.dumps({
        "params": registry.param_count(model), "bytes": path.stat().st_size,
        "save_s": save_s, "load_s": load_s, "bit_equal": True}))


def bf16_against_f32(lm_est, mae_est, clip_est, texts: list, images: torch.Tensor) -> dict:
    """One batch per model in bfloat16 (the default) and in float32 with the
    same weights, on the card."""
    import dataclasses

    from dewi_tpu_torch.models import registry
    from dewi_tpu_torch.models.lm import token_nll
    from dewi_tpu_torch.ops.robust import masked_mean_and_quantiles
    from dewi_tpu_torch.signals.image_entropy import normalize_images

    def f32_twin(init, model):
        twin = init(dataclasses.replace(model.cfg, dtype="float32"), seed=SIGNAL_SEED + 7)
        twin.load_state_dict(model.state_dict())
        return twin

    out = {}
    with torch.no_grad():
        ids, mask = lm_est.tokenizer.encode_batch(texts[:64], 512, pad_to=512)
        ids = torch.from_numpy(ids).cuda().long()
        mask = torch.from_numpy(mask).cuda()
        qs = torch.tensor([0.9], device="cuda")
        stats = []
        for model in (lm_est.model, f32_twin(registry.init_lm, lm_est.model)):
            nll, valid = token_nll(model(ids, mask), ids, mask)
            stats.append(masked_mean_and_quantiles(nll, valid, qs))
        out["lm_nll_mean_rel"] = rel_dev(stats[0][0], stats[1][0])
        out["lm_nll_q90_rel"] = rel_dev(stats[0][1], stats[1][1])

        x = normalize_images(images[:64])
        noise = torch.rand(64, mae_est.cfg.num_patches, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
        losses = [m(x, noise=noise) for m in (mae_est.model,
                                               f32_twin(registry.init_mae, mae_est.model))]
        out["mae_loss_rel"] = rel_dev(losses[0], losses[1])

        cl = clip_est.model
        twin = f32_twin(registry.init_clip, cl)
        ids, mask = clip_est.tokenizer.encode_batch(texts[:64], 77, pad_to=77)
        ids = torch.from_numpy(ids).cuda().long()
        mask = torch.from_numpy(mask).cuda()
        t_cos = (cl.encode_text(ids, mask) * twin.encode_text(ids, mask)).sum(1)
        i_cos = (cl.encode_image(x) * twin.encode_image(x)).sum(1)
        out["clip_text_cos_min"] = float(t_cos.min())
        out["clip_image_cos_min"] = float(i_cos.min())
    check(out["lm_nll_mean_rel"] <= BF16_RTOL and out["lm_nll_q90_rel"] <= BF16_RTOL
          and out["mae_loss_rel"] <= BF16_RTOL, f"signals: bf16 vs f32 {out}")
    check(min(out["clip_text_cos_min"], out["clip_image_cos_min"]) >= BF16_COS,
          f"signals: bf16 vs f32 {out}")
    return out


def phase_text_queries(clip_est, clip_ckpt: Path, lm_est, mae_est, card: str) -> int:
    """10,000 docs through the three estimators and ``DewiScorer`` into an
    int8-query index whose provenance names the CLIP checkpoint; 64 text
    queries through ``SearchServer``, each equal to ``encode_texts`` +
    ``search_batch``.  Returns ``scores_matrix_s8``'s launches."""
    from dewi_tpu_torch import DewiIndex, DewiScorer, SearchServer
    from dewi_tpu_torch.io import DeviceImages
    from dewi_tpu_torch.models.registry import checkpoint_fingerprint
    from dewi_tpu_torch.ops import cuda_search as cs

    t0 = time.perf_counter()
    texts = synthetic_texts(N_SERVE_DOCS, SIGNAL_SEED + 3)
    g = torch.Generator(device="cuda").manual_seed(SIGNAL_SEED + 4)
    images = DeviceImages(torch.randint(0, 256, (N_SERVE_DOCS, 224, 224, 3), device="cuda",
                                        dtype=torch.uint8, generator=g))
    ht_mean, ht_q90, _ = lm_est.batch_compute_stats(texts)
    hi_mean, hi_q90 = mae_est.batch_compute_stats(images)
    t_emb = clip_est.encode_texts_tensor(texts)
    i_emb = clip_est.encode_images_tensor(images)
    # Redundancy and noise are zero columns until their estimators are ported.
    zeros = np.zeros(N_SERVE_DOCS, np.float32)
    sig = torch.from_numpy(np.stack([ht_mean, ht_q90, hi_mean, hi_q90,
                                     (t_emb * i_emb).sum(1).cpu().numpy(), zeros, zeros],
                                    axis=1)).cuda()
    dewi = DewiScorer().fit_and_score(sig)
    emb = t_emb + i_emb  # a multimodal doc: the normalized mean of its two embeddings
    emb = emb / emb.norm(dim=1, keepdim=True)
    index = DewiIndex(dim=clip_est.cfg.d_embed, backend="int8", int8_queries=True,
                      rerank_eta=ETA, entropy_pref=EP)
    index.add_batch([f"doc{i}" for i in range(N_SERVE_DOCS)], emb.cpu().numpy(),
                    torch.cat([dewi[:, None], sig], dim=1).cpu().numpy())
    index.build()
    index.encoder = {"model": "clip-vit-base-patch32", "tokenizer": "byte",
                     "seed": SIGNAL_SEED, "checkpoint": str(clip_ckpt),
                     "checkpoint_fingerprint": checkpoint_fingerprint(clip_ckpt),
                     "d_embed": clip_est.cfg.d_embed}
    sync()
    build_s = time.perf_counter() - t0
    check(index._backend.store.capacity == 16_384, "signals: text-query index capacity")
    check(bool(torch.isfinite(dewi).all()), "signals: DEWI scores")

    queries = synthetic_texts(N_TEXT_QUERIES, SIGNAL_SEED + 5, lo=3, hi=120)
    srv = SearchServer(index, port=0, max_batch=cs.MAX_QUERIES)
    srv.start()
    answers: list = [None] * N_TEXT_QUERIES
    try:
        post(srv.port, "/search", {"text": queries[0], "k": K})  # builds the encoder
        cs.reset_launch_counts()
        t = time.perf_counter()

        def client(c: int) -> None:
            for i in range(c, N_TEXT_QUERIES, 8):
                answers[i] = post(srv.port, "/search", {"text": queries[i], "k": K})

        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        serve_s = time.perf_counter() - t
        launched = cs.launch_counts["scores_matrix_s8"]
    finally:
        srv.shutdown()
    s, rows = index.search_batch(clip_est.encode_texts(queries), k=K)
    s, rows = s.cpu().numpy(), rows.cpu().numpy()
    max_diff = 0.0
    for i, a in enumerate(answers):
        check(a is not None and a["ids"] == [index.doc_ids[r] for r in rows[i]],
              f"signals: text query {i} differs from encode_texts + search_batch")
        max_diff = max(max_diff, float(np.abs(np.asarray(a["scores"]) - s[i]).max()))
    check(max_diff <= 1e-6, f"signals: text-query scores differ by {max_diff}")
    check(launched > 0, "signals: the text queries launched no scores_matrix_s8")
    # The query encoder alone: one text at a time, as the server calls it.
    enc_ms = []
    for q in queries:
        _, sec, _ = timed_run(lambda: clip_est.encode_texts([q]))
        enc_ms.append(sec * 1e3)
    log("signals query encoder: " + json.dumps({
        "encode_p50_ms": statistics.median(enc_ms),
        **signal_profile(lambda: clip_est.encode_texts([queries[0]])), "card": card}))
    log("signals text queries: " + json.dumps({
        "docs": N_SERVE_DOCS, "build_s": build_s, "queries": N_TEXT_QUERIES,
        "wall_s": serve_s, "queries_per_s": N_TEXT_QUERIES / serve_s,
        "scores_matrix_s8_launches": launched, "answers_equal_direct": True,
        "scores_max_abs_diff": max_diff, "card": card}))
    return launched


def phase_signals(card: str) -> dict:
    """The signal estimators at the reference's default widths on the card,
    then the text-query leg; returns the kernel launches of this phase."""
    from dewi_tpu_torch.io import DeviceImages
    from dewi_tpu_torch.models import registry
    from dewi_tpu_torch.signals import (CrossModalDependency, ImageEntropyEstimator,
                                        TextEntropyEstimator, bucket_length)

    lm_est = TextEntropyEstimator("gpt2", batch_size=64, max_length=512, seed=SIGNAL_SEED)
    mae_est = ImageEntropyEstimator("vit-mae-base", batch_size=64, seed=SIGNAL_SEED)
    clip_cfg = registry.clip_config("clip-vit-base-patch32")
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        tmp = Path(tmp)
        checkpoint_round_trip("lm", lm_est.model,
                              registry.init_lm(lm_est.cfg, seed=SIGNAL_SEED + 9), tmp / "lm.msgpack")
        checkpoint_round_trip("mae", mae_est.model,
                              registry.init_mae(mae_est.cfg, seed=SIGNAL_SEED + 9),
                              tmp / "mae.msgpack")
        clip_ckpt = tmp / "clip.msgpack"
        checkpoint_round_trip("clip", registry.init_clip(clip_cfg, seed=SIGNAL_SEED),
                              registry.init_clip(clip_cfg, seed=SIGNAL_SEED + 9), clip_ckpt)
        clip_est = CrossModalDependency("clip-vit-base-patch32", batch_size=128,
                                        checkpoint=str(clip_ckpt))

        texts = synthetic_texts(N_SIGNAL_DOCS, SIGNAL_SEED + 1)
        texts += synthetic_texts(N_LONG_TEXTS, SIGNAL_SEED + 2, lo=1500, hi=4000)
        counts = lm_est.tokenizer.encode_lengths(texts, 1 << 30)
        buckets = {bucket_length(max(int(n), 2)) for n in counts if n <= 512}
        check(buckets == {32, 64, 128, 256, 512} and int((counts > 512).sum()) == N_LONG_TEXTS,
              f"signals: texts cover buckets {sorted(buckets)}")
        g = torch.Generator(device="cuda").manual_seed(SIGNAL_SEED + 6)
        images = DeviceImages(torch.randint(0, 256, (N_SIGNAL_DOCS, 224, 224, 3),
                                            device="cuda", dtype=torch.uint8, generator=g))
        lm_est.batch_compute_stats(texts[:64])  # warm-up: allocator and cuBLAS handles
        mae_est.batch_compute_stats(images.base[:64])
        clip_est.batch_compute(texts[:128], images.base[:128])

        rows = {}
        (means, q90s, q99s), sec, peak = timed_run(lambda: lm_est.batch_compute_stats(texts))
        check(all(np.isfinite(a).all() and a.shape == (len(texts),) for a in (means, q90s, q99s))
              and bool((means > 0).all() and (q99s >= q90s).all()),
              "signals: text entropy output")
        rows["text_entropy"] = dict(model="gpt2", docs=len(texts), long_docs=N_LONG_TEXTS,
                                    batch_size=64, seconds=sec, docs_per_s=len(texts) / sec,
                                    peak_mem_gb=peak, nll_mean_median=float(np.median(means)))
        (hi_mean, hi_q90), sec, peak = timed_run(lambda: mae_est.batch_compute_stats(images))
        check(all(np.isfinite(a).all() and a.shape == (N_SIGNAL_DOCS,) and (a > 0).all()
                  for a in (hi_mean, hi_q90)), "signals: image entropy output")
        rows["image_entropy"] = dict(model="vit-mae-base", docs=N_SIGNAL_DOCS, batch_size=64,
                                     seconds=sec, docs_per_s=N_SIGNAL_DOCS / sec,
                                     peak_mem_gb=peak, loss_mean_median=float(np.median(hi_mean)))
        res, sec, peak = timed_run(lambda: clip_est.batch_compute(texts[:N_SIGNAL_DOCS], images))
        sims = np.asarray([r.info_nce_score for r in res])
        check(sims.shape == (N_SIGNAL_DOCS,) and np.isfinite(sims).all()
              and (np.abs(sims) <= 1 + 1e-5).all(), "signals: cross-modal output")
        rows["cross_modal"] = dict(model="clip-vit-base-patch32", docs=N_SIGNAL_DOCS,
                                   batch_size=128, seconds=sec, docs_per_s=N_SIGNAL_DOCS / sec,
                                   peak_mem_gb=peak)
        for name, row in rows.items():
            log(f"signals {name}: " + json.dumps({**row, "card": card}))
        # One batch of each, profiled: texts of the 512-token bucket.
        long_batch = [t for t in texts if 256 <= len(t) < 512][:64]
        for name, fn in (
                ("text_entropy batch 64 x 512", lambda: lm_est.batch_compute_stats(long_batch)),
                ("image_entropy batch 64", lambda: mae_est.batch_compute_stats(images.base[:64])),
                ("cross_modal batch 128", lambda: clip_est.batch_compute(
                    texts[:128], images.base[:128]))):
            log(f"signals profile {name}: " + json.dumps({**signal_profile(fn), "card": card}))
        log("signals bf16 vs f32: " + json.dumps(
            {**bf16_against_f32(lm_est, mae_est, clip_est, texts, images.base), "card": card}))
        del images
        torch.cuda.empty_cache()
        launched = phase_text_queries(clip_est, clip_ckpt, lm_est, mae_est, card)
    return {"scores_matrix_s8": launched}


# ---- phase 9: the corpus pipeline ---------------------------------------------

N_PIPE_DOCS = 16_384        # 9a: docs through process_corpus
N_PIPE_IMAGES = 8_192       # of them with a 224-px image (one dense 1.23 GB array)
N_PIPE_DUPS = 256           # planted pairs: same text, same image
N_PIPE_QUERIES = 64         # 9b: encode_query + search
N_OBJECT_DOCS = 1_024       # 9b: the object path on the first docs
N_SCAN = 262_144            # 9c: unit vectors through the redundancy scans
N_NOISE_CHECK = 256         # 9d: images held against the CPU
PIPE_KERNELS = ("bmax_s8", "scores_matrix_s8")
# The object path against the columnar one: the bfloat16 models see other
# batch shapes (the cross-modal stage encodes only the pairs' texts), so
# per-doc columns agree to bfloat16 rounding; 1e-2 of max(|value|, 1), the
# bound the CPU tests hold the port's bfloat16 to against the reference.
PIPE_RTOL = 1e-2
BLUR_RTOL = 1e-5            # 9d: card against CPU, relative
GATE_EPS = 1e-5             # 9d: a skin-gate input this close to a threshold may flip


def near_skin_gate(imgs: np.ndarray, size: int = 64) -> np.ndarray:
    """Per image, the pixels whose skin-gate inputs lie within GATE_EPS of a
    threshold, in float64 with the resize weights of the noise pass."""
    from dewi_tpu_torch.io.device_images import _resize_matrix

    x = imgs.astype(np.float64) / 255.0
    my = _resize_matrix(x.shape[1], size).astype(np.float64)
    mx = _resize_matrix(x.shape[2], size).astype(np.float64)
    x = np.einsum("sw,bowc->bosc", mx, np.einsum("oh,bhwc->bowc", my, x))
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    near = np.zeros(y.shape, bool)
    for v, ts in ((0.564 * (b - y) + 0.5, (0.30, 0.50)), (0.713 * (r - y) + 0.5, (0.52, 0.68)),
                  (y, (0.15,))):
        for t in ts:
            near |= np.abs(v - t) <= GATE_EPS
    return near.sum(axis=(1, 2))


def pipeline_index_leg(pipe, corpus, clip_ckpt: str, card: str) -> dict:
    """9b: ``build_index_corpus`` and 64 ``encode_query`` + ``search`` calls,
    each equal to ``search_batch`` on the same embeddings; returns the
    stage-1 kernels' launches."""
    from dewi_tpu_torch.ops import cuda_search as cs

    cs.reset_launch_counts()
    t = time.perf_counter()
    index = pipe.build_index_corpus(corpus)
    sync()
    build_s = time.perf_counter() - t
    queries = synthetic_texts(N_PIPE_QUERIES, SIGNAL_SEED + 12, lo=3, hi=120)
    t = time.perf_counter()
    embs, answers = [], []
    for q in queries:
        e = pipe.encode_query(q)
        embs.append(e)
        answers.append(index.search(e, k=K))
    query_s = time.perf_counter() - t
    launched = {name: cs.launch_counts[name] for name in PIPE_KERNELS}
    check(sum(launched.values()) > 0, f"pipeline: the index launched none of {PIPE_KERNELS}")
    check(index.encoder["source"] == "cross_modal" and index.encoder["checkpoint"] == clip_ckpt,
          f"pipeline: index provenance {index.encoder}")
    s, rows = index.search_batch(np.stack(embs), k=K)
    s, rows = s.cpu().numpy(), rows.cpu().numpy()
    max_diff = 0.0
    for i, a in enumerate(answers):
        check([doc for doc, _, _ in a] == [index.doc_ids[r] for r in rows[i]],
              f"pipeline: query {i} differs from search_batch")
        max_diff = max(max_diff, float(np.abs(np.array([sc for _, sc, _ in a]) - s[i]).max()))
    check(max_diff <= 1e-6, f"pipeline: search scores differ from search_batch by {max_diff}")
    log("pipeline index: " + json.dumps({
        "docs": len(index), "capacity": index._backend.store.capacity,
        "backend": type(index._backend).__name__, "build_s": build_s,
        "queries": N_PIPE_QUERIES, "query_ms": query_s / N_PIPE_QUERIES * 1e3,
        "launches": launched, "answers_equal_search_batch": True,
        "scores_max_abs_diff": max_diff, "card": card}))
    return launched


def pipeline_object_leg(pipe, corpus, card: str) -> None:
    """9b: the first docs through the object path (``compute_signals`` ->
    ``compute_dewi_scores`` -> ``build_index``) against the columnar path on
    the same docs, and against their rows of the full run."""
    from torch_profile_e2e import col_dev

    from dewi_tpu_torch import Corpus, Document
    from dewi_tpu_torch.types import SIGNAL_FIELDS

    n = N_OBJECT_DOCS
    sources = [corpus.images[i] for i in range(n)]
    docs = [Document(doc_id=corpus.ids[i], text=corpus.texts[i], image=sources[i])
            for i in range(n)]
    t = time.perf_counter()
    pipe.compute_dewi_scores(pipe.compute_signals(docs))
    index = pipe.build_index(docs)
    sync()
    object_s = time.perf_counter() - t
    sub = pipe.process_corpus(Corpus(ids=corpus.ids[:n], texts=corpus.texts[:n],
                                     images=sources))
    obj = np.array([[float(getattr(d, k) or 0.0) for k in SIGNAL_FIELDS] for d in docs])
    obj_emb = np.stack([d.embedding for d in docs])
    same = {k: col_dev(obj[:, j], sub.signals[:, j]) for j, k in enumerate(SIGNAL_FIELDS)}
    same["dewi"] = col_dev([d.dewi_score for d in docs], sub.dewi)
    same["embeddings"] = col_dev(obj_emb, sub.embeddings)
    # Redundancy and DEWI depend on the whole corpus; the rest is per doc.
    per_doc = [k for k in SIGNAL_FIELDS if k != "redundancy"]
    full = {k: col_dev(obj[:, SIGNAL_FIELDS.index(k)], corpus.col(k)[:n]) for k in per_doc}
    full["embeddings"] = col_dev(obj_emb, corpus.embeddings[:n])
    log("pipeline object path: " + json.dumps({
        "docs": n, "seconds": object_s, "index_docs": len(index), "rtol": PIPE_RTOL,
        "max_dev_vs_columnar_same_docs": same, "max_dev_vs_full_run_rows": full,
        "card": card}))
    worst = max(max(same.values()), max(full.values()))
    check(worst <= PIPE_RTOL, f"pipeline: object path off the columnar path by {worst}")
    check(index.encoder["source"] == "cross_modal", "pipeline: object-path provenance")


def pipeline_noise_leg(dense: np.ndarray, card: str) -> None:
    """9d: ``batched_image_noise`` on the corpus's images, uploaded in the
    background to the card, against the same function on the CPU."""
    from dewi_tpu_torch.io import device_images_or_none
    from dewi_tpu_torch.ops.image_noise import batched_image_noise

    t = time.perf_counter()
    di = device_images_or_none(dense, non_blocking=True)
    check(di is not None, "pipeline: the image corpus did not go to the card")
    base = di.base
    sync()
    upload_s = time.perf_counter() - t
    check(torch.equal(base[:4].cpu(), torch.from_numpy(dense[:4])), "pipeline: upload bytes")
    batched_image_noise(base[:64])  # warm-up
    sync()
    t = time.perf_counter()
    blur, skin = batched_image_noise(base)
    noise_s = time.perf_counter() - t
    want_blur, want_skin = batched_image_noise(dense[:N_NOISE_CHECK], device="cpu")
    blur_dev = float(np.abs(blur[:N_NOISE_CHECK] - want_blur).max() / np.abs(want_blur).max())
    near = near_skin_gate(dense[:N_NOISE_CHECK])
    skin_diff = np.abs(skin[:N_NOISE_CHECK] - want_skin)
    log("pipeline image noise: " + json.dumps({
        "images": len(dense), "upload_s": upload_s, "ms": noise_s * 1e3,
        "images_per_s": len(dense) / noise_s, "checked": N_NOISE_CHECK,
        "blur_max_rel_dev": blur_dev, "skin_max_abs_diff": float(skin_diff.max()),
        "pixels_at_a_skin_gate": int(near.sum()), "card": card}))
    check(np.isfinite(blur).all() and np.isfinite(skin).all(), "pipeline: noise finite")
    check(blur_dev <= BLUR_RTOL, f"pipeline: blur off the CPU by {blur_dev}")
    check(bool((skin_diff <= 1e-5 * want_skin + near / 64**2).all()),
          "pipeline: skin fraction off the CPU beyond its gate pixels")


def phase_pipeline(card: str) -> dict:
    """Phase 9: the corpus pipeline at the reference's default widths;
    returns the launches of the stage-1 kernels in its index leg."""
    import torch_process_corpus as tpc

    from dewi_tpu_torch import DewiConfig, DewiPipeline

    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        clip_ckpt = tpc.save_clip(Path(tmp) / "clip.msgpack", SIGNAL_SEED)
        cfg = DewiConfig.from_dict(tpc.pipeline_config(
            clip_ckpt, index={"ann": "int8", "int8_queries": True,
                              "rerank_eta": ETA, "entropy_pref": EP}))
        t = time.perf_counter()
        corpus, planted, dense = tpc.make_corpus(N_PIPE_DOCS, N_PIPE_IMAGES, N_PIPE_DUPS,
                                                 SIGNAL_SEED + 10)
        setup_s = time.perf_counter() - t
        t = time.perf_counter()
        pipe = DewiPipeline(cfg)
        warm, _, _ = tpc.make_corpus(256, 128, 4, SIGNAL_SEED + 11)
        pipe.process_corpus(warm)  # builds the estimators; allocator and cuBLAS warm-up
        warm_s = time.perf_counter() - t
        row = tpc.process_run(pipe, corpus)
        red = corpus.col("redundancy")
        rest = np.setdiff1d(np.arange(N_PIPE_DOCS), planted)
        row.update(setup_s=setup_s, warm_up_s=warm_s, planted=len(planted),
                   planted_min_redundancy=float(red[planted].min()),
                   rest_median_redundancy=float(np.median(red[rest])),
                   rest_max_redundancy=float(red[rest].max()))
        log("pipeline process_corpus: " + json.dumps({**row, "card": card}))
        PIPE_9A.update({k: row[k] for k in ("docs", "seconds", "docs_per_s", "stage_seconds")})
        check(bool(np.isfinite(corpus.signals).all() and np.isfinite(corpus.dewi).all()),
              "pipeline: a signal column or dewi is not finite")
        check(row["planted_min_redundancy"] >= 0.99,
              f"pipeline: a planted duplicate reads {row['planted_min_redundancy']}")
        check(row["rest_median_redundancy"] < 0.99,
              f"pipeline: the median redundancy reads {row['rest_median_redundancy']}")
        prof = tpc.profile_run(pipe, 2048, 1024, SIGNAL_SEED + 13)
        log("pipeline process_corpus profile: " + json.dumps({**prof, "card": card}))
        launched = pipeline_index_leg(pipe, corpus, clip_ckpt, card)
        pipeline_object_leg(pipe, corpus, card)
    scan = tpc.redundancy_run(N_SCAN, 512, seed=0)
    log("pipeline redundancy scan: " + json.dumps({**scan, "card": card}))
    check(scan["ok"], f"pipeline: redundancy scan {scan['max_abs_err']}, "
                      f"planted {scan['planted_min']}")
    pipeline_noise_leg(dense, card)
    return launched


# ---- phase 10: the command line -----------------------------------------------

# 16,384 texts and 4,096 images added 103.9 s on an H100 (file writes and
# reads, the checkpoints, a server's start); half of each keeps the phase
# nearer its share of the time limit.
N_CLI_TEXTS = 8_192         # 10a: text files of 1-500 bytes
N_CLI_IMAGES = 2_048        # 10a: 224-px images in a packed .npy
N_CLI_JPEGS = 256           # 10a: JPEG files through pack-images
N_CLI_QUERIES = 64          # 10c: text queries through search
N_CLI_EVAL = 256            # 10c: self-retrieval queries through eval
N_CLI_SERVE = 32            # 10d: text requests, and as many vector requests
N_CLI_SAMPLE = 100          # 10e: docs picked by sample
CLI_EVAL_RECALL = 0.99
CLI_SEARCH = {"k": K, "eta": 0.5, "entropy_pref": 1.0}  # the search command's defaults
# The native pool and PIL decode the same JPEG with different libjpeg builds
# and upsampling; the reference's own test holds them to this mean.
JPEG_MEAN_ABS = 8.0
PIPE_9A: dict = {}          # phase 9a's row, logged beside phase 10's


def quiet(fn, *args):
    """``fn(*args)`` with its standard output and error captured; their
    last lines are logged when it raises or its exit code is not 0."""
    import contextlib
    import io

    buf = io.StringIO()
    failed = True
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            out = fn(*args)
        failed = (out["rc"] if isinstance(out, dict) else out) != 0
        return out
    finally:
        if failed:
            log(buf.getvalue()[-3000:])


def same_answer(got_ids: list, got_scores, want_ids: list, want_scores, tol: float = 1e-6) -> float:
    """Scores within ``tol``; ids equal wherever the score is not tied.
    Returns the largest score difference (raises on a mismatch)."""
    got_scores, want_scores = np.asarray(got_scores, np.float64), np.asarray(want_scores, np.float64)
    check(len(got_ids) == len(want_ids), f"cli: {len(got_ids)} results, want {len(want_ids)}")
    diff = float(np.abs(got_scores - want_scores).max()) if len(got_ids) else 0.0
    check(diff <= tol, f"cli: scores differ by {diff}")
    for i, (a, b) in enumerate(zip(got_ids, want_ids)):
        tied = int((np.abs(want_scores - want_scores[i]) <= tol).sum()) > 1
        check(a == b or tied, f"cli: rank {i} holds {a}, want {b}")
    return diff


def cli_jpeg_leg(tmp: Path, dense: np.ndarray, card: str) -> dict:
    """10a: JPEG files through ``pack-images`` (the native pool where it is
    built), each row against PIL's decode of the same file."""
    from dewi_tpu_torch import cli, native
    from dewi_tpu_torch.io.images import decode_image_uint8
    from dewi_tpu_torch.io.packed import PackedImages

    try:
        from PIL import Image
    except ImportError:
        log("cli jpeg: PIL is not installed here, so no JPEG is written: the JPEG leg is left out")
        return {}
    jdir = tmp / "jpegs"
    jdir.mkdir()
    for i in range(N_CLI_JPEGS):
        Image.fromarray(dense[i]).save(jdir / f"j{i:04d}.jpg", quality=90)
    pool = native.jpeg_pool_available()
    if not pool:
        log("cli jpeg: the native library was built without libjpeg (no jpeglib.h or "
            "-ljpeg here), so pack-images decodes with PIL")
    t = time.perf_counter()
    # --workers 0: decode in this process (a spawned pool would import this
    # script, and torch, in every worker first).
    rc = quiet(cli.main, ["pack-images", str(jdir), str(tmp / "jpegs.npy"), "--workers", "0"])
    pack_s = time.perf_counter() - t
    check(rc == 0, f"cli: pack-images rc {rc}")
    pack = PackedImages(tmp / "jpegs.npy")
    names = json.loads((tmp / "jpegs.npy.manifest.json").read_text())
    check(len(pack) == N_CLI_JPEGS == len(names), "cli: pack-images rows")
    dev = np.array([np.abs(pack[i].astype(np.float32)
                           - decode_image_uint8(names[i], 224).astype(np.float32)).mean()
                    for i in range(N_CLI_JPEGS)])
    row = {"jpegs": N_CLI_JPEGS, "native_pool": pool, "pack_s": pack_s,
           "images_per_s": N_CLI_JPEGS / pack_s, "mean_abs_vs_pil_max": float(dev.max()),
           "mean_abs_vs_pil_mean": float(dev.mean()), "bound": JPEG_MEAN_ABS, "card": card}
    log("cli pack-images: " + json.dumps(row))
    check(float(dev.max()) <= JPEG_MEAN_ABS, f"cli: a packed JPEG is {dev.max()} off PIL")
    return row


def cli_process_leg(tmp: Path, cfg_path: Path, out: Path, card: str) -> None:
    """10b: ``process`` through ``cli.main``, then the artifacts."""
    import torch_cli_process as tcp

    from dewi_tpu_torch import DewiIndex

    rec = quiet(tcp.run_process, ["--device", "cuda", "process", str(cfg_path), str(out),
                                  "--texts", str(tmp / "texts"), "--images",
                                  str(tmp / "images.npy")])
    check(rec["rc"] == 0, f"cli: process rc {rec['rc']}")
    n = N_CLI_TEXTS + N_CLI_IMAGES
    batches = -(-n // 1000)
    for name in ([f"documents_batch_{b:04d}.jsonl" for b in range(1, batches + 1)]
                 + [f"embeddings_batch_{b:04d}.npz" for b in range(1, batches + 1)]
                 + ["signals_summary.json", "metadata.json", "index/config.json",
                    "index/ann_index/payloads.jsonl", "index/ann_index/embeddings.npy"]):
        check((out / name).exists(), f"cli: process wrote no {name}")
    summary = json.loads((out / "signals_summary.json").read_text())
    meta = json.loads((out / "metadata.json").read_text())
    dewi = np.array([r["dewi_score"] for r in summary], np.float64)
    check(len(summary) == n and meta["num_documents"] == n and meta["dimensions"] == 512,
          f"cli: {len(summary)} summary rows, metadata {meta}")
    check(bool(((dewi >= 0) & (dewi <= 1)).all()), "cli: a dewi_score outside [0, 1]")
    t = time.perf_counter()
    index = DewiIndex.load(out / "index")
    load_s = time.perf_counter() - t
    check(len(index) == n and type(index._backend).__name__ == "QuantizedIndex"
          and index._backend.int8_queries, "cli: the saved index")
    check(index.encoder["checkpoint"] is not None, f"cli: index provenance {index.encoder}")
    rec.update(docs=n, texts=N_CLI_TEXTS, images=N_CLI_IMAGES, docs_per_s=n / rec["seconds"],
               index_load_s=load_s, capacity=index._backend.store.capacity)
    log("cli process: " + json.dumps({**rec, "phase_9a": PIPE_9A, "card": card}))


def cli_search_leg(tmp: Path, pipe, out: Path, queries: list, card: str) -> tuple:
    """10c: ``search`` for each text query and one ``.npy`` query, each equal
    to ``DewiIndex.load(...).search(pipe.encode_query(q))``; returns the
    answers and the query vectors."""
    from dewi_tpu_torch import DewiIndex, cli
    from dewi_tpu_torch.ops import cuda_search as cs

    index = DewiIndex.load(out / "index")
    cs.reset_launch_counts()
    answers, ms = [], []
    for i, q in enumerate(queries):
        res = tmp / f"search{i}.json"
        t = time.perf_counter()
        rc = quiet(cli.main, ["--device", "cuda", "search", str(out / "index"), q,
                              "--k", str(K), "-o", str(res)])
        ms.append((time.perf_counter() - t) * 1e3)
        check(rc == 0, f"cli: search rc {rc}")
        answers.append(json.loads(res.read_text()))
    launched = cs.launch_counts["scores_matrix_s8"]
    vecs = np.stack([pipe.encode_query(q) for q in queries])
    max_diff = 0.0
    for a, v in zip(answers, vecs):
        want = index.search(v, **CLI_SEARCH)
        max_diff = max(max_diff, same_answer([r["id"] for r in a], [r["score"] for r in a],
                                             [d for d, _, _ in want], [s for _, s, _ in want]))
    np.save(tmp / "query.npy", vecs[0])
    check(quiet(cli.main, ["--device", "cuda", "search", str(out / "index"),
                           str(tmp / "query.npy"), "-o", str(tmp / "search_npy.json")]) == 0,
          "cli: .npy search")
    a = json.loads((tmp / "search_npy.json").read_text())
    same_answer([r["id"] for r in a], [r["score"] for r in a],
                [r["id"] for r in answers[0]], [r["score"] for r in answers[0]])
    log("cli search: " + json.dumps({
        "queries": len(queries), "ms_p50": statistics.median(ms), "ms_max": max(ms),
        "scores_matrix_s8_launches": launched, "answers_equal_library": True,
        "scores_max_abs_diff": max_diff, "npy_query_equal": True, "card": card}))
    check(launched > 0, "cli: search launched no scores_matrix_s8")
    return answers, vecs, launched


def cli_eval_leg(tmp: Path, out: Path, card: str) -> int:
    """10c: ``eval`` with 256 of the corpus's own texts as queries and each
    query's own document as its qrel; recall@10 asserted."""
    from dewi_tpu_torch import cli
    from dewi_tpu_torch.ops import cuda_search as cs

    rows = [json.loads(line) for f in sorted(out.glob("documents_batch_*.jsonl"))
            for line in f.read_text().splitlines()]
    counts = collections.Counter(r["text"] for r in rows if r["text"])
    picked = [r for r in rows if r["text"] and len(r["text"]) >= 32
              and counts[r["text"]] == 1][:N_CLI_EVAL]
    check(len(picked) == N_CLI_EVAL, "cli: too few distinct texts for eval")
    qids = np.array([f"q{i}" for i in range(N_CLI_EVAL)])
    np.savez(tmp / "queries.npz", query_ids=qids, texts=np.array([r["text"] for r in picked]))
    (tmp / "qrels.json").write_text(json.dumps({q: [r["id"]] for q, r in zip(qids, picked)}))
    cs.reset_launch_counts()
    t = time.perf_counter()
    rc = quiet(cli.main, ["--device", "cuda", "eval", str(out / "index"),
                          str(tmp / "queries.npz"), str(tmp / "qrels.json"), "--eta", "0",
                          "--entropy-pref", "0", "-o", str(tmp / "report.json")])
    sec = time.perf_counter() - t
    launched = cs.launch_counts["scores_matrix_s8"]
    check(rc == 0, f"cli: eval rc {rc}")
    report = json.loads((tmp / "report.json").read_text())
    log("cli eval: " + json.dumps({"seconds": sec, "report": report,
                                   "scores_matrix_s8_launches": launched, "card": card}))
    check(report["recall@10"] >= CLI_EVAL_RECALL, f"cli: eval recall@10 {report['recall@10']}")
    check(launched > 0, "cli: eval launched no scores_matrix_s8")
    return launched


def cli_serve_leg(out: Path, queries: list, vecs: np.ndarray, answers: list, card: str) -> None:
    """10d: ``python -m dewi_tpu_torch serve`` in a child process: text and
    vector requests and one ``/search_batch``, each equal to 10c's answer."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "dewi_tpu_torch", "--device", "cuda", "serve",
                             str(out / "index"), "--port", "0"], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first: list = []  # the line naming the port, printed once the index is up
        reader = threading.Thread(target=lambda: first.append(proc.stdout.readline()),
                                  daemon=True)
        reader.start()
        reader.join(timeout=300)
        line = first[0] if first else ""
        check(line.startswith("Serving"), f"cli: serve printed {line!r}")
        port = int(line.split("http://")[1].split()[0].rsplit(":", 1)[1])
        up_s = time.perf_counter() - t0
        ms, max_diff = [], 0.0
        n = N_CLI_SERVE
        reqs = ([({"text": q, **CLI_SEARCH}, answers[i]) for i, q in enumerate(queries[:n])]
                + [({"vector": vecs[i].tolist(), **CLI_SEARCH}, answers[i])
                   for i in range(n, 2 * n)])
        for req, want in reqs:
            t = time.perf_counter()
            got = post(port, "/search", req)
            ms.append((time.perf_counter() - t) * 1e3)
            max_diff = max(max_diff, same_answer(got["ids"], got["scores"],
                                                 [r["id"] for r in want],
                                                 [r["score"] for r in want]))
        batch = post(port, "/search_batch", {"queries": [
            {"vector": vecs[i].tolist(), **CLI_SEARCH} for i in range(8)]})["results"]
        for got, want in zip(batch, answers[:8]):
            same_answer(got["ids"], got["scores"], [r["id"] for r in want],
                        [r["score"] for r in want])
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rest, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rest, err = proc.communicate()
    log("cli serve: " + json.dumps({
        "up_s": up_s, "text_requests": n, "vector_requests": n, "batch_requests": 8,
        "ms_p50": statistics.median(ms), "answers_equal_search": True,
        "scores_max_abs_diff": max_diff, "rc": proc.returncode,
        "shut_down": "Shutting down." in rest, "card": card}))
    check("Shutting down." in rest, f"cli: serve did not shut down: {err[-2000:]}")


def cli_sample_leg(tmp: Path, out: Path, card: str) -> None:
    """10e: ``sample`` by DEWI^tau and with ``--submodular``."""
    from dewi_tpu_torch import cli

    ids = {r["id"] for r in json.loads((out / "signals_summary.json").read_text())}
    row = {}
    for name, extra in (("dewi_tau", []), ("submodular", ["--submodular"])):
        path = tmp / f"sample_{name}.txt"
        t = time.perf_counter()
        rc = quiet(cli.main, ["--device", "cuda", "sample", str(out), str(N_CLI_SAMPLE),
                              *extra, "-o", str(path)])
        row[f"{name}_s"] = time.perf_counter() - t
        picked = path.read_text().split()
        check(rc == 0 and len(picked) == N_CLI_SAMPLE == len(set(picked))
              and set(picked) <= ids, f"cli: sample {name}")
    log("cli sample: " + json.dumps({**row, "k": N_CLI_SAMPLE, "card": card}))


def phase_cli(card: str) -> dict:
    """Phase 10: the command line at the reference's default widths;
    returns the launches of ``scores_matrix_s8`` in ``search`` and ``eval``."""
    import torch_cli_process as tcp

    from dewi_tpu_torch import DewiConfig, DewiPipeline, cli, native

    check(native.available(), "cli: the native library did not build")
    log("cli native: " + json.dumps({"available": True, "jpeg_pool": native.jpeg_pool_available(),
                                     "build_s": native.build_seconds, "card": card}))
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        tmp = Path(tmp)
        setup = {}
        t = time.perf_counter()
        texts = tcp.write_texts(tmp / "texts", N_CLI_TEXTS, SIGNAL_SEED + 20)
        setup["texts_s"] = time.perf_counter() - t
        dense = tcp.write_pack(tmp / "images.npy", N_CLI_IMAGES, SIGNAL_SEED + 21)
        setup["pack_s"] = time.perf_counter() - t - setup["texts_s"]
        ckpts = tcp.save_checkpoints(tmp, SIGNAL_SEED)
        setup["checkpoints_s"] = time.perf_counter() - t - setup["texts_s"] - setup["pack_s"]
        check(quiet(cli.main, ["config", "-o", str(tmp / "dewi.yaml")]) == 0, "cli: config")
        tree = tcp.cli_config({})
        check((tmp / "dewi.yaml").read_text() == cli.yaml_dump(tree), "cli: config's YAML")
        cfg = tcp.cli_config(ckpts, index={"ann": "int8", "int8_queries": True})
        (tmp / "dewi.json").write_text(json.dumps(cfg))  # JSON: read with or without PyYAML
        log("cli corpus: " + json.dumps({"texts": len(texts), "images": N_CLI_IMAGES,
                                         "setup_s": time.perf_counter() - t, **setup,
                                         "card": card}))
        cli_jpeg_leg(tmp, np.asarray(dense[:N_CLI_JPEGS]), card)
        out = tmp / "out"
        cli_process_leg(tmp, tmp / "dewi.json", out, card)
        pipe = DewiPipeline(DewiConfig.from_dict(cfg))
        queries = synthetic_texts(N_CLI_QUERIES, SIGNAL_SEED + 22, lo=3, hi=120)
        answers, vecs, launched = cli_search_leg(tmp, pipe, out, queries, card)
        launched += cli_eval_leg(tmp, out, card)
        cli_serve_leg(out, queries, vecs, answers, card)
        cli_sample_leg(tmp, out, card)
    return {"scores_matrix_s8": launched}


# ---- phase 11: training on the card ------------------------------------------

TRAIN_SEED = 0
N_TRAIN_TEXTS = 4096        # synthetic_texts of 1-500 bytes (seq_len 128 cuts most)
TRAIN_STEPS = 60            # 11a: train_lm at the gpt2 width
TRAIN_TIMED_FROM = 11       # 11a: steps 11-60 timed
PARITY_STEPS = 3            # 11b: the tiny f32 LM, card against CPU
PARITY_RTOL = 1e-4          # of the largest parameter magnitude; the losses relative
NOISE_LED = 1e-6            # step-1 |grad| below this share of the global norm (nonzero)
MOE_STEPS = 20              # 11c
AUX_WEIGHT = 0.01           # train_moe_lm's default
SIDE_STEPS = 20             # 11d: train_mae, train_clip
SIDE_TIMED_FROM = 6
PROFILE_STEPS = 5           # steps under the profiler after each timed run
N_TRAIN_IMAGES = 256        # 11d: 224-px images in [0, 1]


class StepClock:
    """CUDA events recorded after each optimizer update (``loops._apply_update``
    wrapped for the run), so consecutive events bracket one training step on
    the device; also keeps step 1's global gradient norm, before clipping."""

    def __init__(self) -> None:
        self.events: list = []
        self.grad_norm0 = None

    def __enter__(self):
        from dewi_tpu_torch.training import loops

        self._loops, self._orig = loops, loops._apply_update

        def timed(optimizer, scheduler):
            if self.grad_norm0 is None:
                grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                         if p.grad is not None]
                self.grad_norm0 = torch.linalg.vector_norm(
                    torch.stack(torch._foreach_norm(grads)))
            self._orig(optimizer, scheduler)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)

        loops._apply_update = timed
        sync()
        torch.cuda.reset_peak_memory_stats()
        return self

    def __exit__(self, *exc) -> None:
        self._loops._apply_update = self._orig
        sync()
        self.peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def step_ms(self, first: int) -> float:
        """Median ms of steps ``first``..last (step i ends at event i-1)."""
        ev = self.events
        return statistics.median(ev[i - 2].elapsed_time(ev[i - 1])
                                 for i in range(first, len(ev) + 1))


def train_line(kind: str, clock: StepClock, first: int, items: int, unit: str,
               losses: list, card: str, run, **extra) -> dict:
    """Log one training leg; ``run(steps)`` trains the same model on for
    ``PROFILE_STEPS`` more steps under the profiler: device ms per step and
    the idle share against the event-timed step."""
    ms = clock.step_ms(first)
    prof = device_profile(lambda: run(PROFILE_STEPS), reps=1, top_n=4)
    busy = prof["device_ms"]
    if isinstance(busy, float):
        prof["device_ms_per_step"] = busy / PROFILE_STEPS
        prof["idle_share"] = 1 - busy / PROFILE_STEPS / ms
    row = {"steps": len(clock.events), "ms_per_step": ms, f"{unit}_per_s": items / ms * 1e3,
           "peak_gb": clock.peak_gb, "loss_first": losses[0], "loss_last": losses[-1],
           "grad_norm_step1": float(clock.grad_norm0), **extra, "profile": prof, "card": card}
    log(f"train {kind}: " + json.dumps(row))
    check(all(np.isfinite(losses)) and np.isfinite(row["grad_norm_step1"]),
          f"train {kind}: a loss or the step-1 gradient is not finite")
    return row


def noise_led_grads(model, batch) -> dict:
    """Per parameter, where the step-1 gradient of ``model`` on ``batch`` is
    rounding noise: nonzero but below ``NOISE_LED`` of the global norm.  Adam
    turns such noise of either sign into an update of up to lr."""
    from dewi_tpu_torch.training.loops import _masked_ce

    ids, mask = batch
    model.zero_grad()
    _masked_ce(model(ids, mask), ids, mask).backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad()
    gnorm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()])))
    return {n: (g != 0) & (g.abs() < NOISE_LED * gnorm) for n, g in grads.items()}


def train_parity(texts: list, card: str) -> None:
    """11b: three steps of ``train_lm`` at the tiny f32 LM on the card and on
    the CPU, from one init: losses within ``PARITY_RTOL`` relative, every
    parameter within ``PARITY_RTOL`` of the largest magnitude, except where
    the step-1 gradient is rounding noise (held to ``2 * lr * steps``)."""
    from dewi_tpu_torch.models import registry
    from dewi_tpu_torch.signals.tokenizer import get_tokenizer
    from dewi_tpu_torch.training import lm_batches, train_lm

    cfg = registry.lm_config("tiny", dtype="float32")
    lr = 3e-4
    cpu = registry.init_lm(cfg, seed=TRAIN_SEED, device="cpu")
    gpu = registry.init_lm(cfg, seed=TRAIN_SEED, device="cuda")
    first = next(lm_batches(texts, get_tokenizer("byte"), 128, 32, 1, TRAIN_SEED))
    led = noise_led_grads(registry.init_lm(cfg, seed=TRAIN_SEED, device="cpu"), first)
    a = train_lm(cpu, texts, steps=PARITY_STEPS, lr=lr, log_every=1, seed=TRAIN_SEED)
    b = train_lm(gpu, texts, steps=PARITY_STEPS, lr=lr, log_every=1, seed=TRAIN_SEED)
    loss_rel = max(abs(x - y) / abs(x) for x, y in zip(a.losses, b.losses))
    want = dict(cpu.named_parameters())
    pmax = max(float(p.detach().abs().max()) for p in want.values())
    worst = worst_led = 0.0
    for name, p in gpu.named_parameters():
        d = (p.detach().cpu() - want[name].detach()).abs()
        m = led[name]
        if (~m).any():
            worst = max(worst, float(d[~m].max()) / pmax)
        if m.any():
            worst_led = max(worst_led, float(d[m].max()))
    n_led = int(sum(int(m.sum()) for m in led.values()))
    log("train parity: " + json.dumps({
        "config": "tiny f32", "steps": PARITY_STEPS, "losses_cpu": a.losses,
        "losses_card": b.losses, "loss_max_rel": loss_rel, "param_max_rel": worst,
        "noise_led_elements": n_led, "noise_led_max_abs": worst_led,
        "noise_led_bound": 2 * lr * PARITY_STEPS, "card": card}))
    check(loss_rel <= PARITY_RTOL and worst <= PARITY_RTOL
          and worst_led <= 2 * lr * PARITY_STEPS, "train: card and CPU disagree")


def phase_training(card: str) -> None:
    """Phase 11: the training loops on the card at the reference's default
    widths and settings; launches none of the search kernels."""
    from dewi_tpu_torch.models import registry
    from dewi_tpu_torch.models.moe import load_balance_loss
    from dewi_tpu_torch.ops import cuda_search as cs
    from dewi_tpu_torch.signals import TextEntropyEstimator
    from dewi_tpu_torch.signals.tokenizer import get_tokenizer
    from dewi_tpu_torch.training import lm_batches, train_clip, train_lm, train_mae, train_moe_lm
    from dewi_tpu_torch.training.loops import _masked_ce
    from torch_process_corpus import synthetic_images

    cs.reset_launch_counts()
    texts = synthetic_texts(N_TRAIN_TEXTS, TRAIN_SEED + 30)
    tok = get_tokenizer("byte")
    _, mask = tok.encode_batch(texts, 128, pad_to=128)
    real = float(mask.mean())

    # 11a: train_lm at the gpt2 width, the reference's defaults.
    t = time.perf_counter()
    lm = registry.init_lm(registry.lm_config("gpt2"), seed=TRAIN_SEED)
    init_s = time.perf_counter() - t
    n_params = registry.param_count(lm)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        ckpt = str(Path(tmp) / "lm.msgpack")
        with StepClock() as clock:
            state = train_lm(lm, texts, steps=TRAIN_STEPS, log_every=TRAIN_STEPS,
                             seed=TRAIN_SEED, checkpoint=ckpt)
        tokens = 32 * 128
        row = train_line("lm", clock, TRAIN_TIMED_FROM, tokens, "tokens", state.losses, card,
                         lambda n: train_lm(lm, texts, steps=n, log_every=n), model="gpt2",
                         params=n_params, batch=32, seq_len=128, real_token_share=real,
                         init_s=init_s)
        mfu = 6 * n_params * tokens / (row["ms_per_step"] / 1e3) / BF16_OPS_PER_S
        log("train lm model-flop share: " + json.dumps({
            "flop_per_step": 6 * n_params * tokens, "share_of_bf16_peak": mfu,
            "bound_ms": 6 * n_params * tokens / BF16_OPS_PER_S * 1e3, "card": card}))
        check(state.losses[-1] < state.losses[0], "train lm: the loss did not fall")
        del lm, state
        kw = dict(model_name="gpt2", max_length=1024, batch_size=8, seed=TRAIN_SEED)
        sentence = texts[1][:200]
        trained = TextEntropyEstimator(checkpoint=ckpt, **kw).compute_entropy(sentence)
        fresh = TextEntropyEstimator(**kw).compute_entropy(sentence)
    log("train lm estimator: " + json.dumps({
        "sentence_bytes": len(sentence.encode()), "trained_mean_entropy": trained.mean_entropy,
        "fresh_mean_entropy": fresh.mean_entropy, "card": card}))
    check(trained.mean_entropy < fresh.mean_entropy,
          "train lm: the trained checkpoint does not lower the entropy")
    torch.cuda.empty_cache()

    # 11b: the card against the CPU.
    train_parity(texts, card)

    # 11c: train_moe_lm at the gpt2 width, 4 experts.
    cfg = registry.lm_config("gpt2")
    moe = registry.init_moe_lm(cfg, n_experts=4, capacity_factor=1.25, seed=TRAIN_SEED)
    ids, msk = next(lm_batches(texts, tok, 128, 32, 1, TRAIN_SEED, "cuda"))
    with torch.no_grad():
        ce1 = float(_masked_ce(moe(ids, msk), ids, msk))
        aux1 = float(load_balance_loss(moe))
    with StepClock() as clock:
        state = train_moe_lm(moe, texts, steps=MOE_STEPS, log_every=MOE_STEPS,
                             aux_weight=AUX_WEIGHT, seed=TRAIN_SEED)
    aux_last = float(load_balance_loss(moe).detach())  # kept from the last step's forward
    train_line("moe_lm", clock, SIDE_TIMED_FROM, tokens, "tokens", state.losses, card,
               lambda n: train_moe_lm(moe, texts, steps=n, log_every=n), model="gpt2",
               n_experts=4, capacity_factor=1.25, params=registry.param_count(moe),
               ce_first=ce1, aux_first=aux1, ce_last=state.losses[-1] - AUX_WEIGHT * aux_last, aux_last=aux_last)
    check(abs(ce1 + AUX_WEIGHT * aux1 - state.losses[0]) <= 1e-3 * state.losses[0],
          "train moe_lm: step 1's loss is not CE + aux")
    check(state.losses[-1] < state.losses[0], "train moe_lm: the loss did not fall")
    del moe, state
    torch.cuda.empty_cache()

    # 11d: train_mae and train_clip at their base presets.
    images = synthetic_images(N_TRAIN_IMAGES, TRAIN_SEED + 31).astype(np.float32) / 255.0
    mae = registry.init_mae(registry.mae_config("base"), seed=TRAIN_SEED)
    with StepClock() as clock:
        state = train_mae(mae, images, steps=SIDE_STEPS, batch_size=16, log_every=SIDE_STEPS,
                          seed=TRAIN_SEED)
    train_line("mae", clock, SIDE_TIMED_FROM, 16, "images", state.losses, card,
               lambda n: train_mae(mae, images, steps=n, batch_size=16, log_every=n),
               model="base", batch=16, params=registry.param_count(mae))
    del mae, state
    clip = registry.init_clip(registry.clip_config("base"), seed=TRAIN_SEED)
    with StepClock() as clock:
        state = train_clip(clip, texts[:N_TRAIN_IMAGES], images, steps=SIDE_STEPS,
                           batch_size=32, log_every=SIDE_STEPS, seed=TRAIN_SEED)
    train_line("clip", clock, SIDE_TIMED_FROM, 32, "pairs", state.losses, card,
               lambda n: train_clip(clip, texts[:N_TRAIN_IMAGES], images, steps=n,
                                    batch_size=32, log_every=n),
               model="base", batch=32, params=registry.param_count(clip))
    del clip, state
    torch.cuda.empty_cache()
    launched = sum(cs.launch_counts.values())
    log(f"train: search-kernel launches {launched} (the training path runs none)")


# ---- phase 12: the data axis over ranks ---------------------------------------

# One card: NCCL refuses two ranks on one GPU, so the multi-rank legs run
# ranks that share the card over gloo (12b, 12c), and 12a is a world of one
# over NCCL.  Neither measures scaling: four ranks on one card measure what
# the collectives and the shared card cost.
N_RANKS = 4
MESH_TIERS = (  # tier -> DewiIndex backend and options, sharded searcher options
    ("exact_f32", "exact", {}, {}),
    ("int8", "int8", {}, {}),
    ("int8_s8", "int8", {"int8_queries": True}, {"int8_queries": True}),
    ("int4", "int4", {}, {"int4_storage": True}),
    ("ivf", "ivf", {"nlist": 1024, "nprobe": 32, "dewi_tier": 1024, "kmeans_iters": 8}, {}),
)
N_MESH_Q1 = 50              # Q=1 searches timed per tier on the ranks
N_GATHER_REPS = 50          # all-gathers timed per shape
MESH_TIMEOUT_S = 600.0      # one launch of the ranks, and each collective
MESH_SCORE_TOL = 1e-6       # 12a: the sharded answer against the single-device index
N_DP_DOCS, N_DP_IMAGES, N_DP_DUPS = 4_096, 2_048, 32   # 12c: process_corpus
N_DP_WARM = 256             # 12c: docs of the warm-up run that builds the estimators


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def same_topk(got, want, tol: float) -> float:
    """Scores within ``tol`` (absolute), ids equal wherever the wanted scores
    stand more than twice that apart (equal scores may come in any order)."""
    s, i = (torch.as_tensor(a).cpu() for a in got)
    ws, wi = (torch.as_tensor(a).cpu() for a in want)
    check(s.shape == ws.shape and i.shape == wi.shape, f"shapes {s.shape} != {ws.shape}")
    err = float((s.float() - ws.float()).abs().max())
    check(err <= tol, f"scores differ by {err}")
    gap = ws[:, :-1] - ws[:, 1:]
    clear = torch.ones_like(ws, dtype=torch.bool)
    clear[:, 1:] &= gap > 2 * tol
    clear[:, :-1] &= gap > 2 * tol
    check(torch.equal(i.long()[clear], wi.long()[clear]), "ids differ where the scores are apart")
    return err


def sharded_searcher(tier: str, target, mesh, opts: dict):
    """The tier's sharded searcher over ``target``: a ``DocStore``, or for
    IVF an ``IVFIndex`` (built on the first rank)."""
    from dewi_tpu_torch.parallel import (ShardedExactSearcher, ShardedIVFSearcher,
                                         ShardedQuantizedSearcher)

    if tier == "exact_f32":
        return ShardedExactSearcher(target, mesh, k=K)
    if tier == "ivf":
        return ShardedIVFSearcher(target, mesh, k=K)
    return ShardedQuantizedSearcher(target, mesh, k=K, **opts)


def mesh_bench_data(n: int, nq: int, device: str) -> tuple:
    """The bench corpus (phase 4's seeded tensors) on the host: rows,
    payloads with the scorer's DEWI column, queries, doc ids."""
    from dewi_tpu_torch import DewiScorer

    emb, sig, queries = corpus(n, nq, device)
    dewi = DewiScorer(device=device).fit_and_score(sig)
    pay = torch.cat([dewi[:, None], sig], dim=1).cpu().numpy()
    return (emb.cpu().numpy(), pay, queries.cpu().numpy(), [str(i) for i in range(n)])


def mesh_world_of_one(data: tuple, rendezvous: str, device: str, card: str) -> tuple:
    """12a: a world of one over NCCL (gloo off the card).  Each tier's
    sharded searcher over one shard equals the single-device ``DewiIndex``
    on all queries; returns (the exact tier's answer, launches)."""
    import datetime

    import torch.distributed as dist

    from dewi_tpu_torch import DewiIndex
    from dewi_tpu_torch.index.store import DocStore
    from dewi_tpu_torch.ops import cuda_search as cs
    from dewi_tpu_torch.parallel import make_mesh

    emb, pay, queries, doc_ids = data
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{rendezvous}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    launches: collections.Counter = collections.Counter()
    rows, exact = {}, None
    try:
        mesh = make_mesh(device=None if backend == "nccl" else device)
        check(mesh.shape == {"data": 1, "model": 1} and mesh.group() is not None,
              "12a: the mesh of a world of one")
        for tier, backend_name, kw, opts in MESH_TIERS:
            t = time.perf_counter()
            index = DewiIndex(dim=DIM, backend=backend_name, rerank_eta=ETA, entropy_pref=EP,
                              device=mesh.device, **kw)
            index.add_batch(doc_ids, emb, pay)
            index.build()
            want = index.search_batch(queries, k=K)
            if tier == "ivf":
                target = index._backend
            else:
                target = DocStore(DIM, device=mesh.device)
                target.add_batch(doc_ids, emb, pay)
            searcher = sharded_searcher(tier, target, mesh, opts)
            cs.reset_launch_counts()
            got = searcher.search_batch(queries, eta=ETA, entropy_pref=EP)
            _sync(mesh.device)
            counts = {k: v for k, v in cs.launch_counts.items() if v}
            launches.update(counts)
            err = same_topk(got, want, MESH_SCORE_TOL)
            rows[tier] = {"max_abs_err": err, "launches": counts,
                          "seconds": time.perf_counter() - t}
            if tier == "exact_f32":
                exact = (want[0].cpu(), want[1].cpu())
            del index, target, searcher, got, want
            if mesh.device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    log("mesh 12a world of one: " + json.dumps({"backend": backend, "queries": len(queries),
                                                "equal_to_single_device": rows, "card": card}))
    check(all(rows[t]["launches"] for t in ("int8", "int8_s8", "int4")) or backend == "gloo",
          "12a: a quantized tier launched no kernel")
    return exact, launches


def _time_q1(fn, queries, n: int, device) -> float:
    lat = []
    for i in range(min(n, len(queries))):
        t = time.perf_counter()
        fn(queries[i:i + 1])
        _sync(device)
        lat.append((time.perf_counter() - t) * 1e3)
    return statistics.median(lat)


def _gather_ms(mesh, nq: int, reps: int, device=None) -> float:
    """Median ms of the merge's two all-gathers ([nq, k] scores and ids) of
    tensors on ``device`` (the mesh's: as a sharded search runs them; the
    host's: the collective alone, without the copies to and from the card)."""
    device = device or mesh.device
    v = torch.zeros((nq, K), device=device)
    i = torch.zeros((nq, K), dtype=torch.long, device=device)
    out = []
    for _ in range(reps):
        _sync(mesh.device)
        t = time.perf_counter()
        mesh.all_gather(v, dim=1)
        mesh.all_gather(i, dim=1)
        _sync(mesh.device)
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def mesh_search_rank(paths: dict, n_q1: int, device) -> dict:
    """12b, one rank: its shard of the bench corpus in every sharded tier;
    Q=1 and Q=1000 times, the all-gathers' times, rank 0's answers and the
    launches of every rank."""
    import torch.distributed as dist

    from dewi_tpu_torch import IVFIndex
    from dewi_tpu_torch.index.store import DocStore
    from dewi_tpu_torch.ops import cuda_search as cs
    from dewi_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device=device)
    emb = np.load(paths["emb"], mmap_mode="r")
    pay = np.load(paths["pay"])
    queries = torch.from_numpy(np.load(paths["queries"])).to(mesh.device)
    doc_ids = [str(i) for i in range(len(emb))]
    t = time.perf_counter()
    store = DocStore(DIM, device=mesh.device)
    store.add_batch(doc_ids, emb, pay)
    rows = {"store_s": time.perf_counter() - t}
    cs.reset_launch_counts()
    for tier, _, kw, opts in MESH_TIERS:
        t = time.perf_counter()
        if tier == "ivf":
            target = IVFIndex(dim=DIM, device=mesh.device, **kw)
            if mesh.data_index == 0:  # the first rank builds; the shards are scattered
                target.add_batch(doc_ids, emb, pay)
        else:
            target = store
        searcher = sharded_searcher(tier, target, mesh, opts)
        _sync(mesh.device)
        setup_s = time.perf_counter() - t

        def run(q):
            return searcher.search_batch(q, eta=ETA, entropy_pref=EP)

        run(queries[:1])
        q1 = _time_q1(run, queries, n_q1, mesh.device)
        run(queries)
        _sync(mesh.device)
        t = time.perf_counter()
        s, ids = run(queries)
        _sync(mesh.device)
        batched = (time.perf_counter() - t) * 1e3 / len(queries)
        g1 = _gather_ms(mesh, 1, N_GATHER_REPS)
        gb = _gather_ms(mesh, len(queries), 5)
        rows[tier] = {"setup_s": setup_s, "q1_p50_ms": q1, "batched_ms_per_query": batched,
                      "gather_q1_ms": g1, "gather_q1000_ms": gb,
                      "gather_q1_host_tensors_ms": _gather_ms(mesh, 1, N_GATHER_REPS, "cpu"),
                      "gather_share_q1": g1 / q1,
                      "gather_share_q1000": gb / (batched * len(queries)),
                      "answer": (s.cpu().numpy(), ids.cpu().numpy())}
        del searcher, target
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, dict(cs.launch_counts))
    return {"rows": rows, "launches": {k: sum(c[k] for c in counts) for k in counts[0]},
            "device": str(mesh.device), "backend": dist.get_backend(),
            "shard_rows": store.device_arrays()[0].shape[0]}


def mesh_sharded_search(data: tuple, exact: tuple, tmp: Path, device, card: str) -> dict:
    """12b: four ranks share the card over gloo; answers held to the
    single-device exact index; returns the launches of every rank."""
    from dewi_tpu_torch.parallel import launch_local

    emb, pay, queries, _ = data
    paths = {k: str(tmp / f"{k}.npy") for k in ("emb", "pay", "queries")}
    for k, a in (("emb", emb), ("pay", pay), ("queries", queries)):
        np.save(paths[k], a)
    t = time.perf_counter()
    out = launch_local(mesh_search_rank, N_RANKS, (paths, N_MESH_Q1, device), backend="gloo",
                       timeout=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t
    rows = out.pop("rows")
    summary = {}
    for tier, *_ in MESH_TIERS:
        row = rows[tier]
        s, ids = row.pop("answer")
        rec = recall(torch.from_numpy(ids).long(), exact[1].long())
        if tier == "exact_f32":
            row["max_abs_err_vs_single_device"] = same_topk((s, ids), exact, 1e-5)
        row["recall_at_10"] = rec
        floor = IVF_RANDOM_RECALL_FLOOR if tier == "ivf" else 0.99
        check(rec >= floor, f"12b {tier}: recall@10 {rec} < {floor}")
        summary[tier] = row
    log("mesh 12b sharded search, 4 ranks on one card (gloo): " + json.dumps({
        "ranks": N_RANKS, "shard_rows": out["shard_rows"], "launch_s": wall,
        "store_s": rows["store_s"], "tiers": summary, "launches": out["launches"],
        "device": out["device"], "backend": out["backend"], "card": card}))
    for name in ("bmax", "bmax_s8", "bmax_s4"):
        check(out["launches"][name] > 0 or torch.device(device or "cuda").type == "cpu",
              f"12b: the ranks launched no {name}")
    return out["launches"]


def mesh_scan_input(n: int, dim: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(3)
    emb = torch.randn(n, dim, device=device, generator=g)
    return emb / emb.norm(dim=1, keepdim=True)


def mesh_signals_rank(cfg_dict: dict, sizes: tuple, scan: tuple, device) -> dict:
    """12c, one rank: ``DewiPipeline(mesh=)`` over the corpus, then the
    sharded max off-diagonal scan; rank 0's results."""
    import torch.distributed as dist
    import torch_process_corpus as tpc

    from dewi_tpu_torch import DewiConfig, DewiPipeline
    from dewi_tpu_torch.parallel import make_mesh
    from dewi_tpu_torch.signals.redundancy import max_offdiag_similarity_sharded

    mesh = make_mesh(device=device)
    dev = str(mesh.device.type)
    n, n_img, dups, size = sizes
    t = time.perf_counter()
    pipe = DewiPipeline(DewiConfig.from_dict(cfg_dict), mesh=mesh)
    warm, _, _ = tpc.make_corpus(N_DP_WARM, N_DP_WARM // 2, 4, SIGNAL_SEED + 11, size, dev)
    pipe.process_corpus(warm)  # builds and replicates the estimators
    warm_s = time.perf_counter() - t
    corpus, planted, _ = tpc.make_corpus(n, n_img, dups, SIGNAL_SEED + 20, size, dev)
    mesh.barrier()
    _sync(mesh.device)
    t = time.perf_counter()
    pipe.process_corpus(corpus)
    _sync(mesh.device)
    seconds = time.perf_counter() - t
    emb = mesh_scan_input(*scan, mesh.device)
    mesh.barrier()
    _sync(mesh.device)
    t = time.perf_counter()
    red = max_offdiag_similarity_sharded(emb, mesh)
    scan_s = time.perf_counter() - t
    return {"signals": corpus.signals, "dewi": corpus.dewi, "seconds": seconds,
            "warm_up_s": warm_s, "scan": red, "scan_s": scan_s,
            "peak_mem_gb": (torch.cuda.max_memory_allocated(mesh.device) / 1e9
                            if mesh.device.type == "cuda" else 0.0),
            "backend": dist.get_backend(), "planted": planted}


def mesh_signals(cfg_dict: dict, sizes: tuple, scan: tuple, device, card: str) -> None:
    """12c: the data-parallel pipeline and scan on four ranks against one
    process on the same card and inputs."""
    import torch_process_corpus as tpc
    from torch_profile_e2e import col_dev

    from dewi_tpu_torch import DewiConfig, DewiPipeline
    from dewi_tpu_torch.signals.redundancy import max_offdiag_similarity
    from dewi_tpu_torch.types import SIGNAL_FIELDS

    dev = device or "cuda"
    n, n_img, dups, size = sizes
    pipe = DewiPipeline(DewiConfig.from_dict(cfg_dict), device=dev)
    warm, _, _ = tpc.make_corpus(N_DP_WARM, N_DP_WARM // 2, 4, SIGNAL_SEED + 11, size, dev)
    pipe.process_corpus(warm)
    corpus, planted, _ = tpc.make_corpus(n, n_img, dups, SIGNAL_SEED + 20, size, dev)
    _sync(dev)
    t = time.perf_counter()
    pipe.process_corpus(corpus)
    _sync(dev)
    one_s = time.perf_counter() - t
    emb = mesh_scan_input(*scan, dev)
    max_offdiag_similarity(emb[:1024])  # warm-up
    _sync(dev)
    t = time.perf_counter()
    want_scan = max_offdiag_similarity(emb)
    one_scan_s = time.perf_counter() - t
    del pipe, emb
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    from dewi_tpu_torch.parallel import launch_local

    t = time.perf_counter()
    out = launch_local(mesh_signals_rank, N_RANKS, (cfg_dict, sizes, scan, device),
                       backend="gloo", timeout=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t
    devs = {k: col_dev(out["signals"][:, j], corpus.signals[:, j])
            for j, k in enumerate(SIGNAL_FIELDS)}
    # DEWI is the scorer over the gathered signals: held exactly to the same
    # fit on the mesh's signals.  Against one process it moves by what each
    # column's deviation is worth in robust z units (deviation / (1.4826 *
    # MAD) of the one-process fit), logged beside it.
    scorer = DewiPipeline(DewiConfig.from_dict(cfg_dict), device=dev)._make_scorer()
    scorer.fit_and_score(corpus.signals)
    mads = dict(scorer.stats.mads)
    want_dewi = scorer.fit_and_score(out["signals"]).cpu().numpy()
    z_moves = {k: float(np.abs(out["signals"][:, j] - corpus.signals[:, j]).max()
                        / (1.4826 * mads[k])) for j, k in enumerate(SIGNAL_FIELDS)}
    dewi_dev = float(np.abs(out["dewi"] - corpus.dewi).max())
    rescored = col_dev(out["dewi"], want_dewi)
    scan_err = float(np.abs(out["scan"] - want_scan).max())
    red = out["signals"][:, SIGNAL_FIELDS.index("redundancy")]
    log("mesh 12c data-parallel signals, 4 ranks on one card (gloo): " + json.dumps({
        "docs": n, "images": n_img, "launch_s": wall, "warm_up_s": out["warm_up_s"],
        "seconds": out["seconds"], "docs_per_s": n / out["seconds"],
        "one_process_seconds": one_s, "one_process_docs_per_s": n / one_s,
        "max_dev_vs_one_process": devs, "rtol": PIPE_RTOL,
        "dewi_vs_scorer_on_mesh_signals": rescored,
        "dewi_max_abs_diff_vs_one_process": dewi_dev,
        "docs_dewi_off_by_1e-2": int((np.abs(out["dewi"] - corpus.dewi) > 1e-2).sum()),
        "column_deviation_in_z_units": z_moves, "one_process_mads": mads,
        "planted_min_redundancy": float(red[planted].min()),
        "scan": {"n": scan[0], "dim": scan[1], "seconds": out["scan_s"],
                 "one_process_seconds": one_scan_s, "max_abs_diff": scan_err},
        "peak_mem_gb_rank0": out["peak_mem_gb"], "backend": out["backend"], "card": card}))
    check(bool(np.isfinite(out["signals"]).all() and np.isfinite(out["dewi"]).all()),
          "12c: a signal or dewi is not finite")
    worst = max(devs.values())
    check(worst <= PIPE_RTOL, f"12c: the mesh pipeline's signals are off one process by {worst}")
    check(rescored <= 1e-6, f"12c: DEWI is off the scorer on the gathered signals by {rescored}")
    check(scan_err <= 1e-6, f"12c: the sharded scan is off the single-device scan by {scan_err}")
    check(float(red[planted].min()) >= 0.99, "12c: a planted duplicate was missed")


def phase_mesh(card: str, n_docs: int = N_DOCS, n_queries: int = N_QUERIES, device=None,
               cfg_dict: Optional[dict] = None,
               sizes: tuple = (N_DP_DOCS, N_DP_IMAGES, N_DP_DUPS, 224),
               scan: tuple = (N_SCAN, 512)) -> dict:
    """Phase 12: the data axis (``dewi_tpu_torch.parallel``) on one card.
    Returns the stage-1 kernels' launches of 12a and of every rank of 12b.
    ``device``, ``cfg_dict`` and the sizes let a CPU rehearsal shrink it."""
    dev = device or "cuda"
    t0 = time.perf_counter()
    data = mesh_bench_data(n_docs, n_queries, dev)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        exact, launches = mesh_world_of_one(data, f"{tmp}/rendezvous_12a", dev, card)
        launches.update(mesh_sharded_search(data, exact, Path(tmp), device, card))
    del data
    mesh_signals(cfg_dict or {}, sizes, scan, device, card)
    log(f"mesh phase: {time.perf_counter() - t0:.3f} s")
    return dict(launches)


# ---- phase 13: the model axis over ranks -----------------------------------------

# One card again: 13a is a world of one over NCCL in this process; 13b runs
# four gloo ranks sharing the card (NCCL refuses two ranks on one GPU).  They
# measure correctness and what the collectives cost, not scaling.
MA_SEED = 0
MA_SIZES = dict(
    name="gpt2",            # lm_config preset: d 768, 12 heads, 12 layers, d_ff 3072, bytes
    layers=None,            # keep the preset's depth
    one=(2, 256),           # 13a: batch x tokens
    ring_t=4096,            # 13b ring: one document of T tokens, max_len T
    est=(8, 1500, 4000, 56, 1024),   # long docs, their byte range, short docs, chip_len
    tp=(8, 512),            # TP forward and train_lm step: batch x seq_len
    sp_t=1024,              # sequence-parallel NLL: [2, T]
    moe=(8, 128, 4),        # MoE: batch x tokens, experts (one per rank)
    pp=(32, 128, 8, 5),     # PP: batch x tokens, microbatches, train steps
)
# 13a: max |delta| against the plain module (f32), of the largest |logit|.
# Equal operations would give 0, but cuBLAS rounds f32 GEMMs of other shapes
# (a microbatch's rows, a row-parallel product without its fused bias)
# differently, and the ring's online softmax sums in another order: on an
# H100 these moved gpt2's logits (max 3.41) by 4.8e-7 to 6.3e-6.
MA_ONE_RTOL = 1e-5
MA_RING_RTOL = 1e-4         # 13b: f32 ring logits, of the largest |logit|
MA_BF16_NLL_RTOL = 5e-3     # bf16 mean NLL, relative
MA_EST_TOL = 2e-2           # per-document mean and q90 (the reference's ring bound)
MA_PARAM_RTOL = 1e-5        # a train step's parameters, of the largest magnitude
MA_SP_TOL = 2e-4            # f32 NLL, rtol and atol (the reference's logits bound)
MA_MOE_RTOL = 1e-5
MA_PP_RTOL = 1e-4           # f32 pipelined logits, of the largest |logit|
MA_LR = 3e-4
MA_REPS = 3                 # timed repetitions after a warm-up


def _ma_cfg(sizes: dict, **over):
    import dataclasses

    from dewi_tpu_torch.models.registry import lm_config

    cfg = lm_config(sizes["name"], **over)
    return dataclasses.replace(cfg, n_layers=sizes["layers"]) if sizes["layers"] else cfg


def _ma_ids(shape: tuple, seed: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g).to(device)


def _ma_ms(fn, device, reps: int = MA_REPS) -> float:
    """Median host-clock ms of ``fn()`` to a ``synchronize``, after a warm-up
    call.  Every rank of a collective ``fn`` calls it together."""
    fn()
    _sync(device)
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        _sync(device)
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def _ma_peak(device) -> float:
    return torch.cuda.max_memory_allocated(device) / 1e9 if torch.device(device).type == "cuda" else 0.0


def _ma_reset(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _ma_full(sharded, like) -> dict:
    """``sharded``'s parameters with the shards all-gathered (a collective)."""
    from dewi_tpu_torch.parallel.mesh import all_gather, shard_group

    shapes = {n: p.shape for n, p in like.named_parameters()}
    out = {}
    for n, p in sharded.named_parameters():
        t = p.detach()
        if shard_group(p) is not None:
            dim = next(i for i, (a, b) in enumerate(zip(t.shape, shapes[n])) if a != b)
            t = all_gather(t.contiguous(), shard_group(p), dim=dim)
        out[n] = t
    return out


def _ma_step_dev(got: dict, want: dict, grads: dict, lr: float) -> tuple:
    """(largest deviation where the step-1 gradient is real, over the largest
    parameter; largest where it is rounding noise, over lr): Adam turns
    noise of either sign into an update of up to lr (phase 11b's rule; an
    exact 0 on one side counts as noise)."""
    gnorm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()])))
    pmax = max(float(w.abs().max()) for w in want.values())
    real = led = 0.0
    for k, w in want.items():
        d = (got[k].double() - w.double()).abs()
        noise = grads[k].abs() < NOISE_LED * gnorm
        if (~noise).any():
            real = max(real, float(d[~noise].max()) / pmax)
        if noise.any():
            led = max(led, float(d[noise].max()) / lr)
    return real, led


def _ma_mean_nll(logits: torch.Tensor, ids: torch.Tensor, pad: torch.Tensor) -> float:
    from dewi_tpu_torch.models.lm import token_nll

    nll, valid = token_nll(logits, ids, pad)
    return float(nll[valid].mean())


def ma_world_of_one(sizes: dict, rendezvous: str, device: str, card: str) -> None:
    """13a: a world of one over NCCL (gloo off the card).  Each model-axis
    entry point equals the plain module on the same weights and inputs."""
    import datetime

    import torch.distributed as dist

    from dewi_tpu_torch.models import registry
    from dewi_tpu_torch.models.lm import token_nll
    from dewi_tpu_torch.models.moe import shard_expert_params
    from dewi_tpu_torch.parallel import make_mesh, sequence_sharded_nll
    from dewi_tpu_torch.parallel.pp import (pipelined_lm_logits, shard_stacked_params,
                                            stack_block_params)
    from dewi_tpu_torch.parallel.ring import ring_lm_logits
    from dewi_tpu_torch.parallel.tp import shard_params

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{rendezvous}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    rows = {}
    try:
        mesh = make_mesh(device=None if backend == "nccl" else device)
        check(mesh.group("model") is not None, "13a: the model axis of a world of one has a group")
        cfg = _ma_cfg(sizes, dtype="float32")
        model = registry.init_lm(cfg, seed=MA_SEED, device=mesh.device)
        ids = _ma_ids(sizes["one"], MA_SEED + 1, mesh.device)
        pad = torch.ones(ids.shape, device=mesh.device)
        pad[1, ids.shape[1] * 3 // 4:] = 0
        with torch.no_grad():
            plain = model(ids, pad)
            nll, valid = token_nll(plain, ids, pad)
            lmax = float(plain.abs().max())
            rows["ring_lm_logits"] = float((ring_lm_logits(model, ids, pad, mesh) - plain).abs().max())
            rows["shard_params"] = float((shard_params(model, mesh)(ids, pad) - plain).abs().max())
            got, _ = sequence_sharded_nll(model, ids, pad, mesh)
            rows["sequence_sharded_nll"] = float((got - nll)[valid].abs().max())
            pmesh = make_mesh(device=None if backend == "nccl" else device, axes=("data", "stage"))
            stacked, rest = stack_block_params(model, cfg.n_layers)
            blocks = shard_stacked_params(cfg, stacked, pmesh)
            got = pipelined_lm_logits(cfg, blocks, rest, ids, pad, pmesh, n_microbatches=2)
            rows["pipelined_lm_logits"] = float((got - plain).abs().max())
            del blocks, stacked, rest
            moe = registry.init_moe_lm(cfg, n_experts=sizes["moe"][2], seed=MA_SEED,
                                       device=mesh.device)
            rows["shard_expert_params"] = float(
                (shard_expert_params(moe, mesh)(ids, pad) - moe(ids, pad)).abs().max())
    finally:
        dist.destroy_process_group()
    log("model axis 13a world of one: " + json.dumps({
        "backend": backend, "batch": list(sizes["one"]), "max_abs_diff": rows,
        "max_abs_logit": lmax, "rtol": MA_ONE_RTOL, "card": card}))
    for name, err in rows.items():
        check(err <= MA_ONE_RTOL * lmax, f"13a: {name} is off the plain module by {err}")


def _ma_broadcast(model, group) -> None:
    """The first rank's weights on every rank (seeded weights, broadcast)."""
    from dewi_tpu_torch.parallel.mesh import broadcast

    with torch.no_grad():
        for t in model.state_dict().values():
            broadcast(t, group)


def _ma_coll_ms(fn, mesh) -> float:
    """Median ms of one collective on host tensors, timed alone."""
    mesh.barrier()
    return _ma_ms(fn, "cpu", reps=10)


def _ma_on_rank0(mesh, fn):
    """``fn()`` on the first rank while the others wait (the one-process runs)."""
    out = fn() if mesh.rank == 0 else None
    mesh.barrier()
    return out


def ma_leg_ring(sizes: dict, mesh, dev) -> dict:
    from dewi_tpu_torch.models import registry
    from dewi_tpu_torch.parallel.mesh import ring_shift
    from dewi_tpu_torch.parallel.ring import ring_lm_logits, ring_token_nll

    t = sizes["ring_t"]
    ids = _ma_ids((1, t), MA_SEED + 2, dev)
    pad = torch.ones((1, t), device=dev)
    rec = {"tokens": t}
    for dtype in ("float32", "bfloat16"):
        cfg = _ma_cfg(sizes, max_len=t, dtype=dtype)
        model = registry.init_lm(cfg, seed=MA_SEED, device=dev)
        _ma_broadcast(model, mesh.group("model"))
        _ma_reset(dev)
        if dtype == "float32":
            got = ring_lm_logits(model, ids, pad, mesh)
            rec["ms"] = _ma_ms(lambda: ring_lm_logits(model, ids, pad, mesh), dev)
            rec["peak_mem_gb_rank0"] = _ma_peak(dev)

            def plain():
                with torch.no_grad():
                    want = model(ids, pad)
                    ms = _ma_ms(lambda: model(ids, pad), dev)
                return float((got - want).abs().max() / want.abs().max()), ms

            rec["f32_rel_err"], rec["one_process_ms"] = _ma_on_rank0(mesh, plain) or (None, None)
            h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
            blk = torch.zeros((1, h, t // mesh.n_model, hd))
            rec["shift_host_ms"] = _ma_coll_ms(
                lambda: ring_shift((blk, blk, torch.ones(1, t // mesh.n_model)),
                                   mesh.group("model")).wait(), mesh)
            rec["shifts_per_forward"] = cfg.n_layers * (mesh.n_model - 1)
            rec["p2p_share"] = rec["shift_host_ms"] * rec["shifts_per_forward"] / rec["ms"]
        else:
            nll, valid = ring_token_nll(model, ids, pad, mesh)
            got16 = float(nll[valid].mean())
            rec["bf16_ms"] = _ma_ms(lambda: ring_token_nll(model, ids, pad, mesh), dev)

            def plain16():
                with torch.no_grad():
                    return _ma_mean_nll(model(ids, pad), ids, pad)

            want16 = _ma_on_rank0(mesh, plain16)
            rec["bf16_mean_nll"] = got16
            rec["bf16_mean_nll_rel_err"] = abs(got16 - want16) / abs(want16) if want16 else None
        del model
    return rec


def ma_leg_estimator(sizes: dict, mesh, dev) -> dict:
    from dewi_tpu_torch.signals import TextEntropyEstimator

    n_long, lo, hi, n_short, chip_len = sizes["est"]
    t = sizes["ring_t"]
    texts = (synthetic_texts(n_short, MA_SEED + 3, 1, chip_len - 8)
             + synthetic_texts(n_long, MA_SEED + 4, lo, hi))
    kw = dict(model_name=sizes["name"], max_length=t, batch_size=8, seed=MA_SEED)
    est = TextEntropyEstimator(chip_len=chip_len, ring_mesh=mesh, **kw)
    _ma_reset(dev)
    mesh.barrier()
    tt = time.perf_counter()
    got = est.batch_compute(texts)
    _sync(dev)
    seconds = time.perf_counter() - tt
    rec = {"docs": len(texts), "long_docs": n_long, "chip_len": chip_len, "max_length": t,
           "seconds": seconds, "docs_per_s": len(texts) / seconds,
           "peak_mem_gb_rank0": _ma_peak(dev),
           "long_doc_tokens": [len(r.token_entropies) + 1 for r in got[n_short:]]}
    del est

    def plain():
        one = TextEntropyEstimator(device=dev, **kw)
        tt = time.perf_counter()
        want = one.batch_compute(texts)
        _sync(dev)
        secs = time.perf_counter() - tt
        mean = max(abs(a.mean_entropy - b.mean_entropy) for a, b in zip(got, want))
        q90 = max(abs(a.q90_entropy - b.q90_entropy) for a, b in zip(got, want))
        return mean, q90, secs

    out = _ma_on_rank0(mesh, plain)
    if out is not None:
        rec["max_mean_diff"], rec["max_q90_diff"], s1 = out
        rec["one_process_seconds"], rec["one_process_docs_per_s"] = s1, len(texts) / s1
    return rec


def ma_leg_tp_sp(sizes: dict, mesh, dev, texts: list) -> dict:
    from dewi_tpu_torch.models import registry
    from dewi_tpu_torch.models.lm import token_nll
    from dewi_tpu_torch.parallel import sequence_sharded_nll
    from dewi_tpu_torch.parallel.mesh import all_gather, all_reduce
    from dewi_tpu_torch.parallel.tp import shard_params
    from dewi_tpu_torch.signals.tokenizer import get_tokenizer
    from dewi_tpu_torch.training import lm_batches, train_lm
    from dewi_tpu_torch.training.loops import _masked_ce

    b, t = sizes["tp"]
    rec = {"tp": {"batch": [b, t]}, "sp": {}}
    ids = _ma_ids((b, t), MA_SEED + 5, dev)
    pad = torch.ones((b, t), device=dev)
    m16 = registry.init_lm(_ma_cfg(sizes), seed=MA_SEED, device=dev)
    _ma_broadcast(m16, mesh.group("model"))
    tp16 = shard_params(m16, mesh)
    _ma_reset(dev)
    with torch.no_grad():
        got = _ma_mean_nll(tp16(ids, pad), ids, pad)
        r = rec["tp"]
        r["ms"] = _ma_ms(lambda: tp16(ids, pad), dev)
        r["peak_mem_gb_rank0"] = _ma_peak(dev)
        r["heads_per_rank"] = tp16.encoder.block_0.attn.n_heads

        def plain():
            return _ma_mean_nll(m16(ids, pad), ids, pad), _ma_ms(lambda: m16(ids, pad), dev)

        out = _ma_on_rank0(mesh, plain)
    r["bf16_mean_nll"] = got
    if out is not None:
        r["bf16_mean_nll_rel_err"] = abs(got - out[0]) / abs(out[0])
        r["one_process_ms"] = out[1]
    act = torch.zeros((b, t, m16.cfg.d_model), dtype=torch.bfloat16)
    r["all_reduce_host_ms"] = _ma_coll_ms(lambda: all_reduce(act, mesh.group("model")), mesh)
    r["all_reduces_per_forward"] = 2 * m16.cfg.n_layers
    r["all_reduce_share"] = r["all_reduce_host_ms"] * r["all_reduces_per_forward"] / r["ms"]
    del tp16, m16

    cfg32 = _ma_cfg(sizes, dtype="float32")
    m32 = registry.init_lm(cfg32, seed=MA_SEED, device=dev)
    _ma_broadcast(m32, mesh.group("model"))
    # SP alone and composed with TP, on a [2, sp_t] batch, against the plain NLL
    ts = sizes["sp_t"]
    sids = _ma_ids((2, ts), MA_SEED + 6, dev)
    spad = torch.ones((2, ts), device=dev)
    spad[1, ts * 3 // 4:] = 0
    tp32 = shard_params(m32, mesh)
    with torch.no_grad():
        for name, model in (("alone", m32), ("with_tp", tp32)):
            _ma_reset(dev)
            nll, valid = sequence_sharded_nll(model, sids, spad, mesh)
            rec["sp"][f"{name}_ms"] = _ma_ms(lambda: sequence_sharded_nll(model, sids, spad, mesh), dev)
            rec["sp"][f"{name}_peak_mem_gb_rank0"] = _ma_peak(dev)

            def plain():
                want, _ = token_nll(m32(sids, spad), sids, spad)
                err = float(((nll - want).abs() - MA_SP_TOL * want.abs())[valid].max())
                return err, _ma_ms(lambda: m32(sids, spad), dev)

            out = _ma_on_rank0(mesh, plain)
            if out is not None:
                rec["sp"][f"{name}_excess_over_tol"], rec["sp"]["one_process_ms"] = out
    kb = torch.zeros((2, cfg32.n_heads, ts // mesh.n_model, cfg32.d_model // cfg32.n_heads))
    rec["sp"]["all_gather_host_ms"] = _ma_coll_ms(lambda: all_gather(kb, mesh.group("model"), 2), mesh)
    rec["sp"]["all_gathers_per_forward"] = 2 * cfg32.n_layers
    rec["sp"]["all_gather_share"] = (rec["sp"]["all_gather_host_ms"]
                                     * rec["sp"]["all_gathers_per_forward"] / rec["sp"]["alone_ms"])

    # one train_lm step of the TP model against the unsharded step
    kw = dict(steps=1, batch_size=b, seq_len=t, lr=MA_LR, seed=MA_SEED)
    first = next(lm_batches(texts, get_tokenizer("byte"), t, b, 1, MA_SEED, dev))

    def grads():
        m32.zero_grad()
        _masked_ce(m32(*first), *first).backward()
        g = {n: p.grad.detach().clone() for n, p in m32.named_parameters()}
        m32.zero_grad()
        return g

    step_grads = _ma_on_rank0(mesh, grads)
    _ma_reset(dev)
    mesh.barrier()
    tt = time.perf_counter()
    train_lm(tp32, texts, **kw)
    _sync(dev)
    r["train_step_ms"] = (time.perf_counter() - tt) * 1e3
    r["train_peak_mem_gb_rank0"] = _ma_peak(dev)
    full = _ma_full(tp32, m32)

    def plain_step():
        tt = time.perf_counter()
        train_lm(m32, texts, **kw)
        _sync(dev)
        ms = (time.perf_counter() - tt) * 1e3
        want = {n: p.detach() for n, p in m32.named_parameters()}
        return _ma_step_dev(full, want, step_grads, MA_LR) + (ms,)

    out = _ma_on_rank0(mesh, plain_step)
    if out is not None:
        r["train_param_rel_err"], r["train_noise_led_err_over_lr"], r["one_process_train_step_ms"] = out
    r["note"] = "train_step_ms includes the optimizer build, as one train_lm(steps=1) call does"
    return rec


def ma_leg_moe(sizes: dict, mesh, dev) -> dict:
    from dewi_tpu_torch.models import registry
    from dewi_tpu_torch.models.moe import shard_expert_params
    from dewi_tpu_torch.parallel.mesh import all_reduce

    b, t, e = sizes["moe"]
    cfg = _ma_cfg(sizes, dtype="float32")
    moe = registry.init_moe_lm(cfg, n_experts=e, seed=MA_SEED, device=dev)
    _ma_broadcast(moe, mesh.group("model"))
    ep = shard_expert_params(moe, mesh)
    if mesh.rank:
        del moe
    ids = _ma_ids((b, t), MA_SEED + 7, dev)
    pad = torch.ones((b, t), device=dev)
    _ma_reset(dev)
    rec = {"batch": [b, t], "experts": e, "experts_per_rank": ep.block_0.moe.w_in.shape[0]}
    with torch.no_grad():
        got = ep(ids, pad)
        rec["ms"] = _ma_ms(lambda: ep(ids, pad), dev)
        rec["peak_mem_gb_rank0"] = _ma_peak(dev)

        def plain():
            want = moe(ids, pad)
            return rel_dev(got, want), _ma_ms(lambda: moe(ids, pad), dev)

        out = _ma_on_rank0(mesh, plain)
    if out is not None:
        rec["rel_err"], rec["one_process_ms"] = out
    x = torch.zeros((b * t, cfg.d_model))
    rec["all_reduce_host_ms"] = _ma_coll_ms(lambda: all_reduce(x, mesh.group("model")), mesh)
    rec["all_reduces_per_forward"] = cfg.n_layers
    rec["all_reduce_share"] = rec["all_reduce_host_ms"] * cfg.n_layers / rec["ms"]
    return rec


def ma_leg_pp(sizes: dict, dev) -> dict:
    from dewi_tpu_torch.models import registry
    from dewi_tpu_torch.models.lm import token_nll
    from dewi_tpu_torch.parallel import make_mesh
    from dewi_tpu_torch.parallel.mesh import irecv, isend
    from dewi_tpu_torch.parallel.pp import (pipelined_lm_logits, pp_train_step,
                                            shard_stacked_params, stack_block_params)

    b, t, m, steps = sizes["pp"]
    pmesh = make_mesh(1, N_RANKS, device=dev, axes=("data", "stage"))
    cfg = _ma_cfg(sizes, dtype="float32")
    model = registry.init_lm(cfg, seed=MA_SEED, device=dev)
    _ma_broadcast(model, pmesh.group("stage"))
    stacked, rest = stack_block_params(model, cfg.n_layers)
    blocks = shard_stacked_params(cfg, stacked, pmesh)
    rest = {k: v.clone() for k, v in rest.items()}
    del stacked
    ids = _ma_ids((b, t), MA_SEED + 8, dev)
    pad = torch.ones((b, t), device=dev)
    _ma_reset(dev)
    rec = {"batch": [b, t], "stages": N_RANKS, "layers_per_stage": len(blocks),
           "microbatches": m}
    got = pipelined_lm_logits(cfg, blocks, rest, ids, pad, pmesh, m)
    rec["forward_ms"] = _ma_ms(lambda: pipelined_lm_logits(cfg, blocks, rest, ids, pad, pmesh, m), dev)

    def plain():
        with torch.no_grad():
            want = model(ids, pad)
            ms = _ma_ms(lambda: model(ids, pad), dev)
        nll, valid = token_nll(want, ids, pad)
        w = valid.float()
        return float((got - want).abs().max() / want.abs().max()), ms, float((nll * w).sum() / w.sum())

    out = _ma_on_rank0(pmesh, plain)
    if out is not None:
        rec["logits_rel_err"], rec["one_process_forward_ms"], plain_loss = out
    train = {k: v.clone().requires_grad_() for k, v in rest.items()}
    opt = torch.optim.Adam(list(blocks.parameters()) + list(train.values()), lr=MA_LR)
    step = pp_train_step(cfg, opt, pmesh, n_microbatches=m)
    losses, ms = [], []
    _ma_reset(dev)
    for _ in range(steps):
        pmesh.barrier()
        tt = time.perf_counter()
        losses.append(float(step((blocks, train), ids, pad)))
        _sync(dev)
        ms.append((time.perf_counter() - tt) * 1e3)
    rec.update(losses=losses, step_ms=ms, train_peak_mem_gb_rank0=_ma_peak(dev))
    if out is not None:
        rec["first_loss_rel_err"] = abs(losses[0] - plain_loss) / plain_loss
    act = torch.zeros((b // m, t, cfg.d_model))
    s = pmesh.index("stage")

    def hop():  # one activation from each stage to the next
        p = isend(act, s + 1, pmesh.group("stage")) if s < N_RANKS - 1 else None
        if s > 0:
            irecv(act, s - 1, pmesh.group("stage")).wait()
        if p is not None:
            p.wait()

    rec["p2p_host_ms"] = _ma_coll_ms(hop, pmesh)
    rec["p2p_per_step"] = 2 * m   # each microbatch forward and back, per stage boundary
    rec["p2p_share"] = rec["p2p_host_ms"] * rec["p2p_per_step"] / statistics.median(ms[1:] or ms)
    return rec


def model_axis_rank(sizes: dict, device) -> dict:
    """13b, one rank: every leg on a 1 x 4 mesh (PP on a stage mesh of 4);
    rank 0's records."""
    import torch.distributed as dist

    from dewi_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, N_RANKS, device=device)
    dev = mesh.device
    texts = synthetic_texts(512, MA_SEED + 9, 1, 2 * sizes["tp"][1])
    out = {"backend": dist.get_backend(), "device": str(dev)}
    for name, fn in (("ring", lambda: ma_leg_ring(sizes, mesh, dev)),
                     ("estimator", lambda: ma_leg_estimator(sizes, mesh, dev)),
                     ("tp_sp", lambda: ma_leg_tp_sp(sizes, mesh, dev, texts)),
                     ("moe", lambda: ma_leg_moe(sizes, mesh, dev)),
                     ("pp", lambda: ma_leg_pp(sizes, dev))):
        t = time.perf_counter()
        out[name] = fn()
        out[name]["leg_s"] = time.perf_counter() - t
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def phase_model_axis(card: str, device=None, sizes: Optional[dict] = None) -> None:
    """Phase 13: the model axis (ring attention, TP, SP, EP, PP) on one card;
    13a in this process, 13b on four ranks.  ``device`` and ``sizes`` let a
    CPU rehearsal shrink it.  Only the equalities are asserted."""
    from dewi_tpu_torch.parallel import launch_local

    sizes = {**MA_SIZES, **(sizes or {})}
    dev = device or "cuda"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        ma_world_of_one(sizes, f"{tmp}/rendezvous_13a", dev, card)
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out = launch_local(model_axis_rank, N_RANKS, (sizes, device), backend="gloo",
                       timeout=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t
    common = {"ranks": N_RANKS, "backend": out["backend"], "device": out["device"], "card": card}
    for leg in ("ring", "estimator", "tp_sp", "moe", "pp"):
        log(f"model axis 13b {leg}, 4 ranks on one card (gloo): "
            + json.dumps({**out[leg], **common}))
    ring, est, tp, sp, moe, pp = (out["ring"], out["estimator"], out["tp_sp"]["tp"],
                                  out["tp_sp"]["sp"], out["moe"], out["pp"])
    check(ring["f32_rel_err"] <= MA_RING_RTOL, f"13b ring: f32 logits off by {ring['f32_rel_err']}")
    check(ring["bf16_mean_nll_rel_err"] <= MA_BF16_NLL_RTOL,
          f"13b ring: bf16 mean NLL off by {ring['bf16_mean_nll_rel_err']}")
    check(max(est["max_mean_diff"], est["max_q90_diff"]) <= MA_EST_TOL,
          f"13b estimator: mean/q90 off one process by {est['max_mean_diff']}/{est['max_q90_diff']}")
    check(min(est["long_doc_tokens"]) > est["chip_len"], "13b estimator: a long doc was not long")
    check(tp["bf16_mean_nll_rel_err"] <= MA_BF16_NLL_RTOL,
          f"13b TP: bf16 mean NLL off by {tp['bf16_mean_nll_rel_err']}")
    check(tp["train_param_rel_err"] <= MA_PARAM_RTOL and tp["train_noise_led_err_over_lr"] <= 2.0,
          f"13b TP: the train step is off the unsharded one by {tp['train_param_rel_err']}")
    for name in ("alone", "with_tp"):
        check(sp[f"{name}_excess_over_tol"] <= 0.0, f"13b SP {name}: NLL off the plain NLL")
    check(moe["rel_err"] <= MA_MOE_RTOL, f"13b MoE: off the replicated model by {moe['rel_err']}")
    check(pp["logits_rel_err"] <= MA_PP_RTOL, f"13b PP: logits off by {pp['logits_rel_err']}")
    check(pp["first_loss_rel_err"] <= MA_PARAM_RTOL,
          f"13b PP: the first loss is off the plain step's by {pp['first_loss_rel_err']}")
    check(pp["losses"][-1] < pp["losses"][0], f"13b PP: the loss did not fall: {pp['losses']}")
    log(f"model axis phase: {time.perf_counter() - t0:.3f} s (13b launch {wall:.3f} s)")


# ---- phase 14: the profilers ----------------------------------------------------

PROBE_MAX_SHARE = 1.05      # of 3.35 TB/s: above it the probe's method is at fault
# reduce_sum_f32 against copy_rw's GB/s in the same run: a read-only pass
# reads at least as fast per byte as a copy does on this card
PROBE_MIN_SHARE_OF_COPY = 0.80
PROBE_MB = 256
# Sizes with an n % 16 tail for the probe's sum (the 256 MB array has none).
# Kernel and plain version both sum the integers exactly and round once to
# f32, so they must be equal: a dropped partial or tail shows at any size.
PROBE_RAGGED = (15, 1_000_003, (PROBE_MB << 20) + 7)
PROFILE_RECALL = 0.99       # recall_vs_exact of torch_profile_index's quantized tier
BREAKDOWN_SCORE_TOL = 1e-5  # full_two_stage's scores against the index's, both f32
N_CURVE_DOCS = 262_144      # the recall curve here; the 1M curve is the script's own run
CURVE_NPROBES = (1, 8, 32)
N_PROFILE_SERVE_DOCS = 100_000
PROFILE_SERVE_SECONDS = 3.0


def run_profiler(name: str, argv: list, out_dir: Path) -> dict:
    """``scripts/<name>.py``'s ``main(argv)`` in this process; its JSON."""
    import importlib

    out = out_dir / f"{name}.json"
    t = time.perf_counter()
    rc = importlib.import_module(name).main(argv + ["--output", str(out)])
    check(rc == 0, f"profilers: {name} exited {rc}")
    log(f"profilers {name}: {time.perf_counter() - t:.3f} s")
    return json.loads(out.read_text())


def non_decreasing_recalls(values: list, what: str) -> None:
    """Recall in [0, 1], not falling as nprobe grows: a larger nprobe probes
    a superset of the buckets, so an exact top-k doc found stays found."""
    check(all(0.0 <= v <= 1.0 for v in values), f"{what}: recall out of [0, 1]: {values}")
    check(all(a <= b for a, b in zip(values, values[1:])), f"{what}: recall fell: {values}")


def profile_breakdown_answer(res: dict) -> None:
    """``full_two_stage``'s top 10 for the breakdown's first query against
    ``DewiIndex(backend="int8", int8_queries=True)`` on the same corpus:
    the scores within ``BREAKDOWN_SCORE_TOL`` (the same call on the same
    inputs) and the same ids wherever the scores differ."""
    import torch_profile_scan_breakdown as sb
    from dewi_tpu_torch import DewiIndex

    n, d = res["n_docs"], res["dim"]
    x = sb.make_inputs(n, d, torch.device("cuda"), res["m"])
    index = DewiIndex(dim=d, backend="int8", int8_queries=True, device=x["emb"].device)
    index._backend.store.attach_device([str(i) for i in range(n)], x["emb"], x["pay"])
    index.build()
    s, ids = index.search_batch(x["q0"], k=K, eta=sb.ETA, entropy_pref=sb.EP)
    s, ids = s[0].tolist(), ids[0].tolist()
    got = res["full_two_stage_top10"]
    for j, (a, b) in enumerate(zip(got["ids"], ids)):
        diff = abs(got["scores"][j] - s[j])
        check(diff <= BREAKDOWN_SCORE_TOL,
              f"profilers: full_two_stage score {j} is {got['scores'][j]}, the index's {s[j]}")
        check(a == b or diff <= 1e-6,
              f"profilers: full_two_stage rank {j} is {a}, the index's {b}")
    log("profilers breakdown: full_two_stage equals DewiIndex(int8, int8_queries) "
        f"(scores max |diff| {max(abs(a - b) for a, b in zip(got['scores'], s))}, "
        f"tolerance {BREAKDOWN_SCORE_TOL})")


def probe_kernel_record() -> dict:
    """The probe's reduction (``ops.cuda_probe``) equal to its plain version
    on the probe's 256 MB int8 array and at the ``PROBE_RAGGED`` sizes,
    timed on the 256 MB array beside its bound and
    ``x.sum(dtype=torch.float32)``."""
    from dewi_tpu_torch.ops import cuda_probe

    n_bytes = PROBE_MB << 20
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(-127, 128, (n_bytes // DIM, DIM), dtype=torch.int8, device="cuda",
                      generator=gen)
    err = 0.0
    for arr in [x] + [torch.randint(-127, 128, (n,), dtype=torch.int8, device="cuda",
                                    generator=gen) for n in PROBE_RAGGED]:
        got = float(cuda_probe.reduce_sum_f32(arr))
        want = float(cuda_probe.reduce_sum_f32_plain(arr))
        check(got == want, f"kernel probe_reduce_f32 at {arr.numel()} bytes: {got} "
                           f"against the plain {want}")
        err = max(err, abs(got - want))
    got = float(cuda_probe.reduce_sum_f32(x))
    bound_ms, bound_by = bound(n_bytes, n_bytes, F32_OPS_PER_S)  # one add a byte, CUDA cores
    rec = dict(max_abs_err=err, ms=time_device_ms(lambda: cuda_probe.reduce_sum_f32(x)),
               plain_ms=time_device_ms(lambda: cuda_probe.reduce_sum_f32_plain(x), reps=10),
               bound_ms=bound_ms, bound_by=bound_by,
               library_ms=time_device_ms(lambda: x.sum(dtype=torch.float32)),
               bytes=n_bytes, ragged_bytes=list(PROBE_RAGGED), tol=0.0, sum=got)
    log(f"kernel probe_reduce_f32 {PROBE_MB} MB int8: " + json.dumps(rec))
    return rec


def phase_profilers(card: str) -> tuple:
    """Phase 14: the ``scripts/torch_*`` profilers in this process (the
    serving one with its client processes), their JSON under
    ``chiprun_out/profilers/``; returns this phase's kernel launches and
    the probe reduction's record for the kernels line."""
    from dewi_tpu_torch.ops import cuda_search as cs

    t0 = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "profilers"
    probe_rec = probe_kernel_record()
    torch.cuda.empty_cache()
    cs.reset_launch_counts()

    bw = run_profiler("torch_probe_hbm_bw", ["--mb", str(PROBE_MB)], out_dir)
    for name, row in bw["results"].items():
        if isinstance(row, dict):
            log(f"profilers probe {name}: " + json.dumps({**row, "card": card}))
            check(row["share_of_nominal"] <= PROBE_MAX_SHARE,
                  f"profilers: probe {name} read {row['gbps']} GB/s, over "
                  f"{PROBE_MAX_SHARE} of 3.35 TB/s: the method is at fault")
    share = bw["results"]["reduce_sum_f32"]["gbps"] / bw["results"]["copy_rw"]["gbps"]
    log(f"profilers probe reduce_sum_f32 / copy_rw: {share}")
    check(share >= PROBE_MIN_SHARE_OF_COPY,
          f"profilers: reduce_sum_f32 read {share:.3f} of copy_rw's GB/s, under "
          f"{PROBE_MIN_SHARE_OF_COPY}: the row is no memory rate")
    check(cs.launch_counts["probe_reduce_f32"] > 0,
          "profilers: the probe's reduce_sum_f32 row launched no probe_reduce_f32")

    for backend in ("exact", "quantized"):
        m = run_profiler("torch_profile_index", [
            "--n-docs", str(N_DOCS), "--dim", str(DIM), "--n-queries", str(N_QUERIES),
            "--latency-samples", "200", "--backend", backend], out_dir / backend)
        log(f"profilers index {backend}: " + json.dumps({**m, "card": card}))
        if backend == "quantized":
            check(m["recall_vs_exact"] >= PROFILE_RECALL,
                  f"profilers: quantized recall_vs_exact {m['recall_vs_exact']}")

    res = run_profiler("torch_profile_scan_breakdown", [
        "--n-docs", str(1 << 20), "--dim", str(DIM), "--reps", "3"], out_dir)
    # Each row's device operations (torch.profiler), held complete against
    # the host's launches: this process is some minutes old, and at that
    # age the profiler drops the first device events of a session
    # (launched_kernels opens each session with kernels for it to drop).
    for name, row in res["results"].items():
        log(f"profilers breakdown {name}: " + json.dumps(
            {**{k: row.get(k) for k in ("p50_ms", "spread_ms", "chain", "host_ms", "gbps",
                                        "l2_resident", "route", "launches", "device_ms",
                                        "kernels_complete", "profile_lead_lost",
                                        "same_as")},
             "device_ops": sum(row["kernels"].values())}))
        check(row["kernels_complete"] is True,
              f"profilers: breakdown {name}'s profile lost device events")
    profile_breakdown_answer(res)
    torch.cuda.empty_cache()

    sv = run_profiler("torch_profile_serving", [
        "--n-docs", str(N_PROFILE_SERVE_DOCS), "--clients", "4,16,64",
        "--seconds", str(PROFILE_SERVE_SECONDS)], out_dir)
    for level in sv["levels"]:
        log("profilers serving: " + json.dumps({**level, "card": card}))
        check(level["requests"] > 0, f"profilers: serving level {level['clients']} answered none")
    log("profilers serving overload: " + json.dumps({**sv["overload"], "card": card}))
    check(sv["overload"]["requests"] > 0 and sv["overload"]["shed_429"] >= 1,
          "profilers: the overload level shed nothing or answered nothing")

    ivf = run_profiler("torch_profile_ivf_1m", [], out_dir)
    log("profilers ivf 1m: " + json.dumps({**ivf, "card": card}))
    non_decreasing_recalls([ivf[f"recall_at_k{K}_nprobe{p}"] for p in (8, 16, 32, 64)],
                           "profilers ivf 1m")
    torch.cuda.empty_cache()

    curve = run_profiler("torch_profile_ivf_recall_curve", [
        "--n-docs", str(N_CURVE_DOCS), "--nprobes", ",".join(map(str, CURVE_NPROBES))],
        out_dir)
    log("profilers ivf recall curve: " + json.dumps({**curve, "card": card}))
    keys = [f"nprobe{p}" for p in CURVE_NPROBES]
    shipped = curve["spill"]["spill0.5"]["recall_curves"]
    for label, curves in (("no spill", curve["recall_curves"]), ("spill 0.5", shipped)):
        for fam, row in curves.items():
            non_decreasing_recalls([row[k] for k in keys], f"profilers curve {label} {fam}")
    non_decreasing_recalls([curve["recall_boundary_dewi_tier1024"][k] for k in keys],
                           "profilers curve dewi_tier 1024")
    check(curve["shipped_gate_curve"] == "spill0.5"
          and curve["shipped_default_ok"] == all(
              row[f"nprobe{curve['shipped_default_nprobe']}"] >= 0.99
              for row in shipped.values()),
          "profilers: shipped_default_ok disagrees with its curve")
    torch.cuda.empty_cache()
    counts = dict(cs.launch_counts)
    log(f"profilers phase: {time.perf_counter() - t0:.3f} s, launches "
        + json.dumps({k: v for k, v in counts.items() if v}))
    return counts, probe_rec


# ---- phase 15: the integration flow and the signal profilers -------------------

N_E2E_DOCS = 2048           # torch_profile_e2e, text only, object and columnar
N_E2E_IMAGE_DOCS = 512      # ... with one 64-px image a doc, columnar only
SIGNALS_ARGS = ["--model", "base", "--n-docs", "1024", "--n-images", "128",
                "--n-pairs", "256", "--redundancy-n", "65536"]
SHARDED_ARGS = ["--model", "base", "--n-docs", "1024", "--pipeline-docs", "256"]
# The text query's capacity -> the stage-1 kernel its route must launch
ROUTE_KERNEL = {8192: "scores_matrix", 65536: "bmax"}


def phase_integration(card: str) -> dict:
    """Phase 15: the integration flow at the reference's test sizes and the
    signal profilers at the default widths, in this process; returns the
    text queries' kernel launches."""
    t0 = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "integration"
    fl = run_profiler("torch_integration_flow", [], out_dir)  # exits 1 on a failed assertion
    log("integration flow: " + json.dumps({k: v for k, v in fl.items()
                                           if k not in ("signals", "query_vector")}))
    check(not fl["failures"], f"integration: {fl['failures']}")
    check(fl["sharded"]["backend"] == "nccl", "integration: the sharded leg did not run on NCCL")
    launches: collections.Counter = collections.Counter()
    for leg in [fl["query"]] + fl["query_kernel_routes"]:
        launches.update(leg["launches"])
        check(leg["profile_complete"] is True,
              f"integration: the capacity {leg['capacity']} query's profile lost device events")
    for leg in fl["query_kernel_routes"]:
        name = ROUTE_KERNEL[leg["capacity"]]
        check(leg["launches"].get(name, 0) > 0,
              f"integration: the text query at capacity {leg['capacity']} launched no {name}")
    log("integration text-query launches by capacity: " + json.dumps(
        {leg["capacity"]: leg["launches"] for leg in [fl["query"]] + fl["query_kernel_routes"]}))
    torch.cuda.empty_cache()

    e2e = run_profiler("torch_profile_e2e", ["--n-docs", str(N_E2E_DOCS), "--model", "base"],
                       out_dir / "e2e_text")
    log("integration e2e text: " + json.dumps(e2e))
    check(e2e["max_rel_dev_object_vs_columnar"] <= PIPE_RTOL,
          f"integration: the object path is off the columnar one by "
          f"{e2e['max_rel_dev_object_vs_columnar']}")
    torch.cuda.empty_cache()
    e2i = run_profiler("torch_profile_e2e", [
        "--n-docs", str(N_E2E_IMAGE_DOCS), "--model", "base", "--images", "--image-size", "64",
        "--clip-image-size", "64", "--skip-object"], out_dir / "e2e_images")
    log("integration e2e images: " + json.dumps(e2i))
    for res in (e2e, e2i):
        check(res["columnar_docs_per_sec"] > 0 and all(
            v >= 0 for v in res["columnar_stage_s"].values()), "integration: e2e rates")
    torch.cuda.empty_cache()

    sig = run_profiler("torch_profile_signals", SIGNALS_ARGS, out_dir)
    log("integration signals: " + json.dumps(sig))
    for k, v in sig.items():
        if k.endswith("_per_sec") or k.startswith("full_signals"):
            check(isinstance(v, (int, float)) and np.isfinite(v) and v > 0,
                  f"integration: signals {k} is {v}")
    for stage in ("text", "image", "clip"):
        dev = sig[f"{stage}_device_vs_host_max_rel_dev"]
        check(dev <= PIPE_RTOL, f"integration: signals {stage} device row off the host by {dev}")
    torch.cuda.empty_cache()

    sh = run_profiler("torch_profile_signals_sharded", SHARDED_ARGS, out_dir)
    log("integration signals sharded: " + json.dumps(sh))
    check(sh["backend"] == "nccl" and sh["mesh_devices"] == 1,
          "integration: the sharded profiler did not run as a world of one over NCCL")
    check(all(sh[f"{s}_1M_s_per_card"] > 0 for s in ("text", "image", "clip")),
          "integration: sharded rates")
    torch.cuda.empty_cache()
    log(f"integration phase: {time.perf_counter() - t0:.3f} s, launches "
        + json.dumps(dict(launches)))
    return dict(launches)


def main() -> int:
    if sys.argv[1:2] == ["--serve-clients"]:  # the serving phase's client process
        serve_clients(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import dewi_tpu_torch  # noqa: F401  (sets full-f32 matmuls)
    from dewi_tpu_torch.ops import _build
    from dewi_tpu_torch.utils.profiling import card_line

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
    launches = collections.Counter(phase_bench())
    launches.update(phase_signals(card))
    launches.update(phase_pipeline(card))
    launches.update(phase_cli(card))
    phase_training(card)
    launches.update(phase_mesh(card))
    phase_model_axis(card)
    counts, kernels["probe_reduce_f32"] = phase_profilers(card)
    launches.update(counts)
    launches.update(phase_integration(card))

    line = []
    for name, rec in kernels.items():
        check(launches[name] > 0, f"kernel {name} was launched no time on the main path")
        line.append({"name": name, "route": "cuda",
                     "source": f"dewi_tpu_torch/csrc/{SOURCE.get(name, 'search_kernels.cu')}",
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                     "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                     "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                     # every kernel at 32 queries, stream_search also at 8
                     **{k: rec.get(k) for k in ("q32_ms", "q32_plain_ms", "q32_bound_ms",
                                                "q32_bound_by", "q32_library_ms")},
                     **{k: v for k, v in rec.items() if k.startswith("q8_")}})
    log(json.dumps({"kernels": line}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
