#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dewi_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the stage-1 kernels from ``dewi_tpu_torch/csrc`` with nvcc (into
``dewi_tpu_torch/_build/``) and drives the port's main path through its
public entry points:

1. the card, the versions and the kernel build time;
2. each CUDA kernel against its plain PyTorch version on the card, at the
   main path's shape (cap 2^20, D 256, Q 1 and 32), a ragged one
   (cap 65,536, D 64, Q 5) and a wide one (cap 16,384, D 2048, Q 40, which
   takes two launches), with its time beside its bound;
3. the README quick start at its own size (10k docs x 768, cosine):
   scorer fit + score, ``set_dewi_scores``, ``build``, ``search``, a
   save/load round trip and an eta sweep, checked against numpy;
4. the bench protocol at 1M docs x 256 (cap 2^20), k=10, through
   ``DewiIndex``: exact f32 (the recall reference), exact bf16, int8, int4
   and int4 without block-max selection; Q=1 latency, batched ms/query at
   Q=1000 and recall@10 vs f32 exact over 1000 queries, plus the scorer's
   fit-and-score rate on the [1M, 7] signal matrix;
5. one JSON line with every kernel's launches, error and times.

Every check raises on failure, so the script exits non-zero without a
result line.  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_OPS_PER_S = 989e12     # dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12    # dense int8 tensor-core peak
N_DOCS, DIM, K, N_QUERIES = 1_000_000, 256, 10, 1000
ETA, EP = 0.25, 0.1         # bench.py's re-rank weights
RECALL_BLOCK = 128
TIER_KERNEL = {             # tier -> the stage-1 kernel its main path runs
    "exact_bf16": "scores_matrix",
    "int8": "bmax",
    "int4": "bmax_s4",
    "int4_unfused": "scores_matrix_s4",
}
REPLACES = {
    "bmax_s4": "dewi_tpu/ops/pallas_search.py:661",
    "scores_matrix_s4": "dewi_tpu/ops/pallas_search.py:470",
    "bmax": "dewi_tpu/ops/pallas_search.py:559",
    "scores_matrix": "dewi_tpu/ops/pallas_search.py:309",
}


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


def kernel_cases(x: dict) -> dict:
    """kernel name -> (kernel call, plain call, library call or None, rtol,
    atol fraction of max |ref|, bytes moved, operations, ops peak)."""
    from dewi_tpu_torch.ops import cuda_search as cs

    cap, d = x["e8"].shape
    nq = x["q"].shape[0]
    f4 = 4 * cap  # mult + add, f32 each
    qbf, ebf_t = x["q"].to(torch.bfloat16), x["ebf"].T
    e8bf_t = x["e8"].to(torch.bfloat16).T
    ops = 2.0 * nq * cap * d
    return {
        "bmax_s4": (lambda: cs.bmax_s4(x["p4"], x["m4"], x["add"], x["q8"], x["qs"]),
                    lambda: cs.bmax_s4_plain(x["p4"], x["m4"], x["add"], x["q8"], x["qs"]),
                    None, 1e-6, 0.0,
                    cap * d // 2 + 2 * f4 + nq * d + 4 * nq + 4 * nq * cap // 128,
                    ops, INT8_OPS_PER_S),
        "scores_matrix_s4": (
            lambda: cs.scores_matrix_s4(x["p4"], x["m4"], x["add"], x["q8"], x["qs"]),
            lambda: cs.scores_matrix_s4_plain(x["p4"], x["m4"], x["add"], x["q8"], x["qs"]),
            None, 1e-6, 0.0, cap * d // 2 + 2 * f4 + nq * d + 4 * nq + 4 * nq * cap,
            ops, INT8_OPS_PER_S),
        "bmax": (lambda: cs.bmax(x["e8"], x["m8"], x["add"], x["q"]),
                 lambda: cs.bmax_plain(x["e8"], x["m8"], x["add"], x["q"]),
                 lambda: torch.matmul(qbf, e8bf_t), 1e-5, 1e-5,
                 cap * d + 2 * f4 + 4 * nq * d + 4 * nq * cap // 128, ops, BF16_OPS_PER_S),
        "scores_matrix": (lambda: cs.scores_matrix(x["ebf"], x["mbf"], x["add"], x["q"]),
                          lambda: cs.scores_matrix_plain(x["ebf"], x["mbf"], x["add"], x["q"]),
                          lambda: torch.matmul(qbf, ebf_t), 1e-5, 1e-5,
                          2 * cap * d + 2 * f4 + 4 * nq * d + 4 * nq * cap, ops,
                          BF16_OPS_PER_S),
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


def phase_kernels() -> dict:
    from dewi_tpu_torch.ops import cuda_search as cs

    out = {name: {"max_abs_err": 0.0} for name in REPLACES}
    for cap, d, nq in ((1 << 20, DIM, 1), (1 << 20, DIM, 32), (65536, 64, 5),
                       (16384, 2048, 40)):
        x = kernel_inputs(cap, d, nq, seed=cap + nq)
        for name, (kern, plain, lib, rtol, atol, nbytes, ops, peak) in kernel_cases(x).items():
            err = compare(kern(), plain(), rtol, atol)
            rec = out[name]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if cap != 1 << 20:
                continue
            ms = time_device_ms(kern, reps=50, lead_cycles=400_000)
            plain_ms = time_device_ms(plain, reps=10)
            lib_ms = time_device_ms(lib, reps=50, lead_cycles=400_000) if lib else None
            bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3
            bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak else "operations"
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms, bytes=nbytes, rtol=rtol, atol_of_max=atol)
            log(f"kernel {name} cap={cap} D={d} Q={nq}: " + json.dumps(row))
            if nq == 1:  # the Q=1 search's shape goes into the kernels line
                rec.update(row)
        del x
        torch.cuda.empty_cache()
    log("kernel max_abs_err vs plain (all shapes; tolerance rtol + atol_of_max x max|plain|): " +
        json.dumps({k: v["max_abs_err"] for k, v in out.items()}))
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
        del index
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return launches


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "unknown"


def main() -> int:
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
    phase_quickstart()
    launches = phase_bench()

    line = []
    for name, rec in kernels.items():
        line.append({"name": name, "route": "cuda",
                     "source": "dewi_tpu_torch/csrc/search_kernels.cu",
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                     "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                     "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    log(json.dumps({"kernels": line}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
