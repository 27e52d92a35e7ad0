#!/usr/bin/env python3
"""Index build + search benchmark of the port, with the reference's protocol.

    python3 scripts/torch_profile_index.py --n-docs 1000000 --backend quantized
    python3 scripts/torch_profile_index.py --backend ivf --nlist 256 --nprobe 16

Counterpart of ``scripts/profile_index.py``: the same arguments (plus
``--device``, the card unless ``cpu`` is asked for), the same seeded
gamma/beta synthetic payloads (``generate_synthetic_data``, equal to the
reference's bit for bit), the same ``metrics.json`` keys.  The build (add,
build and a first search) and each of the ``--latency-samples`` Q=1
searches are ``Timer`` spans that end after the card has finished their
results; the batched rate is one ``search_batch`` of every query, host
clock to a ``synchronize``.  ``recall_vs_exact`` (ivf and quantized) is
against ``backend="exact"`` on the same corpus.  ``--trace-dir`` writes a
``torch.profiler`` trace of the latency loop.  ``device`` is the card's
name (``torch.cuda.get_device_name``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def generate_synthetic_data(n_docs: int, dim: int, seed: int = 42,
                            clustered: bool = False, n_clusters: int = 256):
    """Seeded synthetic corpus: unit-ish embeddings + gamma/beta payloads,
    drawn as ``scripts/profile_index.py`` draws them.

    ``clustered=True`` draws a mixture of Gaussians instead of isotropic
    noise: isotropic random vectors have near-uniform pairwise cosine, the
    pathological case for any IVF (recall ~ nprobe/nlist); real embedding
    corpora are clustered, which is what IVF exploits."""
    rng = np.random.default_rng(seed)
    if clustered:
        centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * 3.0
        assign = rng.integers(0, n_clusters, n_docs)
        embeddings = (
            centers[assign] + rng.normal(size=(n_docs, dim))
        ).astype(np.float32)
    else:
        embeddings = rng.normal(size=(n_docs, dim)).astype(np.float32)
    payloads = np.empty((n_docs, 8), dtype=np.float32)
    payloads[:, 0] = rng.beta(2, 2, n_docs)          # dewi
    payloads[:, 1] = rng.gamma(2.0, 1.5, n_docs)     # ht_mean
    payloads[:, 2] = rng.gamma(2.5, 1.5, n_docs)     # ht_q90
    payloads[:, 3] = rng.gamma(2.0, 1.0, n_docs)     # hi_mean
    payloads[:, 4] = rng.gamma(2.5, 1.0, n_docs)     # hi_q90
    payloads[:, 5] = rng.beta(2, 5, n_docs)          # I_hat
    payloads[:, 6] = rng.beta(1, 4, n_docs)          # redundancy
    payloads[:, 7] = rng.beta(1, 9, n_docs)          # noise
    doc_ids = [str(i) for i in range(n_docs)]
    return doc_ids, embeddings, payloads


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--n-queries", type=int, default=1000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--backend", default="exact", choices=["exact", "ivf", "quantized"])
    ap.add_argument("--nlist", type=int, default=256)
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--eta", type=float, default=0.25)
    ap.add_argument("--entropy-pref", type=float, default=0.0)
    ap.add_argument("--latency-samples", type=int, default=200)
    ap.add_argument("--output", default=str(REPO / "chiprun_out" / "profile_metrics.json"))
    ap.add_argument("--trace-dir", default=None,
                    help="Write a torch.profiler trace of the latency loop here")
    ap.add_argument("--clustered", action="store_true",
                    help="Mixture-of-Gaussians corpus (realistic for IVF)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from dewi_tpu_torch.index import DewiIndex
    from dewi_tpu_torch.metrics import recall_matrix
    from dewi_tpu_torch.utils.device import resolve_device
    from dewi_tpu_torch.utils.profiling import (Timer, device_name, summarize, torch_trace,
                                                write_metrics)

    device = resolve_device(args.device)
    print(f"Device: {device_name(device)}", flush=True)
    print(f"Generating {args.n_docs} docs (dim={args.dim})...", flush=True)
    doc_ids, emb, pay = generate_synthetic_data(
        args.n_docs, args.dim, clustered=args.clustered
    )
    qrng = np.random.default_rng(7)
    if args.clustered:
        # Realistic queries resemble corpus points (noisy copies), not
        # isotropic noise landing between clusters.
        picks = qrng.integers(0, args.n_docs, args.n_queries)
        queries = (
            emb[picks] + 0.3 * qrng.normal(size=(args.n_queries, args.dim))
        ).astype(np.float32)
    else:
        queries = qrng.normal(size=(args.n_queries, args.dim)).astype(np.float32)

    kwargs = {}
    if args.backend == "ivf":
        kwargs = {"nlist": args.nlist, "nprobe": args.nprobe}
    index = DewiIndex(dim=args.dim, backend=args.backend, device=device, **kwargs)
    search = dict(k=args.k, eta=args.eta, entropy_pref=args.entropy_pref)

    timer = Timer()
    out: list = []
    with timer.span("build", result=out):
        index.add_batch(doc_ids, emb, pay)
        index.build()
        out.append(index.search_batch(queries[:1], k=args.k))  # the build's last work
    build_s = timer.mean("build") / 1e3
    print(f"Build: {build_s:.2f}s ({args.n_docs / build_s:,.0f} docs/sec)", flush=True)

    def run_queries() -> None:
        for i in range(min(args.latency_samples, args.n_queries)):
            res: list = []
            with timer.span("query", result=res):
                res.append(index.search_batch(queries[i:i + 1], **search))

    warm: list = []
    with timer.span("warmup", result=warm):
        warm.append(index.search_batch(queries[:1], **search))
    with torch_trace(args.trace_dir):
        run_queries()
    if args.trace_dir:
        print(f"torch.profiler trace written to {args.trace_dir}", flush=True)

    batch: list = []
    with timer.span("batch", result=batch):
        batch.append(index.search_batch(queries, **search))
    scores = batch[0][0]
    if not (tuple(scores.shape) == (args.n_queries, min(args.k, args.n_docs))
            and bool(scores.isfinite().all())):
        raise RuntimeError(f"batched search returned {tuple(scores.shape)} or non-finite scores")

    metrics = summarize(timer, args.n_docs, args.n_queries, extra={
        "queries_per_sec": round(args.n_queries / (timer.mean("batch") / 1e3), 1),
        "device": device_name(device),
    })
    metrics = {"backend": args.backend, "clustered_corpus": bool(args.clustered),
               "n_docs": args.n_docs, "dim": args.dim, "n_queries": args.n_queries,
               "k": args.k, **metrics}
    if args.backend in ("ivf", "quantized"):
        exact = DewiIndex(dim=args.dim, backend="exact", device=device)
        exact.add_batch(doc_ids, emb, pay)
        exact.build()
        nq = min(100, args.n_queries)
        _, got = index.search_batch(queries[:nq], **search)
        _, want = exact.search_batch(queries[:nq], **search)
        metrics["recall_vs_exact"] = round(
            recall_matrix(got.cpu().numpy(), want.cpu().numpy()), 4)

    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    write_metrics(metrics, args.output)
    print(json.dumps(metrics, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
