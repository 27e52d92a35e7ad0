#!/usr/bin/env python3
"""IVF recall and build at 1M clustered docs, on the port.

    python3 scripts/torch_profile_ivf_1m.py --n-docs 1000000 --modes 512

Counterpart of ``scripts/profile_ivf_1m.py``: 1M docs drawn on the card
from a mixture of ``--modes`` Gaussian modes with zipf-imbalanced sizes (the
bucket-overflow stress case), queries from the same modes, filled into
``IVFIndex(nlist=1024, nprobe=32, dewi_tier=1024, kmeans_iters=8)`` through
``store.attach_device`` (nothing passes through host memory but the
payloads).  Ground truth is ``ExactIndex`` on the same attached tensors.
Reports cold and warm build seconds (host clock to a ``synchronize``),
recall@k at nprobe 8, 16, ``--nprobe`` and 64, batched ms per query of the
scan and gather probes over f32 and bf16 buckets (host clock, one warm
pass first), and the bf16 tier's recall.  The DEWI column is gamma(2)
and the tier keeps the 1,024 highest-DEWI docs, so the true top k lie in
the tier and recall reads 1.0 at any nprobe, as in the reference: the
recall curve is the IVF profile that can fail.  ``draw_corpus`` makes the
data (``draws=`` can take another source of its draws) and ``measure``
does the rest.  Writes ``--output`` (JSON).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--modes", type=int, default=512,
                    help="Gaussian modes in the synthetic corpus")
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--nprobe", type=int, default=32)
    ap.add_argument("--n-queries", type=int, default=1000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--output", default=str(REPO / "chiprun_out" / "ivf_clustered_1m.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap.parse_args(argv)


class TorchDraws:
    """The corpus's draws from one ``torch.Generator`` seeded 7 on
    ``device``, and the payloads from numpy's seed 1.  ``stream`` names the
    reference's key of the draw (``kc1, kc2, kc3, kq1, kq2`` of
    ``jax.random.split(PRNGKey(7), 5)``, 0-4); here the draws are taken in
    call order instead."""

    def __init__(self, device) -> None:
        import torch

        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(7)

    def normal(self, stream: int, shape: tuple):
        import torch

        return torch.randn(shape, device=self.device, generator=self.gen)

    def categorical(self, stream: int, probs, n: int):
        import torch

        return torch.multinomial(probs, n, replacement=True, generator=self.gen)

    def randint(self, stream: int, shape: tuple, high: int):
        import torch

        return torch.randint(0, high, shape, device=self.device, generator=self.gen)

    def payloads(self, n: int):
        import torch

        return torch.from_numpy(
            np.random.default_rng(1).gamma(2.0, size=(n, 8)).astype(np.float32)).to(self.device)


def draw_corpus(n: int, d: int, nc: int, nq: int, device, draws=None) -> tuple:
    """``(emb, pay, queries)`` on ``device``: ``nc`` Gaussian modes
    (centres ``3 x normal``) with zipf-imbalanced sizes, docs a centre plus
    unit noise, gamma(2) payloads and ``nq`` queries from the same modes.
    ``draws`` gives the random draws (``TorchDraws`` by default)."""
    import torch

    draws = draws or TorchDraws(device)
    centers = draws.normal(0, (nc, d)) * 3.0
    # Imbalanced mode sizes (zipf-ish): the bucket-overflow stress case.
    w = 1.0 / (torch.arange(nc, device=device, dtype=torch.float32) + 1.0)
    labels = draws.categorical(1, w / w.sum(), n)
    emb = centers[labels] + draws.normal(2, (n, d))
    pay = draws.payloads(n)
    queries = centers[draws.randint(3, (nq,), nc)] + draws.normal(4, (nq, d))
    return emb, pay, queries


def measure(args: argparse.Namespace, emb, pay, queries, device,
            build_kw: Optional[dict] = None) -> dict:
    """Build seconds, the recall sweep and the batched latencies of
    ``IVFIndex`` over the attached ``emb``/``pay``; ``build_kw`` goes to
    every ``IVFIndex.build``."""
    import torch

    from dewi_tpu_torch.index.exact import ExactIndex
    from dewi_tpu_torch.index.ivf import IVFIndex
    from dewi_tpu_torch.metrics import recall_matrix
    from dewi_tpu_torch.utils.profiling import card_line, device_name

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    n, d = emb.shape
    nq = len(queries)
    ids = [str(i) for i in range(n)]
    build_kw = build_kw or {}
    metrics: dict = {
        "n_docs": n, "dim": d, "modes": args.modes, "mode_weights": "zipf",
        "nlist": args.nlist, "nprobe": args.nprobe, "k": args.k,
        "n_queries": nq, "device": device_name(device),
    }

    def ivf_index(**kw) -> IVFIndex:
        ivf = IVFIndex(dim=d, nlist=args.nlist, nprobe=args.nprobe, dewi_tier=1024,
                       kmeans_iters=8, device=device, **kw)
        ivf.store.attach_device(ids, emb, pay)
        return ivf

    ivf = ivf_index()
    for label in ("build_cold_s", "build_warm_s"):
        t0 = time.perf_counter()
        ivf.build(**build_kw)
        sync()
        metrics[label] = time.perf_counter() - t0
    print(f"build: cold {metrics['build_cold_s']:.3f}s, "
          f"warm {metrics['build_warm_s']:.3f}s", flush=True)

    exact = ExactIndex(dim=d, device=device)
    exact.store.attach_device(ids, emb, pay)
    exact.build()

    def blocked(search_fn, qblock=128, **kw) -> np.ndarray:
        outs = []
        for s in range(0, nq, qblock):
            _, idx = search_fn(queries[s:s + qblock], k=args.k, **kw)
            outs.append(idx.cpu().numpy())
        return np.concatenate(outs)

    gt = blocked(exact.search_batch)
    for nprobe in (8, 16, args.nprobe, 64):
        r = recall_matrix(blocked(ivf.search_batch, nprobe=nprobe), gt)
        metrics[f"recall_at_k{args.k}_nprobe{nprobe}"] = round(r, 4)
        print(f"nprobe={nprobe}: recall@{args.k} = {r:.4f}", flush=True)

    def timed_ms_per_query(index: IVFIndex) -> float:
        blocked(index.search_batch)  # warm-up pass
        t0 = time.perf_counter()
        blocked(index.search_batch)
        return (time.perf_counter() - t0) / nq * 1e3

    for impl in ("scan", "gather"):
        ivf.probe_impl = impl
        metrics[f"batched_ms_per_query_{impl}_f32"] = timed_ms_per_query(ivf)
        print(f"{impl} f32: {metrics[f'batched_ms_per_query_{impl}_f32']} ms/query",
              flush=True)
    # The headline is what probe_impl="auto" takes on this device (gather on
    # the card, scan on the CPU; index/ivf.py).
    ivf.probe_impl = "auto"
    resolved = ivf._resolved_probe_impl()
    metrics["probe_impl_auto_resolved"] = resolved
    metrics["batched_ms_per_query"] = metrics[f"batched_ms_per_query_{resolved}_f32"]
    del ivf

    # bf16 buckets: half the probe's bytes, recall against the same truth.
    ivf_bf = ivf_index(probe_dtype="bf16")
    ivf_bf.build(**build_kw)
    sync()
    metrics[f"recall_at_k{args.k}_bf16"] = round(
        recall_matrix(blocked(ivf_bf.search_batch), gt), 4)
    for impl in ("scan", "gather"):
        ivf_bf.probe_impl = impl
        metrics[f"batched_ms_per_query_{impl}_bf16"] = timed_ms_per_query(ivf_bf)
        print(f"{impl} bf16: {metrics[f'batched_ms_per_query_{impl}_bf16']} ms/query",
              flush=True)
    print(f"bf16 recall: {metrics[f'recall_at_k{args.k}_bf16']}", flush=True)
    if device.type == "cuda":
        metrics["card"] = card_line()
    return metrics


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from dewi_tpu_torch.utils.device import resolve_device
    from dewi_tpu_torch.utils.profiling import device_name

    device = resolve_device(args.device)
    print(f"Device: {device_name(device)}", flush=True)
    emb, pay, queries = draw_corpus(args.n_docs, args.dim, args.modes, args.n_queries, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print("corpus ready", flush=True)
    metrics = measure(args, emb, pay, queries, device)

    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(metrics, indent=2) + "\n")
    print(json.dumps(metrics, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
