#!/usr/bin/env python3
"""IVF recall against nprobe on hard queries, on the port: a curve that can fail.

    python3 scripts/torch_profile_ivf_recall_curve.py --n-docs 1000000

Counterpart of ``scripts/profile_ivf_recall_curve.py``:

* modes >> nlist (4096 zipf-sized Gaussian modes against 1024 lists), so
  the coarse quantizer must merge modes and a query's neighbours straddle
  lists; centres and docs drawn on the card, the mode labels and the
  payloads (the DEWI column uniform in [0, 1], as the scorer's sigmoid
  gives it) on the host from the reference's seeds;
* three query families, hardest first: ``boundary`` (midpoints of two mode
  centres plus noise), ``offcenter`` (a centre plus 2.5x the corpus noise)
  and ``center`` (the easy control);
* ``--dewi-tier 0`` by default (the always-scanned DEWI tier hides bucket
  misses), with a ``dewi_tier`` 1024 control row on the boundary family;
* recall@k for each nprobe of ``--nprobes`` per family, with no spill and
  with each ``--spill`` fraction (``IVFIndex(spill_frac=)``: docs near a
  bucket boundary get a copy in their runner-up bucket, deduped at top-k),
  and the boundary family's batched ms per query per nprobe (median of 3
  timed passes after a warm one, host clock);
* the knee (the least nprobe with recall >= 0.99 on every family) per
  configuration, and ``shipped_default_ok``: whether the shipped
  ``IndexConfig`` (nprobe, spill_frac) reaches 0.99 on every family of its
  measured curve, computed as the reference computes it.

Ground truth is ``ExactIndex`` on the same attached tensors.
``draw_corpus`` makes the corpus and queries (its ``draws=`` can take
another source of the Gaussian and integer draws, as the tests give it
the reference's) and ``measure`` does the rest.  Writes ``--output``
(JSON).
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
    ap.add_argument("--modes", type=int, default=4096)
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--n-queries", type=int, default=512)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--dewi-tier", type=int, default=0)
    ap.add_argument("--nprobes", default="1,2,4,8,16,32,64")
    ap.add_argument("--spill", default="0.5",
                    help="comma list of spill_frac values to sweep "
                         "alongside the spill=0 control")
    ap.add_argument("--output", default=str(REPO / "chiprun_out" / "ivf_recall_curve.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap.parse_args(argv)


class TorchDraws:
    """The corpus's Gaussian and integer draws, from one ``torch.Generator``
    seeded 7 on ``device``.  ``stream`` names the reference's key of the
    draw (``jax.random.split(PRNGKey(7), 8)[stream]``); here the draws are
    taken in call order instead."""

    def __init__(self, device) -> None:
        import torch

        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(7)

    def normal(self, stream: int, shape: tuple):
        import torch

        return torch.randn(shape, device=self.device, generator=self.gen)

    def randint(self, stream: int, shape: tuple, high: int):
        import torch

        return torch.randint(0, high, shape, device=self.device, generator=self.gen)


def draw_corpus(n: int, d: int, nc: int, nq: int, device, draws=None) -> tuple:
    """``(emb, pay, families)`` on ``device``: ``nc`` zipf-sized Gaussian
    modes (centres ``3 x normal``, docs a centre plus unit noise), payloads
    with a uniform DEWI column, and the three query families.  ``draws``
    gives the Gaussian and integer draws (``TorchDraws`` by default); the
    mode labels and the payloads come from the reference's numpy seeds."""
    import torch

    draws = draws or TorchDraws(device)
    centers = draws.normal(0, (nc, d)) * 3.0
    w = 1.0 / (np.arange(nc) + 1.0)
    labels = torch.from_numpy(
        np.random.default_rng(11).choice(nc, size=n, p=w / w.sum())).to(device)
    emb = centers[labels] + draws.normal(2, (n, d))
    # Serving-like payloads: the DEWI column is a sigmoid output in [0, 1].
    pay_np = np.random.default_rng(1).gamma(2.0, size=(n, 8)).astype(np.float32)
    pay_np[:, 0] = np.random.default_rng(2).uniform(size=n).astype(np.float32)
    pay = torch.from_numpy(pay_np).to(device)
    qa = draws.randint(3, (nq,), nc)
    qb = draws.randint(4, (nq,), nc)
    families = {
        # Midpoint of two modes: the k nearest docs straddle >= 2 buckets.
        "boundary": 0.5 * (centers[qa] + centers[qb]) + 0.5 * draws.normal(5, (nq, d)),
        # Low-density shell, 2.5x the corpus noise radius off a centre.
        "offcenter": centers[qa] + 2.5 * draws.normal(6, (nq, d)),
        # The easy family (control).
        "center": centers[qa] + draws.normal(7, (nq, d)),
    }
    return emb, pay, families


def measure(args: argparse.Namespace, emb, pay, families: dict, device,
            build_kw: Optional[dict] = None) -> dict:
    """The recall curves, latencies, knees and the shipped-default verdict
    of ``IVFIndex`` over the attached ``emb``/``pay`` and the query
    ``families``; ``build_kw`` goes to every ``IVFIndex.build``."""
    import torch

    from dewi_tpu_torch.config import IndexConfig
    from dewi_tpu_torch.index.exact import ExactIndex
    from dewi_tpu_torch.index.ivf import IVFIndex
    from dewi_tpu_torch.metrics import recall_matrix
    from dewi_tpu_torch.utils.profiling import card_line, device_name

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    n, d = emb.shape
    nq = len(families["boundary"])
    nprobes = [int(x) for x in args.nprobes.split(",")]
    ids = [str(i) for i in range(n)]
    build_kw = build_kw or {}

    shipped = IndexConfig()
    spills = [0.0] + [float(x) for x in args.spill.split(",") if x]
    metrics: dict = {
        "n_docs": n, "dim": d, "modes": args.modes, "mode_weights": "zipf",
        "nlist": args.nlist, "k": args.k, "n_queries": nq,
        "dewi_tier": args.dewi_tier, "device": device_name(device),
        "shipped_default_nprobe": shipped.nprobe,
        "shipped_default_spill_frac": shipped.spill_frac,
    }

    exact = ExactIndex(dim=d, device=device)
    exact.store.attach_device(ids, emb, pay)
    exact.build()

    def blocked(search_fn, queries, qblock=128, **kw) -> np.ndarray:
        outs = []
        for s in range(0, len(queries), qblock):
            _, idx = search_fn(queries[s:s + qblock], k=args.k, **kw)
            outs.append(idx.cpu().numpy())
        return np.concatenate(outs)

    gts = {fam: blocked(exact.search_batch, q) for fam, q in families.items()}

    def ivf_index(dewi_tier: int, spill_frac: float = 0.0) -> IVFIndex:
        ivf = IVFIndex(dim=d, nlist=args.nlist, nprobe=max(nprobes), dewi_tier=dewi_tier,
                       kmeans_iters=8, spill_frac=spill_frac, device=device)
        ivf.store.attach_device(ids, emb, pay)
        return ivf

    def sweep(spill_frac: float) -> tuple:
        ivf = ivf_index(args.dewi_tier, spill_frac)
        t0 = time.perf_counter()
        ivf.build(**build_kw)
        sync()
        curves: dict = {"build_s": time.perf_counter() - t0}
        for fam, queries in families.items():
            row = {f"nprobe{p}": round(recall_matrix(
                blocked(ivf.search_batch, queries, nprobe=p), gts[fam]), 4) for p in nprobes}
            curves[fam] = row
            print(f"spill={spill_frac} {fam}: {row}", flush=True)
        # Latency per nprobe on the boundary family: median of 3 timed
        # passes, after a throwaway pass at the smallest nprobe.
        lat = {}
        qs = families["boundary"]
        blocked(ivf.search_batch, qs, nprobe=nprobes[0])
        for p in nprobes:
            blocked(ivf.search_batch, qs, nprobe=p)
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                blocked(ivf.search_batch, qs, nprobe=p)
                times.append(time.perf_counter() - t0)
            lat[f"nprobe{p}"] = float(np.median(times)) / nq * 1e3
        print(f"spill={spill_frac} latency: {lat}", flush=True)
        return curves, lat

    curves0, lat0 = sweep(0.0)
    curves = {k: v for k, v in curves0.items() if k != "build_s"}
    metrics["build_s"] = curves0["build_s"]
    metrics["recall_curves"] = curves
    metrics["batched_ms_per_query"] = lat0
    spill_results: dict = {}
    for sf in spills[1:]:
        c, lt = sweep(sf)
        spill_results[f"spill{sf}"] = {"build_s": c.pop("build_s"), "recall_curves": c,
                                       "batched_ms_per_query": lt}
    if spill_results:
        metrics["spill"] = spill_results

    # Control: the shipped dewi_tier=1024 on the hardest family.
    ivf_tier = ivf_index(1024)
    ivf_tier.build(**build_kw)
    row = {f"nprobe{p}": round(recall_matrix(
        blocked(ivf_tier.search_batch, families["boundary"], nprobe=p), gts["boundary"]), 4)
        for p in nprobes}
    metrics["recall_boundary_dewi_tier1024"] = row
    print(f"boundary + dewi_tier=1024: {row}", flush=True)

    def find_knee(cv: dict):
        for p in nprobes:
            if all(cv[f][f"nprobe{p}"] >= 0.99 for f in cv):
                return p
        return None

    metrics["min_nprobe_recall_0.99_all_families"] = find_knee(curves)
    for key, res in spill_results.items():
        metrics[f"min_nprobe_recall_0.99_all_families_{key}"] = find_knee(res["recall_curves"])

    # Gate the shipped configuration against the curve measured for it; a
    # shipped spill fraction that was not swept gets no verdict.
    ship_curves = None
    for sf in spills:
        if abs(sf - shipped.spill_frac) < 1e-9:
            ship_curves = (curves if sf == 0.0
                           else spill_results[f"spill{sf}"]["recall_curves"])
            metrics["shipped_gate_curve"] = f"spill{sf}"
    ship_key = f"nprobe{shipped.nprobe}"
    if ship_curves is None:
        metrics["shipped_default_ok_note"] = (
            f"shipped spill_frac={shipped.spill_frac} not among swept values {spills}; "
            "no verdict emitted")
    elif ship_key in next(iter(ship_curves.values())):
        metrics["shipped_default_ok"] = bool(
            all(ship_curves[f][ship_key] >= 0.99 for f in ship_curves))
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
    emb, pay, families = draw_corpus(args.n_docs, args.dim, args.modes, args.n_queries, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print("corpus + queries ready", flush=True)
    metrics = measure(args, emb, pay, families, device)

    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(metrics, indent=2) + "\n")
    print(json.dumps(metrics, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
