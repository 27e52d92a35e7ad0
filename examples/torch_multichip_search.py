#!/usr/bin/env python
"""Sharded search over several ranks with the PyTorch port.

The counterpart of ``examples/multichip_search.py`` for ``dewi_tpu_torch``.
The port runs one process per device under ``torch.distributed``: this
script starts ``--ranks`` ranks on this host with ``parallel.launch_local``
(gloo on the CPU or for ranks that share one card, NCCL where every rank
has a card of its own).  Each rank keeps its contiguous block of the
corpus, scans it (exact f32, and int8 two-stage with f32 refinement, whose
stage 1 runs in the port's CUDA kernels once a shard is large enough), and
the per-shard top-k lists are all-gathered and merged.  The answers are
asserted equal to a single-device search over the same rows.
``DEWI_EXAMPLE_DOCS`` sets the corpus size:

    python examples/torch_multichip_search.py               # on the card
    python examples/torch_multichip_search.py --device cpu
"""

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dewi_tpu_torch.parallel import launch_local  # noqa: E402

D, K, NQ, ETA, EP = 64, 10, 8, 0.25, 0.1


def rank_search(emb: np.ndarray, pay: np.ndarray, queries: np.ndarray, device: str) -> dict:
    """One rank: its shard of the corpus in both sharded tiers."""
    import torch.distributed as dist

    from dewi_tpu_torch.index.store import DocStore
    from dewi_tpu_torch.ops import cuda_search
    from dewi_tpu_torch.parallel import (ShardedExactSearcher, ShardedQuantizedSearcher,
                                         make_mesh)

    mesh = make_mesh(device=device)
    ids = [f"doc{i}" for i in range(len(emb))]
    out = {"mesh": mesh.shape}
    for tier in ("exact", "int8"):
        store = DocStore(D, device=mesh.device)
        store.add_batch(ids, emb, pay)
        searcher = (ShardedExactSearcher(store, mesh, k=K) if tier == "exact"
                    else ShardedQuantizedSearcher(store, mesh, k=K))
        scores, idx = searcher.search_batch(queries, eta=ETA, entropy_pref=EP)
        out[tier] = (scores.cpu().numpy(), idx.cpu().numpy())
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, dict(cuda_search.launch_counts))
    out["launches"] = {name: sum(c[name] for c in counts) for name in counts[0]
                       if any(c[name] for c in counts)}
    return out


def same_answer(got: tuple, want: tuple, tol: float = 1e-5) -> None:
    """Scores within ``tol``; ids equal wherever the score is clear of its
    neighbours (equal scores may come in either order)."""
    (s, i), (ws, wi) = got, want
    np.testing.assert_allclose(s, ws, rtol=tol, atol=tol)
    gap = np.diff(ws, axis=1)
    clear = np.ones_like(ws, bool)
    clear[:, 1:] &= -gap > 2 * tol
    clear[:, :-1] &= -gap > 2 * tol
    np.testing.assert_array_equal(i[clear], wi[clear])


def main(device: str, ranks: int) -> None:
    from dewi_tpu_torch import DewiIndex

    cuda = device.startswith("cuda")
    n = int(os.environ.get("DEWI_EXAMPLE_DOCS", 65_536 if cuda else 8_192))
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(n, D)).astype(np.float32)
    pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    queries = rng.normal(size=(NQ, D)).astype(np.float32)
    backend = "nccl" if cuda and torch.cuda.device_count() >= ranks else "gloo"
    if cuda:
        from dewi_tpu_torch.ops import _build

        _build.load_library()  # one build, before the ranks load it
    out = launch_local(rank_search, ranks, (emb, pay, queries, device), backend=backend,
                       timeout=600)
    print(f"mesh: {out['mesh']} over {ranks} {backend} ranks on {device}")

    ids = [f"doc{i}" for i in range(n)]
    for tier, backend_name in (("exact", "exact"), ("int8", "int8")):
        local = DewiIndex(dim=D, backend=backend_name, device=device)
        local.add_batch(ids, emb, pay)
        local.build()
        s, i = local.search_batch(queries, k=K, eta=ETA, entropy_pref=EP)
        same_answer(out[tier], (s.cpu().numpy(), i.cpu().numpy()))
        print(f"{tier} tier: sharded top-{K} == single-device top-{K} "
              f"over {n} docs x {ranks} shards")
    print(f"stage-1 kernel launches on the ranks: {out['launches'] or 'none (plain route)'}")
    print(f"query 0 top-{K}: {[ids[j] for j in out['exact'][1][0]]}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    main(args.device, args.ranks)
