#!/usr/bin/env python
"""DEWI index-tier ladder on the PyTorch port: exact -> int8 -> int4.

The counterpart of ``examples/index_tiers.py`` for ``dewi_tpu_torch``: one
synthetic corpus in each tier, every tier's top-10 held against the exact
ranking (the int tiers' two-stage refine keeps recall >= 0.99 while stage 1
reads a quarter or an eighth of f32's bytes).  Runs on the CUDA card by
default, where the int tiers' stage 1 runs in the port's CUDA kernels once
the index is large enough; ``DEWI_EXAMPLE_DOCS`` sets the corpus size:

    python examples/torch_index_tiers.py               # on the card
    python examples/torch_index_tiers.py --device cpu
"""

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dewi_tpu_torch import DewiIndex  # noqa: E402
from dewi_tpu_torch.metrics import recall_matrix  # noqa: E402

N = int(os.environ.get("DEWI_EXAMPLE_DOCS", 4096))
D, K, NQ = 128, 10, 32


def main(device: str) -> None:
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    pay = np.abs(rng.normal(size=(N, 8))).astype(np.float32)
    pay[:, 0] = rng.beta(2, 2, N)  # dewi column in [0, 1]
    ids = [f"doc{i}" for i in range(N)]
    queries = rng.normal(size=(NQ, D)).astype(np.float32)

    results: dict = {}
    for backend in ("exact", "int8", "int4"):
        idx = DewiIndex(dim=D, backend=backend, device=device)
        idx.add_batch(ids, emb, pay)
        idx.build()
        idx.search_batch(queries, k=K, eta=0.25, entropy_pref=0.1)  # warm-up
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, got = idx.search_batch(queries, k=K, eta=0.25, entropy_pref=0.1)
        got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
        results[backend] = ((time.perf_counter() - t0) / NQ * 1e3, got)

    exact_idx = results["exact"][1]
    print(f"{'backend':8s} {'ms/query':>9s} {'recall@10 vs exact':>19s}")
    for backend, (dt, got) in results.items():
        rec = float(recall_matrix(got, exact_idx))
        print(f"{backend:8s} {dt:9.3f} {rec:19.4f}")
        assert rec >= 0.99, (backend, rec)
    print("all tiers hold the >=0.99 recall gate")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(parser.parse_args().device)
