"""Driver ``closed_batch_search``: one caller, closed loop of ``search_batch``.

Each call takes ``queries_per_call`` fresh queries from a pool drawn on the
card from the seed, and copies its ids and scores to the host.  The window
counts the queries of the calls it completes; a ``--trace 1`` run profiles
``trace_calls`` more calls after it.  Of each call the answers of
``KEEP_PER_CALL`` rows (drawn from the seed for each pool slot) are kept
for the check, so the window's memory does not grow with its length.  The
check compares a seeded sample of ``check_queries`` of them, and the DEWI
scores the index holds, with the float64 reference (``harness/search.py``).

Traffic keys: ``queries_per_call``, ``pool_calls``, ``check_queries``,
``trace_calls``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from harness import search
from harness import trace as tr
from harness.common import Run, end_setup, now, rng, sync, torch_generator
from reference import search as ref

KEEP_PER_CALL = 8


def measure(cell: Any, seed: int, seconds: float, traced: bool, device: Any,
            t_start: float) -> Tuple[Run, Dict[str, Any]]:
    cfg, traffic = cell.config, cell.traffic
    run = Run(cell.name, traced)
    index = search.build_index(cfg, seed, device)
    qn, pool_calls = int(traffic["queries_per_call"]), int(traffic["pool_calls"])
    k, eta, ep = cfg["k"], cfg["eta"], cfg["entropy_pref"]
    # A pool of fresh queries on the card, drawn in one call; call c takes
    # slot c % pool_calls (the pool is sized past what a window can use).
    pool = torch.randn((pool_calls * qn, cfg["dim"]),
                       generator=torch_generator(seed, device, "queries"), device=device)
    per = min(KEEP_PER_CALL, qn)
    keep = np.sort(rng(seed, "keep").random((pool_calls, qn)).argsort(1)[:, :per], 1)
    for _ in range(3):
        index.search_batch(pool[:qn], k=k, eta=eta, entropy_pref=ep)[0].cpu()
    sync(device)
    kept: List[Tuple[np.ndarray, np.ndarray]] = []

    def call(c: int) -> None:
        qs = pool[(c % pool_calls) * qn:(c % pool_calls + 1) * qn]
        with torch.profiler.record_function("bench.search_batch"):
            s, r = index.search_batch(qs, k=k, eta=eta, entropy_pref=ep)
        with torch.profiler.record_function("bench.fetch"):
            r, s = r.cpu().numpy(), s.cpu().numpy()
        kept.append((r[keep[c % pool_calls]], s[keep[c % pool_calls]]))

    run.setup_s = end_setup(t_start)
    t0 = now()
    c = 0
    while now() - t0 < seconds:
        call(c)
        c += 1
    run.window_s = now() - t0
    run.counts.update(calls=c, queries=c * qn)
    if traced:
        n_tr = int(traffic["trace_calls"])
        with tr.Session(device) as session:
            with session.window():
                for j in range(n_tr):
                    call(c + j)
        run.trace = session.trace
        run.counts.update(traced_calls=n_tr, traced_queries=n_tr * qn)
    run.attempted, run.failed = c * qn, 0
    run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0
    run.shapes.update(capacity=cfg["capacity"], dim=cfg["dim"], queries_per_call=qn,
                      group=32, k=k)
    return run, {"index": index, "pool": pool, "kept": kept[:c], "keep": keep}


def judge(run: Run, cell: Any, seed: int, device: Any, state: Dict[str, Any]) -> None:
    cfg, qn = cell.config, int(cell.traffic["queries_per_call"])
    pool_calls = int(cell.traffic["pool_calls"])
    kept, keep = state["kept"], state["keep"]
    per = keep.shape[1]
    take = min(int(cell.traffic["check_queries"]), len(kept) * per)
    flat = np.sort(rng(seed, "check").choice(len(kept) * per, size=take, replace=False))
    rows = np.stack([kept[f // per][0][f % per] for f in flat])
    scores = np.stack([kept[f // per][1][f % per] for f in flat])
    slot = [f // per % pool_calls for f in flat]
    pool_rows = torch.as_tensor([s * qn + int(keep[s, f % per]) for s, f in zip(slot, flat)])
    q = state["pool"][pool_rows.to(state["pool"].device)].cpu().numpy()
    del state["pool"]
    held = search.held_dewi(state.pop("index"), cfg["n_docs"]).clone()  # the index is freed
    search.check(run, cfg, held, seed, device, q, rows, scores, cell.limits)


def control(cell: Any, seed: int, device: Any) -> Run:
    """The reference in the program's place, one precision below the
    deployment's: the DEWI scores in bfloat16 and the search in float32
    with TF32 on (the deployment refines in float32 with TF32 off), over
    the cell's corpus and as many queries as a run checks."""
    cfg = cell.config
    run = Run(cell.name, False)
    emb, sig = search.draw_corpus(cfg, seed, device)
    q = search.queries(seed, "control", int(cell.traffic["check_queries"]), cfg["dim"])
    dewi = ref.dewi_scores(sig, dtype=torch.bfloat16).float()
    docs = ref.normalize(emb)
    ent = 0.5 * (sig[:, 0] + sig[:, 2])
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        scores, rows = ref.search(torch.from_numpy(q).to(device), docs, dewi, ent,
                                  cfg["eta"], cfg["entropy_pref"], cfg["k"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    del docs
    search.check(run, cfg, dewi, seed, device, q, rows.cpu().numpy(),
                 scores.double().cpu().numpy(), cell.limits)
    return run
