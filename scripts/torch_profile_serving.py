#!/usr/bin/env python3
"""Serving benchmark of the port: sustained QPS and latency under HTTP load.

    python3 scripts/torch_profile_serving.py --n-docs 100000 --clients 4,16,64

Counterpart of ``scripts/profile_serving.py``.  It drives the whole
serving stack of ``dewi_tpu_torch.serve`` (HTTP parse, ``MicroBatcher``
admission, window coalescing, the launches of ``search_batch``, the
resolver's event-synchronised fetch, the JSON answer) and reports for each
client-concurrency level:

* the sustained QPS and the clients' p50/p95/p99 latency;
* the server's stage decomposition (``MicroBatcher.stage_summary``:
  ``queue_window``, ``dispatch``, ``resolve_wait``, ``device_fetch``, whose
  terms sum to ``total``) beside the client-minus-server delta (HTTP, the
  loopback and the client's scheduling);
* the mean coalesced batch and the shed (429) count.

Each client is a process of its own (this script with ``--client``, which
imports no torch), a closed-loop keep-alive HTTP client; all of a level's
clients are started, report ready, and are then released together for
``--seconds``, so their start-up is not in the window.  A last overload
level runs against a server with a small admission queue
(``--shed-max-pending``) under ``--shed-clients``, so the 429 path is
exercised, with the accepted requests' p99 beside the shed rate.  Before
the levels, every power-of-two batch the batcher can form is searched once
and 8 clients send requests for up to 3 s (the server's warm-up).  Writes
``--output`` (JSON).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def client_main(port: int, dim: int, ci: int, seconds: float, k: int) -> None:
    """One closed-loop keep-alive HTTP client: prints ``ready``, waits for a
    line on stdin, sends requests for ``seconds``, prints one JSON line."""
    import http.client

    rng = np.random.default_rng(ci)
    bodies = [json.dumps({"vector": rng.normal(size=dim).astype(float).tolist(),
                          "k": k}).encode() for _ in range(64)]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    print("ready", flush=True)
    sys.stdin.readline()
    lats, shed, errors, i = [], 0, 0, ci
    t_start = time.time()
    stop = time.perf_counter() + seconds
    while time.perf_counter() < stop:
        t0 = time.perf_counter()
        try:
            conn.request("POST", "/search", body=bodies[i % 64],
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
        except (OSError, http.client.HTTPException):  # reconnect and go on
            errors += 1
            conn.close()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            continue
        if resp.status == 429:
            shed += 1
            continue
        if resp.status != 200:
            raise RuntimeError(f"client {ci}: HTTP {resp.status}")
        lats.append((time.perf_counter() - t0) * 1e3)
        i += 1
    conn.close()
    print(json.dumps({"lats": lats, "shed": shed, "errors": errors,
                      "t_start": t_start, "t_end": time.time()}), flush=True)


def run_clients(port: int, dim: int, n_clients: int, seconds: float, k: int) -> dict:
    """Start ``n_clients`` client processes, release them together, and
    aggregate their latencies, QPS and shed counts."""
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--client", str(port), str(dim),
         str(i), str(seconds), str(k)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True) for i in range(n_clients)]
    try:
        for p in procs:
            if p.stdout.readline().strip() != "ready":
                raise RuntimeError(f"a client did not start (exit {p.poll()})")
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.flush()
        reports = []
        for p in procs:
            out, _ = p.communicate(timeout=seconds + 120)
            if p.returncode != 0:
                raise RuntimeError(f"a client failed with exit code {p.returncode}")
            reports.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lats = np.asarray([x for r in reports for x in r["lats"]])
    wall = max(r["t_end"] for r in reports) - min(r["t_start"] for r in reports)

    def pct(q: float):
        return float(np.percentile(lats, q)) if lats.size else None

    return {"clients": n_clients, "requests": int(lats.size), "wall_s": wall,
            "qps": lats.size / wall, "p50_ms": pct(50), "p95_ms": pct(95), "p99_ms": pct(99),
            "shed_429": int(sum(r["shed"] for r in reports)),
            "reconnects": int(sum(r["errors"] for r in reports))}


def warm(index, dim: int, k: int, max_batch: int) -> None:
    """Search once at every power-of-two batch the batcher can form (the
    caching allocator's first blocks of each shape, and on the card the
    kernels' first launches)."""
    import torch

    rng = np.random.default_rng(7)
    b = 1
    while b <= max_batch:
        scores, _ = index.search_batch(rng.normal(size=(b, dim)).astype(np.float32), k=k)
        if scores.is_cuda:
            torch.cuda.synchronize(scores.device)
        b *= 2


def health(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
        return json.loads(r.read())


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--backend", default="quantized")
    ap.add_argument("--clients", default="4,16,64")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--shed-max-pending", type=int, default=8,
                    help="admission queue size for the overload level "
                         "(0 disables the overload level)")
    ap.add_argument("--shed-clients", type=int, default=64)
    ap.add_argument("--output", default=str(REPO / "chiprun_out" / "serving_metrics.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from dewi_tpu_torch.index import DewiIndex
    from dewi_tpu_torch.serve import SearchServer
    from dewi_tpu_torch.utils.device import resolve_device
    from dewi_tpu_torch.utils.profiling import card_line, device_name

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(args.n_docs, args.dim)).astype(np.float32)
    pay = rng.gamma(2.0, 1.0, size=(args.n_docs, 8)).astype(np.float32)
    idx = DewiIndex(dim=args.dim, backend=args.backend, device=device)
    idx.add_batch([f"d{i}" for i in range(args.n_docs)], emb, pay)
    idx.build()

    def server(**kw) -> SearchServer:
        srv = SearchServer(idx, window_ms=args.window_ms, max_batch=args.max_batch, **kw)
        warm(idx, args.dim, args.k, args.max_batch)
        srv.start()
        return srv

    srv = server()
    print(f"serving {args.n_docs:,} docs ({args.backend}) on port {srv.port}", flush=True)
    results = []
    try:
        run_clients(srv.port, args.dim, 8, min(3.0, args.seconds), args.k)
        srv.batcher.stage_summary(reset=True)
        for nc in [int(x) for x in args.clients.split(",")]:
            before = health(srv.port)
            r = run_clients(srv.port, args.dim, nc, args.seconds, args.k)
            stages = srv.batcher.stage_summary(reset=True)
            after = health(srv.port)
            dispatches = after["dispatches"] - before["dispatches"]
            r["mean_batch"] = (after["queries"] - before["queries"]) / max(dispatches, 1)
            r["stages_ms"] = stages
            if r["p50_ms"] is not None and stages:
                # The stage terms sum to the server-side total; the rest of
                # the client's p50 is HTTP, the loopback and the client.
                r["server_p50_ms"] = stages["total"]["p50_ms"]
                r["client_overhead_p50_ms"] = r["p50_ms"] - r["server_p50_ms"]
                r["stage_sum_p50_ms"] = sum(
                    stages[s]["p50_ms"]
                    for s in ("queue_window", "dispatch", "resolve_wait", "device_fetch"))
            results.append(r)
            print(json.dumps(r), flush=True)
    finally:
        srv.shutdown()

    overload = None
    if args.shed_max_pending > 0:
        srv2 = server(max_pending=args.shed_max_pending)
        try:
            overload = run_clients(srv2.port, args.dim, args.shed_clients, args.seconds,
                                   args.k)
            overload["max_pending"] = args.shed_max_pending
            overload["stages_ms"] = srv2.batcher.stage_summary()
            overload["shed_rate"] = overload["shed_429"] / max(
                overload["shed_429"] + overload["requests"], 1)
        finally:
            srv2.shutdown()
        print("overload:", json.dumps(overload), flush=True)

    out = {
        "n_docs": args.n_docs, "dim": args.dim, "backend": args.backend,
        "window_ms": args.window_ms, "device": device_name(device),
        "card": card_line() if device.type == "cuda" else None,
        "client_isolation": "separate processes, released together after start-up",
        "levels": results, "overload": overload,
        "note": "Closed-loop keep-alive HTTP clients in separate processes; "
                "client-observed latency plus the server-side stage "
                "decomposition (stages sum to the server total; "
                "client_overhead = HTTP + loopback + client scheduling).",
    }
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps({k: v for k, v in out.items() if k not in ("levels", "overload")}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--client"]:
        a = sys.argv[2:]
        client_main(int(a[0]), int(a[1]), int(a[2]), float(a[3]), int(a[4]))
        sys.exit(0)
    sys.exit(main())
