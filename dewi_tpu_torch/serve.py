"""Micro-batched query serving over a DEWI index.

Counterpart of ``dewi_tpu/serve.py``, with the same batching policy, so
that the dispatch shapes, and so the serving numbers, stay comparable:
concurrent requests are coalesced for up to ``window_ms`` (or
``max_batch`` queries), grouped by ``(k, eta, entropy_pref)``, padded to a
power-of-two batch and dispatched as ONE ``search_batch`` call.

Two layers, both stdlib plus torch:

* :class:`MicroBatcher` -- thread-safe coalescing core (futures in,
  batched device dispatch out).  Usable directly by any embedding host.
* :class:`SearchServer` -- a ``ThreadingHTTPServer`` JSON front end:
  ``POST /search``, ``POST /search_batch``, ``GET /healthz`` and
  ``GET /stats_stages``.

The worker thread launches a batch and records a CUDA event after it; a
resolver thread waits on that event and copies the results to the host
on a stream of its own, so batch k+1 computes while batch k is fetched.
A text query is embedded by the CLIP text tower that the index's
``encoder`` provenance names (:func:`query_encoder_for_index`).
"""

from __future__ import annotations

import collections
import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


def query_encoder_for_index(index: Any) -> Any:
    """The CLIP text encoder an index's embeddings came from.

    Rebuilt from the ``encoder`` provenance the index recorded (model preset,
    tokenizer, seed, checkpoint), on the index's device, so that query vectors
    live in the corpus's space.  Raises ``ValueError`` with the reason where
    no such encoder can be rebuilt: no provenance, external embeddings, a
    checkpoint that is missing, or no checkpoint at all.  The last is
    refused where ``dewi_tpu``'s CLI would answer: seeded weights are not
    portable between the two packages (their random streams differ), so a
    seed-only encoder here is not the one that embedded the corpus.  A
    checkpoint whose fingerprint changed since the index was built warns.
    """
    from .models.registry import checkpoint_fingerprint
    from .signals.cross_modal import CrossModalDependency

    prov = getattr(index, "encoder", None)
    if not prov:
        raise ValueError(
            "the index has no encoder provenance, so text queries cannot be "
            "embedded in its space; send a 'vector' query")
    if prov.get("source") == "external":
        raise ValueError(
            "the index's embeddings were supplied externally (no encoder "
            "provenance); text queries cannot be encoded consistently; send a "
            "'vector' query embedded by the same external model")
    ckpt = prov.get("checkpoint")
    if not ckpt:
        raise ValueError(
            "the index's encoder provenance names no checkpoint, only a seed; "
            "seeded weights are not portable between dewi_tpu and "
            "dewi_tpu_torch, so a text query cannot be embedded in the index's "
            "space; build the index from a saved CLIP checkpoint, or send a "
            "'vector' query")
    if not Path(ckpt).exists():
        raise ValueError(f"the index was embedded with checkpoint {ckpt!r}, which does "
                         "not exist here; restore it, or send a 'vector' query")
    want = prov.get("checkpoint_fingerprint")
    have = checkpoint_fingerprint(ckpt)
    if want and have and want != have:
        logger.warning("checkpoint %s changed since the index was built (fingerprint %s "
                       "!= recorded %s); query embeddings may not match the corpus",
                       ckpt, have, want)
    return CrossModalDependency(model_name=prov.get("model", "small"),
                                tokenizer=prov.get("tokenizer", "byte"),
                                seed=int(prov.get("seed", 0)), checkpoint=ckpt,
                                device=index.device)


def _bucket(n: int, cap: int) -> int:
    """Next power of two >= n, capped: one dispatch shape per bucket."""
    b = 1
    while b < min(n, cap):
        b *= 2
    return min(b, cap)


class OverloadedError(RuntimeError):
    """Raised by ``MicroBatcher.submit`` when the pending queue is full.

    The HTTP layer maps this to 429: load is shed at admission instead of
    queueing without bound.
    """


@dataclass
class _Request:
    query: np.ndarray
    params: Tuple[int, float, float]  # (k, eta, entropy_pref)
    future: Future = field(default_factory=Future)
    t_submit: float = 0.0  # perf_counter stamp at admission


def _to_host(t: torch.Tensor, done: Optional[torch.cuda.Event],
             streams: Dict[torch.device, torch.cuda.Stream]) -> np.ndarray:
    """Fetch a search result: a CUDA tensor is copied once ``done`` has
    fired, on this thread's own stream, so the copy does not queue behind
    the batches launched after it."""
    if done is None:
        return t.numpy()
    stream = streams.get(t.device)
    if stream is None:
        stream = streams[t.device] = torch.cuda.Stream(device=t.device)
    with torch.cuda.stream(stream):
        stream.wait_event(done)
        return t.cpu().numpy()


class MicroBatcher:
    """Coalesce concurrent search requests into fused device dispatches.

    ``submit`` returns a ``Future`` resolving to ``(ids, scores)`` lists.
    Requests sharing ``(k, eta, entropy_pref)`` fuse into one
    ``index.search_batch`` call; mixed parameters split into one dispatch
    per distinct triple within the window.
    """

    STAGE_NAMES = ("queue_window", "dispatch", "resolve_wait",
                   "device_fetch", "total")
    WORKER_NAME = "dewi-serve-worker"

    def __init__(self, index: Any, window_ms: float = 2.0, max_batch: int = 256,
                 max_pending: int = 4096, resolvers: int = 2) -> None:
        self.index = index
        self.window_ms = float(window_ms)
        self.max_batch = int(max_batch)
        self.resolvers = max(1, int(resolvers))
        # Bounded admission queue: beyond max_pending waiting requests,
        # submit() sheds load (OverloadedError -> HTTP 429).
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=int(max_pending))
        # Dispatch pipeline: the worker launches a batch and hands the
        # un-fetched result here; resolver threads wait for the device and
        # fetch.  Queue depth = pool size bounds the batches in flight.
        self._resolve_q: "queue.Queue" = queue.Queue(maxsize=self.resolvers)
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self.stats: Dict[str, float] = {
            "queries": 0, "dispatches": 0, "max_batch_seen": 0, "shed": 0,
        }
        # Per-request stage durations (ms), bounded ring: (queue+window,
        # dispatch, resolve_wait, device+fetch, total).
        self._stages: "collections.deque" = collections.deque(maxlen=8192)
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name=self.WORKER_NAME)
        self._resolver_threads = [
            threading.Thread(target=self._resolve_loop, daemon=True,
                             name=f"dewi-serve-resolver-{i}")
            for i in range(self.resolvers)
        ]
        self._worker.start()
        for t in self._resolver_threads:
            t.start()

    # -- public API -----------------------------------------------------------

    def submit(self, query: Any, k: int = 10, eta: Optional[float] = None,
               entropy_pref: Optional[float] = None) -> Future:
        if self._stop.is_set():
            raise RuntimeError("MicroBatcher is shut down")
        q = np.asarray(query, dtype=np.float32)
        if q.shape != (self.index.dim,):
            raise ValueError(f"Expected query shape ({self.index.dim},), got {q.shape}")
        eta = self.index.rerank_eta if eta is None else float(eta)
        ep = self.index.entropy_pref if entropy_pref is None else float(entropy_pref)
        req = _Request(query=q, params=(int(k), eta, ep), t_submit=time.perf_counter())
        try:
            self._q.put_nowait(req)
        except queue.Full:
            with self._stats_lock:
                self.stats["shed"] += 1
            raise OverloadedError(
                f"pending queue full ({self._q.maxsize} requests); retry later"
            ) from None
        return req.future

    def search(self, query: Any, **kw: Any) -> Tuple[List[str], List[float]]:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(query, **kw).result()

    def shutdown(self) -> None:
        self._stop.set()
        # Both threads observe _stop within their 50 ms poll (the worker's
        # resolve-queue put is stop-aware too), so after these joins the
        # drains below are race-free.
        self._worker.join(timeout=5.0)
        for t in self._resolver_threads:
            t.join(timeout=5.0)
        # Fail anything still queued: a caller blocked on Future.result()
        # would otherwise wait forever on a request no worker will serve.
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(
                    RuntimeError("MicroBatcher shut down before serving this request"))
        self._fail_queued_resolves()

    def _fail_queued_resolves(self) -> None:
        """Fail every batch still waiting on the resolve queue (shutdown's
        drain, and the worker after a put that landed post-stop)."""
        while True:
            try:
                reqs = self._resolve_q.get_nowait()[0]
            except queue.Empty:
                break
            for req in reqs:
                if not req.future.done():
                    req.future.set_exception(
                        RuntimeError("MicroBatcher shut down before resolving this request"))

    # -- worker ---------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.window_ms / 1e3
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            groups: Dict[Tuple[int, float, float], List[_Request]] = {}
            for r in batch:
                groups.setdefault(r.params, []).append(r)
            for (k, eta, ep), reqs in groups.items():
                self._dispatch(reqs, k, eta, ep)
            with self._stats_lock:
                self.stats["queries"] += len(batch)
                self.stats["dispatches"] += len(groups)
                self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], len(batch))

    def _dispatch(self, reqs: List[_Request], k: int, eta: float, ep: float) -> None:
        """Launch one batch and queue it for resolution.

        ``search_batch`` returns once its launches are queued; an event
        recorded after them tells the resolver when the results are ready.
        """
        try:
            t_start = time.perf_counter()
            n = len(reqs)
            b = _bucket(n, self.max_batch)
            qs = np.empty((b, self.index.dim), np.float32)
            for i, r in enumerate(reqs):
                qs[i] = r.query
            qs[n:] = reqs[0].query  # pad rows repeat the first query
            scores, rows = self.index.search_batch(qs, k=k, eta=eta, entropy_pref=ep)
            done = None
            if scores.is_cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(scores.device))
            t_launched = time.perf_counter()
            # Stop-aware handoff: a plain blocking put could strand this
            # batch at shutdown (the resolvers gone, the put blocked).
            while True:
                try:
                    self._resolve_q.put((reqs, scores, rows, done, t_start, t_launched),
                                        timeout=0.05)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        raise RuntimeError(
                            "MicroBatcher shut down before resolving this request")
            # A put that lands after shutdown's drain would sit unresolved:
            # fail it here.
            if self._stop.is_set():
                self._fail_queued_resolves()
        except Exception as e:  # noqa: BLE001 -- fail every waiter, keep serving
            logger.exception("serve: dispatch failed")
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)

    def _resolve_loop(self) -> None:
        streams: Dict[torch.device, torch.cuda.Stream] = {}
        while not self._stop.is_set():
            try:
                reqs, scores, rows, done, t_start, t_launched = self._resolve_q.get(
                    timeout=0.05)
            except queue.Empty:
                continue
            try:
                t_fetch0 = time.perf_counter()
                scores = _to_host(scores, done, streams)
                rows = _to_host(rows, done, streams)
                t_fetch1 = time.perf_counter()
                doc_ids = self.index.doc_ids
                n_live = len(doc_ids)
                for i, r in enumerate(reqs):
                    # k is clamped to capacity: ranks past the corpus carry
                    # pad-row indices (or, from the IVF tier, -1 for an
                    # exhausted pool or a deduped slot), dropped here.
                    pairs = [(doc_ids[j], float(s)) for j, s in zip(rows[i], scores[i])
                             if 0 <= j < n_live]
                    r.future.set_result(([p[0] for p in pairs], [p[1] for p in pairs]))
                with self._stats_lock:
                    for r in reqs:
                        self._stages.append((
                            (t_start - r.t_submit) * 1e3,
                            (t_launched - t_start) * 1e3,
                            (t_fetch0 - t_launched) * 1e3,
                            (t_fetch1 - t_fetch0) * 1e3,
                            (t_fetch1 - r.t_submit) * 1e3,
                        ))
            except Exception as e:  # noqa: BLE001
                logger.exception("serve: resolve failed")
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)

    def stage_summary(self, reset: bool = False) -> Dict[str, Any]:
        """Percentiles (ms) of each serving stage since the last reset.

        ``queue_window`` (admission -> its batch's dispatch starts) +
        ``dispatch`` (the launches of ``search_batch``) + ``resolve_wait``
        (pipeline handoff) + ``device_fetch`` (device compute + result copy)
        = ``total``, the server-side latency of a request.
        """
        with self._stats_lock:
            rows = list(self._stages)
            if reset:
                self._stages.clear()
        if not rows:
            return {}
        arr = np.asarray(rows)  # [n, 5]
        out: Dict[str, Any] = {}
        for j, name in enumerate(self.STAGE_NAMES):
            col = arr[:, j]
            out[name] = {
                "p50_ms": round(float(np.percentile(col, 50)), 3),
                "p95_ms": round(float(np.percentile(col, 95)), 3),
                "mean_ms": round(float(col.mean()), 3),
            }
        out["n"] = int(arr.shape[0])
        return out


class SearchServer:
    """Stdlib HTTP JSON front end over a :class:`MicroBatcher`.

    Endpoints:
      ``POST /search``        {"vector": [...], "k", "eta", "entropy_pref"}
                              -> {"ids", "scores"}
      ``POST /search_batch``  {"queries": [ {...}, ... ]} -> {"results": [...]}
      ``GET  /healthz``       {"docs", "dim", "queries", "dispatches", ...}
      ``GET  /stats_stages``  :meth:`MicroBatcher.stage_summary`

    A request with ``"text"`` is embedded by :meth:`encode_text`; where the
    index's provenance names no usable encoder it gets a 400 with the reason.
    """

    #: Per-request result deadline; overload is handled by admission
    #: shedding (429), not by this timeout.
    request_timeout_s: float = 600.0

    def __init__(self, index: Any, host: str = "127.0.0.1", port: int = 0,
                 window_ms: float = 2.0, max_batch: int = 256,
                 max_pending: int = 4096, resolvers: int = 2) -> None:
        self.index = index
        self._encoder: Any = None
        self._encoder_lock = threading.Lock()
        self.batcher = MicroBatcher(index, window_ms=window_ms, max_batch=max_batch,
                                    max_pending=max_pending, resolvers=resolvers)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt: str, *args: Any) -> None:
                logger.debug("serve: " + fmt, *args)

            def _reply(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                if self.path == "/healthz":
                    self._reply(200, server.health())
                elif self.path == "/stats_stages":
                    self._reply(200, server.batcher.stage_summary())
                else:
                    self._reply(404, {"error": "unknown path"})

            def do_POST(self) -> None:
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, OSError) as e:
                    self._reply(400, {"error": f"bad JSON: {e}"})
                    return
                try:
                    if self.path == "/search":
                        self._reply(200, server.handle_search(req))
                    elif self.path == "/search_batch":
                        futs = [server.submit_request(q) for q in req.get("queries", [])]
                        self._reply(200, {"results": [server._resolve(f) for f in futs]})
                    else:
                        self._reply(404, {"error": "unknown path"})
                except OverloadedError as e:
                    self._reply(429, {"error": str(e)})
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 -- keep serving
                    logger.exception("serve: request failed")
                    self._reply(500, {"error": str(e)})

        # The stdlib listen backlog is 5: a burst of concurrent clients
        # beyond it gets resets before accept() runs.
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        self.httpd = _Server((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                                        name="dewi-serve-http")

    # -- request handling -------------------------------------------------------

    def submit_request(self, req: Dict[str, Any]) -> Future:
        if not isinstance(req, dict):
            raise ValueError("a request must be a JSON object")
        if "vector" in req:
            q = np.asarray(req["vector"], np.float32)
        elif "text" in req:
            q = self.encode_text(str(req["text"]))
        else:
            raise ValueError("request needs 'vector' or 'text'")
        return self.batcher.submit(q, k=int(req.get("k", 10)), eta=req.get("eta"),
                                   entropy_pref=req.get("entropy_pref"))

    def _resolve(self, fut: Future) -> Dict[str, Any]:
        ids, scores = fut.result(timeout=self.request_timeout_s)
        return {"ids": ids, "scores": scores}

    def handle_search(self, req: Dict[str, Any]) -> Dict[str, Any]:
        return self._resolve(self.submit_request(req))

    def encode_text(self, text: str) -> np.ndarray:
        """A text query's embedding, by the query encoder of the index's
        provenance (built once, under a lock)."""
        with self._encoder_lock:
            if self._encoder is None:
                self._encoder = query_encoder_for_index(self.index)
        return self._encoder.encode_texts([text])[0]

    def health(self) -> Dict[str, Any]:
        with self.batcher._stats_lock:
            s = dict(self.batcher.stats)
        return {
            "docs": len(self.index),
            "dim": self.index.dim,
            "queries": int(s["queries"]),
            "dispatches": int(s["dispatches"]),
            "max_batch_seen": int(s["max_batch_seen"]),
            "shed": int(s["shed"]),
            "mean_batch": round(s["queries"] / s["dispatches"], 2) if s["dispatches"] else 0.0,
        }

    # -- lifecycle ---------------------------------------------------------------

    def start(self) -> None:
        self._thread.start()
        logger.info("DEWI search server on port %d (%d docs)", self.port, len(self.index))

    def serve_forever(self) -> None:
        self.start()
        self._thread.join()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.shutdown()


def retier_index(index: Any, backend: str) -> Any:
    """Re-tier a loaded index's stored corpus into a different backend.

    The stored ids, embeddings and payloads re-ingest into the requested
    backend (exact, int8, int4 or IVF) on the index's device; search defaults, metadata and encoder
    provenance carry over.  Returns ``index`` unchanged when it already
    uses the requested backend.
    """
    from .index import DewiIndex
    from .index.facade import IndexBackend

    want = IndexBackend.from_str(backend).resolve()
    if want is type(index._backend):
        return index
    store = index._backend.store
    retiered = DewiIndex(dim=index.dim, space=index.space, backend=backend,
                         ef_query=index.ef_query, rerank_eta=index.rerank_eta,
                         entropy_pref=index.entropy_pref, device=index.device)
    retiered.add_batch(store.doc_ids, store.embedding_matrix(), store.payload_matrix())
    retiered.encoder = index.encoder
    retiered._meta = dict(index._meta)
    retiered.build()
    return retiered


__all__ = ["MicroBatcher", "OverloadedError", "SearchServer", "query_encoder_for_index",
           "retier_index"]
