"""The port's serving layer (``dewi_tpu_torch.serve``) on a CPU index.

The cases of ``tests/test_serve.py``, run on a port index with
``device="cpu"``: batching semantics, HTTP endpoints, answers equal to
direct search, error isolation, shutdown, stage instrumentation.  Besides:
the JAX package's ``MicroBatcher`` and the port's answer the same requests
over the same corpus; a text query is embedded by the CLIP text tower of
the checkpoint that the index's provenance names and equals
``encode_texts`` + ``search_batch``, and without a usable provenance gets a
400 that says why; the int8-query tier is served through its fused route.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dewi_tpu_torch import DewiIndex, Payload
from dewi_tpu_torch.serve import (MicroBatcher, OverloadedError, SearchServer, _bucket,
                                  query_encoder_for_index, retier_index)

N, DIM = 200, 16


def _make_index(backend="exact", n=N, dim=DIM, seed=0, **kw):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, dim)).astype(np.float32)
    pay = rng.gamma(2.0, size=(n, 8)).astype(np.float32)
    idx = DewiIndex(dim=dim, backend=backend, device="cpu", **kw)
    idx.add_batch([f"d{i}" for i in range(n)], emb, pay)
    idx.build()
    return idx, emb, pay


@pytest.fixture(scope="module")
def index():
    return _make_index()[0]


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def _direct_ids(index, qs, k):
    _, rows = index.search_batch(np.asarray(qs, np.float32), k=k)
    return [[index.doc_ids[j] for j in r] for r in rows.numpy()]


class TestBucket:
    def test_powers_of_two(self):
        assert [_bucket(n, 256) for n in (1, 2, 3, 5, 9, 256, 999)] == [
            1, 2, 4, 8, 16, 256, 256]


class TestMicroBatcher:
    def test_matches_direct_search(self, index):
        mb = MicroBatcher(index, window_ms=1.0)
        try:
            q = np.random.default_rng(1).normal(size=DIM).astype(np.float32)
            ids, scores = mb.search(q, k=5, eta=0.25, entropy_pref=0.1)
            direct = index.search(q, k=5, eta=0.25, entropy_pref=0.1)
            assert ids == [r[0] for r in direct]
            np.testing.assert_allclose(scores, [r[1] for r in direct], rtol=1e-5)
        finally:
            mb.shutdown()

    def test_concurrent_requests_coalesce(self, index):
        mb = MicroBatcher(index, window_ms=25.0, max_batch=64)
        try:
            qs = np.random.default_rng(2).normal(size=(32, DIM)).astype(np.float32)
            futs = [mb.submit(q, k=3) for q in qs]
            results = [f.result(timeout=30) for f in futs]
            assert all(len(ids) == 3 for ids, _ in results)
            assert mb.stats["dispatches"] < mb.stats["queries"]
            assert mb.stats["max_batch_seen"] > 1
            assert [ids for ids, _ in results] == _direct_ids(index, qs, 3)
        finally:
            mb.shutdown()

    def test_mixed_params_split(self, index):
        mb = MicroBatcher(index, window_ms=25.0)
        try:
            q = np.ones(DIM, np.float32)
            f1 = mb.submit(q, k=3, eta=0.0)
            f2 = mb.submit(q, k=3, eta=1.0)
            ids1, _ = f1.result(timeout=30)
            ids2, _ = f2.result(timeout=30)
            assert ids1 == [r[0] for r in index.search(q, k=3, eta=0.0)]
            assert ids2 == [r[0] for r in index.search(q, k=3, eta=1.0)]
            assert mb.stats["dispatches"] == 2
        finally:
            mb.shutdown()

    def test_bad_shape_rejected(self, index):
        mb = MicroBatcher(index)
        try:
            with pytest.raises(ValueError):
                mb.submit(np.ones(DIM + 1, np.float32))
        finally:
            mb.shutdown()

    def test_overload_sheds_with_429_error(self, index):
        mb = MicroBatcher(index, window_ms=50.0, max_batch=4, max_pending=8)
        q = np.ones(DIM, np.float32)
        futs, shed = [], 0
        try:
            for _ in range(64):
                try:
                    futs.append(mb.submit(q, k=2))
                except OverloadedError:
                    shed += 1
            assert shed > 0
            with mb._stats_lock:
                assert mb.stats["shed"] == shed
            for f in futs:
                ids, _ = f.result(timeout=30)
                assert len(ids) == 2
        finally:
            mb.shutdown()

    def test_shutdown_never_strands_in_flight_requests(self, index):
        rng = np.random.default_rng(5)
        for trial in range(10):
            mb = MicroBatcher(index, window_ms=0.1, max_batch=2)
            futures = [mb.submit(rng.normal(size=DIM).astype(np.float32), k=3)
                       for _ in range(32)]
            time.sleep(0.002 * trial)  # vary how many batches are in flight
            mb.shutdown()
            assert not mb._worker.is_alive()
            for f in futures:
                try:
                    f.result(timeout=10)  # a stranded request raises Timeout
                except RuntimeError:
                    pass  # the shutdown error is the other legal outcome

    def test_pipelined_resolution_preserves_order_and_results(self, index):
        mb = MicroBatcher(index, window_ms=1.0, max_batch=16)
        try:
            qs = np.random.default_rng(9).normal(size=(40, DIM)).astype(np.float32)
            futs = [mb.submit(q, k=4) for q in qs]
            for q, f in zip(qs, futs):
                ids, _ = f.result(timeout=30)
                assert ids == [r[0] for r in index.search(q, k=4)]
        finally:
            mb.shutdown()

    def test_launches_come_from_the_worker_thread(self, index, monkeypatch):
        seen = []
        search_batch = index.search_batch
        monkeypatch.setattr(index, "search_batch", lambda *a, **k: seen.append(
            threading.current_thread().name) or search_batch(*a, **k))
        mb = MicroBatcher(index, window_ms=1.0)
        try:
            mb.search(np.ones(DIM, np.float32), k=3)
        finally:
            mb.shutdown()
        assert seen == [MicroBatcher.WORKER_NAME]


class TestSearchServer:
    @pytest.fixture(scope="class")
    def server(self, index):
        srv = SearchServer(index, port=0, window_ms=5.0)
        srv.start()
        yield srv
        srv.shutdown()

    def test_vector_search(self, server, index):
        q = np.random.default_rng(3).normal(size=DIM).astype(np.float32)
        out = _post(server.port, "/search", {"vector": q.tolist(), "k": 4, "eta": 0.25})
        direct = index.search(q, k=4, eta=0.25)
        assert out["ids"] == [r[0] for r in direct]
        np.testing.assert_allclose(out["scores"], [r[1] for r in direct], rtol=1e-5)

    def test_search_batch_endpoint(self, server, index):
        qs = np.random.default_rng(4).normal(size=(6, DIM)).astype(np.float32)
        out = _post(server.port, "/search_batch",
                    {"queries": [{"vector": q.tolist(), "k": 2} for q in qs]})
        assert [r["ids"] for r in out["results"]] == _direct_ids(index, qs, 2)

    def test_healthz(self, server):
        h = _get(server.port, "/healthz")
        assert h["docs"] == N and h["dim"] == DIM
        assert h["queries"] >= 1 and h["dispatches"] >= 1

    def test_bad_request_isolated(self, server):
        for body in (b"{not json", json.dumps({"k": 3}).encode()):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/search", data=body,
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.port, "/nowhere")
        assert e.value.code == 404
        out = _post(server.port, "/search", {"vector": [1.0] * DIM, "k": 2})
        assert len(out["ids"]) == 2

    def test_concurrent_http_load(self, server, index):
        qs = np.random.default_rng(5).normal(size=(24, DIM)).astype(np.float32)
        results = [None] * len(qs)

        def hit(i):
            results[i] = _post(server.port, "/search", {"vector": qs[i].tolist(), "k": 3})

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(qs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert [r["ids"] for r in results] == _direct_ids(index, qs, 3)


@pytest.fixture(scope="module")
def text_index(tmp_path_factory):
    """An index of 60 CLIP-embedded docs whose provenance names the saved
    checkpoint of a seeded tiny CLIP, and that checkpoint's encoder."""
    from dewi_tpu_torch.models import registry
    from dewi_tpu_torch.signals import CrossModalDependency

    ckpt = str(tmp_path_factory.mktemp("clip") / "clip.msgpack")
    registry.save_params(registry.init_clip(registry.clip_config("tiny"), seed=4,
                                            device="cpu"), ckpt)
    enc = CrossModalDependency("tiny", device="cpu", checkpoint=ckpt, batch_size=16)
    texts = [f"document {i} about {w}" for i, w in
             enumerate(["cats", "boats", "maps", "rain", "glass", "tea"] * 10)]
    rng = np.random.default_rng(6)
    idx = DewiIndex(dim=enc.cfg.d_embed, backend="exact", device="cpu")
    idx.add_batch([f"t{i}" for i in range(len(texts))], enc.encode_texts(texts),
                  rng.gamma(2.0, size=(len(texts), 8)).astype(np.float32))
    idx.build()
    idx.encoder = {"model": "tiny", "tokenizer": "byte", "seed": 0, "checkpoint": ckpt,
                   "checkpoint_fingerprint": registry.checkpoint_fingerprint(ckpt),
                   "d_embed": enc.cfg.d_embed}
    return idx, enc


class TestTextQueries:
    def test_text_query_equals_encode_and_search(self, text_index):
        idx, enc = text_index
        queries = ["a boat on the sea", "rain over glass", "document 7", ""]
        srv = SearchServer(idx, port=0, window_ms=5.0)
        srv.start()
        try:
            out = [_post(srv.port, "/search", {"text": q, "k": 5, "eta": 0.2})
                   for q in queries]
            batch = _post(srv.port, "/search_batch",
                          {"queries": [{"text": q, "k": 5, "eta": 0.2} for q in queries]})
        finally:
            srv.shutdown()
        s, rows = idx.search_batch(enc.encode_texts(queries), k=5, eta=0.2)
        for r, rb, want_rows, want_s in zip(out, batch["results"], rows.numpy(), s.numpy()):
            assert r["ids"] == rb["ids"] == [idx.doc_ids[j] for j in want_rows]
            np.testing.assert_allclose(r["scores"], want_s, rtol=1e-6)
        assert srv._encoder is not None and srv._encoder.device.type == "cpu"

    @pytest.mark.parametrize("case,reason", [
        ("none", "no encoder provenance"),
        ("external", "supplied externally"),
        ("seed_only", "not portable"),
        ("missing_checkpoint", "does not exist here"),
    ])
    def test_text_query_refused_with_the_reason(self, text_index, case, reason):
        idx, _ = text_index
        prov = {"none": None, "external": {"source": "external"},
                "seed_only": {"model": "tiny", "tokenizer": "byte", "seed": 0,
                              "checkpoint": None},
                "missing_checkpoint": dict(idx.encoder, checkpoint="/nonexistent/clip.msgpack"),
                }[case]
        saved = idx.encoder
        idx.encoder = prov
        srv = SearchServer(idx, port=0, window_ms=5.0)
        srv.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv.port, "/search", {"text": "a red bicycle", "k": 3})
            assert e.value.code == 400
            assert reason in json.loads(e.value.read())["error"]
            with pytest.raises(ValueError, match=reason):
                srv.encode_text("x")
            # Vector queries are still served.
            out = _post(srv.port, "/search", {"vector": [0.1] * idx.dim, "k": 2})
            assert len(out["ids"]) == 2
        finally:
            srv.shutdown()
            idx.encoder = saved

    def test_changed_checkpoint_warns(self, text_index, caplog):
        idx, _ = text_index
        prov = dict(idx.encoder, checkpoint_fingerprint="0" * 16)
        probe = type("Probe", (), {"encoder": prov, "device": idx.device})()
        with caplog.at_level("WARNING", logger="dewi_tpu_torch.serve"):
            enc = query_encoder_for_index(probe)
        assert "changed since the index was built" in caplog.text
        assert enc.cfg.d_embed == idx.dim


class TestServeRetier:
    def test_retier_index_helper(self, tmp_path):
        rng = np.random.default_rng(0)
        n, d = 64, 16
        idx = DewiIndex(dim=d, backend="exact", rerank_eta=0.4, device="cpu")
        pay = [Payload(dewi=float(x)) for x in rng.uniform(size=n)]
        idx.add_batch([str(i) for i in range(n)], rng.normal(size=(n, d)).astype(np.float32),
                      np.stack([p.to_array() for p in pay]))
        idx.encoder = {"source": "external"}
        idx._meta["0"] = {"k": "v"}
        idx.build()
        idx.save(tmp_path / "idx")

        loaded = DewiIndex.load(tmp_path / "idx", device="cpu")
        retiered = retier_index(loaded, "quantized")
        assert type(retiered._backend).__name__ == "QuantizedIndex"
        assert retiered.encoder == loaded.encoder
        assert retiered.rerank_eta == loaded.rerank_eta
        assert retiered._meta == {"0": {"k": "v"}}
        assert retiered.device == loaded.device
        assert retier_index(retiered, "quantized") is retiered
        q = rng.normal(size=d).astype(np.float32)
        a = [i for i, _s, _p in loaded.search(q, k=5, eta=0.3)]
        b = [i for i, _s, _p in retiered.search(q, k=5, eta=0.3)]
        assert len(set(a) & set(b)) >= 4


    def test_retier_to_ivf(self):
        """``retier_index(index, "ivf")`` re-ingests into an IVFIndex whose
        default buckets (nlist 100 clamps to the corpus) answer as exact
        search does at full probe."""
        idx, _, _ = _make_index()
        ivf = retier_index(idx, "ivf")
        assert type(ivf._backend).__name__ == "IVFIndex" and len(ivf) == N
        assert ivf._built and ivf._backend._dev is not None
        assert retier_index(ivf, "faiss_ivfflat") is ivf
        q = np.random.default_rng(1).normal(size=(4, DIM)).astype(np.float32)
        _, want = idx.search_batch(q, k=5)
        _, got = ivf.search_batch(q, k=5)
        hits = [len(set(a.tolist()) & set(b.tolist())) for a, b in zip(got.numpy(),
                                                                       want.numpy())]
        assert sum(hits) >= 12  # nprobe 8 of 100 single-digit buckets + the DEWI tier

    def test_served_ivf_query_over_http(self):
        """A served IVF result drops its -1 ids (exhausted pool, deduped
        slots) as the reference does: ids and scores stay aligned."""
        idx, _, _ = _make_index(backend="ivf", n=24, nlist=8, nprobe=1, kmeans_iters=4,
                                dewi_tier=0, spill_frac=1.0)
        q = np.random.default_rng(2).normal(size=DIM).astype(np.float32)
        scores, rows = idx.search_batch(q, k=20)
        rows, scores = rows.numpy()[0], scores.numpy()[0]
        assert (rows < 0).any()
        srv = SearchServer(idx, port=0, window_ms=1.0)
        srv.start()
        try:
            out = _post(srv.port, "/search", {"vector": q.tolist(), "k": 20})
        finally:
            srv.shutdown()
        assert out["ids"] == [idx.doc_ids[j] for j in rows if j >= 0]
        assert len(out["ids"]) == len(set(out["ids"])) == len(out["scores"])
        np.testing.assert_allclose(out["scores"], scores[rows >= 0], rtol=1e-6)


class TestSmallCorpusK:
    def test_k_exceeding_corpus_filters_pad_rows(self):
        idx, _, _ = _make_index(n=5, dim=8)
        b = MicroBatcher(idx, window_ms=1.0)
        try:
            ids, scores = b.search(np.random.default_rng(0).normal(size=8).astype(np.float32),
                                   k=10)
            assert len(ids) == 5
            assert all(i.startswith("d") for i in ids)
            assert all(np.isfinite(s) for s in scores)
        finally:
            b.shutdown()


class TestStageInstrumentation:
    def test_stage_summary_rows_sum_to_total(self, index):
        mb = MicroBatcher(index, window_ms=1.0)
        try:
            rng = np.random.default_rng(3)
            for _ in range(12):
                mb.search(rng.normal(size=DIM).astype(np.float32), k=3, eta=0.2,
                          entropy_pref=0.0)
            summ = mb.stage_summary()
        finally:
            mb.shutdown()
        assert set(summ) == set(MicroBatcher.STAGE_NAMES) | {"n"}
        assert summ["n"] == 12
        for name in MicroBatcher.STAGE_NAMES:
            assert 0.0 <= summ[name]["p50_ms"] <= summ[name]["p95_ms"]
            assert summ[name]["mean_ms"] >= 0.0
        comp = sum(summ[s]["mean_ms"] for s in MicroBatcher.STAGE_NAMES if s != "total")
        assert comp == pytest.approx(summ["total"]["mean_ms"], rel=0.05, abs=0.01)

    def test_stage_summary_reset(self, index):
        mb = MicroBatcher(index, window_ms=1.0)
        try:
            mb.search(np.ones(DIM, np.float32), k=3)
            assert mb.stage_summary(reset=True)["n"] == 1
            assert mb.stage_summary() == {}
        finally:
            mb.shutdown()

    def test_stats_stages_endpoint(self, index):
        server = SearchServer(index, port=0, window_ms=1.0)
        server.start()
        try:
            _post(server.port, "/search", {"vector": [1.0] * DIM, "k": 3})
            stages = _get(server.port, "/stats_stages")
            assert stages["n"] >= 1
            assert set(stages) == set(MicroBatcher.STAGE_NAMES) | {"n"}
        finally:
            server.shutdown()


class TestAgainstJax:
    def test_jax_and_port_batchers_answer_alike(self):
        """The JAX package's MicroBatcher and the port's, over the same
        corpus and the same concurrent requests (mixed eta), give the same
        ids and scores."""
        from dewi_tpu.index.facade import DewiIndex as JDewiIndex
        from dewi_tpu.serve import MicroBatcher as JMicroBatcher

        port, emb, pay = _make_index(seed=11)
        ref = JDewiIndex(dim=DIM, backend="exact")
        ref.add_batch(port.doc_ids, emb, pay)
        ref.build()
        qs = np.random.default_rng(12).normal(size=(20, DIM)).astype(np.float32)
        answers = []
        for cls, ix in ((JMicroBatcher, ref), (MicroBatcher, port)):
            mb = cls(ix, window_ms=10.0, max_batch=8)
            try:
                futs = [mb.submit(q, k=5, eta=0.1 * (i % 3), entropy_pref=0.2)
                        for i, q in enumerate(qs)]
                answers.append([f.result(timeout=60) for f in futs])
            finally:
                mb.shutdown()
        for (ids_j, s_j), (ids_p, s_p) in zip(*answers):
            assert ids_p == ids_j
            np.testing.assert_allclose(s_p, s_j, rtol=1e-5, atol=1e-6)

    def test_int8_query_tier_served_through_bmax_s8(self, monkeypatch):
        """At cap 65,536 the int8-query tier takes the fused ``bmax_s8``
        route from the worker thread; served answers equal direct search."""
        from dewi_tpu_torch.ops import cuda_search

        idx, _, _ = _make_index("int8", n=40_000, dim=32, seed=13, int8_queries=True)
        assert idx._backend.store.capacity == 65536
        threads = []
        fn = cuda_search.bmax_s8
        monkeypatch.setattr(cuda_search, "bmax_s8", lambda *a, **k: threads.append(
            threading.current_thread().name) or fn(*a, **k))
        qs = np.random.default_rng(14).normal(size=(10, 32)).astype(np.float32)
        srv = SearchServer(idx, port=0, window_ms=20.0)
        srv.start()
        try:
            out = _post(srv.port, "/search_batch",
                        {"queries": [{"vector": q.tolist(), "k": 10} for q in qs]})
        finally:
            srv.shutdown()
        assert threads and set(threads) == {MicroBatcher.WORKER_NAME}
        s, rows = idx.search_batch(qs, k=10)
        for r, want_rows, want_s in zip(out["results"], rows.numpy(), s.numpy()):
            assert r["ids"] == [idx.doc_ids[j] for j in want_rows]
            np.testing.assert_allclose(r["scores"], want_s, rtol=1e-6)


@pytest.mark.cuda
def test_card_served_answers_equal_direct_search():
    """On the card: the worker launches, the resolver waits on the batch's
    CUDA event and copies on its own stream; every served answer equals a
    direct ``search_batch`` of its query (int8-query tier, fused route)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    rng = np.random.default_rng(15)
    n, dim = 40_000, 64
    idx = DewiIndex(dim=dim, backend="int8", int8_queries=True)
    idx.add_batch([f"d{i}" for i in range(n)], rng.normal(size=(n, dim)).astype(np.float32),
                  rng.gamma(2.0, size=(n, 8)).astype(np.float32))
    idx.build()
    qs = rng.normal(size=(48, dim)).astype(np.float32)
    mb = MicroBatcher(idx, window_ms=5.0)
    try:
        results = [f.result(timeout=60) for f in [mb.submit(q, k=10) for q in qs]]
    finally:
        mb.shutdown()
    s, rows = idx.search_batch(qs, k=10)
    for (ids, scores), want_rows, want_s in zip(results, rows.cpu().numpy(), s.cpu().numpy()):
        assert ids == [idx.doc_ids[j] for j in want_rows]
        np.testing.assert_allclose(scores, want_s, rtol=0, atol=1e-6)
