"""The port's eval harness, metrics, schemas and compatibility shims against
the JAX package's.

Same seeded numpy inputs through both; the port runs on the CPU.
Tolerances: the metrics are the same float64 arithmetic, so equal; the eval
reports equal (the same ids from both indexes: an exact f32 index and an
int8 index, each held to the reference's); the schema files byte-equal.
"""

import json

import numpy as np
import pytest

from dewi_tpu import eval as j_eval
from dewi_tpu import metrics as jm
from dewi_tpu.config import EvalConfig as JEvalConfig
from dewi_tpu_torch import eval as t_eval
from dewi_tpu_torch import metrics as tm
from dewi_tpu_torch.config import EvalConfig


def _rankings(seed, n_queries=30, n_docs=80):
    rng = np.random.default_rng(seed)
    docs = [f"d{i}" for i in range(n_docs)]
    gt = {f"q{q}": list(rng.choice(docs, rng.integers(1, 6), replace=False))
          for q in range(n_queries)}
    ranked = {f"q{q}": list(rng.choice(docs, rng.integers(0, 25), replace=False))
              for q in range(n_queries) if q % 7}  # some queries have no ranking
    rel = {q: {d: int(rng.integers(1, 4)) for d in ds} for q, ds in gt.items()}
    dewi = {d: float(rng.random()) for d in docs}
    return docs, gt, ranked, rel, dewi


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal(seed):
    docs, gt, ranked, rel, dewi = _rankings(seed)
    for k in (1, 5, 10, 20):
        assert tm.recall_at_k(gt, ranked, k=k) == jm.recall_at_k(gt, ranked, k=k)
        assert tm.ndcg_at_k(rel, ranked, k=k) == jm.ndcg_at_k(rel, ranked, k=k)
    assert tm.mrr(gt, ranked) == jm.mrr(gt, ranked)
    gains = list(np.random.default_rng(seed).random(12))
    assert tm.dcg_at_k(gains) == jm.dcg_at_k(gains)
    bins = [0.0, 0.25, 0.5, 0.75, 1.0]
    assert tm.stratify_by_dewi(bins, dewi, ranked) == jm.stratify_by_dewi(bins, dewi, ranked)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 50, (20, 10))
    b = rng.integers(0, 50, (20, 10))
    assert tm.recall_matrix(a, b) == jm.recall_matrix(a, b)
    first = rng.integers(0, 50, 20)
    assert tm.mrr_matrix(a, first) == jm.mrr_matrix(a, first)
    clusters = [list(rng.choice(docs, rng.integers(1, 5), replace=False)) for _ in range(9)]
    picked = list(rng.choice(docs, 10, replace=False))
    assert tm.cluster_coverage(picked, clusters) == jm.cluster_coverage(picked, clusters)
    assert tm.duplicate_rate(clusters) == jm.duplicate_rate(clusters)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    n, d = 300, 32
    emb = rng.normal(size=(n, d)).astype(np.float32)
    pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    pay[:, 0] = rng.beta(2, 2, n)
    ids = [f"d{i}" for i in range(n)]
    src = rng.choice(n, 70, replace=False)  # more queries than one search group
    queries = emb[src] + 0.05 * rng.normal(size=(70, d)).astype(np.float32)
    gt = {f"q{i}": [f"d{s}", f"d{(s + 1) % n}"] for i, s in enumerate(src)}
    return emb, pay, ids, queries.astype(np.float32), gt


def _pair(corpus, backend, **kw):
    from dewi_tpu import DewiIndex as JDewiIndex
    from dewi_tpu_torch import DewiIndex

    emb, pay, ids, _, _ = corpus
    port = DewiIndex(dim=emb.shape[1], backend=backend, device="cpu", **kw)
    ref = JDewiIndex(dim=emb.shape[1], backend=backend, **kw)
    for index in (port, ref):
        index.add_batch(ids, emb, pay)
        index.build()
    if backend == "int8":
        ref._backend.approx_select = False  # the port's select is exact
    return port, ref


@pytest.mark.parametrize("backend,kw", [("exact", {}), ("int8", {}),
                                        ("int8", {"int8_queries": True})],
                         ids=["exact", "int8", "int8_s8"])
@pytest.mark.parametrize("eta,ep", [(0.0, 0.0), (0.5, 1.0)])
def test_evaluate_index_equal(corpus, backend, kw, eta, ep):
    port, ref = _pair(corpus, backend, **kw)
    _, _, _, queries, gt = corpus
    qids = list(gt)
    for cfg in (None, (EvalConfig(recall_k=[2, 7], ndcg_k=[3], mrr=False, dewi_bins=[]),
                       JEvalConfig(recall_k=[2, 7], ndcg_k=[3], mrr=False, dewi_bins=[]))):
        got = t_eval.evaluate_index(port, queries, gt, query_ids=qids, eta=eta,
                                    entropy_pref=ep, config=cfg and cfg[0])
        want = j_eval.evaluate_index(ref, queries, gt, query_ids=qids, eta=eta,
                                     entropy_pref=ep, config=cfg and cfg[1])
        assert got == want


def test_evaluate_index_groups_queries(corpus, monkeypatch):
    """The queries go to ``search_batch`` in groups of ``QUERY_GROUP``, and
    the report equals one call over all of them."""
    port, _ = _pair(corpus, "exact")
    _, _, _, queries, gt = corpus
    sizes = []
    search = port.search_batch
    monkeypatch.setattr(port, "search_batch",
                        lambda q, **kw: sizes.append(len(q)) or search(q, **kw))
    report = t_eval.evaluate_index(port, queries, gt, query_ids=list(gt))
    assert sizes == [32, 32, 6]
    monkeypatch.setattr(t_eval, "QUERY_GROUP", 1000)
    assert t_eval.evaluate_index(port, queries, gt, query_ids=list(gt)) == report


def test_recall_vs_exact_equal(corpus):
    port_q, ref_q = _pair(corpus, "int8")
    port_e, ref_e = _pair(corpus, "exact")
    rng = np.random.default_rng(1)
    q = rng.normal(size=(40, 32)).astype(np.float32)
    for eta, ep in ((0.0, 0.0), (0.25, 0.1)):
        got = t_eval.recall_vs_exact(port_q, port_e, q, k=10, eta=eta, entropy_pref=ep)
        want = j_eval.recall_vs_exact(ref_q, ref_e, q, k=10, eta=eta, entropy_pref=ep)
        assert got == want and got >= 0.99


def test_schemas_equal(tmp_path):
    pytest.importorskip("pydantic")
    from dewi_tpu import schemas as js
    from dewi_tpu_torch import schemas as ts

    got = ts.export(tmp_path / "port")
    want = js.export(tmp_path / "ref")
    assert [p.name for p in got] == [p.name for p in want]
    for a, b in zip(got, want):
        assert a.read_bytes() == b.read_bytes()
    props = json.loads((tmp_path / "port" / "dewi_config.schema.json").read_text())["properties"]
    assert {"text", "image", "scoring", "index", "mesh"} <= set(props)


def test_schemas_import_no_pydantic():
    import subprocess
    import sys

    code = ("import sys, dewi_tpu_torch.schemas; "
            "sys.exit(1 if 'pydantic' in sys.modules else 0)")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0


# ---- the reference's compatibility import surfaces -------------------------------


class TestBackendsShim:
    def test_reference_imports(self):
        from dewi_tpu_torch.backends import (_HAS_FAISS, _HAS_HNSW, BACKEND_CLASSES, BaseIndex,
                                             DocStore, FAISSIndex, HNSWIndex, IndexBackend,
                                             IVFIndex)

        assert _HAS_FAISS is True and _HAS_HNSW is True
        assert issubclass(HNSWIndex, BaseIndex) and issubclass(FAISSIndex, BaseIndex)
        assert FAISSIndex is IVFIndex and BACKEND_CLASSES["FAISSIndex"] is IVFIndex
        assert DocStore is not None
        assert IndexBackend.from_str("auto") is IndexBackend.EXACT
        assert IndexBackend.from_str("faiss_ivfflat") is IndexBackend.FAISS_IVFFLAT

    def test_hnsw_alias_searches_like_the_reference(self):
        from dewi_tpu.backends import HNSWIndex as JHNSW
        from dewi_tpu_torch.backends import HNSWIndex

        rng = np.random.default_rng(42)
        emb = rng.normal(size=(64, 32)).astype(np.float32)
        pay = rng.random((64, 8)).astype(np.float32)
        q = rng.normal(size=32).astype(np.float32)
        port, ref = HNSWIndex(dim=32, device="cpu"), JHNSW(dim=32)
        for idx in (port, ref):
            idx.add_batch([str(i) for i in range(64)], emb, pay)
            idx.build()
        got, want = port.search(q, k=3), ref.search(q, k=3)
        assert [d for d, _, _ in got] == [d for d, _, _ in want]
        np.testing.assert_allclose([s for _, s, _ in got], [s for _, s, _ in want], atol=1e-5)


class TestRobustShim:
    def test_payload_fit_surface(self, dummy_payloads):
        from dewi_tpu.robust import RobustStats as JRobustStats
        from dewi_tpu_torch.robust import PAYLOAD_STAT_FIELDS, RobustStats
        from dewi_tpu_torch.types import Payload

        payloads = [Payload(**p.to_dict()) for p in dummy_payloads]
        stats = RobustStats.from_payloads(payloads, device="cpu")
        want = JRobustStats.from_payloads(dummy_payloads)
        assert set(stats.keys) == set(PAYLOAD_STAT_FIELDS)
        for key in PAYLOAD_STAT_FIELDS:
            assert stats.z(key, 5.0) == pytest.approx(want.z(key, 5.0), rel=1e-6)

    def test_robust_standardize_helper(self):
        from dewi_tpu.robust import _robust_standardize as j_std
        from dewi_tpu_torch.robust import _robust_standardize

        assert _robust_standardize(2.0, 1.0, 0.5) == j_std(2.0, 1.0, 0.5)
        assert _robust_standardize(2.0, 1.0, 0.5) == pytest.approx(
            (2.0 - 1.0) / (1.4826 * (0.5 + 1e-8)), rel=1e-9)


def test_local_weights_shim():
    from dewi_tpu.local_weights import local_weights_from_surprisal as j_lw
    from dewi_tpu_torch.local_weights import local_weights_from_surprisal

    s = np.random.default_rng(42).gamma(2.0, 1.0, size=50).astype(np.float32)
    w = local_weights_from_surprisal(s, device="cpu")
    assert w.shape == (50,) and np.all(w > 0)
    np.testing.assert_allclose(w, np.asarray(j_lw(s)), rtol=1e-6)
