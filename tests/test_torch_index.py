"""The port's store and indexes against the JAX package's, end to end.

Both packages index the same seeded corpus.  The port runs on the CPU
(``device="cpu"``), where each kernel wrapper computes its plain version;
the JAX side runs the same index configuration on the CPU.  At 60k docs
(cap 65,536) the port's int8/int4 tiers take the fused block-max route,
whose selection math is the same as JAX's two-pass block max; the exact
bf16 tier's stage-1 kernel rounds the query to bf16, so it is held
against JAX's ``fused_search`` on its Pallas route (interpret mode).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dewi_tpu import DewiIndex as JDewiIndex
from dewi_tpu import DewiScorer as JDewiScorer
from dewi_tpu.ops import similarity as jsim
from dewi_tpu_torch import (DewiIndex, DewiScorer, Payload, Signals, Weights,
                            index_from_numpy_state, stats_from_numpy_state)
from dewi_tpu_torch.index import DocStore
from dewi_tpu_torch.index import ExactIndex as ExactIndexPort
from dewi_tpu_torch.ops import cuda_search

from test_torch_search import assert_same_topk

N, DIM, NQ = 60_000, 32, 7
ETA, EP = 0.3, 0.2


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(N, DIM)).astype(np.float32)
    pay = np.abs(rng.normal(size=(N, 8))).astype(np.float32)
    ids = [f"d{i}" for i in range(N)]
    q = rng.normal(size=(NQ, DIM)).astype(np.float32)
    return ids, emb, pay, q


def _pair(corpus, backend, space="cosine", **kw):
    ids, emb, pay, _ = corpus
    jkw = dict(kw)
    if kw.get("dtype") is torch.bfloat16:
        jkw["dtype"] = jnp.bfloat16
    port = DewiIndex(dim=DIM, space=space, backend=backend, device="cpu", **kw)
    ref = JDewiIndex(dim=DIM, space=space, backend=backend, **jkw)
    for ix in (port, ref):
        ix.add_batch(ids, emb, pay)
        ix.build()
    return port, ref


# ---- DocStore ------------------------------------------------------------


def test_docstore_growth_and_mask():
    st = DocStore(4, device="cpu")
    assert st.capacity == 1024
    st.add_batch([f"a{i}" for i in range(1500)], np.ones((1500, 4), np.float32),
                 np.zeros((1500, 8), np.float32))
    assert st.capacity == 2048 and len(st) == 1500
    st.add("x", np.ones(4, np.float32), Payload(dewi=0.5))
    emb, sqn, pay, n = st.device_arrays()
    assert emb.shape == (2048, 4) and n == 1501
    np.testing.assert_allclose(sqn[:n].numpy(), 1.0, rtol=1e-6)
    assert float(pay[1500, 0]) == 0.5 and float(emb[1600].abs().sum()) == 0.0
    p = st.get_payload("x")
    p.dewi = 0.9  # live write-back
    assert float(st.device_arrays()[2][1500, 0]) == pytest.approx(0.9)
    with pytest.raises(ValueError):
        st.add("bad", np.ones(5, np.float32), Payload())


def test_padding_rows_never_returned():
    rng = np.random.default_rng(1)
    for backend in ("exact", "int8", "int4"):
        ix = DewiIndex(dim=32, backend=backend, device="cpu")
        ix.add_batch([f"d{i}" for i in range(20)], rng.normal(size=(20, 32)),
                     np.zeros((20, 8), np.float32))
        s, i = ix.search_batch(rng.normal(size=(3, 32)).astype(np.float32), k=10)
        assert int(i.max()) < 20 and torch.isfinite(s).all()


# ---- attach_device ---------------------------------------------------------


def _small(n=64, d=32, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    return [str(i) for i in range(n)], emb, pay, rng


@pytest.mark.parametrize("backend,kw", [("exact", {}), ("exact", {"space": "l2"}),
                                        ("exact", {"dtype": torch.bfloat16}),
                                        ("int8", {}), ("ivf", {"nlist": 4, "nprobe": 4})])
def test_attach_matches_add_batch(backend, kw):
    """A corpus attached as tensors searches as one filled by ``add_batch``,
    and as the JAX store filled through its own ``attach_device``."""
    ids, emb, pay, rng = _small()
    a = DewiIndex(dim=32, backend=backend, device="cpu", **kw)
    a.add_batch(ids, emb, pay)
    b = DewiIndex(dim=32, backend=backend, device="cpu", **kw)
    b._backend.store.attach_device(ids, torch.from_numpy(emb), torch.from_numpy(pay))
    assert b._backend.store._host_stale and len(b) == 64
    assert b._backend.store.capacity == 1024
    q = rng.normal(size=(5, 32)).astype(np.float32)
    sa, ia = a.search_batch(q, k=5, eta=0.3, entropy_pref=0.1)
    sb, ib = b.search_batch(q, k=5, eta=0.3, entropy_pref=0.1)
    assert torch.equal(ia, ib) and torch.equal(sa, sb)
    assert b._backend.store._host_stale  # searching fetched nothing
    if backend == "exact":
        jkw = {k: (jnp.bfloat16 if v is torch.bfloat16 else v) for k, v in kw.items()}
        ref = JDewiIndex(dim=32, backend="exact", **jkw)
        ref._backend.store.attach_device(ids, jnp.asarray(emb), jnp.asarray(pay))
        s_ref, i_ref = ref.search_batch(q, k=5, eta=0.3, entropy_pref=0.1)
        tol = 1e-2 if kw.get("dtype") is torch.bfloat16 else 1e-5
        assert_same_topk(sb, ib, s_ref, i_ref, rtol=tol, atol=tol)
    ra = a.search(q[0], k=5, eta=0.3, entropy_pref=0.1)
    rb = b.search(q[0], k=5, eta=0.3, entropy_pref=0.1)
    assert [r[0] for r in ra] == [r[0] for r in rb]
    for (_, _, pa), (_, _, pb) in zip(ra, rb):
        assert pa.dewi == pytest.approx(pb.dewi, abs=1e-6)


def test_attach_then_host_accessors_and_save(tmp_path):
    ids, emb, pay, rng = _small()
    idx = DewiIndex(dim=32, device="cpu")
    store = idx._backend.store
    store.attach_device(ids, torch.from_numpy(emb), torch.from_numpy(pay))
    p = idx.get_payload("3")  # lazy host fetch
    assert p is not None and p.dewi == pytest.approx(float(pay[3, 0]), abs=1e-6)
    assert not store._host_stale and store.capacity >= 64
    assert len(store.payload_matrix()) == 64
    # the mirror holds the device's rows: normalized for a cosine store
    np.testing.assert_allclose(idx.get_embedding("3"), emb[3] / np.linalg.norm(emb[3]),
                               rtol=1e-6)
    store.attach_device(ids, torch.from_numpy(emb), torch.from_numpy(pay))
    idx.set_dewi_scores(np.linspace(0, 1, 64, dtype=np.float32))
    assert float(store.device_arrays()[2][63, 0]) == 1.0
    store.attach_device(ids, torch.from_numpy(emb), torch.from_numpy(pay))
    idx.build()
    idx.save(tmp_path / "ix")
    loaded = DewiIndex.load(tmp_path / "ix", device="cpu")
    q = rng.normal(size=32).astype(np.float32)
    assert [r[0] for r in idx.search(q, k=5)] == [r[0] for r in loaded.search(q, k=5)]
    ref = JDewiIndex.load(tmp_path / "ix")
    assert [r[0] for r in ref.search(q, k=5)] == [r[0] for r in loaded.search(q, k=5)]


def test_attach_validation():
    store = DocStore(dim=8, device="cpu")
    with pytest.raises(ValueError, match="embeddings"):
        store.attach_device(["a"], torch.zeros(1, 4), torch.zeros(1, 8))
    with pytest.raises(ValueError, match="mismatch"):
        store.attach_device(["a", "b"], torch.zeros(1, 8), torch.zeros(1, 8))
    with pytest.raises(ValueError, match="mismatch"):
        store.attach_device(["a"], torch.zeros(1, 8), torch.zeros(1, 7))
    with pytest.raises(ValueError, match="lie on"):
        store.attach_device(["a"], torch.zeros(1, 8, device="meta"), torch.zeros(1, 8))
    store.attach_device(["a"], np.ones((1, 8), np.float32), np.zeros((1, 8), np.float32))
    assert len(store) == 1 and store.device_arrays()[3] == 1


def test_add_after_attach_buffers_and_merges_on_device():
    """Adds to a device-resident store are buffered and merged on the device
    (the reference's cases, tests/test_index.py:305-330, 641-657)."""
    ids, emb, pay, rng = _small()
    idx = ExactIndexPort(dim=32, device="cpu")
    idx.store.attach_device(ids, torch.from_numpy(emb), torch.from_numpy(pay))
    idx.build()
    q = rng.normal(size=32).astype(np.float32)
    idx.add("new", (q / np.linalg.norm(q)).astype(np.float32), Payload(dewi=0.9))
    idx.add_batch(["n2", "n3"], -np.stack([q, q]), np.zeros((2, 8), np.float32))
    assert idx.store._host_stale and len(idx) == 67  # still device-resident
    idx.build()
    _, row = idx.search_batch(q, k=1, eta=0.0, entropy_pref=0.0)
    assert idx.store.doc_ids[int(row[0, 0])] == "new"  # the exact match ranks first
    assert idx.store._host_stale and idx.store.device_arrays()[3] == 67
    assert idx.get_payload("new").dewi == pytest.approx(0.9, abs=1e-6)
    # past the device capacity: the arrays grow on the device
    n = 1024
    s = DocStore(dim=16, device="cpu")
    s.attach_device([str(i) for i in range(n)], torch.randn(n, 16), torch.rand(n, 8))
    s.add("extra", np.ones(16, np.float32), Payload(dewi=0.5))
    emb_d, sqn_d, pay_d, nv = s.device_arrays()
    assert emb_d.shape == (2048, 16) and nv == n + 1 and s.capacity == 2048
    assert float(sqn_d[n]) == pytest.approx(1.0, rel=1e-6) and float(pay_d[n, 0]) == 0.5
    s2 = DocStore(dim=16, device="cpu")
    s2.attach_device([str(i) for i in range(n)], torch.randn(n, 16), torch.rand(n, 8))
    s2.add("extra", np.ones(16, np.float32), Payload(dewi=0.5))
    assert abs(s2.get_payload("extra").dewi - 0.5) < 1e-6  # host sync folds it in
    assert s2.payload_matrix().shape[0] == n + 1 and s2.device_arrays()[3] == n + 1


def test_attach_device_clears_pending_adds():
    rng = np.random.default_rng(0)
    n, d = 64, 8
    s = DocStore(dim=d, device="cpu")
    s.attach_device([f"a{i}" for i in range(n)], torch.randn(n, d), torch.rand(n, 8))
    s.add("ghost", np.ones(d, np.float32), Payload(dewi=0.5))
    s.attach_device([f"b{i}" for i in range(n)],
                    rng.normal(size=(n, d)).astype(np.float32),
                    np.abs(rng.normal(size=(n, 8))).astype(np.float32))
    _, _, _, nv = s.device_arrays()
    assert nv == n and len(s) == n and "ghost" not in s.doc_ids


# ---- DewiIndex tiers at the fused-route size -------------------------------


@pytest.mark.parametrize("backend,kw", [
    ("exact", {}),
    ("int8", {}),
    ("int4", {}),
    ("int4", {"blockmax_select": False}),
    ("exact", {"space": "l2"}),
    ("int8", {"space": "l2"}),
    ("int8", {"int8_queries": True}),
    ("int8", {"int8_queries": True, "blockmax_select": False}),
    ("int8", {"int8_queries": True, "space": "l2"}),
])
def test_index_tiers_match_jax(corpus, backend, kw):
    port, ref = _pair(corpus, backend, **kw)
    q = corpus[3]
    s, i = port.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    s_ref, i_ref = ref.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    assert_same_topk(s, i, s_ref, i_ref)


def test_index_routes_to_fused_kernels(corpus, monkeypatch):
    """At cap 65,536 the quantized tiers take the fused kernel route and
    int4 with blockmax off takes the scores kernel (counted by spying on
    the wrappers, since plain CPU calls count no launch)."""
    calls = []
    for name in ("bmax", "bmax_s4", "scores_matrix", "scores_matrix_s4", "bmax_s8",
                 "scores_matrix_s8", "bmax_t", "bmax_s8_t"):
        fn = getattr(cuda_search, name)
        monkeypatch.setattr(cuda_search, name,
                            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    q = corpus[3]
    for backend, kw, want in [("int8", {}, "bmax"), ("int4", {}, "bmax_s4"),
                              ("int4", {"blockmax_select": False}, "scores_matrix_s4"),
                              ("int8", {"int8_queries": True}, "bmax_s8"),
                              ("int8", {"int8_queries": True, "blockmax_select": False},
                               "scores_matrix_s8")]:
        port = DewiIndex(dim=DIM, backend=backend, device="cpu", **kw)
        port.add_batch(corpus[0], corpus[1], corpus[2])
        calls.clear()
        port.search_batch(q, k=10)
        assert calls == [want]


def test_int8_query_tier_in_query_groups(corpus, monkeypatch):
    """Above 32 queries the int8-query tier runs ``bmax_s8`` once per
    32-query group (the last one padded) and still returns JAX's answers."""
    port, ref = _pair(corpus, "int8", int8_queries=True)
    calls = []
    fn = cuda_search.bmax_s8
    monkeypatch.setattr(cuda_search, "bmax_s8",
                        lambda *a, **k: calls.append(a[3].shape[0]) or fn(*a, **k))
    q = np.random.default_rng(5).normal(size=(40, DIM)).astype(np.float32)
    s, i = port.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    assert calls == [32, 32]
    s_ref, i_ref = ref.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    assert_same_topk(s, i, s_ref, i_ref)


def test_exact_bf16_matches_jax_kernel_route(corpus):
    port, ref = _pair(corpus, "exact", dtype=torch.bfloat16)
    q = corpus[3]
    s, i = port.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    emb, sqn, pay, n = ref._backend.store.device_arrays()
    s_ref, i_ref = jsim.fused_search(emb, sqn, pay, jnp.asarray(q), n, jnp.float32(ETA),
                                     jnp.float32(EP), k=10, pallas_scores=True,
                                     blockmax_select=True, interpret=True)
    assert_same_topk(s, i, s_ref, i_ref)


@pytest.mark.parametrize("backend,kw", [
    ("exact", {"dtype": torch.bfloat16}),
    ("int4", {"blockmax_select": False}),
])
def test_many_queries_take_the_chunked_f32_dot(corpus, backend, kw):
    """Above 32 queries these tiers score the whole store with a full-f32
    product, converting the bf16/int8 rows in ROW_CHUNK steps."""
    port, ref = _pair(corpus, backend, **kw)
    q = np.random.default_rng(4).normal(size=(40, DIM)).astype(np.float32)
    s, i = port.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    s_ref, i_ref = ref.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    assert_same_topk(s, i, s_ref, i_ref)


# ---- README quick start, save/load, state carried across -------------------


def _quickstart(make_index, make_scorer, n=2000, dim=64):
    rng = np.random.default_rng(0)
    index = make_index(dim)
    rows = []
    for i in range(n):
        sig = Signals(ht_mean=rng.gamma(2, 1.5), ht_q90=rng.gamma(2.5, 1.5),
                      hi_mean=rng.gamma(2, 1), hi_q90=rng.gamma(2.5, 1),
                      I_hat=rng.beta(2, 5), redundancy=rng.beta(1, 4),
                      noise=rng.beta(1, 9))
        rows.append(sig)
        index.add(f"doc{i}", rng.normal(size=dim).astype(np.float32),
                  Payload(dewi=0.0, **sig.__dict__))
    scorer = make_scorer()
    scorer.fit_stats(rows)
    index.set_dewi_scores(np.asarray(scorer.score_batch(rows)))
    index.build()
    q = rng.normal(size=dim).astype(np.float32)
    return index, q, index.search(q, k=10, eta=0.3, entropy_pref=0.5)


def test_readme_quickstart_matches_jax():
    port, q, got = _quickstart(lambda d: DewiIndex(dim=d, space="cosine", device="cpu"),
                               lambda: DewiScorer(Weights(), device="cpu"))
    _, _, want = _quickstart(lambda d: JDewiIndex(dim=d, space="cosine"),
                             lambda: JDewiScorer())
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want], rtol=1e-5)
    np.testing.assert_allclose([r[2].dewi for r in got], [r[2].dewi for r in want],
                               rtol=1e-6)
    # eta sweep: mean top-k DEWI rises with eta
    means = [np.mean([r[2].dewi for r in port.search(q, k=10, eta=e, entropy_pref=0.0)])
             for e in (0.0, 0.5, 1.0)]
    assert means[0] <= means[1] <= means[2] and means[0] < means[2]


@pytest.mark.parametrize("backend", ["exact", "int8", "int4"])
def test_cross_package_save_load(tmp_path, corpus, backend):
    ids, emb, pay, q = corpus
    port, ref = _pair((ids[:5000], emb[:5000], pay[:5000], q), backend)
    s, i = port.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    s_ref, i_ref = ref.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    port.save(tmp_path / "port")
    ref.save(tmp_path / "jax")
    from_jax = DewiIndex.load(tmp_path / "jax", device="cpu")
    from_port = JDewiIndex.load(tmp_path / "port")
    assert type(from_jax._backend).__name__ == type(port._backend).__name__
    assert from_jax.doc_ids == ids[:5000]
    s2, i2 = from_jax.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    s3, i3 = from_port.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    assert_same_topk(s2, i2, s_ref, i_ref)
    assert_same_topk(s, i, s3, i3)
    again = DewiIndex.load(tmp_path / "port", device="cpu")
    s4, i4 = again.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    torch.testing.assert_close(s4, s)
    assert torch.equal(i4, i)
    assert again.get_payload("d7").to_dict() == ref.get_payload("d7").to_dict()


@pytest.mark.parametrize("backend", ["exact", "int8", "int4"])
def test_index_from_numpy_state(corpus, backend):
    ids, emb, pay, q = corpus
    ref = JDewiIndex(dim=DIM, backend=backend)
    ref.add_batch(ids, emb, pay)
    ref.build()
    jb = ref._backend
    state = [np.asarray(a) for a in jb.store.device_arrays()]
    kw = {}
    if backend != "exact":
        kw = dict(q_emb=np.asarray(jb._q_emb), q_scales=np.asarray(jb._q_scales))
    port = index_from_numpy_state(ids, state, backend=backend, device="cpu", **kw)
    if backend == "int4":
        # the JAX CPU build keeps int4 unpacked; the port keeps it packed
        from dewi_tpu_torch.ops.quantized import quantize_rows_int4
        packed, _ = quantize_rows_int4(torch.from_numpy(state[0].copy()))
        np.testing.assert_array_equal(
            np.asarray(jb._q_emb),
            np.concatenate([packed.numpy() >> 4, (packed.numpy() & 15) - 8], axis=1))
        port._backend._q_emb = packed
    s, i = port.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    s_ref, i_ref = ref.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    assert_same_topk(s, i, s_ref, i_ref)


def test_stats_from_numpy_state(signal_rows):
    ref = JDewiScorer()
    ref.fit_stats(signal_rows)
    stats = stats_from_numpy_state(*ref.stats.arrays())
    port = DewiScorer(device="cpu")
    port.stats = stats
    np.testing.assert_allclose(port.score_batch(signal_rows).numpy(),
                               np.asarray(ref.score_batch(signal_rows)), rtol=1e-6)


def test_backends_and_device_rule():
    assert type(DewiIndex(dim=8, backend="int4", device="cpu")._backend).__name__ == \
        "QuantizedIndex"
    assert DewiIndex(dim=8, backend="int4", device="cpu")._backend.int4_storage
    for name in ("ivf", "faiss_ivfflat"):
        ivf = DewiIndex(dim=8, backend=name, device="cpu", nlist=4)
        assert type(ivf._backend).__name__ == "IVFIndex" and ivf._backend.nlist == 4
    assert type(DewiIndex(dim=8, backend="ivf", use_ann=False, device="cpu")._backend
                ).__name__ == "ExactIndex"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DewiIndex(dim=8)


def test_approx_select_is_not_an_option(tmp_path):
    """The port's flat select is always exact: asking for approx_select
    raises, a save omits it, and a JAX save's value is ignored on load."""
    import json

    for value in (True, False):
        with pytest.raises(TypeError, match="approx_select"):
            DewiIndex(dim=8, backend="int8", device="cpu", approx_select=value)
    ref = JDewiIndex(dim=8, backend="int8", approx_select=False)
    ref.add("a", np.ones(8, np.float32), Payload())
    ref.save(tmp_path / "jax")
    port = DewiIndex.load(tmp_path / "jax", device="cpu")
    port.save(tmp_path / "port")
    meta = json.loads((tmp_path / "port" / "ann_index" / "metadata.json").read_text())
    assert "approx_select" not in meta["hyperparams"]
    assert JDewiIndex.load(tmp_path / "port")._backend.approx_select is True


def test_payloads_jsonl_codec_matches_jax(tmp_path):
    """The port's JSONL writer gives the JAX package's Python-fallback lines;
    each package reads the other's file; ``"id"`` is accepted on read."""
    import json

    from dewi_tpu import native
    from dewi_tpu.types import Payload as JPayload
    from dewi_tpu_torch.index.base import read_payloads_jsonl, write_payloads_jsonl

    mat = np.random.default_rng(3).random((5, 8)).astype(np.float32)
    ids = [f"doc {i}" for i in range(5)]
    write_payloads_jsonl(tmp_path / "port.jsonl", ids, mat)
    want = [json.dumps({"doc_id": d, "payload": JPayload.from_array(r).to_dict()})
            for d, r in zip(ids, mat)]
    assert (tmp_path / "port.jsonl").read_text().splitlines() == want
    got_ids, got = native.read_payloads_jsonl(tmp_path / "port.jsonl")
    assert got_ids == ids
    np.testing.assert_array_equal(got, mat)
    native.write_payloads_jsonl(tmp_path / "jax.jsonl", ids, mat)
    got_ids, got = read_payloads_jsonl(tmp_path / "jax.jsonl")
    assert got_ids == ids
    np.testing.assert_allclose(got, mat, rtol=1e-6)
    (tmp_path / "old.jsonl").write_text('{"id": "a", "payload": {"dewi": 0.5}}\n')
    got_ids, got = read_payloads_jsonl(tmp_path / "old.jsonl")
    assert got_ids == ["a"] and got[0, 0] == 0.5 and got[0, 1:].sum() == 0
