"""The port's k-means and IVF tier against the JAX package's.

* ``kmeans`` / ``assign_clusters`` / ``assign_clusters_top2`` from the same
  initial rows (drawn with JAX and handed over as numpy): the scatter sums
  in another order, so centroids within 1e-5, at least 99% equal
  assignments, margins within 1e-5.
* ``_ivf_plan`` and ``_ivf_materialize`` from the same assignment: every
  output array equal.
* the search from a ``_dev`` tuple carried across by
  ``ivf_index_from_numpy_state``: scan and gather, with and without spill
  and dedup, cosine and l2, f32 and bf16 buckets.  Scores within 1e-5
  (1e-2 for bf16 buckets), ids equal wherever neighbouring scores differ by
  more, -inf/-1 slots in the same places.
* ``IVFIndex`` / ``DewiIndex(backend="ivf")`` as a whole, at the sizes and
  hyperparameters of tests/test_index.py and tests/test_ivf_probe.py: the
  two packages draw their k-means samples from different random streams,
  so buckets differ and the port is held to recall against its own exact
  index, with the reference's thresholds (1.0 at full probe and at eta 1
  with the DEWI tier, >= 0.95 on clustered data, >= 0.7 on random data at
  nprobe 8 of 32).

The port runs on the CPU (``device="cpu"``), the JAX side under
``JAX_PLATFORMS=cpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dewi_tpu.index import DewiIndex as JDewiIndex
from dewi_tpu.index import IVFIndex as JIVFIndex
from dewi_tpu.index import ivf as jivf
from dewi_tpu.ops import kmeans as jkm
from dewi_tpu_torch import DewiIndex, ExactIndex, IVFIndex, ivf_index_from_numpy_state
from dewi_tpu_torch.index import ivf as tivf
from dewi_tpu_torch.ops import kmeans as tkm

from test_torch_search import assert_same_topk

T = torch.from_numpy


def _corpus(n, d, seed, clustered=0):
    rng = np.random.default_rng(seed)
    if clustered:
        centers = rng.normal(size=(clustered, d)).astype(np.float32) * 3
        emb = (centers[rng.integers(0, clustered, n)] + rng.normal(size=(n, d)))
    else:
        emb = rng.normal(size=(n, d))
    pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    return emb.astype(np.float32), pay, [f"d{i}" for i in range(n)], rng


def _recall(ids, ref):
    ids, ref = np.asarray(ids), np.asarray(ref)
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / len(b)
                          for a, b in zip(ids, ref)]))


# ---- k-means ---------------------------------------------------------------


@pytest.mark.parametrize("spherical", [False, True])
def test_kmeans_matches_jax(spherical):
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(12, 16)) * 4
    x = (centers[rng.integers(0, 12, 3000)] + rng.normal(size=(3000, 16))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    init_idx = np.asarray(jax.random.permutation(key, x.shape[0])[:12])
    c_ref, a_ref = jkm.kmeans(jnp.asarray(x), key, n_clusters=12, n_iters=6,
                              spherical=spherical, chunk=1024)
    c, a = tkm.kmeans(T(x), n_clusters=12, n_iters=6, spherical=spherical, chunk=1024,
                      init_idx=T(init_idx.copy()))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-5, atol=1e-5)
    assert a.dtype == torch.int32
    assert np.mean(a.numpy() == np.asarray(a_ref)) >= 0.99


def test_kmeans_own_draw_is_seeded():
    x = T(np.random.default_rng(1).normal(size=(500, 8)).astype(np.float32))
    c0, a0 = tkm.kmeans(x, n_clusters=5, n_iters=3, seed=4)
    c1, _ = tkm.kmeans(x, n_clusters=5, n_iters=3, seed=4)
    c2, _ = tkm.kmeans(x, n_clusters=5, n_iters=3, seed=5)
    assert torch.equal(c0, c1) and not torch.equal(c0, c2)
    assert c0.shape == (5, 8) and a0.shape == (500,) and int(a0.max()) < 5


@pytest.mark.parametrize("chunk", [256, 16384])
def test_assign_clusters_match_jax(chunk):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1000, 24)).astype(np.float32)
    cent = rng.normal(size=(20, 24)).astype(np.float32)
    cent[7] = cent[3]  # equal distances: the lower centroid wins
    a_ref = np.asarray(jkm.assign_clusters(jnp.asarray(x), jnp.asarray(cent), chunk=chunk))
    a = tkm.assign_clusters(T(x), T(cent), chunk=chunk).numpy()
    assert np.mean(a == a_ref) >= 0.99 and not np.any(a == 7)
    a2_ref, m_ref = jkm.assign_clusters_top2(jnp.asarray(x), jnp.asarray(cent), chunk=chunk)
    a2, m = tkm.assign_clusters_top2(T(x), T(cent), chunk=chunk)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-5, atol=1e-5)
    assert np.mean(a2.numpy() == np.asarray(a2_ref)) >= 0.99
    first = a2.numpy()[:, 0] == 3
    assert np.all(a2.numpy()[first, 1] == 7) and np.all(m.numpy()[first] == 0)


# ---- plan and materialize --------------------------------------------------


@pytest.mark.parametrize("spill,tier_n,emb_dtype", [
    (0, 0, "float32"), (0, 40, "float32"), (150, 40, "float32"), (150, 40, "bfloat16")])
def test_plan_and_materialize_equal_jax(spill, tier_n, emb_dtype):
    rng = np.random.default_rng(5)
    n, d, nlist, cap = 500, 12, 9, 40  # some clusters overflow cap
    emb = rng.normal(size=(n, d)).astype(np.float32)
    sqn = np.sum(emb * emb, axis=1).astype(np.float32)
    pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    pay[:, 0] = np.clip(rng.normal(0.5, 0.6, n), 0, 1)  # DEWI scores tie at 0 and 1
    assign = rng.integers(0, nlist, n + spill).astype(np.int32)
    doc_of = np.concatenate([np.arange(n), rng.permutation(n)[:spill]]).astype(np.int32)
    plan_ref = jivf._ivf_plan(jnp.asarray(assign), jnp.asarray(pay), jnp.asarray(doc_of),
                              nlist=nlist, cap=cap, tier_n=tier_n)
    plan = tivf._ivf_plan(T(assign), T(pay), T(doc_of), nlist=nlist, cap=cap, tier_n=tier_n)
    for got, want in zip(plan, plan_ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    o_n = int(np.sum(~np.asarray(plan_ref[2])))
    o_cap = max(8, -(-max(o_n, 1) // 8) * 8)
    b_ref, o_ref = jivf._ivf_materialize(
        jnp.asarray(emb), jnp.asarray(sqn), jnp.asarray(pay), *plan_ref, jnp.asarray(assign),
        jnp.asarray(doc_of), nlist=nlist, cap=cap, o_cap=o_cap, emb_dtype=emb_dtype)
    b, o = tivf._ivf_materialize(
        T(emb), T(sqn), T(pay), *plan, T(assign), T(doc_of), nlist=nlist, cap=cap,
        o_cap=o_cap, emb_dtype=getattr(torch, emb_dtype))
    assert len(b) == 5 and len(o) == 4
    for got, want in zip(b + o, b_ref + o_ref):
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


# ---- the search from state carried across ----------------------------------


def _carried_pair(n=600, d=32, seed=3, jdtype=None, **kw):
    emb, pay, ids, rng = _corpus(n, d, seed)
    hyper = dict(nlist=16, nprobe=6, kmeans_iters=4, dewi_tier=32)
    hyper.update(kw)
    jkw = dict(hyper, **({"dtype": jdtype} if jdtype is not None else {}))
    ref = JIVFIndex(dim=d, **jkw)
    ref.add_batch(ids, emb, pay)
    ref.build()
    state = [np.asarray(a) for a in ref.store.device_arrays()]
    port = ivf_index_from_numpy_state(ids, state, [np.asarray(a) for a in ref._dev],
                                      space=hyper.pop("space", "cosine"), device="cpu",
                                      **hyper)
    return port, ref, rng


def _assert_same_ivf(port_out, ref_out, tol):
    s, i = port_out
    s_ref, i_ref = np.asarray(ref_out[0]), np.asarray(ref_out[1])
    assert s.shape == s_ref.shape and i.shape == i_ref.shape
    dead = np.isneginf(s_ref)
    np.testing.assert_array_equal(np.isneginf(s.numpy()), dead)
    np.testing.assert_array_equal(i.numpy()[dead], i_ref[dead])
    assert np.all(i_ref[dead] == -1)
    live_rows = ~dead.any(axis=1)
    assert_same_topk(s[live_rows], i[live_rows], s_ref[live_rows], i_ref[live_rows],
                     rtol=tol, atol=tol)
    for r in np.flatnonzero(~live_rows):  # rows with -1 slots: the live prefix
        m = ~dead[r]
        assert_same_topk(s[r:r + 1, m], i[r:r + 1, m], s_ref[r:r + 1, m], i_ref[r:r + 1, m],
                         rtol=tol, atol=tol)


@pytest.mark.parametrize("probe_impl", ["scan", "gather"])
@pytest.mark.parametrize("space", ["cosine", "l2"])
@pytest.mark.parametrize("spill_frac", [0.0, 0.5])
@pytest.mark.parametrize("probe_dtype", ["float32", "bfloat16"])
def test_search_from_carried_state(probe_impl, space, spill_frac, probe_dtype):
    port, ref, rng = _carried_pair(probe_impl=probe_impl, space=space,
                                   spill_frac=spill_frac, probe_dtype=probe_dtype)
    backend = port._backend
    assert isinstance(backend, IVFIndex) and backend._resolved_probe_impl() == probe_impl
    assert backend._dev[1].dtype == getattr(torch, probe_dtype)
    assert backend._dev[5].dtype == torch.float32  # b_sqn stays f32
    q = rng.normal(size=(9, 32)).astype(np.float32)
    tol = 1e-5 if probe_dtype == "float32" else 1e-2
    for k, eta, ep in ((12, 0.0, 0.0), (12, 0.4, 0.2), (5, 1.0, 0.0)):
        got = port.search_batch(q, k=k, eta=eta, entropy_pref=ep)
        want = ref.search_batch(q, k=k, eta=eta, entropy_pref=ep)
        _assert_same_ivf(got, want, tol)
    # a single query, through the facade's search: same documents
    res = port.search(q[0], k=5, eta=0.4, entropy_pref=0.2)
    res_ref = ref.search(q[0], k=5, eta=0.4, entropy_pref=0.2)
    np.testing.assert_allclose([r[1] for r in res], [r[1] for r in res_ref],
                               rtol=tol, atol=tol)


def test_search_bf16_store_from_carried_state():
    """A bf16 store with ``probe_dtype="auto"``: bf16 buckets on both sides."""
    port, ref, rng = _carried_pair(jdtype=jnp.bfloat16, probe_dtype="auto")
    assert port._backend.store.dtype == torch.bfloat16
    assert port._backend._dev[1].dtype == torch.bfloat16
    q = rng.normal(size=(5, 32)).astype(np.float32)
    _assert_same_ivf(port.search_batch(q, k=8, eta=0.3, entropy_pref=0.1),
                     ref.search_batch(q, k=8, eta=0.3, entropy_pref=0.1), 1e-2)


@pytest.mark.parametrize("probe_impl", ["scan", "gather"])
def test_exhausted_pool_slots_match_jax(probe_impl):
    """k beyond the probed pool's distinct docs: -inf scores and -1 ids in
    the same slots as the reference (dedup on: 24 docs, all spilled)."""
    port, ref, rng = _carried_pair(n=24, d=16, seed=17, nlist=8, nprobe=2, dewi_tier=0,
                                   spill_frac=1.0, probe_impl=probe_impl)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    got = port.search_batch(q, k=12, eta=0.2, entropy_pref=0.0)
    want = ref.search_batch(q, k=12, eta=0.2, entropy_pref=0.0)
    assert np.any(np.asarray(want[1]) == -1)
    _assert_same_ivf(got, want, 1e-5)
    for row in got[1].numpy():
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
    res = port._backend.search(q[0], k=12, eta=0.2)
    assert len(res) == int((got[1][0] >= 0).sum())  # -1 slots are skipped


def test_dedup_topk_matches_jax():
    rng = np.random.default_rng(9)
    ids = rng.integers(-1, 12, size=(6, 20)).astype(np.int32)
    vals = -np.sort(-rng.normal(size=(6, 20)).astype(np.float32), axis=1)
    vals[ids < 0] = -np.inf
    vals = -np.sort(-vals, axis=1)
    order = np.argsort(-vals, axis=1, kind="stable")
    ids = np.take_along_axis(ids, order, axis=1)
    for k in (5, 10, 30):
        v_ref, i_ref = jivf._dedup_topk(jnp.asarray(vals), jnp.asarray(ids), k)
        v, i = tivf._dedup_topk(T(vals), T(ids), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
        live = np.isfinite(np.asarray(v_ref))
        np.testing.assert_array_equal(i.numpy()[live], np.asarray(i_ref)[live])
        assert np.all(i.numpy()[~live] == -1) and np.all(np.asarray(i_ref)[~live] == -1)


# ---- the index as a whole --------------------------------------------------


def _exact_ids(emb, pay, ids, q, space="cosine", **search):
    exact = ExactIndex(dim=emb.shape[1], space=space, device="cpu")
    exact.add_batch(ids, emb, pay)
    exact.build()
    return exact.search_batch(q, **search)[1].numpy()


def test_full_probe_equals_exact():
    emb, pay, ids, rng = _corpus(600, 16, 21)
    ivf = IVFIndex(dim=16, nlist=16, nprobe=16, kmeans_iters=5, device="cpu")
    ivf.add_batch(ids, emb, pay)
    ivf.build()
    q = rng.normal(size=(6, 16)).astype(np.float32)
    _, i = ivf.search_batch(q, k=10, eta=0.3, entropy_pref=0.1)
    np.testing.assert_array_equal(
        i.numpy(), _exact_ids(emb, pay, ids, q, k=10, eta=0.3, entropy_pref=0.1))


def test_spill_full_probe_equals_exact():
    emb, pay, ids, rng = _corpus(400, 16, 13)
    ivf = IVFIndex(dim=16, nlist=8, nprobe=8, kmeans_iters=4, dewi_tier=0, spill_frac=1.0,
                   bucket_load_factor=4.0, device="cpu")
    ivf.add_batch(ids, emb, pay)
    ivf.build()
    q = rng.normal(size=(8, 16)).astype(np.float32)
    _, i = ivf.search_batch(q, k=10, eta=0.3, entropy_pref=0.1)
    np.testing.assert_array_equal(
        i.numpy(), _exact_ids(emb, pay, ids, q, k=10, eta=0.3, entropy_pref=0.1))


@pytest.mark.parametrize("case", ["random", "clustered", "high_eta_tier", "l2"])
def test_recall_against_exact(case):
    """The reference's IVF recall cases (tests/test_index.py:395-414,
    587-638), held to its thresholds or tighter."""
    space = "l2" if case == "l2" else "cosine"
    if case == "random":
        emb, pay, ids, rng = _corpus(2000, 16, 31)
        kw, search, floor = dict(nlist=32, nprobe=8, kmeans_iters=5), dict(eta=0.0), 0.7
        q = rng.normal(size=(20, 16)).astype(np.float32)
    elif case == "high_eta_tier":
        emb, pay, ids, rng = _corpus(4000, 32, 32)
        pay[:, 0] = rng.beta(2, 2, 4000)
        kw, search, floor = dict(nlist=64, nprobe=4, dewi_tier=256), dict(eta=1.0), 1.0
        q = rng.normal(size=(16, 32)).astype(np.float32)
    else:
        emb, pay, ids, rng = _corpus(2000, 32, 33, clustered=32)
        kw, search, floor = dict(nlist=32, nprobe=8, dewi_tier=128), dict(eta=0.0), 0.95
        q = (emb[rng.integers(0, 2000, 16)] + 0.1 * rng.normal(size=(16, 32))).astype(np.float32)
    ivf = IVFIndex(dim=emb.shape[1], space=space, device="cpu", **kw)
    ivf.add_batch(ids, emb, pay)
    ivf.build()
    _, i = ivf.search_batch(q, k=10, entropy_pref=0.0, **search)
    want = _exact_ids(emb, pay, ids, q, space=space, k=10, entropy_pref=0.0, **search)
    assert _recall(i.numpy(), want) >= floor


def test_k_larger_than_candidate_pool():
    emb, pay, ids, rng = _corpus(400, 32, 3)
    ivf = IVFIndex(dim=32, nlist=16, nprobe=6, kmeans_iters=4, dewi_tier=32, device="cpu")
    ivf.add_batch(ids, emb, pay)
    q = rng.normal(size=32).astype(np.float32)
    res = ivf.search(q, k=400, eta=0.2, entropy_pref=0.1)
    assert 0 < len(res) <= 400 and len({r[0] for r in res}) == len(res)
    vals, idx = ivf.search_batch(q, k=400)
    pool = 6 * ivf._dev[1].shape[1] + ivf._dev[6].shape[0]
    assert idx.shape == (1, min(400, pool))


def test_rebuild_after_add():
    emb, pay, ids, rng = _corpus(300, 16, 4)
    ivf = DewiIndex(dim=16, backend="ivf", nlist=8, nprobe=8, device="cpu")
    ivf.add_batch(ids, emb, pay)
    ivf.build()
    needle = rng.normal(size=16).astype(np.float32)
    from dewi_tpu_torch import Payload
    ivf.add("needle", needle, Payload(dewi=0.1))
    assert ivf.search(needle, k=1, eta=0.0)[0][0] == "needle"
    # straight on the backend: a stale build is rebuilt by search_batch
    backend = ivf._backend
    backend.add("needle2", -needle, Payload())
    _, i = backend.search_batch(-needle, k=1, eta=0.0)
    assert backend.store.doc_ids[int(i[0, 0])] == "needle2"


def test_bad_options_rejected():
    with pytest.raises(ValueError, match="probe_impl"):
        IVFIndex(dim=8, probe_impl="stream", device="cpu")
    with pytest.raises(ValueError, match="probe_dtype"):
        IVFIndex(dim=8, probe_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="spill_frac"):
        IVFIndex(dim=8, spill_frac=1.5, device="cpu")
    with pytest.raises(ValueError, match="No embeddings"):
        IVFIndex(dim=8, device="cpu").build()


def test_auto_probe_impl_and_dtype():
    ivf = IVFIndex(dim=8, device="cpu")
    assert ivf.probe_impl == "auto" and ivf._resolved_probe_impl() == "scan"
    ivf.store.device = torch.device("cuda")  # the choice follows the index's device
    assert ivf._resolved_probe_impl() == "gather"
    emb, pay, ids, _ = _corpus(200, 8, 6)
    bf = IVFIndex(dim=8, nlist=4, nprobe=2, probe_dtype="auto", dtype=torch.bfloat16,
                  device="cpu")
    bf.add_batch(ids, emb, pay)
    bf.build()
    assert bf.probe_dtype == "auto" and bf._dev[1].dtype == torch.bfloat16
    assert bf._dev[6].dtype == torch.bfloat16 and bf._dev[5].dtype == torch.float32


def test_build_takes_the_sample_and_the_initial_rows():
    emb, pay, ids, _ = _corpus(500, 8, 8)
    a = IVFIndex(dim=8, nlist=6, nprobe=6, train_sample=200, device="cpu")
    a.add_batch(ids, emb, pay)
    a.build(sample_idx=np.arange(200), init_idx=np.arange(6))
    train = torch.nn.functional.normalize(T(emb[:200]), dim=1)
    want, _ = tkm.kmeans(train, n_clusters=6, n_iters=10, spherical=True,
                         init_idx=torch.arange(6))
    torch.testing.assert_close(a._dev[0], want)
    b = IVFIndex(dim=8, nlist=6, nprobe=6, train_sample=200, seed=1, device="cpu")
    b.add_batch(ids, emb, pay)
    b.build()
    c = IVFIndex(dim=8, nlist=6, nprobe=6, train_sample=200, seed=1, device="cpu")
    c.add_batch(ids, emb, pay)
    c.build()
    assert torch.equal(b._dev[0], c._dev[0]) and not torch.equal(a._dev[0], b._dev[0])


# ---- persistence -------------------------------------------------------------

HYPER = dict(nlist=11, nprobe=7, dewi_tier=33, kmeans_iters=3, bucket_load_factor=2.0,
             train_sample=5000, seed=3, probe_dtype="bfloat16", probe_impl="gather",
             spill_frac=0.25)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port", "port_to_port"])
def test_cross_package_save_load(tmp_path, direction):
    """An IVF index is rebuilt on load from embeddings, payloads and
    hyperparameters: across packages the buckets differ, so the loaded
    index is held to hyperparameters, ids and recall against exact."""
    emb, pay, ids, rng = _corpus(900, 16, 40, clustered=11)
    q = (emb[rng.integers(0, 900, 12)] + 0.1 * rng.normal(size=(12, 16))).astype(np.float32)
    want = _exact_ids(emb, pay, ids, q, k=10, eta=0.3, entropy_pref=0.1)
    if direction == "jax_to_port":
        src = JDewiIndex(dim=16, backend="ivf", **HYPER)
    else:
        src = DewiIndex(dim=16, backend="ivf", device="cpu", **HYPER)
    src.add_batch(ids, emb, pay)
    src.build()
    src.save(tmp_path / "ix")
    if direction == "port_to_jax":
        back = JDewiIndex.load(tmp_path / "ix")
    else:
        back = DewiIndex.load(tmp_path / "ix", device="cpu")
    assert type(back._backend).__name__ == "IVFIndex"
    assert back._backend._hyperparams() == src._backend._hyperparams()
    assert back._backend._hyperparams() == {**HYPER, "bucket_load_factor": 2.0}
    assert back.doc_ids == ids and len(back) == 900
    _, i = back.search_batch(q, k=10, eta=0.3, entropy_pref=0.1)
    assert _recall(np.asarray(i), want) >= 0.9
    if direction == "port_to_port":  # same package, same seed: the same buckets
        _, i0 = src.search_batch(q, k=10, eta=0.3, entropy_pref=0.1)
        assert torch.equal(i, i0)


def test_faiss_name_loads_as_ivf(tmp_path):
    import json

    emb, pay, ids, _ = _corpus(100, 8, 41)
    ivf = DewiIndex(dim=8, backend="faiss_ivfflat", nlist=4, nprobe=4, device="cpu")
    assert isinstance(ivf._backend, IVFIndex)
    ivf.add_batch(ids, emb, pay)
    ivf.build()
    ivf.save(tmp_path / "ix")
    for name in ("config.json", "ann_index/metadata.json"):
        path = tmp_path / "ix" / name
        path.write_text(path.read_text().replace("IVFIndex", "FAISSIndex"))
    assert json.loads((tmp_path / "ix" / "config.json").read_text())["backend_type"] == \
        "FAISSIndex"
    back = DewiIndex.load(tmp_path / "ix", device="cpu")
    assert isinstance(back._backend, IVFIndex) and back._backend.nlist == 4
