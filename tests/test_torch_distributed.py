"""The port's mesh, runtime and sharded searchers against ``dewi_tpu.parallel``.

The port runs one process per device: the sharded searchers run on four
gloo ranks on the CPU, started by ``parallel.launch_local`` (one launch for
every case, a module-scoped fixture), and are held to the JAX package's
sharded searchers on a 4-device slice of the conftest's 8 virtual CPU
devices, on the same seeded corpora.  The rank functions live at module
level and this module imports JAX only inside test bodies, so the spawned
ranks never load it.

Tolerances: scores within 1e-5 (the f32 refine may differ in the order of
a shard-sized sum); ids equal except where scores tie; the integer stage-1
accumulators are exact on both sides, so the quantized candidates agree.
IVF runs from the reference's built ``_dev`` state carried across
(k-means draws from different random streams in the two packages).
"""

import time

import numpy as np
import pytest
import torch

from dewi_tpu_torch.parallel import (
    DATA_AXIS, Mesh, ShardedExactSearcher, ShardedIVFSearcher, ShardedQuantizedSearcher,
    data_sharding, device_summary, initialize_runtime, launch_local, make_mesh, shard_batch,
    single_device_mesh)

RANKS = 4
LAUNCH_TIMEOUT = 120.0
ETA, EP = 0.3, 0.1
TOL = 1e-5

# name -> (kind, n, d, n_queries, k, options)
SEARCH_CASES = {
    "exact_cosine": ("exact", 600, 16, 5, 10, {}),
    "exact_l2": ("exact", 600, 16, 5, 10, {"space": "l2"}),
    "exact_k_rebound": ("exact", 600, 16, 5, 7, {"rebind_from": 10}),
    "int8": ("quant", 600, 32, 5, 10, {}),
    "int8_queries": ("quant", 600, 32, 5, 10, {"int8_queries": True}),
    "int4": ("quant", 600, 32, 5, 10, {"int4_storage": True}),
    "int8_l2": ("quant", 600, 32, 5, 10, {"space": "l2"}),
    # cap 32,768: 8,192-row shards take the scores-kernel route
    "int8_kernel_route": ("quant", 20_000, 32, 5, 10, {}),
    # cap 65,536: 16,384-row shards take the fused block-max route; Q 40
    # runs in 32-query groups
    "int8_fused_route": ("quant", 40_000, 32, 40, 10, {}),
    "int8_queries_fused_route": ("quant", 40_000, 32, 40, 10, {"int8_queries": True}),
    "int4_fused_route": ("quant", 40_000, 32, 8, 10, {"int4_storage": True}),
    "ivf_full_probe": ("ivf", 600, 16, 5, 10, {"nprobe_per_shard": 16}),
    "ivf_bf16_buckets": ("ivf", 600, 16, 8, 10, {"nprobe_per_shard": 16,
                                                 "probe_dtype": "bf16"}),
    "ivf_k_beyond_pool": ("ivf", 600, 16, 4, 599, {"nprobe_per_shard": 2, "nprobe": 2,
                                                   "dewi_tier": 16}),
    "ivf_partial_probe": ("ivf", 2000, 16, 20, 10, {"nlist": 32, "nprobe": 8,
                                                    "dewi_tier": 64}),
    "ivf_spill_dedup": ("ivf", 600, 16, 6, 10, {"nprobe_per_shard": 3, "spill_frac": 0.25}),
}
IVF_DEFAULTS = dict(nlist=16, nprobe=16, kmeans_iters=4, dewi_tier=32)


def _corpus(name):
    kind, n, d, nq, k, opts = SEARCH_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    emb = rng.normal(size=(n, d)).astype(np.float32)
    pay = np.abs(rng.normal(size=(n, 8))).astype(np.float32)
    pay[:, 0] = rng.random(n)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    return emb, pay, q


def _ids(n):
    return [f"d{i}" for i in range(n)]


def _ivf_kwargs(opts):
    kw = dict(IVF_DEFAULTS)
    kw.update({k: v for k, v in opts.items() if k in ("nlist", "nprobe", "dewi_tier",
                                                      "spill_frac", "probe_dtype")})
    return kw


# ---- rank functions (run in the spawned ranks; no JAX) ----------------------


def _port_search(name, ivf_state=None):
    from dewi_tpu_torch import ivf_index_from_numpy_state
    from dewi_tpu_torch.index.store import DocStore

    kind, n, d, nq, k, opts = SEARCH_CASES[name]
    emb, pay, q = _corpus(name)
    mesh = make_mesh(device="cpu")
    if kind == "ivf":
        state, dev_state, bf16 = ivf_state
        kw = _ivf_kwargs(opts)
        kw.pop("probe_dtype", None)
        ivf = ivf_index_from_numpy_state(_ids(n), state, dev_state, device="cpu", **kw)._backend
        if bf16:
            ivf._dev = tuple(t.to(torch.bfloat16) if i in (1, 6) else t
                             for i, t in enumerate(ivf._dev))
        searcher = ShardedIVFSearcher(ivf, mesh, k=k,
                                      nprobe_per_shard=opts.get("nprobe_per_shard"))
        return searcher.search_batch(q, eta=ETA, entropy_pref=EP)
    store = DocStore(d, space=opts.get("space", "cosine"), device="cpu")
    store.add_batch(_ids(n), emb, pay)
    if kind == "exact":
        searcher = ShardedExactSearcher(store, mesh, k=opts.get("rebind_from", k))
        return searcher.search_batch(q, eta=ETA, entropy_pref=EP, k=k)
    searcher = ShardedQuantizedSearcher(store, mesh, k=k,
                                        int8_queries=opts.get("int8_queries", False),
                                        int4_storage=opts.get("int4_storage", False))
    return searcher.search_batch(q, eta=ETA, entropy_pref=EP)


def _searchers_worker(ivf_states):
    """Every search case, then the 2x2 mesh's collectives; rank 0's answers
    and each rank's stage-1 routes."""
    out = {}
    for name in SEARCH_CASES:
        v, i = _port_search(name, ivf_states.get(name))
        out[name] = (v.float().numpy(), i.numpy())
    routes = {}
    for name in ("int8", "int8_kernel_route", "int8_fused_route", "int4_fused_route"):
        from dewi_tpu_torch.index.store import DocStore

        kind, n, d, nq, k, opts = SEARCH_CASES[name]
        store = DocStore(d, device="cpu")
        emb, pay, _ = _corpus(name)
        store.add_batch(_ids(n), emb, pay)
        s = ShardedQuantizedSearcher(store, make_mesh(device="cpu"), k=k,
                                     int4_storage=opts.get("int4_storage", False))
        routes[name] = (s._pallas_capable, s._fused_bmax, tuple(s._q_emb.shape))
    out["routes"] = routes
    grid = make_mesh(n_data=2, n_model=2, device="cpu")
    me = torch.tensor([float(grid.rank)])
    out["grid"] = (grid.data_index, grid.model_index,
                   grid.all_gather(me).tolist(), grid.all_gather(me, axis="model").tolist())
    grids = [torch.zeros(4) for _ in range(RANKS)]
    import torch.distributed as dist

    dist.all_gather(grids, torch.tensor([float(grid.rank), *out["grid"][2], 0.0]))
    out["grids"] = [g.tolist() for g in grids]
    return out


def _failing_worker():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    dist.barrier()  # rank 0 waits here until the launcher stops it
    return "unreachable"


def _sleeping_worker():
    time.sleep(600)


# ---- the reference --------------------------------------------------------------


def _jax_mesh():
    import jax
    from dewi_tpu.parallel import make_mesh as jmake_mesh

    return jmake_mesh(RANKS, 1, devices=jax.devices()[:RANKS])


def _jax_ivf(name):
    from dewi_tpu.index.ivf import IVFIndex as JIVF

    kind, n, d, nq, k, opts = SEARCH_CASES[name]
    emb, pay, _ = _corpus(name)
    kw = _ivf_kwargs(opts)
    ivf = JIVF(dim=d, **kw)
    ivf.add_batch(_ids(n), emb, pay)
    ivf.build()
    return ivf


def _ivf_state(ivf):
    """The reference index's arrays as numpy (bfloat16 buckets as float32,
    exactly: they are cast back in the rank)."""
    import jax.numpy as jnp

    state = [np.asarray(a) for a in ivf.store.device_arrays()]
    dev = [np.asarray(a.astype(jnp.float32)) if getattr(a, "dtype", None) == jnp.bfloat16
           else np.asarray(a) for a in ivf._dev]
    return state, dev, ivf._dev[1].dtype == jnp.bfloat16


def _jax_search(name, ivf=None):
    import dewi_tpu.parallel as jp
    from dewi_tpu.index.store import DocStore as JStore

    kind, n, d, nq, k, opts = SEARCH_CASES[name]
    emb, pay, q = _corpus(name)
    mesh = _jax_mesh()
    if kind == "ivf":
        s = jp.ShardedIVFSearcher(ivf, mesh, k=k, nprobe_per_shard=opts.get("nprobe_per_shard"))
        return s.search_batch(q, eta=ETA, entropy_pref=EP)
    store = JStore(d, space=opts.get("space", "cosine"))
    store.add_batch(_ids(n), emb, pay)
    if kind == "exact":
        return jp.ShardedExactSearcher(store, mesh, k=k).search_batch(
            q, eta=ETA, entropy_pref=EP)
    s = jp.ShardedQuantizedSearcher(store, mesh, k=k,
                                    int8_queries=opts.get("int8_queries", False),
                                    int4_storage=opts.get("int4_storage", False))
    return s.search_batch(q, eta=ETA, entropy_pref=EP)


@pytest.fixture(scope="module")
def reference():
    ivfs = {name: _jax_ivf(name) for name, case in SEARCH_CASES.items() if case[0] == "ivf"}
    return ivfs


@pytest.fixture(scope="module")
def port(reference):
    states = {name: _ivf_state(ivf) for name, ivf in reference.items()}
    return launch_local(_searchers_worker, RANKS, (states,), timeout=LAUNCH_TIMEOUT, threads=1)


def _assert_same(got, want, tol=TOL):
    from test_torch_search import assert_same_topk

    s, i = got
    s_ref, i_ref = np.asarray(want[0], np.float32), np.asarray(want[1])
    assert s.shape == s_ref.shape and i.shape == i_ref.shape
    dead = np.isneginf(s_ref)
    np.testing.assert_array_equal(np.isneginf(s), dead)
    live = ~dead.any(axis=1)
    assert_same_topk(torch.from_numpy(s[live]), torch.from_numpy(i[live]), s_ref[live],
                     i_ref[live], rtol=tol, atol=tol)
    for r in np.flatnonzero(~live):  # rows with exhausted slots: their live prefix
        m = ~dead[r]
        assert_same_topk(torch.from_numpy(s[r:r + 1, m]), torch.from_numpy(i[r:r + 1, m]),
                         s_ref[r:r + 1, m], i_ref[r:r + 1, m], rtol=tol, atol=tol)


# ---- the sharded searchers against the reference ------------------------------


@pytest.mark.parametrize("name", sorted(SEARCH_CASES))
def test_sharded_search_matches_reference(port, reference, name):
    want = _jax_search(name, reference.get(name))
    _assert_same(port[name], want)


def test_quantized_routes_follow_the_shard(port):
    """Shards of 256 rows take the plain route, of 8,192 the scores kernels,
    of 16,384 the fused block-max kernels; int4 shards stay packed."""
    r = port["routes"]
    assert r["int8"][:2] == (False, False)
    assert r["int8_kernel_route"][:2] == (True, False)
    assert r["int8_fused_route"][:2] == (True, True)
    assert r["int4_fused_route"] == (True, True, (65_536 // RANKS, 16))


def test_full_probe_ivf_is_exact(port):
    """Every bucket of every shard probed: the exact search's answer."""
    from dewi_tpu_torch.index.store import DocStore

    name = "ivf_full_probe"
    emb, pay, q = _corpus(name)
    store = DocStore(emb.shape[1], device="cpu")
    store.add_batch(_ids(len(emb)), emb, pay)
    want = ShardedExactSearcher(store, single_device_mesh("cpu"), k=10).search_batch(
        q, eta=ETA, entropy_pref=EP)
    _assert_same(port[name], (want[0].numpy(), want[1].numpy()))


def test_mesh_grid_groups(port):
    """A 2x2 mesh: rank r at (r // 2, r % 2); the data axis gathers a
    column, the model axis a row, in rank order."""
    rows = {int(g[0]): g for g in port["grids"]}
    for r in range(RANKS):
        assert rows[r][1:3] == [float(r % 2), float(r % 2 + 2)]
    assert port["grid"][:2] == (0, 0)
    assert port["grid"][3] == [0.0, 1.0]


# ---- one device: the meshless index ------------------------------------------------


@pytest.mark.parametrize("tier", ["exact", "int8", "int8_queries", "int4", "ivf"])
def test_single_device_mesh_equals_meshless_index(tier):
    from dewi_tpu_torch import DewiIndex
    from dewi_tpu_torch.index.store import DocStore

    rng = np.random.default_rng(5)
    n, d = 700, 32
    emb = rng.normal(size=(n, d)).astype(np.float32)
    pay = rng.random((n, 8)).astype(np.float32)
    q = rng.normal(size=(6, d)).astype(np.float32)
    mesh = single_device_mesh("cpu")
    backend = {"exact": "exact", "int8": "int8", "int8_queries": "int8", "int4": "int4",
               "ivf": "ivf"}[tier]
    kw = {"int8_queries": True} if tier == "int8_queries" else {}
    if tier == "ivf":
        kw = dict(nlist=8, nprobe=3, kmeans_iters=3, dewi_tier=16)
    index = DewiIndex(dim=d, backend=backend, device="cpu", **kw)
    index.add_batch(_ids(n), emb, pay)
    index.build()
    want = index.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    if tier == "ivf":
        got = ShardedIVFSearcher(index._backend, mesh, k=10).search_batch(q, ETA, EP)
    else:
        store = DocStore(d, device="cpu")
        store.add_batch(_ids(n), emb, pay)
        if tier == "exact":
            got = ShardedExactSearcher(store, mesh, k=10).search_batch(q, ETA, EP)
        else:
            got = ShardedQuantizedSearcher(store, mesh, k=10, int8_queries=tier == "int8_queries",
                                           int4_storage=tier == "int4").search_batch(q, ETA, EP)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


# ---- the store under a data sharding -------------------------------------------------


def _fake_mesh(n_data, rank):
    """A mesh position without a process group: enough for placement."""
    return Mesh(n_data, 1, rank, torch.device("cpu"), {DATA_AXIS: None})


def test_store_sharding_keeps_this_ranks_rows():
    from dewi_tpu_torch.index.store import DocStore

    rng = np.random.default_rng(2)
    n, d = 1500, 8  # capacity 2048: four blocks of 512, the last two partly or wholly empty
    emb = rng.normal(size=(n, d)).astype(np.float32)
    pay = rng.random((n, 8)).astype(np.float32)
    full = DocStore(d, device="cpu")
    full.add_batch(_ids(n), emb, pay)
    fe, fs, fp, fn = full.device_arrays()
    for r in range(4):
        store = DocStore(d, device="cpu")
        store.add_batch(_ids(n), emb, pay)
        store.sharding = data_sharding(_fake_mesh(4, r))
        e, s, p, nv = store.device_arrays()
        assert nv == n and e.shape == (512, d)
        torch.testing.assert_close(e, fe[r * 512:(r + 1) * 512], rtol=0, atol=0)
        torch.testing.assert_close(s, fs[r * 512:(r + 1) * 512], rtol=0, atol=0)
        torch.testing.assert_close(p, fp[r * 512:(r + 1) * 512], rtol=0, atol=0)
        # attach_device copies only the block (the host array is sliced first)
        att = DocStore(d, device="cpu", sharding=data_sharding(_fake_mesh(4, r)))
        att.attach_device(_ids(n), emb, pay)
        a = att.device_arrays()
        assert a[3] == n and att.capacity == 2048
        for x, y in zip(a[:3], (e, s, p)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        with pytest.raises(NotImplementedError, match="this rank's rows"):
            att.embedding_matrix()
    bad = DocStore(d, device="cpu")
    bad.add_batch(_ids(n), emb, pay)
    bad.sharding = data_sharding(_fake_mesh(3, 0))
    with pytest.raises(ValueError, match="does not divide"):
        bad.device_arrays()


def test_store_sharding_set_after_attach():
    """A corpus attached unsharded keeps its rows when a sharding is set
    (the reference's ``TestShardingAfterAttach``)."""
    from dewi_tpu_torch.index.store import DocStore

    rng = np.random.default_rng(4)
    emb = rng.normal(size=(300, 8)).astype(np.float32)
    pay = rng.random((300, 8)).astype(np.float32)
    store = DocStore(8, device="cpu")
    store.attach_device(_ids(300), torch.from_numpy(emb), torch.from_numpy(pay))
    ref = store.device_arrays()[0].clone()
    store.sharding = data_sharding(_fake_mesh(2, 0))
    e, _, _, n = store.device_arrays()
    assert n == 300 and e.shape == (512, 8)
    # the host mirror holds the normalized rows, normalized again here
    torch.testing.assert_close(e, ref[:512], rtol=0, atol=1e-6)


# ---- mesh and runtime --------------------------------------------------------------


def test_make_mesh_without_a_process_group():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.groups[DATA_AXIS] is None
    t = torch.arange(6.0).reshape(2, 3)
    assert mesh.all_gather(t) is t
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        make_mesh(n_data=2, device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        from dewi_tpu_torch.parallel.mesh import check_mesh

        check_mesh(object())


def test_initialize_runtime_is_a_noop_without_an_environment(monkeypatch):
    import torch.distributed as dist

    for var in ("WORLD_SIZE", "DEWI_NUM_PROCESSES", "COORDINATOR_ADDRESS",
                "JAX_COORDINATOR_ADDRESS", "MEGASCALE_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    initialize_runtime()
    assert not dist.is_initialized()
    summary = device_summary()
    assert summary["process_count"] == 1 and summary["platform"] in ("cpu", "gpu")


def test_initialize_runtime_raises_when_init_fails(monkeypatch):
    import torch.distributed as dist

    with pytest.raises(ValueError, match="together"):
        initialize_runtime(num_processes=2)
    with pytest.raises(Exception, match="bogus"):
        initialize_runtime("bogus://nowhere", num_processes=2, process_id=0, backend="gloo",
                           timeout=5)
    monkeypatch.setenv("DEWI_NUM_PROCESSES", "2")
    for var in ("WORLD_SIZE", "DEWI_PROCESS_ID", "COORDINATOR_ADDRESS",
                "JAX_COORDINATOR_ADDRESS", "MEGASCALE_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="DEWI_PROCESS_ID"):
        initialize_runtime()
    assert not dist.is_initialized()


def test_shard_batch_pads_and_reports_the_length():
    batch = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    rows, n = shard_batch(batch, single_device_mesh("cpu"))
    assert n == 10 and rows.shape == (10, 3)
    parts = [shard_batch(batch, _fake_mesh(4, r), pad_value=-1) for r in range(4)]
    assert all(p[1] == 10 and p[0].shape == (3, 3) for p in parts)
    joined = torch.cat([p[0] for p in parts]).numpy()
    np.testing.assert_array_equal(joined[:10], batch)
    assert (joined[10:] == -1).all()


def test_launch_raises_a_ranks_error():
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank one fails on purpose"):
        launch_local(_failing_worker, 2, timeout=60, threads=1)


def test_launch_stops_ranks_at_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        launch_local(_sleeping_worker, 2, timeout=8, threads=1)
    assert time.monotonic() - t0 < 30


# ---- on the card --------------------------------------------------------------------


def _card_worker(emb, pay, q):
    import torch.distributed as dist

    from dewi_tpu_torch.index.store import DocStore
    from dewi_tpu_torch.ops import cuda_search as cs

    mesh = make_mesh()  # the card; the two ranks share it
    store = DocStore(emb.shape[1], device=mesh.device)
    store.add_batch(_ids(len(emb)), emb, pay)
    searcher = ShardedQuantizedSearcher(store, mesh, k=10, int8_queries=True)
    cs.reset_launch_counts()
    s, i = searcher.search_batch(q, eta=ETA, entropy_pref=EP)
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, cs.launch_counts["bmax_s8"])
    return s.cpu().numpy(), i.cpu().numpy(), counts, searcher._fused_bmax


@pytest.mark.cuda
def test_card_sharded_search_launches_kernels():
    """Two gloo ranks share the card: each runs ``bmax_s8`` on its
    32,768-row shard, and the merged answer is the single-device index's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dewi_tpu_torch import DewiIndex
    from dewi_tpu_torch.ops import _build

    _build.load_library()  # one build before the ranks load it
    rng = np.random.default_rng(9)
    n, d = 40_000, 64
    emb = rng.normal(size=(n, d)).astype(np.float32)
    pay = rng.random((n, 8)).astype(np.float32)
    q = rng.normal(size=(40, d)).astype(np.float32)
    s, i, counts, fused = launch_local(_card_worker, 2, (emb, pay, q), timeout=300)
    assert fused and all(c == 2 for c in counts)  # 40 queries: two groups of 32
    index = DewiIndex(dim=d, backend="int8", int8_queries=True)
    index.add_batch(_ids(n), emb, pay)
    index.build()
    ws, wi = index.search_batch(q, k=10, eta=ETA, entropy_pref=EP)
    np.testing.assert_allclose(s, ws.cpu().numpy(), rtol=0, atol=1e-5)
    assert (i == wi.cpu().numpy()).mean() >= 0.99
