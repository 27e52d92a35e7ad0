"""The streaming top-k searches against the JAX package's Pallas kernels.

``stream_search`` and ``int8_stream_search`` on the CPU (their plain
versions) are held against ``pallas_fused_search`` and
``pallas_int8_search`` in interpret mode on the same seeded numpy inputs,
at the reference's own cases (tests/test_pallas_search.py).  Scores: rtol
= atol = 1e-5, the reference's own tolerance (the dot's f32 sum runs in
another order, and XLA may contract the re-rank into fused multiply-adds).
Ids: equal wherever neighbouring scores differ by more than that; among
equal scores the lower row comes first.  Empty slots (fewer than k live
rows) are (-3.4e38, 0): the reference's answer when it runs in one block;
in several blocks it repeats the best row's id there, so those ids are
compared at ``block == cap`` only.

The tests marked ``cuda`` hold the CUDA kernels against the plain versions
and skip without a card.  They import no JAX, so on the card they run with
``python -m pytest --noconftest -m cuda tests/test_torch_stream.py``.
"""

import numpy as np
import pytest
import torch

from dewi_tpu_torch.ops import cuda_search as cs

TOL = 1e-5
NEG = np.float32(-3.4e38)
T = torch.from_numpy


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels (imported lazily: the card-only tests of
    this file run where JAX is not installed)."""
    import jax.numpy as jnp
    from dewi_tpu.ops import pallas_search

    return jnp, pallas_search


def _normalize(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def setup_arrays(cap=2048, d=64, q=3, seed=0):
    rng = np.random.default_rng(seed)
    emb = _normalize(rng.normal(size=(cap, d)))
    pay = np.abs(rng.normal(size=(cap, 8))).astype(np.float32)
    queries = _normalize(rng.normal(size=(q, d)))
    return emb, pay, queries


def assert_same_stream(s, i, s_ref, i_ref, empty_ids=True):
    s, i = np.asarray(s), np.asarray(i)
    s_ref, i_ref = np.asarray(s_ref), np.asarray(i_ref)
    assert s.dtype == np.float32 and i.dtype == np.int32 and s.shape == s_ref.shape
    empty = s_ref == NEG
    np.testing.assert_array_equal(s == NEG, empty)
    np.testing.assert_allclose(s[~empty], s_ref[~empty], rtol=TOL, atol=TOL)
    assert np.all(np.diff(s, axis=1) <= 0)
    if empty_ids:
        np.testing.assert_array_equal(i[empty], i_ref[empty])
    assert np.all(i[empty] == 0)
    tol = TOL + TOL * np.abs(s_ref)
    for r in range(s.shape[0]):
        for j in np.flatnonzero(~empty[r]):
            lo = s_ref[r, j + 1] if j + 1 < s.shape[1] else -np.inf
            hi = s_ref[r, j - 1] if j else np.inf
            if hi - s_ref[r, j] > 2 * tol[r, j] and s_ref[r, j] - lo > 2 * tol[r, j]:
                assert i[r, j] == i_ref[r, j]


def run_both(jx, emb, pay, q, n_valid, eta, ep, k, block=1024):
    jnp, ps = jx
    s_ref, i_ref = ps.pallas_fused_search(
        jnp.asarray(emb), jnp.asarray(pay), jnp.asarray(q), jnp.int32(n_valid),
        jnp.float32(eta), jnp.float32(ep), k=k, block=block, interpret=True)
    s, i = cs.stream_search(T(emb), T(pay), T(q), n_valid, eta, ep, k=k, block=block)
    return s, i, s_ref, i_ref


class TestStreamSearch:
    def test_matches_pallas_scores_and_ids(self, jx):
        emb, pay, q = setup_arrays()
        assert_same_stream(*run_both(jx, emb, pay, q, 2000, 0.3, 0.1, k=10))

    @pytest.mark.parametrize("k", [5, 7])
    @pytest.mark.parametrize("block", [256, 1024])
    def test_validity_mask(self, jx, k, block):
        """Five live rows: no padding row appears, and with k = 7 the last
        two slots are (-3.4e38, 0)."""
        emb, pay, q = setup_arrays(cap=1024, d=32, q=2)
        s, i, s_ref, i_ref = run_both(jx, emb, pay, q, 5, 0.0, 0.0, k=k, block=block)
        assert int(i.max()) < 5
        assert_same_stream(s, i, s_ref, i_ref, empty_ids=block == 1024)
        if k == 7:
            assert np.all(s.numpy()[:, 5:] == NEG) and np.all(i.numpy()[:, 5:] == 0)
            assert np.all(np.asarray(i_ref)[:, 5:] < 5)

    def test_multi_block_merge(self, jx):
        emb, pay, q = setup_arrays(cap=2048, d=32, q=2, seed=3)
        assert_same_stream(*run_both(jx, emb, pay, q, 2048, 0.5, 0.2, k=7, block=256))

    @pytest.mark.parametrize("eta", [0.0, 1.0])
    def test_eta_extremes(self, jx, eta):
        emb, pay, q = setup_arrays(cap=1024, d=32, q=2, seed=5)
        assert_same_stream(*run_both(jx, emb, pay, q, 1000, eta, 0.0, k=5, block=512))

    def test_capacity_must_divide(self):
        emb, pay, q = setup_arrays(cap=1024, d=32, q=1)
        with pytest.raises(ValueError, match="multiple of 3000"):
            cs.stream_search(T(emb), T(pay), T(q), 10, 0.5, 0.0, k=5, block=3000)

    @pytest.mark.parametrize("block", [256, 2048])
    def test_lower_row_wins_ties(self, jx, block):
        """Duplicated rows score bit-equal: the lower row comes first, in
        the reference whatever its block size, and in the port."""
        emb, pay, q = setup_arrays(cap=2048, d=32, q=2, seed=7)
        for src, dst in ((3, 900), (3, 1500), (40, 41), (700, 10)):
            emb[dst], pay[dst] = emb[src], pay[src]
        emb[[3, 40, 700]] = q[0]  # the duplicated rows rank first for query 0
        emb[[900, 1500, 41, 10]] = q[0]
        s, i, s_ref, i_ref = run_both(jx, emb, pay, q, 2048, 0.05, 0.02, k=10, block=block)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        row = i.numpy()[0].tolist()
        assert row.index(3) < row.index(900) < row.index(1500)
        assert row.index(40) < row.index(41) and row.index(10) < row.index(700)

    def test_k_and_dtype_limits(self):
        emb, pay, q = setup_arrays(cap=1024, d=32, q=1)
        with pytest.raises(ValueError, match="k must be"):
            cs.stream_search(T(emb), T(pay), T(q), 10, 0.5, 0.0, k=cs.STREAM_MAX_K + 1)
        with pytest.raises(ValueError, match="float32"):
            cs.stream_search(T(emb).double(), T(pay), T(q), 10, 0.5, 0.0)
        with pytest.raises(ValueError, match="payloads"):
            cs.stream_search(T(emb), T(pay)[:, :4].contiguous(), T(q), 10, 0.5, 0.0)
        assert cs.launch_counts["stream_search"] == 0


def _int8_arrays(seed=11, cap=2048, d=64, q=3):
    emb, pay, q = setup_arrays(cap=cap, d=d, q=q, seed=seed)
    e8 = np.clip(np.round(emb * 127), -127, 127).astype(np.int8)
    sc = (np.abs(emb).max(axis=1) / 127.0).astype(np.float32)
    return emb, e8, sc, pay, q


def run_int8_both(jx, cap, d, nq, n_valid, k, block, seed=13):
    jnp, ps = jx
    _, e8, sc, pay, q = _int8_arrays(seed=seed, cap=cap, d=d, q=nq)
    s_ref, i_ref = ps.pallas_int8_search(
        jnp.asarray(e8), jnp.asarray(sc), jnp.asarray(pay), jnp.asarray(q),
        jnp.int32(n_valid), jnp.float32(0.25), jnp.float32(0.1), k=k, block=block,
        interpret=True)
    s, i = cs.int8_stream_search(T(e8), T(sc), T(pay), T(q), n_valid, 0.25, 0.1, k=k,
                                 block=block)
    return s, i, s_ref, i_ref


class TestInt8StreamSearch:
    @pytest.mark.parametrize("block,n_valid,k", [(512, 2000, 10), (2048, 2000, 10),
                                                 (256, 2048, 7), (2048, 4, 6)])
    def test_matches_pallas(self, jx, block, n_valid, k):
        jnp, ps = jx
        _, e8, sc, pay, q = _int8_arrays()
        s_ref, i_ref = ps.pallas_int8_search(
            jnp.asarray(e8), jnp.asarray(sc), jnp.asarray(pay), jnp.asarray(q),
            jnp.int32(n_valid), jnp.float32(0.3), jnp.float32(0.1), k=k, block=block,
            interpret=True)
        s, i = cs.int8_stream_search(T(e8), T(sc), T(pay), T(q), n_valid, 0.3, 0.1, k=k,
                                     block=block)
        assert_same_stream(s, i, s_ref, i_ref)

    def test_matches_numpy_oracle(self):
        """The reference's own oracle (tests/test_pallas_search.py:77-95):
        an f32-query numpy search shares at least 9 of 10 ids (the slack is
        the queries' bf16 rounding)."""
        _, e8, sc, pay, q = _int8_arrays()
        _, i = cs.int8_stream_search(T(e8), T(sc), T(pay), T(q), 2000, 0.3, 0.1, k=10,
                                     block=512)
        sim = (q @ e8.astype(np.float32).T) * sc[None, :]
        adj = (np.float32(0.7) * sim + np.float32(0.3) * pay[:, 0]
               + np.float32(0.1) * 0.5 * (pay[:, 1] + pay[:, 3]))
        adj[:, 2000:] = -np.inf
        ref = np.argsort(-adj, axis=1)[:, :10]
        for a, b in zip(i.numpy(), ref):
            assert len(set(a.tolist()) & set(b.tolist())) >= 9

    # The edges of the card kernel's tiling: 32-row groups, 128-row tiles
    # (the rows walked end at a tile), tiles of 8 queries, lists of 32.
    @pytest.mark.parametrize("n_valid", [1, 31, 32, 33, 127, 129])
    def test_live_rows_into_a_unit(self, jx, n_valid):
        """``n_valid`` rows into a tile, and 512 rows further on: the rows
        past it never appear, and with one live row the other slots are
        (-3.4e38, 0) (one block, where the reference gives those ids)."""
        for base in (0, 512):
            s, i, s_ref, i_ref = run_int8_both(jx, 1024, 48, 9, base + n_valid, 10, 1024)
            assert int(i.max()) < base + n_valid
            assert_same_stream(s, i, s_ref, i_ref)

    @pytest.mark.parametrize("nq", [1, 7, 8, 9, 33])
    def test_queries_around_a_tile(self, jx, nq):
        assert_same_stream(*run_int8_both(jx, 1024, 112, nq, 1000, 32, 256))

    @pytest.mark.parametrize("d", [16, 48, 112])
    @pytest.mark.parametrize("k", [1, 10, 32])
    def test_k_and_dims(self, jx, k, d):
        assert_same_stream(*run_int8_both(jx, 1024, d, 5, 1000, k, 512, seed=d + k))

    def test_checks(self):
        _, e8, sc, pay, q = _int8_arrays()
        with pytest.raises(ValueError, match="multiple of 3000"):
            cs.int8_stream_search(T(e8), T(sc), T(pay), T(q), 10, 0.5, 0.0, block=3000)
        with pytest.raises(ValueError, match="scales"):
            cs.int8_stream_search(T(e8), T(sc)[:5].contiguous(), T(pay), T(q), 10, 0.5, 0.0)
        with pytest.raises(ValueError, match="int8"):
            cs.int8_stream_search(T(e8).float(), T(sc), T(pay), T(q), 10, 0.5, 0.0)
        assert cs.launch_counts["int8_stream_search"] == 0


# ---- on the card: each kernel against its plain version ------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _card_inputs(dev, cap, d, nq, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.nn.functional.normalize(torch.randn(cap, d, device=dev, generator=g), dim=1)
    e8 = torch.clamp(torch.round(emb * 127), -127, 127).to(torch.int8)
    sc = emb.abs().amax(dim=1) / 127.0
    pay = torch.rand(cap, 8, device=dev, generator=g)
    q = torch.nn.functional.normalize(torch.randn(nq, d, device=dev, generator=g), dim=1)
    return emb.contiguous(), e8.contiguous(), sc.contiguous(), pay, q.contiguous()


def _card_same(got, want):
    """Scores within 1e-5; ids equal wherever the plain scores stand further
    apart than that."""
    torch.cuda.synchronize()
    (s, i), (s_ref, i_ref) = [(a.cpu(), b.cpu()) for a, b in (got, want)]
    assert_same_stream(s, i, s_ref.numpy(), i_ref.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("cap,d,nq,n_valid,k", [
    (65536, 64, 5, 65000, 10), (65536, 64, 1, 65536, 10), (65536, 64, 32, 60001, 32),
    (65536, 64, 40, 65000, 10), (4096, 2048, 40, 4000, 10), (65536, 64, 3, 4, 10),
    (65536, 64, 2, 0, 5), (16384, 100, 7, 16000, 1), (1 << 20, 256, 8, 1_000_000, 10),
])
def test_card_stream_search(cuda_device, cap, d, nq, n_valid, k):
    emb, _, _, pay, q = _card_inputs(cuda_device, cap, d, nq)
    group = cs.stream_queries_per_launch("stream_search", d)
    before = cs.launch_counts["stream_search"]
    got = cs.stream_search(emb, pay, q, n_valid, 0.25, 0.1, k=k)
    assert cs.launch_counts["stream_search"] == before + -(-nq // group)
    _card_same(got, cs.stream_search_plain(emb, pay, q, n_valid, 0.25, 0.1, k=k))


@pytest.mark.cuda
@pytest.mark.parametrize("cap,d,nq,n_valid,k", [
    (65536, 64, 5, 65000, 10), (65536, 64, 1, 65536, 10), (65536, 64, 32, 60001, 32),
    (65536, 64, 40, 65000, 10), (4096, 2048, 40, 4000, 10), (65536, 64, 3, 4, 10),
    (65536, 64, 2, 0, 5), (16384, 112, 7, 16000, 1), (1 << 20, 256, 8, 1_000_000, 10),
])
def test_card_int8_stream_search(cuda_device, cap, d, nq, n_valid, k):
    _, e8, sc, pay, q = _card_inputs(cuda_device, cap, d, nq)
    group = cs.stream_queries_per_launch("int8_stream_search", d)
    before = cs.launch_counts["int8_stream_search"]
    got = cs.int8_stream_search(e8, sc, pay, q, n_valid, 0.25, 0.1, k=k)
    assert cs.launch_counts["int8_stream_search"] == before + -(-nq // group)
    _card_same(got, cs.int8_stream_search_plain(e8, sc, pay, q, n_valid, 0.25, 0.1, k=k))


@pytest.mark.cuda
@pytest.mark.parametrize("cap,d,nq,n_valid,k", [
    # live rows into a 32-row group and a 128-row tile, none, and fewer than k
    *[(65536, 64, 9, n, 10) for n in (1, 31, 32, 33, 127, 129, 32768 + 33, 0)],
    (65536, 64, 3, 20, 32),
    # queries around the tiles of 8 and the launch of 32
    *[(65536, 112, nq, 60001, 32) for nq in (1, 7, 8, 9, 16, 17, 32, 33)],
    # k and dims that end inside a 64-byte chunk
    *[(16384, d, 5, 16000, k) for d in (16, 48, 112) for k in (1, 10, 32)],
    # wide dims: fewer queries per launch
    (8192, 2048, 40, 8000, 10), (4096, 8192, 20, 4000, 10),
    # live rows past four seed prefixes: a seeding pass, then the full one
    (262144, 48, 9, 131073, 10), (262144, 64, 33, 262000, 32),
])
def test_card_int8_stream_edges(cuda_device, cap, d, nq, n_valid, k):
    _, e8, sc, pay, q = _card_inputs(cuda_device, cap, d, nq, seed=d + nq)
    group = cs.stream_queries_per_launch("int8_stream_search", d)
    assert group > 0
    before = cs.launch_counts["int8_stream_search"]
    got = cs.int8_stream_search(e8, sc, pay, q, n_valid, 0.25, 0.1, k=k)
    assert cs.launch_counts["int8_stream_search"] == before + -(-nq // group)
    _card_same(got, cs.int8_stream_search_plain(e8, sc, pay, q, n_valid, 0.25, 0.1, k=k))
    assert int(got[1].max()) < max(n_valid, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("ctas", [1, 2, 3, None])
def test_card_int8_ties_across_warps_and_ctas(cuda_device, ctas, monkeypatch):
    """Four equal rows that rank first for query 0, in the row groups that
    warps 0, 4, 6 and 2 of one CTA walk when the grid has one, and that
    fall on two CTAs with two or three: the lower row first, and the same
    answer whatever the grid."""
    monkeypatch.setattr(cs, "INT8_STREAM_CTAS", ctas)
    _, e8, sc, pay, q = _card_inputs(cuda_device, 8192, 64, 4)
    q8 = torch.clamp(torch.round(q[0] / q[0].abs().max() * 127), -127, 127).to(torch.int8)
    dup = [5, 130, 2000, 8000]
    e8[dup], sc[dup], pay[dup] = q8, q[0].abs().max() / 127.0, 1.0
    got = cs.int8_stream_search(e8, sc, pay, q, 8100, 0.25, 0.1, k=10)
    _card_same(got, cs.int8_stream_search_plain(e8, sc, pay, q, 8100, 0.25, 0.1, k=10))
    assert got[1][0, :4].tolist() == dup
    assert len(set(got[0][0, :4].tolist())) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("ctas", [3, None])
def test_card_int8_ties_around_the_seed(cuda_device, ctas, monkeypatch):
    """Where a first pass over the first 32,768 rows seeds the thresholds
    (more than 131,072 live rows, more than 8 queries):
    equal rows on both sides of that prefix, which rank first for query 0,
    come back lower row first, and the scores equal to the seed's k-th are
    not pruned."""
    monkeypatch.setattr(cs, "INT8_STREAM_CTAS", ctas)
    _, e8, sc, pay, q = _card_inputs(cuda_device, 262144, 64, 12)
    q8 = torch.clamp(torch.round(q[0] / q[0].abs().max() * 127), -127, 127).to(torch.int8)
    dup = [5, 32767, 32768, 200000, 261999]
    e8[dup], sc[dup], pay[dup] = q8, q[0].abs().max() / 127.0, 1.0
    for k in (2, 3, 5, 10):
        got = cs.int8_stream_search(e8, sc, pay, q, 262000, 0.25, 0.1, k=k)
        _card_same(got, cs.int8_stream_search_plain(e8, sc, pay, q, 262000, 0.25, 0.1, k=k))
        assert got[1][0, :min(k, 5)].tolist() == dup[:min(k, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_rows,ctas", [(128, 1), (1024, 3), (1 << 20, None)])
def test_card_ties_and_chunking(cuda_device, chunk_rows, ctas, monkeypatch):
    """Duplicated rows: the lower row first, whatever the chunking (the
    rows per CTA of ``stream_search``, the grid of ``int8_stream_search``)."""
    monkeypatch.setattr(cs, "STREAM_CHUNK_ROWS", chunk_rows)
    monkeypatch.setattr(cs, "INT8_STREAM_CTAS", ctas)
    emb, e8, sc, pay, q = _card_inputs(cuda_device, 8192, 64, 4)
    for src, dst in ((5, 8000), (5, 130), (4000, 17)):
        for t in (emb, e8, sc, pay):
            t[dst] = t[src]
    emb[[5, 8000, 130]] = q[0]
    got = cs.stream_search(emb, pay, q, 8100, 0.25, 0.1, k=10)
    want = cs.stream_search_plain(emb, pay, q, 8100, 0.25, 0.1, k=10)
    _card_same(got, want)
    assert got[1][0, :3].tolist() == [5, 130, 8000]
    got8 = cs.int8_stream_search(e8, sc, pay, q, 8100, 0.25, 0.1, k=10)
    _card_same(got8, cs.int8_stream_search_plain(e8, sc, pay, q, 8100, 0.25, 0.1, k=10))
    row = got8[1][1].tolist()
    if 17 in row and 4000 in row:
        assert row.index(17) < row.index(4000)


@pytest.mark.cuda
def test_card_stream_raises(cuda_device):
    emb, e8, sc, pay, q = _card_inputs(cuda_device, 4096, 64, 2)
    with pytest.raises(ValueError, match="k must be"):
        cs.stream_search(emb, pay, q, 4096, 0.25, 0.1, k=33)
    with pytest.raises(ValueError, match="multiple of 4"):
        cs.stream_search(emb[:, :62].contiguous(), pay, q[:, :62].contiguous(), 4096, 0.25, 0.1)
    with pytest.raises(ValueError, match="too wide"):
        wide = torch.zeros(128, 65536, device=cuda_device)
        cs.stream_search(wide, pay[:128].contiguous(), wide[:1].contiguous(), 128, 0.25, 0.1,
                         block=128)
    with pytest.raises(ValueError, match="same|must be on"):
        cs.int8_stream_search(e8, sc.cpu(), pay, q, 4096, 0.25, 0.1)
    with pytest.raises(ValueError, match="multiple of 16"):
        cs.int8_stream_search(e8[:, :56].contiguous(), sc, pay, q[:, :56].contiguous(), 4096,
                              0.25, 0.1)
    with pytest.raises(ValueError, match="too wide"):
        wide = torch.zeros(128, 32768, dtype=torch.int8, device=cuda_device)
        cs.int8_stream_search(wide, sc[:128].contiguous(), pay[:128].contiguous(),
                              torch.zeros(1, 32768, device=cuda_device), 128, 0.25, 0.1,
                              block=128)
