"""Stage-1 kernels of the port against the JAX package's Pallas kernels.

Each plain version in ``dewi_tpu_torch/ops/cuda_search.py`` (what a
wrapper computes for a CPU tensor) is held against its Pallas function run
in interpret mode, on the same seeded numpy inputs, with padding rows
masked through ``add = -inf``.  Tolerances: int4 and s8 kernels bit for bit
(the integer accumulator is exact, the f32 epilogue is the same fused
association); bf16-dot kernels, the corpus-major ``bmax_t`` included, rtol
1e-5 and atol 1e-5 of the largest |score| (only the order of the f32 sum
differs, and its rounding scales with the terms).  The quantizers must
match bit for bit.  The tensor-core kernels are also held at the shapes
their tiling makes special: 7, 8, 9, 17 and 33 queries (around the 8-query
tiles and the 32-query launch); for the float-query kernels dims 16, 48
and, for bf16 rows, 264 (a multiple of 8 but not of 16), over three
sub-blocks of which the last is all padding; for the s8 kernels dims 16,
48 (not a multiple of the 64-byte chunk) and 272 (a 16-byte second slab),
for the int4 kernels dims 32, 96 and 288 (packed rows of 16, 48 and 144
bytes: a part chunk, and a 16-byte second slab of 128-byte slab rows),
over 1024 rows whose last sub-block is all padding; one saturated s8 case
(all values +-127 at D 2048), where only an exact integer sum, not an f32
one, gives the reference's scores, and one saturated int4 case (every byte
value in the packed rows, queries +-127, D 2048).

``kernel_takes``, the kernels' shape predicate, is held at dims on and off
each kind's grid, and an index at a dim off it (int8 at D 100, with and
without int8 queries, int4 at D 48, exact bf16 at D 100) is held to call
no kernel wrapper and to return the JAX package's answers.

The tests marked ``cuda`` hold each CUDA kernel against its plain version
and skip without a card.  They import no JAX, so on the card they run
alone: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from dewi_tpu_torch.ops import cuda_search as cs
from dewi_tpu_torch.ops import quantized as tq

CAP, D = 4096, 64
N_LIVE = 3900  # rows >= N_LIVE are padding: add = -inf


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels and quantizers (imported lazily, so the
    card-only tests of this file run where JAX is not installed)."""
    import jax.numpy as jnp
    from dewi_tpu.ops import pallas_search, quantized

    return jnp, pallas_search, quantized


def _inputs(nq, seed, bf16_corpus=False, cap=CAP, d=D):
    """At another ``cap`` than the default the last 150 rows are padding: a
    whole 128-row sub-block of ``-inf`` and part of the one before."""
    rng = np.random.default_rng(seed)
    if bf16_corpus:
        emb = rng.normal(size=(cap, d)).astype(np.float32)
    else:
        emb = rng.integers(-127, 128, size=(cap, d)).astype(np.int8)
    vals = rng.integers(-7, 8, size=(cap, d)).astype(np.int8)
    packed = (vals[:, : d // 2] * 16 + (vals[:, d // 2:] + 8)).astype(np.int8)
    mult = rng.uniform(0.5, 1.5, size=cap).astype(np.float32)
    add = rng.normal(size=cap).astype(np.float32)
    add[N_LIVE if cap == CAP else cap - 150:] = -np.inf
    q = rng.normal(size=(nq, d)).astype(np.float32)
    q8 = rng.integers(-127, 128, size=(nq, d)).astype(np.int8)
    qs = rng.uniform(0.01, 0.1, size=nq).astype(np.float32)
    return emb, packed, mult, add, q, q8, qs


# Shapes the tensor-core tiling of the float-query kernels makes special:
# (queries, dim, bf16 rows).  Dim 264 is a multiple of 8 and not of 16, which
# only bf16 rows may have.
TILE_EDGE_SHAPES = ([(nq, d, bf) for nq in (7, 8, 9, 17, 33) for d in (16, 48)
                     for bf in (False, True)]
                    + [(nq, 264, True) for nq in (7, 8, 9, 17, 33)])
TILE_EDGE_CAP = 384  # three sub-blocks, walked in one block by the Pallas functions


# Shapes the tensor-core tiling of the s8 kernels makes special: (queries,
# dim).  Dim 48 is not a multiple of a 64-byte chunk; 272 adds a 16-byte
# second slab of 256-byte rows.
S8_TILE_EDGE_SHAPES = [(nq, d) for nq in (7, 8, 9, 17, 33) for d in (16, 48, 272)]
S8_TILE_EDGE_CAP = 1024  # the smallest corpus pallas_bmax_s8_t takes; 8 sub-blocks
# ... and of the int4 kernels: packed rows of 16 bytes (a part chunk), 48
# and 144 (a 16-byte second slab of 128-byte slab rows).
S4_TILE_EDGE_SHAPES = [(nq, d) for nq in (7, 8, 9, 17, 33) for d in (32, 96, 288)]


def _saturated_s8(nq=5, cap=S8_TILE_EDGE_CAP, d=2048, seed=44):
    """s8 queries and int8 rows that are all +-127.  The first half of the
    rows copy a query's signs with 1% of them flipped, so their |acc| passes
    2^24, past which an f32 running sum is no longer exact; the rest are
    random.  The last 150 rows are padding."""
    rng = np.random.default_rng(seed)
    qsign = rng.choice(np.array([-1, 1], np.int8), size=(nq, d))
    src = qsign[np.arange(cap) % nq]
    rate = np.where(np.arange(cap) < cap // 2, 0.01, 0.5)[:, None]
    emb = (127 * np.where(rng.random((cap, d)) < rate, -src, src)).astype(np.int8)
    mult = rng.uniform(0.5, 1.5, size=cap).astype(np.float32)
    add = rng.normal(size=cap).astype(np.float32)
    add[cap - 150:] = -np.inf
    qs = rng.uniform(0.01, 0.1, size=nq).astype(np.float32)
    return emb, mult, add, (127 * qsign).astype(np.int8), qs


def _saturated_s4(nq=5, cap=S8_TILE_EDGE_CAP, d=2048, seed=47):
    """Packed int4 rows against s8 queries of +-127.  In the first quarter
    of the rows every nibble is an extreme (7 or -8) of the sign of a
    query's matching dim, so |acc| comes near 127 * 8 * D; in the rest
    row r holds the byte values r, r + 1, ... mod 256, so every byte value
    sits at every packed column.  The last 150 rows are padding."""
    rng = np.random.default_rng(seed)
    d2 = d // 2
    qsign = rng.choice(np.array([-1, 1], np.int8), size=(nq, d))
    src = qsign[np.arange(cap) % nq]
    hi = np.where(src[:, :d2] > 0, 7, -8)
    lo = np.where(src[:, d2:] > 0, 7, -8)
    packed = (hi * 16 + lo + 8).astype(np.uint8)
    cyc = ((np.arange(cap)[:, None] + np.arange(d2)[None, :]) % 256).astype(np.uint8)
    packed = np.where((np.arange(cap) < cap // 4)[:, None], packed, cyc).view(np.int8)
    mult = rng.uniform(0.5, 1.5, size=cap).astype(np.float32)
    add = rng.normal(size=cap).astype(np.float32)
    add[cap - 150:] = -np.inf
    qs = rng.uniform(0.01, 0.1, size=nq).astype(np.float32)
    return packed, mult, add, (127 * qsign).astype(np.int8), qs


def _corpus_pair(jnp, emb, bf16_corpus):
    """The same corpus for both packages (bf16 rounding is RNE in both)."""
    if bf16_corpus:
        return jnp.asarray(emb).astype(jnp.bfloat16), torch.from_numpy(emb).to(torch.bfloat16)
    return jnp.asarray(emb), torch.from_numpy(emb)


def _assert_match(port, ref, rtol, atol):
    """``atol`` is relative to the largest |score|: the f32 sum's rounding
    error scales with its terms, not with a result near zero."""
    port = port.float().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(np.isneginf(port), np.isneginf(ref))
    fin = np.isfinite(ref)
    scale = float(np.abs(ref[fin]).max())
    np.testing.assert_allclose(port[fin], ref[fin], rtol=rtol, atol=atol * scale)


T = torch.from_numpy


class TestPlainVsPallas:
    @pytest.mark.parametrize("nq", [1, 5, 32])
    def test_bmax_s4(self, jx, nq):
        jnp, ps, _ = jx
        _, packed, mult, add, _, q8, qs = _inputs(nq, 1)
        ref = ps.pallas_bmax_s4(jnp.asarray(packed), jnp.asarray(mult), jnp.asarray(add),
                                jnp.asarray(q8), jnp.asarray(qs), block=1024,
                                interpret=True)
        port = cs.bmax_s4(T(packed), T(mult), T(add), T(q8), T(qs))
        _assert_match(port, ref, rtol=0, atol=0)

    @pytest.mark.parametrize("nq", [1, 5, 32])
    @pytest.mark.parametrize("bf16_out", [False, True])
    def test_scores_matrix_s4(self, jx, nq, bf16_out):
        jnp, ps, _ = jx
        _, packed, mult, add, _, q8, qs = _inputs(nq, 2)
        ref = ps.pallas_scores_matrix_s4(
            jnp.asarray(packed), jnp.asarray(mult), jnp.asarray(add), jnp.asarray(q8),
            jnp.asarray(qs), block=1024, interpret=True,
            out_dtype=jnp.bfloat16 if bf16_out else jnp.float32)
        port = cs.scores_matrix_s4(T(packed), T(mult), T(add), T(q8), T(qs),
                                   out_dtype=torch.bfloat16 if bf16_out else torch.float32)
        assert port.dtype == (torch.bfloat16 if bf16_out else torch.float32)
        _assert_match(port, ref, rtol=0, atol=0)

    @pytest.mark.parametrize("nq", [1, 5, 32])
    @pytest.mark.parametrize("bf16_corpus", [False, True])
    def test_bmax(self, jx, nq, bf16_corpus):
        jnp, ps, _ = jx
        emb, _, mult, add, q, _, _ = _inputs(nq, 3, bf16_corpus)
        je, te = _corpus_pair(jnp, emb, bf16_corpus)
        ref = ps.pallas_bmax(je, jnp.asarray(mult), jnp.asarray(add), jnp.asarray(q),
                             block=1024, interpret=True)
        port = cs.bmax(te, T(mult), T(add), T(q))
        _assert_match(port, ref, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("nq,d,bf16_corpus", TILE_EDGE_SHAPES)
    def test_bmax_tile_edges(self, jx, nq, d, bf16_corpus):
        jnp, ps, _ = jx
        emb, _, mult, add, q, _, _ = _inputs(nq, 40, bf16_corpus, cap=TILE_EDGE_CAP, d=d)
        je, te = _corpus_pair(jnp, emb, bf16_corpus)
        ref = ps.pallas_bmax(je, jnp.asarray(mult), jnp.asarray(add), jnp.asarray(q),
                             block=TILE_EDGE_CAP, interpret=True)
        port = cs.bmax(te, T(mult), T(add), T(q))
        assert tuple(port.shape) == (nq, 3) and bool(torch.isneginf(port[:, 2]).all())
        _assert_match(port, ref, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("nq", [1, 5, 32])
    @pytest.mark.parametrize("bf16_corpus", [False, True])
    def test_scores_matrix(self, jx, nq, bf16_corpus):
        jnp, ps, _ = jx
        emb, _, mult, add, q, _, _ = _inputs(nq, 4, bf16_corpus)
        je, te = _corpus_pair(jnp, emb, bf16_corpus)
        ref = ps.pallas_scores_matrix(je, jnp.asarray(mult), jnp.asarray(add),
                                      jnp.asarray(q), block=1024, interpret=True)
        port = cs.scores_matrix(te, T(mult), T(add), T(q))
        _assert_match(port, ref, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("nq,d,bf16_corpus", TILE_EDGE_SHAPES)
    def test_scores_matrix_tile_edges(self, jx, nq, d, bf16_corpus):
        jnp, ps, _ = jx
        emb, _, mult, add, q, _, _ = _inputs(nq, 41, bf16_corpus, cap=TILE_EDGE_CAP, d=d)
        je, te = _corpus_pair(jnp, emb, bf16_corpus)
        ref = ps.pallas_scores_matrix(je, jnp.asarray(mult), jnp.asarray(add),
                                      jnp.asarray(q), block=TILE_EDGE_CAP, interpret=True)
        port = cs.scores_matrix(te, T(mult), T(add), T(q))
        _assert_match(port, ref, rtol=1e-5, atol=1e-5)

    def test_scores_matrix_bf16_out(self, jx):
        jnp, ps, _ = jx
        emb, _, mult, add, q, _, _ = _inputs(5, 5)
        ref = ps.pallas_scores_matrix(jnp.asarray(emb), jnp.asarray(mult), jnp.asarray(add),
                                      jnp.asarray(q), block=1024, interpret=True,
                                      out_dtype=jnp.bfloat16)
        port = cs.scores_matrix(T(emb), T(mult), T(add), T(q), out_dtype=torch.bfloat16)
        # One bf16 ulp: the f32 scores may differ in the last bits before rounding.
        _assert_match(port, ref, rtol=2 ** -7, atol=1e-5)


    @pytest.mark.parametrize("nq", [1, 5, 32])
    def test_bmax_s8(self, jx, nq):
        jnp, ps, _ = jx
        emb, _, mult, add, _, q8, qs = _inputs(nq, 30)
        ref = ps.pallas_bmax_s8(jnp.asarray(emb), jnp.asarray(mult), jnp.asarray(add),
                                jnp.asarray(q8), jnp.asarray(qs), block=1024,
                                interpret=True)
        port = cs.bmax_s8(T(emb), T(mult), T(add), T(q8), T(qs))
        _assert_match(port, ref, rtol=0, atol=0)

    @pytest.mark.parametrize("nq", [1, 5, 32])
    @pytest.mark.parametrize("bf16_out", [False, True])
    def test_scores_matrix_s8(self, jx, nq, bf16_out):
        jnp, ps, _ = jx
        emb, _, mult, add, _, q8, qs = _inputs(nq, 31)
        ref = ps.pallas_scores_matrix_s8(
            jnp.asarray(emb), jnp.asarray(mult), jnp.asarray(add), jnp.asarray(q8),
            jnp.asarray(qs), block=1024, interpret=True,
            out_dtype=jnp.bfloat16 if bf16_out else jnp.float32)
        port = cs.scores_matrix_s8(T(emb), T(mult), T(add), T(q8), T(qs),
                                   out_dtype=torch.bfloat16 if bf16_out else torch.float32)
        assert port.dtype == (torch.bfloat16 if bf16_out else torch.float32)
        _assert_match(port, ref, rtol=0, atol=0)

    @pytest.mark.parametrize("nq", [1, 5, 32])
    @pytest.mark.parametrize("bf16_corpus", [False, True])
    def test_bmax_t(self, jx, nq, bf16_corpus):
        jnp, ps, _ = jx
        emb, _, mult, add, q, _, _ = _inputs(nq, 32, bf16_corpus)
        je, te = _corpus_pair(jnp, emb, bf16_corpus)
        ref = ps.pallas_bmax_t(je, jnp.asarray(mult), jnp.asarray(add), jnp.asarray(q),
                               block=1024, interpret=True)
        port = cs.bmax_t(te, T(mult), T(add), T(q))
        assert tuple(port.shape) == (CAP // 128, nq)
        _assert_match(port, ref, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("nq,d,bf16_corpus", TILE_EDGE_SHAPES)
    def test_bmax_t_tile_edges(self, jx, nq, d, bf16_corpus):
        """``pallas_bmax_t`` walks blocks of a multiple of 1024 rows, so its
        smallest corpus is 1024 rows (eight sub-blocks, the last all padding)."""
        jnp, ps, _ = jx
        emb, _, mult, add, q, _, _ = _inputs(nq, 42, bf16_corpus, cap=1024, d=d)
        je, te = _corpus_pair(jnp, emb, bf16_corpus)
        ref = ps.pallas_bmax_t(je, jnp.asarray(mult), jnp.asarray(add), jnp.asarray(q),
                               block=1024, interpret=True)
        port = cs.bmax_t(te, T(mult), T(add), T(q))
        assert tuple(port.shape) == (8, nq) and bool(torch.isneginf(port[7]).all())
        _assert_match(port, ref, rtol=1e-5, atol=1e-5)
        assert torch.equal(port, cs.bmax(te, T(mult), T(add), T(q)).T)

    @pytest.mark.parametrize("nq", [1, 5, 32])
    def test_bmax_s8_t(self, jx, nq):
        jnp, ps, _ = jx
        emb, _, mult, add, _, q8, qs = _inputs(nq, 33)
        ref = ps.pallas_bmax_s8_t(jnp.asarray(emb), jnp.asarray(mult), jnp.asarray(add),
                                  jnp.asarray(q8), jnp.asarray(qs), block=1024,
                                  interpret=True)
        port = cs.bmax_s8_t(T(emb), T(mult), T(add), T(q8), T(qs))
        assert tuple(port.shape) == (CAP // 128, nq)
        _assert_match(port, ref, rtol=0, atol=0)
        # the corpus-major maxima are the query-major ones transposed
        assert torch.equal(port, cs.bmax_s8(T(emb), T(mult), T(add), T(q8), T(qs)).T)

    @pytest.mark.parametrize("nq,d", S8_TILE_EDGE_SHAPES)
    def test_bmax_s8_tile_edges(self, jx, nq, d):
        jnp, ps, _ = jx
        emb, _, mult, add, _, q8, qs = _inputs(nq, 43, cap=S8_TILE_EDGE_CAP, d=d)
        ref = ps.pallas_bmax_s8(jnp.asarray(emb), jnp.asarray(mult), jnp.asarray(add),
                                jnp.asarray(q8), jnp.asarray(qs), block=S8_TILE_EDGE_CAP,
                                interpret=True)
        port = cs.bmax_s8(T(emb), T(mult), T(add), T(q8), T(qs))
        assert tuple(port.shape) == (nq, 8) and bool(torch.isneginf(port[:, 7]).all())
        _assert_match(port, ref, rtol=0, atol=0)

    @pytest.mark.parametrize("nq,d", S8_TILE_EDGE_SHAPES)
    @pytest.mark.parametrize("bf16_out", [False, True])
    def test_scores_matrix_s8_tile_edges(self, jx, nq, d, bf16_out):
        jnp, ps, _ = jx
        emb, _, mult, add, _, q8, qs = _inputs(nq, 44, cap=S8_TILE_EDGE_CAP, d=d)
        ref = ps.pallas_scores_matrix_s8(
            jnp.asarray(emb), jnp.asarray(mult), jnp.asarray(add), jnp.asarray(q8),
            jnp.asarray(qs), block=S8_TILE_EDGE_CAP, interpret=True,
            out_dtype=jnp.bfloat16 if bf16_out else jnp.float32)
        port = cs.scores_matrix_s8(T(emb), T(mult), T(add), T(q8), T(qs),
                                   out_dtype=torch.bfloat16 if bf16_out else torch.float32)
        _assert_match(port, ref, rtol=0, atol=0)

    @pytest.mark.parametrize("nq,d", S8_TILE_EDGE_SHAPES)
    def test_bmax_s8_t_tile_edges(self, jx, nq, d):
        jnp, ps, _ = jx
        emb, _, mult, add, _, q8, qs = _inputs(nq, 45, cap=S8_TILE_EDGE_CAP, d=d)
        ref = ps.pallas_bmax_s8_t(jnp.asarray(emb), jnp.asarray(mult), jnp.asarray(add),
                                  jnp.asarray(q8), jnp.asarray(qs), block=S8_TILE_EDGE_CAP,
                                  interpret=True)
        port = cs.bmax_s8_t(T(emb), T(mult), T(add), T(q8), T(qs))
        assert tuple(port.shape) == (8, nq) and bool(torch.isneginf(port[7]).all())
        _assert_match(port, ref, rtol=0, atol=0)
        assert torch.equal(port, cs.bmax_s8(T(emb), T(mult), T(add), T(q8), T(qs)).T)

    @pytest.mark.parametrize("nq,d", S4_TILE_EDGE_SHAPES)
    def test_bmax_s4_tile_edges(self, jx, nq, d):
        jnp, ps, _ = jx
        _, packed, mult, add, _, q8, qs = _inputs(nq, 46, cap=S8_TILE_EDGE_CAP, d=d)
        ref = ps.pallas_bmax_s4(jnp.asarray(packed), jnp.asarray(mult), jnp.asarray(add),
                                jnp.asarray(q8), jnp.asarray(qs), block=S8_TILE_EDGE_CAP,
                                interpret=True)
        port = cs.bmax_s4(T(packed), T(mult), T(add), T(q8), T(qs))
        assert tuple(port.shape) == (nq, 8) and bool(torch.isneginf(port[:, 7]).all())
        _assert_match(port, ref, rtol=0, atol=0)

    @pytest.mark.parametrize("nq,d", S4_TILE_EDGE_SHAPES)
    @pytest.mark.parametrize("bf16_out", [False, True])
    def test_scores_matrix_s4_tile_edges(self, jx, nq, d, bf16_out):
        jnp, ps, _ = jx
        _, packed, mult, add, _, q8, qs = _inputs(nq, 47, cap=S8_TILE_EDGE_CAP, d=d)
        ref = ps.pallas_scores_matrix_s4(
            jnp.asarray(packed), jnp.asarray(mult), jnp.asarray(add), jnp.asarray(q8),
            jnp.asarray(qs), block=S8_TILE_EDGE_CAP, interpret=True,
            out_dtype=jnp.bfloat16 if bf16_out else jnp.float32)
        port = cs.scores_matrix_s4(T(packed), T(mult), T(add), T(q8), T(qs),
                                   out_dtype=torch.bfloat16 if bf16_out else torch.float32)
        _assert_match(port, ref, rtol=0, atol=0)

    @pytest.mark.parametrize("kernel", ["bmax_s4", "scores_matrix_s4"])
    def test_s4_saturated(self, jx, kernel):
        jnp, ps, _ = jx
        packed, mult, add, q8, qs = _saturated_s4()
        assert set(np.unique(packed.view(np.uint8))) == set(range(256))
        ref = getattr(ps, "pallas_" + kernel)(
            jnp.asarray(packed), jnp.asarray(mult), jnp.asarray(add), jnp.asarray(q8),
            jnp.asarray(qs), block=S8_TILE_EDGE_CAP, interpret=True)
        port = getattr(cs, kernel)(T(packed), T(mult), T(add), T(q8), T(qs))
        _assert_match(port, ref, rtol=0, atol=0)

    def test_scores_matrix_s8_saturated(self, jx):
        jnp, ps, _ = jx
        emb, mult, add, q8, qs = _saturated_s8()
        acc = q8.astype(np.int64) @ emb.T.astype(np.int64)
        f32_running_sum = np.add.accumulate(
            q8[:, None, :].astype(np.float32) * emb[None].astype(np.float32), axis=-1)[..., -1]
        assert np.abs(acc).max() > 2 ** 24 and bool((f32_running_sum != acc).any())
        ref = ps.pallas_scores_matrix_s8(jnp.asarray(emb), jnp.asarray(mult), jnp.asarray(add),
                                         jnp.asarray(q8), jnp.asarray(qs),
                                         block=S8_TILE_EDGE_CAP, interpret=True)
        port = cs.scores_matrix_s8(T(emb), T(mult), T(add), T(q8), T(qs))
        _assert_match(port, ref, rtol=0, atol=0)


class TestQuantizersBitExact:
    @pytest.mark.parametrize("shape", [(64, 32), (257, 64), (16, 256)])
    def test_quantize_rows(self, jx, shape):
        jnp, _, jq = jx
        x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
        x[3] = 0.0  # zero row: scale 0, codes 0
        ref_q, ref_s = jq.quantize_rows(jnp.asarray(x))
        q, s = tq.quantize_rows(T(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
        np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))

    @pytest.mark.parametrize("shape", [(64, 32), (257, 64), (16, 256)])
    def test_quantize_rows_int4_and_unpack(self, jx, shape):
        jnp, _, jq = jx
        x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
        x[3] = 0.0
        ref_p, ref_s = jq.quantize_rows_int4(jnp.asarray(x))
        p, s = tq.quantize_rows_int4(T(x))
        np.testing.assert_array_equal(p.numpy(), np.asarray(ref_p))
        np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
        np.testing.assert_array_equal(tq.unpack_int4(p).numpy(),
                                      np.asarray(jq.unpack_int4(ref_p)))

    def test_unpack_every_byte(self, jx):
        jnp, _, jq = jx
        b = np.arange(-128, 128, dtype=np.int8).reshape(8, 32)
        np.testing.assert_array_equal(tq.unpack_int4(T(b)).numpy(),
                                      np.asarray(jq.unpack_int4(jnp.asarray(b))))


class TestWrapperChecks:
    def test_rejects_bad_inputs(self):
        _, packed, mult, add, q, q8, qs = _inputs(3, 8)
        e8 = T(np.zeros((CAP, D), np.int8))
        with pytest.raises(ValueError, match="queries"):
            cs.scores_matrix(e8, T(mult), T(add), T(q).double())
        with pytest.raises(ValueError, match="mult"):
            cs.bmax(e8, T(mult)[:-1], T(add), T(q))
        with pytest.raises(ValueError, match="multiple of 128"):
            cs.bmax(e8[:1000], T(mult)[:1000], T(add)[:1000], T(q))
        with pytest.raises(ValueError, match="no queries"):
            cs.bmax_s4(T(packed), T(mult), T(add), T(np.zeros((0, D), np.int8)),
                       T(np.ones(0, np.float32)))
        with pytest.raises(ValueError, match="D/2"):
            cs.scores_matrix_s4(T(packed), T(mult), T(add), T(q8[:, :32].copy()), T(qs))
        with pytest.raises(ValueError, match="contiguous"):
            cs.scores_matrix(e8, T(mult), T(add), T(q).t().contiguous().t())

    def test_rejects_bad_s8_inputs(self):
        emb, packed, mult, add, q, q8, qs = _inputs(3, 10)
        with pytest.raises(ValueError, match="corpus must be int8"):
            cs.bmax_s8(T(emb).float(), T(mult), T(add), T(q8), T(qs))
        with pytest.raises(ValueError, match="queries must be int8"):
            cs.scores_matrix_s8(T(emb), T(mult), T(add), T(q), T(qs))
        with pytest.raises(ValueError, match="q_scale"):
            cs.bmax_s8_t(T(emb), T(mult), T(add), T(q8), T(qs[:2].copy()))
        with pytest.raises(ValueError, match="queries must be float32"):
            cs.bmax_t(T(emb), T(mult), T(add), T(q8))

    def test_plain_path_counts_no_launch(self):
        emb, packed, mult, add, q, q8, qs = _inputs(2, 9)
        cs.reset_launch_counts()
        cs.bmax_s4(T(packed), T(mult), T(add), T(q8), T(qs))
        cs.bmax_s8(T(emb), T(mult), T(add), T(q8), T(qs))
        cs.bmax_t(T(emb), T(mult), T(add), T(q))
        assert cs.launch_counts["bmax_s4"] == 0
        assert sum(cs.launch_counts.values()) == 0


# ---- routing by the dim ---------------------------------------------------


@pytest.mark.parametrize("kind,d,takes", [
    ("int8", 96, True), ("int8", 100, False), ("int8", 8, False),
    ("s8", 256, True), ("s8", 100, False),
    ("bf16", 104, True), ("bf16", 100, False),
    ("s4", 64, True), ("s4", 48, False), ("s4", 0, False),
])
def test_kernel_takes(kind, d, takes):
    """The dim rule alone off the card: rows of whole 16-byte copies."""
    assert cs.kernel_takes(kind, d) is takes
    assert cs.kernel_takes(kind, d, torch.device("cpu")) is takes


# Indexes at a dim their stage-1 kernels do not take: (backend, options,
# dim, kernel kind).  At 33,000 docs the capacity is 65,536, so the fused
# block-max gate would engage at a dim the kernels take.
OFF_GRID_INDEXES = [
    ("int8", {}, 100, "int8"),
    ("int8", {"int8_queries": True}, 100, "s8"),
    ("int4", {}, 48, "s4"),
    ("exact", {"dtype": torch.bfloat16}, 100, "bf16"),
]
OFF_GRID_DOCS = 33_000
STAGE1_WRAPPERS = ("bmax", "bmax_s4", "scores_matrix", "scores_matrix_s4", "bmax_s8",
                   "scores_matrix_s8", "bmax_t", "bmax_s8_t")


def _off_grid_corpus(d, nq):
    rng = np.random.default_rng(d)
    emb = rng.normal(size=(OFF_GRID_DOCS, d)).astype(np.float32)
    pay = np.abs(rng.normal(size=(OFF_GRID_DOCS, 8))).astype(np.float32)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    return [f"d{i}" for i in range(OFF_GRID_DOCS)], emb, pay, q


@pytest.mark.parametrize("backend,kw,d,kind", OFF_GRID_INDEXES)
def test_off_grid_dim_takes_the_plain_route(jx, monkeypatch, backend, kw, d, kind):
    """The index gates ask ``kernel_takes``: off its grid every gate is shut,
    no kernel wrapper is called (a CUDA tensor there would raise), and the
    plain route returns what the JAX package returns on the same inputs."""
    from dewi_tpu import DewiIndex as JDewiIndex
    from dewi_tpu_torch import DewiIndex
    from test_torch_search import assert_same_topk

    jnp = jx[0]
    assert not cs.kernel_takes(kind, d)
    ids, emb, pay, q = _off_grid_corpus(d, 7)
    calls = []
    for name in STAGE1_WRAPPERS:
        fn = getattr(cs, name)
        monkeypatch.setattr(cs, name,
                            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    port = DewiIndex(dim=d, backend=backend, device="cpu", **kw)
    jkw = {k: (jnp.bfloat16 if v is torch.bfloat16 else v) for k, v in kw.items()}
    ref = JDewiIndex(dim=d, backend=backend, **jkw)
    for ix in (port, ref):
        ix.add_batch(ids, emb, pay)
        ix.build()
    b = port._backend
    assert b.store.capacity == 65536
    if backend == "exact":
        assert not b._pallas_ok(7) and not b._fused_bmax_ok(7)
    else:
        assert not b._pallas_stage1_ok(7) and b._fused_bmax_block() == 0
    s, i = port.search_batch(q, k=10, eta=0.3, entropy_pref=0.2)
    assert calls == []
    s_ref, i_ref = ref.search_batch(q, k=10, eta=0.3, entropy_pref=0.2)
    assert_same_topk(s, i, s_ref, i_ref)


# ---- on the card: each kernel against its plain version ------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _card_inputs(dev, cap=65536, d=64, nq=5, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    e8 = torch.randint(-127, 128, (cap, d), dtype=torch.int8, device=dev, generator=g)
    ebf = torch.randn(cap, d, device=dev, generator=g).to(torch.bfloat16)
    p4 = torch.randint(-128, 128, (cap, d // 2), dtype=torch.int8, device=dev, generator=g)
    mult = torch.rand(cap, device=dev, generator=g) + 0.5
    add = torch.randn(cap, device=dev, generator=g)
    add[cap - 200:] = float("-inf")
    q = torch.randn(nq, d, device=dev, generator=g)
    q8 = torch.randint(-127, 128, (nq, d), dtype=torch.int8, device=dev, generator=g)
    qs = torch.rand(nq, device=dev, generator=g) * 0.1
    return e8, ebf, p4, mult, add, q, q8, qs


def _card_match(got, want, rtol, atol):
    """As ``_assert_match``: ``atol`` is a fraction of the largest |score|."""
    torch.cuda.synchronize()
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    scale = float(want[fin].abs().max())
    torch.testing.assert_close(got[fin], want[fin], rtol=rtol, atol=atol * scale)


# (queries, dim, capacity, saturated) for the int4 kernels on the card: the
# ragged main shapes, the tile edges of the CPU tests, and the saturated
# case at D 2048 in two launches.
CARD_S4_CASES = ([(nq, 64, 65536, False) for nq in (1, 5, 32, 40)]
                 + [(nq, d, S8_TILE_EDGE_CAP, False) for nq, d in S4_TILE_EDGE_SHAPES]
                 + [(40, 2048, 4096, True)])


def _card_s4_inputs(dev, nq, d, cap, saturated):
    """Packed int4 rows, mult, add, s8 queries and their scales on the card."""
    if saturated:
        return tuple(T(a).to(dev) for a in _saturated_s4(nq, cap, d))
    _, _, p4, mult, add, _, q8, qs = _card_inputs(dev, cap=cap, d=d, nq=nq)
    return p4, mult, add, q8, qs


@pytest.mark.cuda
@pytest.mark.parametrize("nq,d,cap,saturated", CARD_S4_CASES)
def test_card_bmax_s4(cuda_device, nq, d, cap, saturated):
    s4 = _card_s4_inputs(cuda_device, nq, d, cap, saturated)
    before = cs.launch_counts["bmax_s4"]
    got = cs.bmax_s4(*s4)
    assert cs.launch_counts["bmax_s4"] == before + (nq + 31) // 32
    assert bool(torch.isneginf(got[:, -1]).all())
    _card_match(got, cs.bmax_s4_plain(*s4), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,d,cap,saturated", CARD_S4_CASES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_card_scores_matrix_s4(cuda_device, nq, d, cap, saturated, out_dtype):
    s4 = _card_s4_inputs(cuda_device, nq, d, cap, saturated)
    got = cs.scores_matrix_s4(*s4, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    _card_match(got, cs.scores_matrix_s4_plain(*s4, out_dtype), rtol=0, atol=0)


# (queries, dim, capacity) for the float-query kernels on the card: the
# ragged main shapes, the tile edges of the CPU tests and two wide dims.
CARD_FLOAT_SHAPES = ([(nq, 64, 65536) for nq in (1, 5, 32)]
                     + [(nq, d, TILE_EDGE_CAP) for nq in (7, 8, 9, 17, 33)
                        for d in (16, 48, 264)]
                     + [(33, 2048, 4096), (9, 8192, 4096)])


def _float_corpora(e8, ebf):
    """int8 rows need a dim that is a multiple of 16, bf16 rows of 8."""
    return (e8, ebf) if e8.shape[1] % 16 == 0 else (ebf,)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,d,cap", CARD_FLOAT_SHAPES)
def test_card_bmax(cuda_device, nq, d, cap):
    """The last 200 rows are padding (``add = -inf``), so the last
    sub-block's maximum must be ``-inf`` itself, not NaN."""
    e8, ebf, _, mult, add, q, _, _ = _card_inputs(cuda_device, cap=cap, d=d, nq=nq)
    for emb in _float_corpora(e8, ebf):
        got = cs.bmax(emb, mult, add, q)
        assert bool(torch.isneginf(got[:, -1]).all())
        _card_match(got, cs.bmax_plain(emb, mult, add, q), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,d,cap", CARD_FLOAT_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_card_scores_matrix(cuda_device, nq, d, cap, out_dtype):
    e8, ebf, _, mult, add, q, _, _ = _card_inputs(cuda_device, cap=cap, d=d, nq=nq)
    # bf16 out: the f32 scores may differ in the last bits before rounding,
    # which can move a score by one bf16 ulp.
    rtol = 1e-5 if out_dtype == torch.float32 else 2 ** -7
    for emb in _float_corpora(e8, ebf):
        got = cs.scores_matrix(emb, mult, add, q, out_dtype=out_dtype)
        assert got.dtype == out_dtype
        _card_match(got, cs.scores_matrix_plain(emb, mult, add, q, out_dtype),
                    rtol=rtol, atol=1e-5)


@pytest.mark.cuda
def test_card_score_independent_of_batch(cuda_device):
    """One code path serves every Q, so a query's stage-1 score is the same
    bit for bit whether it rides alone, in a tile of 8 or in a full launch."""
    e8, ebf, p4, mult, add, q, q8, qs = _card_inputs(cuda_device, nq=32)
    for emb in (e8, ebf):
        full = cs.scores_matrix(emb, mult, add, q)
        for nq in (1, 8, 9):
            assert torch.equal(cs.scores_matrix(emb, mult, add, q[:nq].contiguous()), full[:nq])
        assert torch.equal(cs.bmax(emb, mult, add, q[:1].contiguous()),
                           cs.bmax(emb, mult, add, q)[:1])
    full = cs.scores_matrix_s8(e8, mult, add, q8, qs)
    for nq in (1, 8, 9):
        part = (e8, mult, add, q8[:nq].contiguous(), qs[:nq].contiguous())
        assert torch.equal(cs.scores_matrix_s8(*part), full[:nq])
        assert torch.equal(cs.bmax_s8(*part), cs.bmax_s8(e8, mult, add, q8, qs)[:nq])
        assert torch.equal(cs.bmax_s8_t(*part), cs.bmax_s8_t(e8, mult, add, q8, qs)[:, :nq])
    full = cs.scores_matrix_s4(p4, mult, add, q8, qs)
    for nq in (1, 8, 9):
        part = (p4, mult, add, q8[:nq].contiguous(), qs[:nq].contiguous())
        assert torch.equal(cs.scores_matrix_s4(*part), full[:nq])
        assert torch.equal(cs.bmax_s4(*part), cs.bmax_s4(p4, mult, add, q8, qs)[:nq])


@pytest.mark.cuda
@pytest.mark.parametrize("d,nq,groups", [
    # (dim, queries, queries per launch over int8 rows, bf16 rows, int4 rows)
    (2048, 32, (32, 32, 32)),
    (2048, 40, (32, 32, 32)),
    (8192, 20, (8, 8, 16)),
])
def test_card_wide_dim(cuda_device, d, nq, groups):
    """Wide dims: the staged queries must fit in shared memory, so past
    some dim a launch takes fewer than 32 queries (the float-query kernels
    stage bf16 queries in whole tiles of 8 for either row type)."""
    e8, ebf, p4, mult, add, q, q8, qs = _card_inputs(cuda_device, cap=4096, d=d, nq=nq)
    g_int8, g_bf16, g_s4 = groups
    for emb, g in ((e8, g_int8), (ebf, g_bf16)):
        for name, fn, plain in (("bmax", cs.bmax, cs.bmax_plain),
                                ("scores_matrix", cs.scores_matrix, cs.scores_matrix_plain)):
            before = cs.launch_counts[name]
            got = fn(emb, mult, add, q)
            assert cs.launch_counts[name] - before == -(-nq // g)
            _card_match(got, plain(emb, mult, add, q), rtol=1e-5, atol=1e-5)
    for name, fn, plain in (("bmax_s4", cs.bmax_s4, cs.bmax_s4_plain),
                            ("scores_matrix_s4", cs.scores_matrix_s4,
                             cs.scores_matrix_s4_plain)):
        before = cs.launch_counts[name]
        got = fn(p4, mult, add, q8, qs)
        assert cs.launch_counts[name] - before == -(-nq // g_s4)
        _card_match(got, plain(p4, mult, add, q8, qs), rtol=0, atol=0)


# (queries, dim, capacity, saturated) for the s8 kernels on the card: the
# ragged main shapes, the tile edges of the CPU tests, and the saturated
# case at D 2048 in two launches.
CARD_S8_CASES = ([(nq, 64, 65536, False) for nq in (1, 5, 32, 40)]
                 + [(nq, d, S8_TILE_EDGE_CAP, False) for nq, d in S8_TILE_EDGE_SHAPES]
                 + [(40, 2048, 4096, True)])


def _card_s8_inputs(dev, nq, d, cap, saturated):
    """int8 rows, mult, add, s8 queries and their scales on the card."""
    if saturated:
        return tuple(T(a).to(dev) for a in _saturated_s8(nq, cap, d))
    e8, _, _, mult, add, _, q8, qs = _card_inputs(dev, cap=cap, d=d, nq=nq)
    return e8, mult, add, q8, qs


@pytest.mark.cuda
@pytest.mark.parametrize("nq,d,cap,saturated", CARD_S8_CASES)
def test_card_bmax_s8(cuda_device, nq, d, cap, saturated):
    s8 = _card_s8_inputs(cuda_device, nq, d, cap, saturated)
    before = cs.launch_counts["bmax_s8"]
    got = cs.bmax_s8(*s8)
    assert cs.launch_counts["bmax_s8"] == before + (nq + 31) // 32
    assert bool(torch.isneginf(got[:, -1]).all())
    _card_match(got, cs.bmax_s8_plain(*s8), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,d,cap,saturated", CARD_S8_CASES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_card_scores_matrix_s8(cuda_device, nq, d, cap, saturated, out_dtype):
    s8 = _card_s8_inputs(cuda_device, nq, d, cap, saturated)
    got = cs.scores_matrix_s8(*s8, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    _card_match(got, cs.scores_matrix_s8_plain(*s8, out_dtype), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,d,cap,saturated",
                         [(nq, 64, 65536, False) for nq in (1, 5, 32, 40)]
                         + [(nq, d, cap, False) for nq, d, cap in CARD_FLOAT_SHAPES[3:]]
                         + CARD_S8_CASES[4:])
def test_card_corpus_major(cuda_device, nq, d, cap, saturated):
    """The ``*_t`` kernels: their plain versions, and bit for bit the
    query-major kernels transposed (a group of 32 writes its columns)."""
    e8, ebf, _, mult, add, q, q8, qs = _card_inputs(cuda_device, cap=cap, d=d, nq=nq)
    if d % 16 == 0:
        s8 = _card_s8_inputs(cuda_device, nq, d, cap, saturated)
        got = cs.bmax_s8_t(*s8)
        assert tuple(got.shape) == (cap // 128, nq)
        _card_match(got, cs.bmax_s8_t_plain(*s8), rtol=0, atol=0)
        assert torch.equal(got, cs.bmax_s8(*s8).T)
    if saturated:
        return
    for emb in _float_corpora(e8, ebf):
        got = cs.bmax_t(emb, mult, add, q)
        assert bool(torch.isneginf(got[-1]).all())
        _card_match(got, cs.bmax_t_plain(emb, mult, add, q), rtol=1e-5, atol=1e-5)
        assert torch.equal(got, cs.bmax(emb, mult, add, q).T)


@pytest.mark.cuda
def test_card_s8_rejects_misaligned_queries(cuda_device):
    """The s8 kernels read 16 query bytes at a time, so a query view that
    does not start on 16 bytes is refused, not read misaligned."""
    e8, _, _, mult, add, _, q8, qs = _card_inputs(cuda_device, nq=2)
    q_off = torch.zeros(2 * 64 + 1, dtype=torch.int8, device=cuda_device)[1:].view(2, 64)
    q_off.copy_(q8)
    for fn in (cs.bmax_s8, cs.scores_matrix_s8, cs.bmax_s8_t):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(e8, mult, add, q_off, qs)


@pytest.mark.cuda
def test_card_s4_rejects_misaligned_queries(cuda_device):
    """The int4 kernels read the queries 16 bytes at a time too."""
    _, _, p4, mult, add, _, q8, qs = _card_inputs(cuda_device, nq=2)
    q_off = torch.zeros(2 * 64 + 1, dtype=torch.int8, device=cuda_device)[1:].view(2, 64)
    q_off.copy_(q8)
    for fn in (cs.bmax_s4, cs.scores_matrix_s4):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(p4, mult, add, q_off, qs)


@pytest.mark.cuda
def test_card_wrappers_refuse_off_grid_dims(cuda_device):
    """A wrapper given a dim its kernel does not take raises; the index
    gates keep the index routes from asking."""
    e8, ebf, p4, mult, add, q, q8, qs = _card_inputs(cuda_device, cap=1024, d=96, nq=2)
    with pytest.raises(ValueError, match="multiple of 32"):
        cs.bmax_s4(p4[:, :24].contiguous(), mult, add, q8[:, :48].contiguous(), qs)
    with pytest.raises(ValueError, match="multiple of 16"):
        cs.bmax_s8(e8[:, :88].contiguous(), mult, add, q8[:, :88].contiguous(), qs)
    with pytest.raises(ValueError, match="multiple of 8"):
        cs.scores_matrix(ebf[:, :92].contiguous(), mult, add, q[:, :92].contiguous())
    assert not cs.kernel_takes("s4", 48, cuda_device)
    assert cs.kernel_takes("s4", 96, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,kw,d,kind", OFF_GRID_INDEXES)
def test_card_off_grid_dim_takes_the_plain_route(cuda_device, backend, kw, d, kind):
    """An index on the card at a dim its kernels do not take searches (at
    Q 5 and, in 32-query groups, 40) without raising, launches no kernel,
    and returns what the same index with ``use_pallas=False`` returns."""
    from dewi_tpu_torch import DewiIndex

    ids, emb, pay, q = _off_grid_corpus(d, 40)
    idx = DewiIndex(dim=d, backend=backend, **kw)
    plain = DewiIndex(dim=d, backend=backend, use_pallas=False, **kw)
    for ix in (idx, plain):
        ix.add_batch(ids, emb, pay)
        ix.build()
    assert idx._backend.store.capacity == 65536
    for nq in (5, 40):
        cs.reset_launch_counts()
        s, i = idx.search_batch(q[:nq], k=10, eta=0.3, entropy_pref=0.2)
        torch.cuda.synchronize()
        assert sum(cs.launch_counts.values()) == 0
        s_p, i_p = plain.search_batch(q[:nq], k=10, eta=0.3, entropy_pref=0.2)
        assert bool(torch.isfinite(s).all()) and s.shape == (nq, 10)
        assert torch.equal(s, s_p) and torch.equal(i, i_p)


@pytest.mark.cuda
@pytest.mark.parametrize("d,nq,group", [(2048, 40, 32), (8192, 20, 16)])
def test_card_wide_dim_s8(cuda_device, d, nq, group):
    e8, _, _, mult, add, _, q8, qs = _card_inputs(cuda_device, cap=4096, d=d, nq=nq)
    for name, fn, plain in (("bmax_s8", cs.bmax_s8, cs.bmax_s8_plain),
                            ("scores_matrix_s8", cs.scores_matrix_s8,
                             cs.scores_matrix_s8_plain),
                            ("bmax_s8_t", cs.bmax_s8_t, cs.bmax_s8_t_plain)):
        before = cs.launch_counts[name]
        got = fn(e8, mult, add, q8, qs)
        assert cs.launch_counts[name] - before == -(-nq // group)
        _card_match(got, plain(e8, mult, add, q8, qs), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,d,rows", [(5, 64, 32768), (40, 64, 32768), (40, 2048, 32768),
                                       (3, 100, 32765)])
def test_card_plain_s8_route(cuda_device, nq, d, rows):
    """The s8 stage 1 without a kernel (``s8_folded_dot``): ``torch._int_mm``
    on zero-padded queries (and dims and rows, where they are not multiples
    of 8), then ``addcmul``; bit for bit the exact plain version of
    ``scores_matrix_s8``."""
    from dewi_tpu_torch.ops.similarity import s8_folded_dot

    e8, _, _, mult, add, _, q8, qs = _card_inputs(cuda_device, cap=32768, d=d, nq=nq)
    e8, mult, add = e8[:rows], mult[:rows], add[:rows]
    got = s8_folded_dot(q8, e8, qs, mult, add)
    _card_match(got, cs.scores_matrix_s8_plain(e8, mult, add, q8, qs), rtol=0, atol=0)
