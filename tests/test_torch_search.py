"""The port's search ops against the JAX package's, on the same corpus.

``quantized_search`` is held against the JAX function on its TPU route
(Pallas stage 1 in interpret mode, ``approx_select=False``): the fused
block-max route and the unfused scores-kernel route, int8 and packed int4,
float and s8 queries, query-major and corpus-major stream blocks, cosine
and L2, Q in {3, 40} (40 exercises the 32-query chunking and the
score-gather refine).  The plain s8 stage 1 is held bit for bit against
the JAX package's int32 dot at D = 2048, where an f32 sum is no longer
exact.  ``fused_search`` is held against JAX's two-pass block max, with
and without the stage-1 kernel.

Scores: allclose (rtol 1e-5, atol 1e-6; stage 2 is exact f32 on both
sides).  Ids: compared only where scores differ (tie order may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dewi_tpu.ops import quantized as jq
from dewi_tpu.ops import similarity as jsim
from dewi_tpu_torch.ops import quantized as tq
from dewi_tpu_torch.ops import similarity as tsim

CAP, D, N_LIVE = 4096, 64, 3900
ETA, EP = 0.3, 0.2


def _corpus(seed, normalize=True):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(CAP, D)).astype(np.float32)
    emb[N_LIVE:] = 0.0
    if normalize:
        emb = np.asarray(jsim.l2_normalize(jnp.asarray(emb)))
    pay = np.abs(rng.normal(size=(CAP, 8))).astype(np.float32)
    sqn = np.sum(emb * emb, axis=1).astype(np.float32)
    return emb, pay, sqn


def assert_same_topk(s_port, i_port, s_ref, i_ref, rtol=1e-5, atol=1e-6):
    s_port, i_port = s_port.float().numpy(), i_port.numpy()
    s_ref, i_ref = np.asarray(s_ref, np.float32), np.asarray(i_ref)
    np.testing.assert_allclose(s_port, s_ref, rtol=rtol, atol=atol)
    tol = atol + rtol * np.abs(s_ref)
    for r in range(s_ref.shape[0]):
        # ids whose score is clear of the k-th one must agree as sets, and
        # each rank whose score is clear of both neighbours must agree
        clear = s_ref[r] > s_ref[r, -1] + 2 * tol[r]
        assert set(i_port[r][clear]) == set(i_ref[r][clear])
        for j in range(s_ref.shape[1]):
            lo = s_ref[r, j + 1] if j + 1 < s_ref.shape[1] else -np.inf
            hi = s_ref[r, j - 1] if j else np.inf
            if hi - s_ref[r, j] > 2 * tol[r, j] and s_ref[r, j] - lo > 2 * tol[r, j]:
                assert i_port[r, j] == i_ref[r, j]


def _quantized_args(emb, pay, sqn, q, int4):
    if int4:
        je, js = jq.quantize_rows_int4(jnp.asarray(emb))
    else:
        je, js = jq.quantize_rows(jnp.asarray(emb))
    jargs = (je, js, jnp.asarray(emb), jnp.asarray(sqn), jnp.asarray(pay), jnp.asarray(q),
             jnp.int32(N_LIVE), jnp.float32(ETA), jnp.float32(EP))
    targs = (torch.from_numpy(np.asarray(je)), torch.from_numpy(np.asarray(js)),
             torch.from_numpy(emb), torch.from_numpy(sqn), torch.from_numpy(pay),
             torch.from_numpy(q), N_LIVE, ETA, EP)
    return jargs, targs


@pytest.mark.parametrize("nq", [3, 40, 100])
@pytest.mark.parametrize("space", ["cosine", "l2"])
@pytest.mark.parametrize("int4", [False, True])
def test_quantized_search_fused_route(nq, space, int4):
    normalize = space == "cosine"
    emb, pay, sqn = _corpus(11, normalize)
    q = np.random.default_rng(12).normal(size=(nq, D)).astype(np.float32)
    jargs, targs = _quantized_args(emb, pay, sqn, q, int4)
    m = 320 if int4 else 80
    s_ref, i_ref = jq.quantized_search(
        *jargs, k=10, m=m, normalize=normalize, approx_select=False,
        pallas_stage1=True, pallas_block=CAP, interpret=True,
        int8_queries=int4, blockmax_select=True, fused_bmax=True, int4_packed=int4)
    s, i = tq.quantized_search(
        *targs, k=10, m=m, normalize=normalize, kernel_stage1=True,
        kernel_block=CAP, int8_queries=int4, blockmax_select=True,
        fused_bmax=True, int4_packed=int4)
    assert_same_topk(s, i, s_ref, i_ref)


@pytest.mark.parametrize("nq", [3, 40])
@pytest.mark.parametrize("space", ["cosine", "l2"])
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("blockmax", [False, True])
def test_quantized_search_scores_kernel_route(nq, space, int4, blockmax):
    normalize = space == "cosine"
    emb, pay, sqn = _corpus(13, normalize)
    q = np.random.default_rng(14).normal(size=(nq, D)).astype(np.float32)
    jargs, targs = _quantized_args(emb, pay, sqn, q, int4)
    m = 320 if int4 else 80
    s_ref, i_ref = jq.quantized_search(
        *jargs, k=10, m=m, normalize=normalize, approx_select=False,
        pallas_stage1=True, pallas_block=CAP, interpret=True,
        int8_queries=int4, blockmax_select=blockmax, int4_packed=int4)
    s, i = tq.quantized_search(
        *targs, k=10, m=m, normalize=normalize, kernel_stage1=True,
        int8_queries=int4, blockmax_select=blockmax, int4_packed=int4)
    assert_same_topk(s, i, s_ref, i_ref)


@pytest.mark.parametrize("bf16_scores", [False, True])
def test_quantized_search_plain_routes(bf16_scores):
    """The XLA stage-1 routes (no kernel): bf16 dot and s8 dot."""
    emb, pay, sqn = _corpus(15)
    q = np.random.default_rng(16).normal(size=(5, D)).astype(np.float32)
    for int8_queries in (False, True):
        jargs, targs = _quantized_args(emb, pay, sqn, q, int4=False)
        s_ref, i_ref = jq.quantized_search(
            *jargs, k=10, m=80, approx_select=False, int8_queries=int8_queries,
            bf16_scores=bf16_scores, blockmax_select=True)
        s, i = tq.quantized_search(*targs, k=10, m=80, int8_queries=int8_queries,
                                   bf16_scores=bf16_scores, blockmax_select=True)
        assert_same_topk(s, i, s_ref, i_ref)


def test_quantized_search_s8_kernel_route_matches_jax():
    """The kernel route with int8 queries runs the s8 stage-1 kernels and
    matches JAX's Pallas s8 route."""
    emb, pay, sqn = _corpus(17)
    q = np.random.default_rng(18).normal(size=(2, D)).astype(np.float32)
    jargs, targs = _quantized_args(emb, pay, sqn, q, int4=False)
    s_ref, i_ref = jq.quantized_search(
        *jargs, k=10, m=80, approx_select=False, pallas_stage1=True, pallas_block=CAP,
        interpret=True, int8_queries=True)
    s, i = tq.quantized_search(*targs, k=10, m=80, kernel_stage1=True, int8_queries=True)
    assert_same_topk(s, i, s_ref, i_ref)


@pytest.mark.parametrize("nq", [3, 40, 100])
@pytest.mark.parametrize("block", [512, 1024, CAP])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("int4,int8_queries", [(False, False), (False, True), (True, True)])
def test_quantized_search_block_routes(nq, block, fused, int4, int8_queries):
    """Every stream block of the JAX gates on a 4096 cap: 512 is too small
    to fuse (it runs the scores kernel), 1024 fuses corpus-major
    (``bmax_t``/``bmax_s8_t``; packed int4 unpacks and runs unfused), 4096
    is the whole corpus and fuses query-major."""
    emb, pay, sqn = _corpus(19)
    q = np.random.default_rng(20).normal(size=(nq, D)).astype(np.float32)
    jargs, targs = _quantized_args(emb, pay, sqn, q, int4)
    m = 320 if int4 else 80
    s_ref, i_ref = jq.quantized_search(
        *jargs, k=10, m=m, approx_select=False, pallas_stage1=True, pallas_block=block,
        interpret=True, int8_queries=int8_queries, blockmax_select=True,
        fused_bmax=fused, int4_packed=int4)
    s, i = tq.quantized_search(
        *targs, k=10, m=m, kernel_stage1=True, kernel_block=block,
        int8_queries=int8_queries, blockmax_select=True, fused_bmax=fused,
        int4_packed=int4)
    assert_same_topk(s, i, s_ref, i_ref)


@pytest.mark.parametrize("space", ["cosine", "l2"])
@pytest.mark.parametrize("int4", [False, True])
def test_fused_batch_equals_its_32_query_slices(space, int4):
    """A fused call of 100 queries runs one pipeline (four stage-1 launches,
    the last of 4 queries, then one select and one refine) and gives each
    query what the small-Q body gives its 32-row slice, as the JAX
    package's 32-query groups do.  Under cosine the slices get the
    normalised queries, which the groups normalise once more."""
    normalize = space == "cosine"
    emb, pay, sqn = _corpus(21, normalize)
    q = np.random.default_rng(22).normal(size=(100, D)).astype(np.float32)
    _, targs = _quantized_args(emb, pay, sqn, q, int4)
    kw = dict(k=10, m=320 if int4 else 80, normalize=normalize, kernel_stage1=True,
              kernel_block=CAP, int8_queries=True, blockmax_select=True, fused_bmax=True,
              int4_packed=int4)
    s, i = tq.quantized_search(*targs, **kw)
    qt = targs[5]
    if normalize:
        qt = tsim.l2_normalize(qt)
    parts = [tq.quantized_search(*targs[:5], qt[j:j + 32], *targs[6:], **kw)
             for j in range(0, 100, 32)]
    torch.testing.assert_close(s, torch.cat([p[0] for p in parts]), rtol=0, atol=1e-6)
    assert torch.equal(i, torch.cat([p[1] for p in parts]))


def _saturated_s8(nq, cap=2048, d=2048, seed=27):
    """Rows of 127/125 and queries of 127/123: the s8 dot passes 2^24."""
    rng = np.random.default_rng(seed)
    e8 = np.where(rng.random((cap, d)) < 0.5, 127, 125).astype(np.int8)
    q8 = np.where(rng.random((nq, d)) < 0.5, 127, 123).astype(np.int8)
    qs = rng.uniform(0.001, 0.01, nq).astype(np.float32)
    mult = rng.uniform(0.5, 1.5, cap).astype(np.float32)
    add = rng.normal(size=cap).astype(np.float32)
    return e8, q8, qs, mult, add


@pytest.mark.parametrize("nq", [1, 3])
def test_plain_s8_stage1_is_exact_at_wide_dim(nq):
    """The plain s8 stage 1 equals, bit for bit, the JAX package's XLA s8
    stage 1 (dewi_tpu/ops/quantized.py:415-421: int32 dot, cast to f32,
    ``acc * (q_scale * mult) + add``) where an f32 sum of the products
    rounds (127^2 * 2048 > 2^24)."""
    import jax

    e8, q8, qs, mult, add = _saturated_s8(nq)
    acc = jax.lax.dot_general(jnp.asarray(q8), jnp.asarray(e8),
                              dimension_numbers=(((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32).astype(jnp.float32)
    ref = np.asarray(jax.jit(lambda a, s, m, b: a * (s[:, None] * m[None, :]) + b[None, :])(
        acc, jnp.asarray(qs), jnp.asarray(mult), jnp.asarray(add)))
    T = torch.from_numpy
    got = tsim.s8_folded_dot(T(q8), T(e8), T(qs), T(mult), T(add))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_plain_s8_route_matches_jax_at_wide_dim():
    """``quantized_search`` with int8 queries on the plain route (no
    kernel, flat select, k = m) over saturated rows at D = 2048."""
    e8, _, _, _, _ = _saturated_s8(1)
    emb = e8.astype(np.float32)
    pay = np.zeros((e8.shape[0], 8), np.float32)
    sqn = np.sum(emb * emb, axis=1).astype(np.float32)
    q = np.where(np.random.default_rng(28).random((2, e8.shape[1])) < 0.5,
                 127.0, 123.0).astype(np.float32)
    scales = np.ones(e8.shape[0], np.float32)
    n = e8.shape[0]
    s_ref, i_ref = jq.quantized_search(
        jnp.asarray(e8), jnp.asarray(scales), jnp.asarray(emb), jnp.asarray(sqn),
        jnp.asarray(pay), jnp.asarray(q), jnp.int32(n), jnp.float32(0.0),
        jnp.float32(0.0), k=10, m=10, approx_select=False, int8_queries=True)
    T = torch.from_numpy
    s, i = tq.quantized_search(T(e8), T(scales), T(emb), T(sqn), T(pay), T(q), n, 0.0,
                               0.0, k=10, m=10, int8_queries=True)
    assert_same_topk(s, i, s_ref, i_ref)


@pytest.mark.parametrize("dtype,space,route", [
    ("float32", "cosine", "plain"), ("float32", "l2", "plain"),
    ("bfloat16", "cosine", "plain"), ("bfloat16", "l2", "plain"),
    # the stage-1 kernel serves bf16 cosine stores
    ("bfloat16", "cosine", "kernel"), ("bfloat16", "cosine", "fused"),
])
def test_fused_search_blockmax(dtype, space, route):
    normalize = space == "cosine"
    emb, pay, sqn = _corpus(21, normalize)
    q = np.random.default_rng(22).normal(size=(6, D)).astype(np.float32)
    je = jnp.asarray(emb).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    te = torch.from_numpy(emb).to(getattr(torch, dtype))
    flags = dict(k=10, normalize=normalize, blockmax_select=True)
    s_ref, i_ref = jsim.fused_search(
        je, jnp.asarray(sqn), jnp.asarray(pay), jnp.asarray(q), jnp.int32(N_LIVE),
        jnp.float32(ETA), jnp.float32(EP), pallas_scores=route != "plain",
        fused_bmax=route == "fused", interpret=True, pallas_block=CAP, **flags)
    s, i = tsim.fused_search(
        te, torch.from_numpy(sqn), torch.from_numpy(pay), torch.from_numpy(q), N_LIVE,
        ETA, EP, kernel_scores=route != "plain", fused_bmax=route == "fused",
        kernel_block=CAP, **flags)
    assert_same_topk(s, i, s_ref, i_ref)


def test_fused_search_flat_topk_and_helpers():
    emb, pay, sqn = _corpus(23)
    q = np.random.default_rng(24).normal(size=(4, D)).astype(np.float32)
    s_ref, i_ref = jsim.fused_search(
        jnp.asarray(emb), jnp.asarray(sqn), jnp.asarray(pay), jnp.asarray(q),
        jnp.int32(N_LIVE), jnp.float32(ETA), jnp.float32(EP), k=10)
    s, i = tsim.fused_search(torch.from_numpy(emb), torch.from_numpy(sqn),
                             torch.from_numpy(pay), torch.from_numpy(q), N_LIVE,
                             ETA, EP, k=10)
    assert_same_topk(s, i, s_ref, i_ref)
    assert int(i.max()) < N_LIVE
    a, b = q, emb[:50]
    np.testing.assert_allclose(tsim.pairwise_cosine(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jsim.pairwise_cosine(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)
    sim = np.random.default_rng(25).normal(size=(3, CAP)).astype(np.float32)
    np.testing.assert_allclose(
        tsim.rerank_scores(torch.from_numpy(sim), torch.from_numpy(pay), ETA, EP).numpy(),
        np.asarray(jsim.rerank_scores(jnp.asarray(sim), jnp.asarray(pay),
                                      jnp.float32(ETA), jnp.float32(EP))), rtol=1e-6)
    sc = np.random.default_rng(26).normal(size=(3, 40)).astype(np.float32)
    ix = np.arange(120).reshape(3, 40).astype(np.int64)
    vs, vi = tsim.topk_merge(torch.from_numpy(sc), torch.from_numpy(ix), 5)
    ws, wi = jsim.topk_merge(jnp.asarray(sc), jnp.asarray(ix.astype(np.int32)), 5)
    np.testing.assert_array_equal(vs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(vi.numpy(), np.asarray(wi))
