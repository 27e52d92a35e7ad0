"""Ring attention (``dewi_tpu_torch.parallel.ring``) and the estimator's
long-document path against ``dewi_tpu.parallel.ring``.

The port runs on four gloo ranks started once by ``parallel.launch_local``
(a module-scoped fixture; the rank function lives at module level and this
module imports JAX only inside test bodies, so the ranks never load it).
The reference runs as ``tests/test_ring.py`` calls it, on 4 or 8 of the
conftest's virtual CPU devices; the port's 4 ranks give the same values.
Inputs come from numpy with a seed; the LM weights are the port's seeded
init, carried to the reference by ``convert.lm_params_to_flax``; the
estimators of both packages load one msgpack checkpoint with a sidecar.

Tolerances:

* attention outputs (float32): 2e-5 absolute, with the reference's
  ``rtol 2e-4``;
* ring logits and the long document's NLL (float32): ``rtol 2e-4,
  atol 2e-4``, the reference's;
* estimators on a float32 checkpoint: 1e-5 of the largest value (mean,
  q90, q99, per-token NLL);
* estimators on a bfloat16 checkpoint: mean within 2e-2, q90 within 5e-2
  and per-token NLL within ``rtol 3e-2, atol 3e-2``, the bounds of the
  reference's ``test_estimator_ring_mode_matches_direct_forward``.
"""

import numpy as np
import pytest
import torch

from dewi_tpu_torch.models import registry as treg
from dewi_tpu_torch.models.lm import token_nll
from dewi_tpu_torch.parallel import launch_local, make_mesh, single_device_mesh
from dewi_tpu_torch.parallel.mesh import all_gather
from dewi_tpu_torch.parallel.ring import ring_attention, ring_lm_logits, ring_token_nll
from dewi_tpu_torch.signals import TextEntropyEstimator

RANKS = 4
LAUNCH_TIMEOUT = 180.0
ATTN_ATOL, ATTN_RTOL = 2e-5, 2e-4
LOGIT_TOL = 2e-4
F32_RTOL = 1e-5
BF16_MEAN, BF16_Q90, BF16_TOKEN = 2e-2, 5e-2, 3e-2
RING_TEXT = "the quick brown fox jumps over the lazy dog " * 3   # ~132 tokens
LONG_TEXT = "word " * 300                                         # past max_len: windows
EST_KW = dict(model_name="tiny", max_length=256, batch_size=4)


def _qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.normal(size=(2, 3, 32, 16)).astype(np.float32) for _ in range(3))


def _attn_pad():
    pad = np.ones((2, 32), np.float32)
    pad[:, 24:] = 0.0
    return pad


def _lm(max_len):
    return treg.init_lm(treg.lm_config("tiny", max_len=max_len, dtype="float32"), seed=0,
                        device="cpu")


def _lm_inputs(t, seed):
    ids = np.random.default_rng(seed).integers(0, 258, (2, t)).astype(np.int64)
    pad = np.ones_like(ids, np.float32)
    if t == 64:
        pad[:, 48:] = 0.0
    return ids, pad


def _texts():
    return ["short", "a few more words here", RING_TEXT, LONG_TEXT, "x" * 70]


def _estimate(est):
    """The results the tests hold to the reference."""
    r = est.compute_entropy(RING_TEXT)
    return {"ring": (r.mean_entropy, r.q90_entropy, r.q99_entropy, r.token_entropies),
            "relative": est.compute_entropy(RING_TEXT, relative_to_domain=True).token_entropies,
            "stats": est.batch_compute_stats(_texts())}


def _ring_worker(ckpts):
    torch.manual_seed(0)
    mesh = make_mesh(1, RANKS, device="cpu")
    group = mesh.group("model")
    i, tl = mesh.model_index, 32 // RANKS
    q, k, v = (torch.from_numpy(a[:, :, i * tl:(i + 1) * tl]) for a in _qkv())
    pad = torch.from_numpy(_attn_pad()[:, i * tl:(i + 1) * tl])
    out = {}
    for name, causal, p in (("causal", True, None), ("bidirectional", False, None),
                            ("pad", True, pad)):
        o = ring_attention(q, k, v, mesh, causal=causal, pad_mask=p)
        out[name] = all_gather(o, group, dim=2).numpy()
    out["one_rank"] = ring_attention(*(torch.from_numpy(a) for a in _qkv()),
                                     single_device_mesh("cpu"), causal=True).numpy()
    out["logits"] = ring_lm_logits(_lm(32), *_lm_inputs(32, 0), mesh).numpy()
    ids, pad = _lm_inputs(64, 1)
    model = _lm(64)
    out["long_doc_logits"] = ring_lm_logits(model, ids, pad, mesh).numpy()
    nll, valid = ring_token_nll(model, ids, pad, mesh)
    out["long_doc_nll"] = (nll.numpy(), valid.numpy())
    for dtype, paths in ckpts.items():
        est = TextEntropyEstimator(ring_mesh=mesh, chip_len=64, checkpoint=paths["lm"],
                                   domain_model_name="tiny", domain_checkpoint=paths["domain"],
                                   **EST_KW)
        out[f"estimator_{dtype}"] = _estimate(est)
        out[f"chip_len_{dtype}"] = est.chip_len
    est = TextEntropyEstimator("tiny", max_length=64, chip_len=32, ring_mesh=mesh)
    out["windows"] = est.compute_entropy(LONG_TEXT).mean_entropy
    mesh22 = make_mesh(2, 2, device="cpu")
    est = TextEntropyEstimator(ring_mesh=mesh22, chip_len=64, checkpoint=ckpts["float32"]["lm"],
                               **EST_KW)
    out["data_parallel_mesh"] = est.compute_entropy(RING_TEXT).token_entropies
    return out


# ---- the fixtures ---------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    from dewi_tpu.models.import_hf import write_sidecar_config

    tmp = tmp_path_factory.mktemp("ring")
    dom = tmp / "domain.msgpack"
    treg.save_params(treg.init_lm(treg.lm_config("tiny", max_len=256), seed=2, device="cpu"), dom)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = treg.lm_config("tiny", max_len=256, dtype=dtype)
        path = tmp / f"lm_{dtype}.msgpack"
        treg.save_params(treg.init_lm(cfg, seed=1, device="cpu"), path)
        write_sidecar_config(path, "lm", cfg)
        out[dtype] = {"lm": str(path), "domain": str(dom)}
    return out


@pytest.fixture(scope="module")
def port(ckpts):
    return launch_local(_ring_worker, RANKS, (ckpts,), timeout=LAUNCH_TIMEOUT, threads=1)


def _jax_mesh(n_data, n_model):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n_data * n_model]).reshape(n_data, n_model),
                ("data", "model"))


def _ref_estimator(**kw):
    from test_torch_signals import _ref

    from dewi_tpu.signals import text_entropy as j_text

    return _ref(lambda: j_text.TextEntropyEstimator(**kw))


def rel_dev(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---- ring attention -------------------------------------------------------------


@pytest.mark.parametrize("name,n_dev,causal,pad", [
    ("causal", 4, True, False), ("bidirectional", 8, False, False), ("pad", 4, True, True),
    ("one_rank", 1, True, False)])
def test_ring_attention_matches_reference(port, name, n_dev, causal, pad):
    import jax.numpy as jnp

    from dewi_tpu.parallel.ring import ring_attention as j_ring

    q, k, v = (jnp.asarray(a) for a in _qkv())
    p = jnp.asarray(_attn_pad()) if pad else None
    want = np.asarray(j_ring(q, k, v, _jax_mesh(1, n_dev), causal=causal, pad_mask=p))
    got = port[name]
    if pad:  # rows past the last real key: both packages are free there
        got, want = got[:, :, :24], want[:, :, :24]
    np.testing.assert_allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL)


def test_ring_attention_matches_dense_softmax(port):
    q, k, v = _qkv()
    sc = np.einsum("bhqd,bhkd->bhqk", q, k) / 4.0
    sc = np.where(np.tril(np.ones((32, 32), bool)), sc, -1e30)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(port["causal"], want, rtol=ATTN_RTOL, atol=ATTN_ATOL)


# ---- the ring LM -----------------------------------------------------------------


def test_ring_logits_match_reference_and_plain_forward(port):
    from dewi_tpu.models import registry as jreg
    from dewi_tpu.parallel.ring import ring_lm_logits as j_ring_logits
    from dewi_tpu_torch import convert

    model = _lm(32)
    ids, pad = _lm_inputs(32, 0)
    params = convert.lm_params_to_flax(model)
    want = np.asarray(j_ring_logits(jreg.TransformerConfig(**model.cfg.__dict__), params,
                                    ids.astype(np.int32), pad, _jax_mesh(1, 4)))
    np.testing.assert_allclose(port["logits"], want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    with torch.no_grad():
        plain = model(torch.from_numpy(ids), torch.from_numpy(pad)).numpy()
    np.testing.assert_allclose(port["logits"], plain, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_padded_long_doc_nll(port):
    """The reference's ``test_padded_long_doc`` (8 devices there, 4 ranks
    here), and the gathered NLL equal to the NLL of the gathered logits."""
    from dewi_tpu.models import registry as jreg
    from dewi_tpu.models.lm import token_nll as j_token_nll
    from dewi_tpu.parallel.ring import ring_lm_logits as j_ring_logits
    from dewi_tpu_torch import convert

    model = _lm(64)
    ids, pad = _lm_inputs(64, 1)
    cfg = jreg.TransformerConfig(**model.cfg.__dict__)
    ref_logits = j_ring_logits(cfg, convert.lm_params_to_flax(model), ids.astype(np.int32), pad,
                               _jax_mesh(1, 8))
    nr, vr = (np.asarray(a) for a in j_token_nll(ref_logits, ids, pad))
    ng, vg = port["long_doc_nll"]
    np.testing.assert_array_equal(vg, vr)
    np.testing.assert_allclose(ng[vg], nr[vr], rtol=LOGIT_TOL, atol=LOGIT_TOL)
    with torch.no_grad():
        plain = model(torch.from_numpy(ids), torch.from_numpy(pad))
    np_, vp = token_nll(plain, torch.from_numpy(ids), torch.from_numpy(pad))
    np.testing.assert_allclose(ng[vg], np_.numpy()[vp.numpy()], rtol=LOGIT_TOL, atol=LOGIT_TOL)
    nl, _ = token_nll(torch.from_numpy(port["long_doc_logits"]), torch.from_numpy(ids),
                      torch.from_numpy(pad))
    np.testing.assert_allclose(ng[vg], nl.numpy()[vg], rtol=1e-6, atol=1e-6)


# ---- the estimator ---------------------------------------------------------------


def _assert_estimates(got, want, dtype):
    if dtype == "float32":
        assert rel_dev(got["ring"][:3], want["ring"][:3]) <= F32_RTOL
        assert rel_dev(got["ring"][3], want["ring"][3]) <= F32_RTOL
        assert rel_dev(got["relative"], want["relative"]) <= 3e-2  # the domain LM is bf16
        for g, w in zip(got["stats"], want["stats"]):
            assert rel_dev(g, w) <= F32_RTOL
        return
    assert abs(got["ring"][0] - want["ring"][0]) < BF16_MEAN
    assert abs(got["ring"][1] - want["ring"][1]) < BF16_Q90
    np.testing.assert_allclose(got["ring"][3], want["ring"][3], rtol=BF16_TOKEN, atol=BF16_TOKEN)
    np.testing.assert_allclose(got["relative"], want["relative"], rtol=BF16_TOKEN,
                               atol=BF16_TOKEN)
    for g, w in zip(got["stats"], want["stats"]):
        np.testing.assert_allclose(g, w, rtol=BF16_MEAN, atol=BF16_MEAN)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_estimator_ring_mode_matches_reference(port, ckpts, dtype):
    """``chip_len < n <= max_len``: one ring forward, in both packages, on
    one checkpoint; ``batch_compute_stats`` mixes short documents, a ring
    document and one past ``max_len`` (windows of ``chip_len``)."""
    ref = _ref_estimator(ring_mesh=_jax_mesh(1, 4), chip_len=64, checkpoint=ckpts[dtype]["lm"],
                         domain_model_name="tiny", domain_checkpoint=ckpts[dtype]["domain"],
                         **EST_KW)
    n = ref._token_count(RING_TEXT, 1 << 30)
    assert ref.chip_len == port[f"chip_len_{dtype}"] == 64 < n <= 256
    _assert_estimates(port[f"estimator_{dtype}"], _estimate(ref), dtype)


def test_estimator_ring_mode_matches_direct_forward(port, ckpts):
    """The reference's test on the port: the ring's whole-document score
    equals one process's direct forward (no windows at ``max_len`` 256)."""
    plain = TextEntropyEstimator(device="cpu", checkpoint=ckpts["bfloat16"]["lm"], **EST_KW)
    r = plain.compute_entropy(RING_TEXT)
    got = port["estimator_bfloat16"]["ring"]
    assert abs(got[0] - r.mean_entropy) < BF16_MEAN
    assert abs(got[1] - r.q90_entropy) < BF16_Q90
    np.testing.assert_allclose(got[3], r.token_entropies, rtol=BF16_TOKEN, atol=BF16_TOKEN)


def test_windows_fallback_past_positional_capacity(port):
    assert np.isfinite(port["windows"]) and port["windows"] > 0


def test_ring_mode_on_data_parallel_mesh(port):
    """A ``[1, T]`` document on a 2 x 2 mesh replicates its batch dim and
    scores as on the 1 x 4 mesh."""
    got = port["data_parallel_mesh"]
    assert rel_dev(got, port["estimator_float32"]["ring"][3]) <= F32_RTOL


def test_chip_len_without_ring_mesh_matches_reference_windows(ckpts):
    """``chip_len`` alone windows at ``chip_len``, as the reference does on
    one device."""
    kw = dict(chip_len=64, checkpoint=ckpts["float32"]["lm"], **EST_KW)
    ref = _ref_estimator(**kw)
    port = TextEntropyEstimator(device="cpu", **kw)
    assert port.chip_len == ref.chip_len == 64
    for text in (RING_TEXT, LONG_TEXT):
        got, want = port.compute_entropy(text), ref.compute_entropy(text)
        assert rel_dev(got.token_entropies, want.token_entropies) <= F32_RTOL
    got, want = port.batch_compute_stats(_texts()), ref.batch_compute_stats(_texts())
    for g, w in zip(got, want):
        assert rel_dev(g, w) <= F32_RTOL
    assert TextEntropyEstimator(device="cpu", chip_len=10_000, **EST_KW).chip_len == 256
