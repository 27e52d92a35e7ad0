"""Moonlight-16B-A3B (``models/moonlight.py``) against its plain reference.

The CPU cases run ``moonlight-tiny`` (every mechanism of the published
block at a few dozen dims: latent attention, DeepSeek-V3 RoPE, a dense
first layer, sigmoid routing with a correction bias over 8 experts, 3 a
token, 2 shared) on seeded weights against ``tests/moonlight_reference.py``
(plain float32, one sequence at a time, a per-token gather of the experts):
per-token NLL within 1e-5 in float32 (float32 rounding through 3 layers,
measured up to 2.3e-6).  In bfloat16 each matmul's inputs are rounded to 8
bits and a token near a routing tie takes another expert, which moves its
NLL by up to 1.3 nats at this width, so the bound is on the median token
(0.05; measured up to 0.025 over four seeds) and on each sequence's mean
(0.06; measured up to 0.033).  They take about 20 s under the driver's command.

The card cases (``cuda``) run at the published widths: one forward of
the whole model with ``torch.cuda.set_sync_debug_mode("error")``, so a
host sync in the forward fails, and the grouped GEMM of the experts
against one matmul an expert.  They need about 35 GB of the card:
``python -m pytest --noconftest -m cuda tests/test_torch_moonlight.py``.
This file imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import moonlight_reference as ref
from dewi_tpu_torch.models.moonlight import (MOONLIGHT_PRESETS, MoE, grouped_mm,
                                             grouped_mm_loop, init_moonlight, moonlight_config,
                                             route)
from dewi_tpu_torch.signals.text_entropy import TextEntropyEstimator
from dewi_tpu_torch.utils.profiling import reset_trace_stats, trace_stats

F32_TOL = 1e-5
BF16_MEDIAN_TOL = 0.05
BF16_MEAN_TOL = 0.06


def _model(seed=3, **over):
    """``moonlight-tiny`` with a routing bias and norm scales that are not
    their initial 0 and 1, so both reach the comparison."""
    cfg = moonlight_config("moonlight-tiny", **over)
    m = init_moonlight(cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("e_score_correction_bias"):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
            elif name.endswith("norm.weight"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return m


def _cfg_dict(m):
    return dataclasses.asdict(m.cfg)


def _batch(lens, seed=0, vocab=258, pad=257):
    g = torch.Generator().manual_seed(seed)
    ids = torch.full((len(lens), max(lens)), pad)
    mask = torch.zeros(len(lens), max(lens))
    for r, n in enumerate(lens):
        ids[r, :n] = torch.randint(0, vocab, (n,), generator=g)
        mask[r, :n] = 1
    return ids, mask


@pytest.mark.parametrize("seed", [3, 4])
def test_nll_matches_reference_f32(seed):
    m = _model(seed)
    lens = [40, 17, 2, 33, 64]
    ids, mask = _batch(lens, seed)
    nll, valid = m.token_nll(ids, mask)
    w, c = ref.float_weights(m.state_dict()), _cfg_dict(m)
    for r, n in enumerate(lens):
        want = ref.token_nll(ids[r, :n].tolist(), w, c)
        assert valid[r].sum() == n - 1
        assert (nll[r, :n - 1].double() - want).abs().max() <= F32_TOL


def test_nll_bf16_within_bound():
    m32 = _model(5)
    m = init_moonlight(moonlight_config("moonlight-tiny", dtype=torch.bfloat16), device="cpu")
    m.load_state_dict(m32.state_dict())
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    lens = [48, 9, 120]
    ids, mask = _batch(lens, 5)
    nll, _ = m.token_nll(ids, mask)
    assert nll.dtype == torch.float32
    w, c = ref.float_weights(m.state_dict()), _cfg_dict(m)
    for r, n in enumerate(lens):
        got, want = nll[r, :n - 1].double(), ref.token_nll(ids[r, :n].tolist(), w, c)
        assert (got - want).abs().median() <= BF16_MEDIAN_TOL
        assert (got.mean() - want.mean()).abs() <= BF16_MEAN_TOL


@pytest.mark.parametrize("chunk", [1, 7, 96, 100000])
def test_chunked_nll_equals_full_logits(chunk):
    m = _model(6, logit_chunk=chunk)
    ids, mask = _batch([30, 12], 6)
    nll, _ = m.token_nll(ids, mask)
    b, t = ids.shape
    cu = torch.arange(0, (b + 1) * t, t, dtype=torch.int32)
    with torch.no_grad():
        x = m.hidden(ids.reshape(-1), cu, t, mask.reshape(-1).bool()).view(b, t, -1)[:, :-1]
        logits = m.lm_head(x).float()
        full = torch.logsumexp(logits, -1) - logits.gather(-1, ids[:, 1:, None]).squeeze(-1)
    assert torch.allclose(nll, full, rtol=0, atol=1e-6)


def test_routing_bias_changes_choice_not_gates():
    m = _model(7)
    router = m.layers[1].mlp.gate
    x = torch.randn(64, m.cfg.hidden_size, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        router.e_score_correction_bias.zero_()
        c0, g0 = route(x, router, 3, 2.446)
        router.e_score_correction_bias[c0[0, 0]] = -10.0  # the first token's top expert shunned
        c1, g1 = route(x, router, 3, 2.446)
    assert c0[0, 0] not in c1[0]
    assert not torch.equal(c0, c1)
    s = torch.sigmoid(x @ router.weight.t())
    for c, g in ((c0, g0), (c1, g1)):
        # the gates are the unbiased scores of the chosen experts, normalised
        want = s.gather(-1, c)
        assert torch.allclose(g, want / want.sum(-1, keepdim=True) * 2.446, atol=1e-6)
        assert torch.allclose(g.sum(-1), torch.full((64,), 2.446), atol=1e-5)


def test_bf16_router_reads_the_float32_norm_output(monkeypatch):
    """In a bfloat16 model the router scores the norm's float32 output, not
    its bfloat16 rounding, which would alone move tokens near a tie."""
    import dewi_tpu_torch.models.moonlight as mod

    m = init_moonlight(moonlight_config("moonlight-tiny", dtype=torch.bfloat16), device="cpu")
    m.load_state_dict(_model(9).state_dict())
    seen = []
    real = mod.route

    def spy(x, *a):
        seen.append(x)
        return real(x, *a)

    monkeypatch.setattr(mod, "route", spy)
    ids, mask = _batch([30, 12], 9)
    m.token_nll(ids, mask)
    assert len(seen) == m.cfg.num_hidden_layers - m.cfg.first_k_dense_replace
    for x in seen:
        assert x.dtype == torch.float32
        assert not torch.equal(x, x.to(torch.bfloat16).float())


def test_moe_drops_no_token_and_skips_pads():
    """Every real token's output is the shared experts' plus all k of its
    chosen experts' (the reference's per-token gather); a pad's is the
    shared experts' alone; the routed rows are k a real token."""
    m = _model(8)
    moe = m.layers[2].mlp
    assert isinstance(moe, MoE)
    x = torch.randn(40, m.cfg.hidden_size, generator=torch.Generator().manual_seed(8))
    routed = torch.ones(40, dtype=torch.bool)
    routed[29:] = False
    reset_trace_stats()
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        y = moe(x, routed)
        m.flush_counts()
    c = trace_stats()["counters"]
    assert c["moe.routed_rows"] == 29 * m.cfg.num_experts_per_tok
    assert c["moe.layer_forwards"] == 1
    assert 29 * 3 / 8 <= c["moe.busiest_expert_rows"] <= 29
    w, cd = ref.float_weights(m.state_dict()), _cfg_dict(m)
    want = ref.moe(x, w, "layers.2.mlp", cd)
    assert torch.allclose(y[:29], want[:29], atol=1e-5)
    with torch.no_grad():
        shared = moe.shared_experts(x)
    assert torch.equal(y[29:], shared[29:])


def test_rope_pairing_against_reference():
    from dewi_tpu_torch.models.moonlight import apply_rope, rope_tables

    x = torch.randn(50, 3, 8, generator=torch.Generator().manual_seed(9))
    cos, sin = rope_tables(50, 8, 50000.0, torch.device("cpu"))
    got = apply_rope(x, cos, sin)
    assert torch.allclose(got, ref.rope(x, 50000.0), atol=1e-6)
    # position 0 only reorders: evens first, then odds
    assert torch.equal(got[0], torch.cat([x[0, :, 0::2], x[0, :, 1::2]], -1))


def test_grouped_mm_matches_loop():
    g = torch.Generator().manual_seed(10)
    x = torch.randn(23, 16, generator=g)
    w = torch.randn(4, 24, 16, generator=g)
    offs = torch.tensor([5, 5, 12, 20], dtype=torch.int32)  # an empty group; 3 rows past the end
    assert torch.allclose(grouped_mm(x, w, offs)[:20], grouped_mm_loop(x, w, offs)[:20],
                          atol=1e-5)


def test_published_sizes_on_the_meta_device():
    """The published configuration holds 15.96B parameters (2.58B active a
    token); built on the meta device, nothing is drawn."""
    from dewi_tpu_torch.models.moonlight import MoonlightLM

    cfg = moonlight_config("moonlight-16b-a3b")
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_hidden_layers, cfg.n_routed_experts,
            cfg.num_experts_per_tok, cfg.max_len, cfg.dtype) == (
        163840, 2048, 27, 64, 6, 8192, torch.bfloat16)
    with torch.device("meta"):
        m = MoonlightLM(cfg)
    n = sum(p.numel() for p in m.parameters())
    assert 15.9e9 < n < 16.0e9, n
    assert m.layers[1].mlp.w_gate_up.shape == (64, 2816, 2048)


def _texts(rng, n, long_every=5):
    words = ["cat", "river", "entropy", "zebra", "quartz", "the", "of", "über"]
    out = []
    for i in range(n):
        k = 60 if i % long_every == 0 else int(rng.integers(1, 12))
        out.append(" ".join(rng.choice(words, k)))
    return out


def _ref_stats(texts, est):
    w, c = ref.float_weights(est.model.state_dict()), dataclasses.asdict(est.model.cfg)
    t = est.chip_len
    out = []
    for text in texts:
        ids = est.tokenizer.encode(text, 1 << 30)
        if len(ids) <= t:
            s = ref.token_nll(ids, w, c).numpy()
        else:  # the program's windowing: stride t - t // 4, context-only targets dropped
            ov = t // 4
            parts = []
            for j, a in enumerate(range(0, max(len(ids) - ov, 1), t - ov)):
                nll = ref.token_nll(ids[a:a + t], w, c).numpy()
                parts.append(nll if j == 0 else nll[ov - 1:])
            s = np.concatenate(parts)
        out.append((s.mean(), np.quantile(s, 0.9)))
    return np.array(out)


def test_estimator_packed_windows_match_reference():
    est = TextEntropyEstimator("moonlight-tiny", device="cpu", batch_size=4, max_length=64)
    texts = _texts(np.random.default_rng(11), 9)
    assert any(len(t) + 1 > 64 for t in texts)
    means, q90s, _ = est.batch_compute_stats(texts)
    want = _ref_stats(texts, est)
    assert np.abs(means - want[:, 0]).max() <= F32_TOL
    assert np.abs(q90s - want[:, 1]).max() <= 1e-4


def _length_texts(lens, seed):
    """Texts of these byte-tokenizer lengths (a BOS, then a token a byte)."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghij klmnop"))
    return ["".join(rng.choice(letters, n - 1)) for n in lens]


def _route_stats(est, path, texts):
    """``[documents, 2]``: each document's mean and 0.9 quantile."""
    if path == "batch_compute_stats":
        means, q90s, _ = est.batch_compute_stats(texts)
        return np.stack([means, q90s], 1)
    return np.array([(r.mean_entropy, r.q90_entropy) for r in est.batch_compute(texts)])


@pytest.mark.parametrize("path", ["batch_compute_stats", "batch_compute"])
def test_packed_route_matches_reference_and_single_documents(path):
    """Short documents and long ones of 2, 3 and 5 windows, packed into
    flat forwards of at most 4 x 64 tokens: each document's mean and 0.9
    quantile as the plain reference gives them one document at a time, and
    as the port gives them for the document alone, to float32 rounding."""
    est = TextEntropyEstimator("moonlight-tiny", device="cpu", batch_size=4, max_length=64)
    assert est._packs
    lens = [2, 9, 64, 30, 80, 17, 150, 45, 230, 63, 33, 1]
    windows = [len(range(0, max(n - 16, 1), 48)) for n in lens]
    assert sorted(w for w in windows if w > 1) == [2, 3, 5]
    texts = _length_texts(lens, 21)
    assert [len(est.tokenizer.encode(t, 1 << 30)) for t in texts] == lens
    reset_trace_stats()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = _route_stats(est, path, texts)
    assert trace_stats()["counters"]["text.forwards"] == 4  # 836 tokens, 256 a forward
    assert np.array_equal(got[-1], [0.0, 0.0])  # one token: nothing to score
    want = _ref_stats(texts[:-1], est)
    assert np.abs(got[:-1, 0] - want[:, 0]).max() <= F32_TOL
    assert np.abs(got[:-1, 1] - want[:, 1]).max() <= 1e-4
    one = np.array([_route_stats(est, path, [t])[0] for t in texts])
    assert np.all(np.abs(got - one) <= 1e-6 * np.abs(one))
    if path == "batch_compute":
        w, c = ref.float_weights(est.model.state_dict()), _cfg_dict(est.model)
        for r, text in zip(est.batch_compute(texts), texts):
            ids = est.tokenizer.encode(text, 1 << 30)
            if 1 < len(ids) <= est.chip_len:
                assert np.abs(np.array(r.token_entropies) - ref.token_nll(ids, w, c).numpy()
                              ).max() <= F32_TOL


@pytest.mark.parametrize("dense", [False, True])
def test_flat_forward_keeps_sequences_apart(dense):
    """Two sequences in one flat forward score as each does alone, and the
    second never sees the first: new tokens in the first leave the
    second's NLL bit for bit through attention, the dense layers and the
    head (``dense``: every layer dense).  With experts, the other
    sequence's routing changes the row count of each expert's GEMM, and
    the CPU's GEMM picks its kernel by row count, so there the NLL holds
    to float32 rounding."""
    m = _model(3, **({"first_k_dense_replace": 3} if dense else {}))
    g = torch.Generator().manual_seed(30)
    a, a2, b = (torch.randint(0, 258, (n,), generator=g) for n in (37, 37, 50))
    cu = torch.tensor([0, 37, 87], dtype=torch.int32)
    both = m.packed_nll(torch.cat([a, b]), cu, 50)
    assert both.shape == (36 + 49,)
    for got, seq in ((both[:36], a), (both[36:], b)):
        alone = m.packed_nll(seq, torch.tensor([0, len(seq)], dtype=torch.int32), len(seq))
        assert torch.allclose(got, alone, rtol=1e-6, atol=0)
        want = ref.token_nll(seq.tolist(), ref.float_weights(m.state_dict()), _cfg_dict(m))
        assert (got.double() - want).abs().max() <= F32_TOL
    other = m.packed_nll(torch.cat([a2, b]), cu, 50)
    assert not torch.allclose(other[:36], both[:36], rtol=1e-3, atol=0)
    if dense:
        assert torch.equal(other[36:], both[36:])
    else:
        assert torch.allclose(other[36:], both[36:], rtol=1e-6, atol=0)


def test_rope_positions_restart_per_sequence():
    from dewi_tpu_torch.models.moonlight import positions, scored_positions

    cu = torch.tensor([0, 3, 4, 9], dtype=torch.int32)
    assert positions(cu, 9).tolist() == [0, 1, 2, 0, 0, 1, 2, 3, 4]
    assert scored_positions(cu, 9).tolist() == [0, 1, 4, 5, 6, 7]
    m = _model(4)
    s = torch.randint(0, 258, (20,), generator=torch.Generator().manual_seed(31))
    with torch.no_grad():
        twice = m.hidden(torch.cat([s, s]), torch.tensor([0, 20, 40], dtype=torch.int32), 20)
        joined = m.hidden(torch.cat([s, s]), torch.tensor([0, 40], dtype=torch.int32), 40)
    # the second copy starts again at position 0 ...
    assert torch.allclose(twice[20:], twice[:20], rtol=0, atol=1e-6)
    # ... where, as one sequence, its tokens sit at 20..39
    assert not torch.allclose(joined[20:], twice[20:], rtol=0, atol=1e-3)


def test_plan_forwards_cuts_evenly_within_the_cap():
    from dewi_tpu_torch.signals.text_entropy import plan_forwards

    rng = np.random.default_rng(32)
    lens = np.sort(np.clip(np.exp(rng.normal(np.log(1247), 1.0, 140)), 2, 8192).astype(int))
    cap = 16 * 8192
    parts = plan_forwards(lens, cap)
    assert [p.start for p in parts] == [0] + [p.stop for p in parts[:-1]]
    assert parts[-1].stop == len(lens)
    sizes = [int(lens[p].sum()) for p in parts]
    assert len(parts) == 3 and max(sizes) <= cap  # 261,358 tokens: 2 would overflow
    assert max(sizes) - min(sizes) <= 2 * lens.max()
    # where the even cut overflows the cap, one forward more
    assert [(p.start, p.stop) for p in plan_forwards(np.array([60, 60, 60]), 100)] == \
        [(0, 1), (1, 2), (2, 3)]
    assert plan_forwards(np.array([5]), 100) == [slice(0, 1)]


def test_pipeline_process_corpus_matches_reference():
    from dewi_tpu_torch import DewiConfig, DewiPipeline
    from dewi_tpu_torch.corpus import Corpus

    cfg = DewiConfig.from_dict({
        "text": {"model": "moonlight-tiny", "batch_size": 4, "max_length": 64},
        "cross_modal": {"model": "tiny", "batch_size": 4},
        "redundancy": {"block_size": 8}})
    pipe = DewiPipeline(cfg, device="cpu")
    texts = _texts(np.random.default_rng(12), 10, long_every=4)
    corpus = Corpus(ids=[f"d{i}" for i in range(10)], texts=texts)
    pipe.process_corpus(corpus)
    want = _ref_stats(texts, pipe.text_entropy)
    assert np.abs(corpus.signals[:, 0] - want[:, 0]).max() <= F32_TOL
    assert np.abs(corpus.signals[:, 1] - want[:, 1]).max() <= 1e-4


def test_cli_process_accepts_preset(tmp_path, monkeypatch):
    from dewi_tpu_torch import cli

    monkeypatch.setenv("DEWI_TEST_MODE", "0")
    texts = tmp_path / "texts"
    texts.mkdir()
    for i, t in enumerate(_texts(np.random.default_rng(13), 6)):
        (texts / f"t{i}.txt").write_text(t)
    cfg = {"text": {"model": "moonlight-tiny", "batch_size": 4, "max_length": 64},
           "cross_modal": {"model": "tiny", "batch_size": 4}, "redundancy": {"block_size": 8}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    assert cli.main(["--device", "cpu", "process", str(tmp_path / "cfg.json"),
                     str(tmp_path / "out"), "--texts", str(texts)]) == 0
    rows = json.loads((tmp_path / "out" / "signals_summary.json").read_text())
    assert len(rows) == 6 and all(5.0 < r["ht_mean"] < 7.0 for r in rows)


class _WideTokenizer:
    """A tokenizer whose ids run past ``moonlight-tiny``'s 320."""

    vocab_size = 1000
    pad_id = 999
    bos_id = 0

    def encode_batch(self, texts, max_len, pad_to=None):
        raise AssertionError("never called")


def test_estimator_refuses_ids_outside_the_vocabulary():
    with pytest.raises(ValueError, match="1000 ids"):
        TextEntropyEstimator("moonlight-tiny", device="cpu", max_length=64,
                             tokenizer=_WideTokenizer())
    with pytest.raises(ValueError, match="seed alone"):
        TextEntropyEstimator("moonlight-tiny", device="cpu", checkpoint="x.msgpack")
    with pytest.raises(ValueError, match="positions"):
        TextEntropyEstimator("moonlight-tiny", device="cpu", max_length=512)


def test_traced_spans_and_counters():
    est = TextEntropyEstimator("moonlight-tiny", device="cpu", batch_size=4, max_length=64)
    texts = _texts(np.random.default_rng(14), 7)
    reset_trace_stats()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        est.batch_compute_stats(texts)
    st = trace_stats()
    c, spans = st["counters"], st["spans"]
    for name in ("dewi.lm.attention", "dewi.lm.moe.route", "dewi.lm.moe.experts",
                 "dewi.lm.head"):
        assert spans[name]["count"] > 0, name
    moe_layers = est.model.cfg.num_hidden_layers - est.model.cfg.first_k_dense_replace
    assert c["moe.layer_forwards"] == moe_layers * c["text.forwards"]
    assert c["moe.routed_rows"] == 3 * moe_layers * c["text.tokens"]
    assert c["moe.busiest_expert_rows"] * 8 >= c["moe.routed_rows"] / moe_layers
    assert c["text.logit_chunks"] >= c["text.forwards"]
    assert c["text.tokens"] < c["text.attention_pairs"] <= c["text.tokens"] * 65 // 2


# ---- on the card, at the published widths ------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (published widths, bfloat16 grouped GEMMs)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_published_forward_never_syncs(cuda_device):
    cfg = moonlight_config("moonlight-16b-a3b")
    m = init_moonlight(cfg, seed=1, device=cuda_device)
    ids, mask = _batch([2048, 1500, 700, 3], 1)
    ids, mask = ids.to(cuda_device), mask.to(cuda_device)
    with torch.no_grad():
        m.token_nll(ids, mask)  # warm-up: the first calls may load libraries
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            nll, valid = m.token_nll(ids, mask)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    nll = nll[valid].float()
    assert torch.isfinite(nll).all() and 5.0 < nll.mean().item() < 20.0
    del m
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_card_grouped_gemm_matches_expert_loop(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    e, d, f = 64, 2048, 1408
    w = (torch.randn(e, 2 * f, d, generator=g, device=cuda_device) / d ** 0.5).bfloat16()
    rows = torch.randint(0, 400, (e,), generator=g, device=cuda_device)
    rows[5] = 0
    offs = torch.cumsum(rows, 0).to(torch.int32)
    x = torch.randn(int(offs[-1]) + 77, d, generator=g, device=cuda_device).bfloat16()
    got = grouped_mm(x, w, offs)[:int(offs[-1])].float()
    want = grouped_mm_loop(x, w, offs)[:int(offs[-1])].float()
    assert (got - want).abs().max().item() <= 0.02 * want.abs().max().item()


def _web_texts(n, seed):
    """``n`` documents at web-text's lengths (bytes lognormal, median 1,246,
    sigma 1, 80 to 32,768), then one of 20,000 bytes: past 8,192 tokens,
    three windows."""
    rng = np.random.default_rng(seed)
    words = ["the", "of", "river", "entropy", "zebra", "quartz", "cat", "und", "index", "a"]
    lens = np.clip(np.exp(rng.normal(np.log(1246), 1.0, n)), 80, 32768).astype(int).tolist()
    out = []
    for size in lens + [20000]:
        text = " ".join(rng.choice(words, size // 3 + 1))
        out.append(text[:size])
    return out


@torch.no_grad()
def _harness_scales(model, seed):
    """The benchmark's weight scales (``benchmark/harness/moonlight.py``):
    the embedding N(0, 4^2), kernels N(0, 1/fan_in) and those that write
    the residual stream times 1/sqrt(54) more, norm scales 1 + 0.02 n, the
    routing bias 0.02 n; rounded to the model's dtype."""
    g = torch.Generator(device=model.lm_head.weight.device).manual_seed(seed)
    for name, p in model.named_parameters():
        x = torch.randn(p.shape, generator=g, device=p.device)
        if name == "embed_tokens.weight":
            x *= 4.0
        elif name.endswith("norm.weight"):
            x = 1.0 + 0.02 * x
        elif name.endswith("e_score_correction_bias"):
            x *= 0.02
        else:
            x /= math.sqrt(p.shape[-1])
            if name.endswith(("o_proj.weight", "down_proj.weight", "w_down")):
                x /= math.sqrt(54)
        p.copy_(x)


# The largest gap of a document's mean NLL between the packed route and the
# document alone, in bfloat16 at the published widths (3 layers, the test's
# documents, weight seeds 1-4).  A forward of another size takes other GEMM
# tiles, so bfloat16 rounds another way: the bucket route moved the same
# documents by up to 3.2e-4 between its 16-row batches and batches of 4 or
# 1 rows (by under 2e-6 between rows of one batch shape); the packed route
# measured up to 2.4e-4 against the documents alone.
CARD_PACKED_TOL = 5e-4


@pytest.mark.cuda
def test_card_packed_route_matches_single_documents(cuda_device, monkeypatch):
    """Published widths with the first 3 layers (dense, then 2 MoE) in
    bfloat16 on the benchmark's weight scales, 48 documents at web-text
    lengths and one of three windows: each document's mean NLL from the
    packed forwards against the document scored alone; and one packed
    forward (upload, forward, statistics) never waits for the card."""
    monkeypatch.setitem(MOONLIGHT_PRESETS, "moonlight-3-layers", {"num_hidden_layers": 3})
    est = TextEntropyEstimator("moonlight-3-layers", device=cuda_device, batch_size=16,
                               max_length=8192)
    _harness_scales(est.model, 1)
    texts = _web_texts(48, 1)
    means = est.batch_compute_stats(texts)[0]
    one = np.array([est.batch_compute_stats([t])[0][0] for t in texts])
    gap = np.abs(means - one)
    print("packed vs alone: max", gap.max(), "median", np.median(gap))
    assert np.isfinite(means).all() and 5.0 < means.mean() < 20.0
    assert gap.max() <= CARD_PACKED_TOL
    seqs = [np.asarray(est.tokenizer.encode(t, 8192), dtype=np.int32) for t in texts[:8]]
    est._score_packed(seqs, np.zeros(8, dtype=bool))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        est._score_packed(seqs, np.zeros(8, dtype=bool))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    del est
    torch.cuda.empty_cache()
