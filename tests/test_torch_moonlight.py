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

import numpy as np
import pytest
import torch

import moonlight_reference as ref
from dewi_tpu_torch.models.moonlight import (MoE, grouped_mm, grouped_mm_loop, init_moonlight,
                                             moonlight_config, route)
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
    with torch.no_grad():
        x = m.hidden(ids, mask)[:, :-1]
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
