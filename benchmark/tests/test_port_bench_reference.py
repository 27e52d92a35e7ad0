"""Each plain reference agrees at tiny sizes with independent arithmetic."""

import math

import numpy as np
import pytest
import torch

from harness import weights as wts
from reference import corpus as refc
from reference import models as refm
from reference import search as refs

LM = {"vocab_size": 258, "n_embd": 16, "n_layer": 2, "n_head": 2, "n_inner": 32,
      "n_positions": 24, "layer_norm_epsilon": 1e-6, "activation_function": "gelu_new"}


def lm_weights(seed=0):
    return wts.make(wts.lm_layout(LM), torch.Generator().manual_seed(seed), "cpu")


def test_dewi_scores_by_hand():
    sig = torch.tensor([[1.0, 2, 3, 4, 5, 6, 7], [2, 4, 6, 8, 1, 1, 1], [3, 6, 9, 12, 9, 2, 0]])
    got = refs.dewi_scores(sig).numpy()
    x = sig.double().numpy()
    med = np.median(x, axis=0)
    mad = np.median(np.abs(x - med), axis=0)
    mad[mad == 0] = 1e-8
    z = (x - med) / (1.4826 * mad)
    u = 0.5 * (z[:, 0] + z[:, 1]) + 0.5 * (z[:, 2] + z[:, 3]) - z[:, 4] - z[:, 5] - z[:, 6]
    assert np.allclose(got, 1 / (1 + np.exp(-np.clip(u, -3, 3))))


def test_search_and_judge_by_hand():
    g = np.random.default_rng(0)
    docs, q = g.standard_normal((50, 8)), g.standard_normal((3, 8))
    dewi, ent = g.random(50), g.random(50)
    dn = docs / np.linalg.norm(docs, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    adj = 0.75 * qn @ dn.T + 0.25 * dewi + 0.1 * ent
    top = np.argsort(-adj, axis=1)[:, :5]
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    s, i = refs.search(t(q), refs.normalize(t(docs)), t(dewi), t(ent), 0.25, 0.1, 5, block=2)
    assert np.array_equal(i.numpy(), top)
    assert np.allclose(s.numpy(), np.take_along_axis(adj, top, 1))
    sg, miss = refs.judge(t(q), i, s, refs.normalize(t(docs)), t(dewi), t(ent), 0.25, 0.1, 5)
    assert sg < 1e-12 and miss == 0.0
    worse = top.copy()
    worse[0, -1] = np.argsort(-adj, axis=1)[0, 7]  # the 8th best in place of the 5th
    sg, miss = refs.judge(t(q), t(worse), t(np.take_along_axis(adj, worse, 1)),
                          refs.normalize(t(docs)), t(dewi), t(ent), 0.25, 0.1, 5)
    assert sg < 1e-12 and miss == pytest.approx(1 / 15)  # one of 3 x 5
    off = s.clone()
    off[:, 0] += 1e-3  # right documents, a wrong score
    sg, miss = refs.judge(t(q), i, off, refs.normalize(t(docs)), t(dewi), t(ent), 0.25, 0.1, 5)
    assert sg == pytest.approx(1e-3) and miss == 0.0
    dup = top.copy()
    dup[0, 1] = dup[0, 0]
    assert refs.judge(t(q), t(dup), s, refs.normalize(t(docs)), t(dewi), t(ent),
                      0.25, 0.1, 5) == (1.0, pytest.approx(1 / 15))


def naive_lm_nll(ids, w):
    """The same network written token by token in float64."""
    d, h = LM["n_embd"], LM["n_head"]
    hd = d // h
    W = {k: v.double().numpy() for k, v in w.items()}

    def ln(x, p):
        m, v = x.mean(), x.var()
        return (x - m) / math.sqrt(v + 1e-6) * W[p + ".weight"] + W[p + ".bias"]

    def lin(x, p):
        return W[p + ".weight"] @ x + W[p + ".bias"]

    xs = [W["wte.weight"][t] + W["wpe.weight"][i] for i, t in enumerate(ids)]
    for layer in range(LM["n_layer"]):
        p = f"encoder.block_{layer}"
        hs = [ln(x, p + ".ln_attn") for x in xs]
        qs = [lin(x, p + ".attn.query") for x in hs]
        ks = [lin(x, p + ".attn.key") for x in hs]
        vs = [lin(x, p + ".attn.value") for x in hs]
        new = []
        for i in range(len(xs)):
            o = np.zeros(d)
            for a in range(h):
                sl = slice(a * hd, (a + 1) * hd)
                sc = np.array([qs[i][sl] @ ks[j][sl] / math.sqrt(hd) for j in range(i + 1)])
                pr = np.exp(sc - sc.max())
                pr /= pr.sum()
                o[sl] = sum(pr[j] * vs[j][sl] for j in range(i + 1))
            x = xs[i] + lin(o, p + ".attn.out")
            y = lin(ln(x, p + ".ln_mlp"), p + ".mlp.fc_in")
            y = 0.5 * y * (1 + np.tanh(math.sqrt(2 / math.pi) * (y + 0.044715 * y ** 3)))
            new.append(x + lin(y, p + ".mlp.fc_out"))
        xs = new
    out = []
    for i in range(len(ids) - 1):
        logits = W["wte.weight"] @ ln(xs[i], "encoder.ln_final")
        m = logits.max()
        out.append(m + math.log(np.exp(logits - m).sum()) - logits[ids[i + 1]])
    return np.array(out)


def test_lm_nll_against_a_token_by_token_network():
    w = lm_weights()
    ids = [256, 10, 200, 3, 3, 99, 7]
    got = refm.lm_token_nll(torch.tensor([ids]), w, LM)[0].numpy()
    assert np.allclose(got, naive_lm_nll(ids, w), atol=1e-4)


def test_windows_and_stats_against_whole_documents():
    w = lm_weights(1)
    ctx = LM["n_positions"]
    short, long_ = "abc def", "x" * 9 + "the quick brown fox jumps over" * 2
    ids = refc.token_ids(long_)
    wins = refc.windows(ids, ctx)
    assert [len(x) for x, _ in wins][0] == ctx and wins[1][1] == ctx // 4 - 1
    # every target is scored once: the first window's, then each window's new ones
    assert sum(len(x) - 1 - d for x, d in wins) == len(ids) - 1
    stats = refc.surprisal_stats([short, long_], w, LM, ctx)
    nll = naive_lm_nll(refc.token_ids(short), w)
    assert stats[0] == pytest.approx([nll.mean(), np.quantile(nll, 0.9)], abs=1e-4)
    parts = [naive_lm_nll(x, w)[d:] for x, d in wins]
    s = np.concatenate(parts)
    assert stats[1] == pytest.approx([s.mean(), np.quantile(s, 0.9)], abs=1e-4)


def test_redundancy_and_noise_by_hand():
    e = torch.tensor([[1.0, 0, 0], [0.6, 0.8, 0], [0, 0, 1]])
    assert np.allclose(refc.redundancy(e).numpy(), [0.6, 0.6, 0.0])
    got = refc.text_noise(["hello world", "!!!! ??", "ab12"])
    # 'hello world': quality 1; '!!!! ??': alnum 0 < 0.3 and symbols 6/7 > 0.5
    assert np.allclose(got, [1 - (0.7 + 0.15), 1 - (0.7 * 0.4 + 0.15), 1 - (0.7 + 0.15)])


def test_fp8_control_rounds_to_three_mantissa_bits():
    a = torch.tensor([[1.0 + 1 / 16, 3.0]])
    b = torch.tensor([[1.0], [0.0]])
    # per-tensor scale 3/448; 1.0625 lands off the e4m3 grid and moves
    assert refm.fp8(a, b).item() != pytest.approx(1.0625, abs=1e-4)
    assert refm.exact(a, b).item() == pytest.approx(1.0625)
