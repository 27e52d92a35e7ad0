"""Each generator repeats exactly from its seed, and its sizes follow the
stated distribution."""

from statistics import NormalDist

import numpy as np
import pytest
import torch

from harness import search
from harness.common import rng, seed_state
from harness.spec import load_cell
from harness.textgen import TextGenerator, lengths

WEB = load_cell("corpus-web-text").traffic["text"]


def test_seed_streams():
    assert seed_state(5, "a") == seed_state(5, "a")
    assert len({seed_state(5, "a"), seed_state(5, "b"), seed_state(6, "a"),
                seed_state(-5, "a"), seed_state(2 ** 33 + 5, "a")}) == 5


def test_text_repeats_from_its_seed():
    def shard(seed):
        g = TextGenerator(WEB, rng(seed, "vocabulary"))
        return g.shard(64, rng(seed, "documents"))

    a, b, c = shard(2 ** 31 + 11), shard(2 ** 31 + 11), shard(12)
    assert a == b and a != c
    assert all(t.isascii() for t in a)


def test_lengths_are_the_stated_lognormal():
    n = 4096
    x = lengths(WEB, n, np.random.default_rng(0))
    assert x.min() >= WEB["min_bytes"] and x.max() <= WEB["max_bytes"]
    assert np.median(x) == pytest.approx(WEB["median_bytes"], rel=0.01)
    # share past the 512-token window (511 bytes + BOS)
    p = 1 - NormalDist().cdf(np.log(511 / WEB["median_bytes"]) / WEB["sigma"])
    assert np.mean(x > 511) == pytest.approx(p, abs=0.01)
    # every seed gets the same multiset of lengths, in another order
    y = lengths(WEB, n, np.random.default_rng(1))
    assert sorted(x) == sorted(y) and list(x) != list(y)


def test_documents_have_their_lengths_and_near_duplicates():
    g = TextGenerator(WEB, rng(3, "vocabulary"))
    r = rng(3, "documents")
    docs = g.shard(256, r)
    want = lengths(WEB, 256, rng(3, "documents"))
    assert [len(d) for d in docs] == list(want)
    words = [set(d.split()) for d in docs]
    close = sum(any(len(words[i] & words[j]) > 0.8 * max(len(words[i]), 1)
                    for j in range(i)) for i in range(1, 256) if len(words[i]) > 20)
    assert close >= int(round(WEB["near_dup_frac"] * 256)) // 2


def test_search_inputs_repeat_from_their_seed():
    cfg = {"n_docs": 500, "dim": 16}
    e1, s1 = search.draw_corpus(cfg, 9, torch.device("cpu"))
    e2, s2 = search.draw_corpus(cfg, 9, torch.device("cpu"))
    assert torch.equal(e1, e2) and torch.equal(s1, s2)
    assert float(s1.mean()) == pytest.approx(2.0, rel=0.05)  # gamma(2, 1)
    assert float(s1.var()) == pytest.approx(2.0, rel=0.15)
    assert np.array_equal(search.queries(9, "q", 4, 16), search.queries(9, "q", 4, 16))
