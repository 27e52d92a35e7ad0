"""Seeded web-like text: Zipf words at lognormal lengths, with near-duplicates.

One general generator, driven by a traffic file's ``text`` parameters:

* ``vocab_words`` distinct lowercase words (lengths 1 + Poisson(``word_len_mean`` - 1))
  drawn with Zipf(``zipf_s``) weights by rank; a sentence ends every
  ``sentence_words`` words on average;
* document lengths in bytes: the quantiles ``(i + 0.5) / n`` of a lognormal
  with median ``median_bytes`` and ``sigma``, clipped to
  ``[min_bytes, max_bytes]``, in an order drawn from the seed.  Every seed
  and every shard so gets the same multiset of lengths, and with the byte
  tokenizer the same device work, in another order;
* ``near_dup_frac`` of the documents copy an earlier document of the
  shard with ``near_dup_edit`` of its words replaced, cut to their own length.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import Any, Dict, List

import numpy as np

_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)


def vocabulary(p: Dict[str, Any], rng: np.random.Generator) -> List[bytes]:
    n = int(p["vocab_words"])
    lens = 1 + rng.poisson(float(p["word_len_mean"]) - 1.0, n)
    letters = _LETTERS[rng.integers(0, 26, int(lens.sum()))].tobytes()
    ends = np.cumsum(lens)
    return [letters[e - n_:e] for e, n_ in zip(ends, lens)]


def lengths(p: Dict[str, Any], n: int, rng: np.random.Generator) -> np.ndarray:
    """The stratified lognormal lengths of ``n`` documents, shuffled."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.exp(np.log(float(p["median_bytes"])) + float(p["sigma"]) * z)
    x = np.clip(np.round(x), int(p["min_bytes"]), int(p["max_bytes"])).astype(np.int64)
    return rng.permutation(x)


class TextGenerator:
    def __init__(self, params: Dict[str, Any], rng: np.random.Generator) -> None:
        self.p = params
        self.vocab = vocabulary(params, rng)
        ranks = np.arange(1, len(self.vocab) + 1, dtype=np.float64)
        w = ranks ** -float(params["zipf_s"])
        self.cdf = np.cumsum(w / w.sum())

    def _words(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return np.minimum(np.searchsorted(self.cdf, rng.random(n)), len(self.vocab) - 1)

    def _text(self, words: np.ndarray, rng: np.random.Generator) -> bytes:
        ends = rng.random(len(words)) < 1.0 / float(self.p["sentence_words"])
        return b" ".join(self.vocab[w] + (b"." if e else b"") for w, e in zip(words, ends))

    def shard(self, n: int, rng: np.random.Generator) -> List[str]:
        """``n`` documents of one ``process_corpus`` call."""
        sizes = lengths(self.p, n, rng)
        mean_word = float(self.p["word_len_mean"]) + 1.1
        docs: List[bytes] = []
        words_of: List[np.ndarray] = []
        n_dup = int(round(float(self.p["near_dup_frac"]) * n))
        dup_at = set(rng.choice(np.arange(1, n), size=min(n_dup, n - 1), replace=False).tolist()) \
            if n > 1 else set()
        for i, size in enumerate(sizes):
            if i in dup_at:
                src = words_of[int(rng.integers(0, i))].copy()
                edit = rng.random(len(src)) < float(self.p["near_dup_edit"])
                src[edit] = self._words(rng, int(edit.sum()))
                words = src
            else:
                words = self._words(rng, int(size / mean_word) + 8)
            text = self._text(words, rng)
            while len(text) < size:  # rare: short words
                more = self._words(rng, int(size / mean_word) + 8)
                words = np.concatenate([words, more])
                text = text + b" " + self._text(more, rng)
            docs.append(text[:size])
            words_of.append(words)
        return [d.decode("ascii") for d in docs]


__all__ = ["TextGenerator", "lengths", "vocabulary"]
