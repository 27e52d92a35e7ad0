"""The check catches a broken timed path: a run on the CPU at a tiny size,
with the look for a card skipped and the program broken underneath,
comes out not correct, once for each fault the cell can have."""

import numpy as np
import pytest
import torch

import run as bench_run
from conftest import tiny_corpus, tiny_search
from harness.spec import load_cell


def run_cell(cell, seed=17, device=torch.device("cpu"), seconds=1.0):
    r = bench_run.execute(cell, seed, seconds, False, device, 0.0)
    return r.correct(), {n: (v, lim) for n, v, lim in r.checks}


def _patch_search(monkeypatch, fault):
    from dewi_tpu_torch.index.facade import DewiIndex

    real = DewiIndex.search_batch

    def broken(self, queries, *a, **kw):
        s, i = real(self, queries, *a, **kw)
        if fault == "answer":  # each query's best answer swapped for another row
            i = i.clone()
            i[:, 0] = (i[:, 0] + 1) % len(self)
        elif fault == "half":  # the second half of the batch answered as the first
            h = (i.shape[0] + 1) // 2
            i, s = torch.cat([i[:h], i[:i.shape[0] - h]]), torch.cat([s[:h], s[:s.shape[0] - h]])
        return s, i

    def eleventh(self, queries, k=10, *a, **kw):
        # a selection fault: every 20th query of a call gets its 11th-best
        # document in place of its 10th, each served score still right
        s, i = real(self, queries, k + 1, *a, **kw)
        s, i = s.clone(), i.clone()
        s[::20, k - 1], i[::20, k - 1] = s[::20, k], i[::20, k]
        return s[:, :k], i[:, :k]

    monkeypatch.setattr(DewiIndex, "search_batch", eleventh if fault == "eleventh" else broken)


@pytest.mark.parametrize("fault", ["answer", "half", "eleventh"])
def test_search_faults_fail(monkeypatch, fault):
    _patch_search(monkeypatch, fault)
    ok, got = run_cell(tiny_search("search-batch-q1000"))
    assert not ok, got


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103])
def test_card_selection_fault_fails(monkeypatch, seed):
    """The selection fault at the cell's own size on the card: its
    ``recall_miss`` is the upper reading of that number's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _patch_search(monkeypatch, "eleventh")
    ok, got = run_cell(load_cell("search-batch-q1000"), seed, torch.device("cuda", 0), 3.0)
    print("selection fault", seed, got)
    assert not ok and got["recall_miss"][0] > got["recall_miss"][1], got


def test_search_dewi_fault_fails(monkeypatch):
    from dewi_tpu_torch import scorer

    real = scorer.DewiScorer.fit_and_score
    monkeypatch.setattr(scorer.DewiScorer, "fit_and_score",
                        lambda self, *a, **kw: real(self, *a, **kw) * 0.99)
    ok, got = run_cell(tiny_search("search-batch-q1000"))
    assert not ok and got["dewi_gap"][0] > got["dewi_gap"][1]


def _patch_text(monkeypatch, fault):
    from dewi_tpu_torch.signals.text_entropy import TextEntropyEstimator

    real = TextEntropyEstimator.batch_compute_stats

    def broken(self, texts, *a, **kw):
        means, q90s, q99s = real(self, texts, *a, **kw)
        if fault == "answer":  # each surprisal mean off by 0.1 nats
            means += 0.1
        elif fault == "half":  # half of the batch left out, the rest's mean in its place
            h = len(texts) // 2
            means[h:], q90s[h:] = means[:h].mean(), q90s[:h].mean()
        return means, q90s, q99s

    monkeypatch.setattr(TextEntropyEstimator, "batch_compute_stats", broken)


@pytest.mark.parametrize("fault", ["answer", "half"])
def test_corpus_text_faults_fail(monkeypatch, fault):
    _patch_text(monkeypatch, fault)
    cell = tiny_corpus("corpus-web-text")
    cell.traffic["check_docs"] = 64  # the whole window at this size
    ok, got = run_cell(cell)
    assert not ok, got


def test_corpus_embedding_fault_fails(monkeypatch):
    from dewi_tpu_torch.signals.cross_modal import CrossModalDependency

    real = CrossModalDependency.encode_texts
    monkeypatch.setattr(CrossModalDependency, "encode_texts",
                        lambda self, t, *a, **kw: np.roll(real(self, t, *a, **kw), 1, axis=0))
    ok, got = run_cell(tiny_corpus("corpus-web-text"))
    assert not ok and got["emb_gap"][0] > got["emb_gap"][1]
