"""The readers of the program's own spans and counters: their arithmetic
on a made-up ``trace_stats()`` snapshot, None where a span or counter is
missing, and None from a program that has no registry at all."""

import sys

import pytest

from harness.spec import load_reader, load_module


def span(total_s, count=1):
    return {"count": count, "total_s": total_s, "self_s": total_s, "parents": {None: total_s}}


STATS = {
    "spans": {"dewi.process_corpus": span(9.0), "dewi.build_index_corpus": span(1.0),
              "dewi.text_entropy": span(8.5), "dewi.search_batch": span(0.8, count=20)},
    "counters": {"text.forwards": 211, "text.token_slots": 1000, "text.tokens": 98,
                 "text.windows": 500},
}


def value(name, stats):
    return load_module("metrics", name).value(stats)


def test_arithmetic():
    assert value("text.pad_pct.corpus", STATS) == pytest.approx(90.2)
    assert value("corpus.text_entropy_pct", STATS) == pytest.approx(85.0)
    assert value("index.dispatch_ms_per_call", STATS) == pytest.approx(40.0)


@pytest.mark.parametrize("name,drop", [
    ("text.pad_pct.corpus", ("counters", "text.token_slots")),
    ("text.pad_pct.corpus", ("counters", "text.tokens")),
    ("corpus.text_entropy_pct", ("spans", "dewi.text_entropy")),
    ("corpus.text_entropy_pct", ("spans", "dewi.process_corpus")),
    ("corpus.text_entropy_pct", ("spans", "dewi.build_index_corpus")),
    ("index.dispatch_ms_per_call", ("spans", "dewi.search_batch")),
])
def test_none_where_missing(name, drop):
    stats = {k: dict(v) for k, v in STATS.items()}
    del stats[drop[0]][drop[1]]
    assert value(name, stats) is None
    assert value(name, {"spans": {}, "counters": {}}) is None
    assert value(name, None) is None


NAMES = ["text.pad_pct.corpus", "corpus.text_entropy_pct", "index.dispatch_ms_per_call"]


@pytest.mark.parametrize("name", NAMES)
def test_read_takes_the_registry(monkeypatch, name):
    from dewi_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "trace_stats", lambda: STATS)
    assert load_reader(name)(None) == value(name, STATS)


@pytest.mark.parametrize("gone", ["function", "module"])
@pytest.mark.parametrize("name", NAMES)
def test_read_without_a_registry(monkeypatch, name, gone):
    """A program older than the registry (the parent of the change that
    added it) reads None and raises nothing."""
    from dewi_tpu_torch.utils import profiling

    if gone == "function":
        monkeypatch.delattr(profiling, "trace_stats")
    else:
        monkeypatch.setitem(sys.modules, "dewi_tpu_torch.utils.profiling", None)
    assert load_reader(name)(None) is None
