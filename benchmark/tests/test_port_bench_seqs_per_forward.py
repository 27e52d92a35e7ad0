"""The reader of ``text.seqs_per_forward.corpus_moonlight``: its
arithmetic on a made-up ``trace_stats()`` snapshot, None where a counter is
missing (a program without the packed route), and None from a program that
has no registry at all."""

import sys

import pytest

from harness.spec import load_module, load_reader

NAME = "text.seqs_per_forward.corpus_moonlight"
STATS = {"spans": {}, "counters": {"text.forwards": 3, "text.sequences": 141,
                                   "text.token_slots": 270389, "text.tokens": 270389}}


def value(stats):
    return load_module("metrics", NAME).value(stats)


def test_arithmetic():
    assert value(STATS) == pytest.approx(47.0)


@pytest.mark.parametrize("drop", ["text.sequences", "text.forwards"])
def test_none_where_missing(drop):
    stats = {"spans": {}, "counters": dict(STATS["counters"])}
    del stats["counters"][drop]
    assert value(stats) is None
    assert value({"spans": {}, "counters": {}}) is None
    assert value(None) is None


def test_read_takes_the_registry(monkeypatch):
    from dewi_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "trace_stats", lambda: STATS)
    assert load_reader(NAME)(None) == pytest.approx(47.0)


@pytest.mark.parametrize("gone", ["function", "module"])
def test_read_without_a_registry(monkeypatch, gone):
    from dewi_tpu_torch.utils import profiling

    if gone == "function":
        monkeypatch.delattr(profiling, "trace_stats")
    else:
        monkeypatch.setitem(sys.modules, "dewi_tpu_torch.utils.profiling", None)
    assert load_reader(NAME)(None) is None
