"""The port's own spans and counters (``dewi_tpu_torch.utils.profiling``).

* With no profiler recording, ``span`` never opens a ``record_function``
  range and nothing reaches the registry, on the corpus and search paths too.
* Under a CPU ``torch.profiler`` session the corpus and search stages show
  among the profiler's events, nested as the program nests them, and the
  registry's self time is the total less the children's.
* The LM's counters equal hand counts on texts of known token counts,
  where the long documents' windows pack across documents too, and where
  Moonlight packs whole sequences into flat forwards.
* The program's results are bit-identical with the profiler on and off.
* ``process`` with ``runtime.profile`` writes ``profile/spans.json``.

Everything here runs on the CPU.
"""

import json

import numpy as np
import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile

from dewi_tpu_torch import Corpus, DewiConfig, DewiIndex, DewiPipeline, cli
from dewi_tpu_torch.signals import TextEntropyEstimator
from dewi_tpu_torch.utils import profiling as prof

CORPUS_PARENTS = {
    "dewi.process_corpus": {None},
    "dewi.build_index_corpus": {None},
    "dewi.text_entropy": {"dewi.process_corpus"},
    "dewi.image_entropy": {"dewi.process_corpus"},
    "dewi.cross_modal.text": {"dewi.process_corpus"},
    "dewi.cross_modal.image": {"dewi.process_corpus"},
    "dewi.embeddings": {"dewi.process_corpus"},
    "dewi.redundancy": {"dewi.process_corpus"},
    "dewi.noise": {"dewi.process_corpus"},
    "dewi.score": {"dewi.process_corpus"},
    "dewi.index.build": {"dewi.build_index_corpus"},
    "dewi.text_entropy.long": {"dewi.text_entropy"},
    "dewi.text_entropy.buckets": {"dewi.text_entropy"},
    "dewi.text_entropy.fetch": {"dewi.text_entropy.long", "dewi.text_entropy.buckets"},
}
# One pipeline a call at every Q: each stage once, under the call.
SEARCH_PARENTS = {
    "dewi.search_batch": {None},
    "dewi.search.fold": {"dewi.search_batch"},
    "dewi.search.stage1": {"dewi.search_batch"},
    "dewi.search.select": {"dewi.search_batch"},
    "dewi.search.refine": {"dewi.search_batch"},
}

# Token counts (byte tokenizer: one BOS, then one token a byte) with
# chip_len 32 and batches of 4: five short documents in one 32-token
# bucket, two forwards of [4, 32]; an 80-token document in three windows
# (starts 0, 24, 48; 32 tokens each) and a 41-token document in two windows
# (32 and 17 tokens): five windows, two forwards of [4, 32] whether each
# document has its own or the windows are packed across documents.
def _pairs(*lens):
    """The causal (query, key) pairs of rows of these real lengths."""
    return sum(n * (n + 1) // 2 for n in lens)


SHORT = ["a" * 4, "b" * 8, "c" * 16, "d" * 29, "e" * 9]
LONG = ["f" * 79, "g" * 40]
HAND = {"text.forwards": 2 + 1 + 1,
        "text.token_slots": 2 * 4 * 32 + 4 * 32 + 4 * 32,
        "text.tokens": (5 + 9 + 17 + 30 + 10) + 3 * 32 + (32 + 17),
        "text.attention_pairs": _pairs(5, 9, 17, 30, 10, 32, 32, 32, 32, 17),
        "text.windows": 3 + 2,
        "text.window_forwards": 2}
# Three documents of 41, 46 and 51 tokens, two windows each (32 tokens,
# then 17, 22 and 27): six windows pack into two forwards of [4, 32], where
# one forward a document would take three.
PACKED = ["h" * 40, "i" * 45, "j" * 50]
PACKED_HAND = {"text.forwards": 2,
               "text.token_slots": 2 * 4 * 32,
               "text.tokens": 3 * 32 + 17 + 22 + 27,
               "text.attention_pairs": _pairs(32, 17, 32, 22, 32, 27),
               "text.windows": 6,
               "text.window_forwards": 2}
# Moonlight scores flat forwards of whole sequences, at most 4 x 32 = 128
# tokens a forward: SHORT's five documents and LONG's five windows, 216
# tokens, sorted by length and cut nearest the half: 120 tokens (5, 9, 10,
# 17, 17, 30, 32) and 96 (32, 32, 32), both with windows.  No padding, so
# the slots are the tokens, and the pairs are counted a sequence.
MOONLIGHT_HAND = {"text.forwards": 2,
                  "text.token_slots": 216,
                  "text.tokens": 216,
                  "text.attention_pairs": _pairs(5, 9, 17, 30, 10, 32, 32, 32, 32, 17),
                  "text.sequences": 10,
                  "text.windows": 3 + 2,
                  "text.window_forwards": 2}


@pytest.fixture(autouse=True)
def _empty_registry():
    prof.reset_trace_stats()
    yield
    prof.reset_trace_stats()


def _traced(fn):
    """``fn()`` under a CPU profiler: (its result, the profiler's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as p:
        out = fn()
    return out, p.events()


def _dewi_parent(evt):
    """The name of the nearest enclosing ``dewi.*`` event, or None."""
    up = evt.cpu_parent
    while up is not None and not up.name.startswith("dewi."):
        up = up.cpu_parent
    return None if up is None else up.name


def _check_nesting(events, stats, parents):
    seen = {}
    for e in events:
        if e.name.startswith("dewi."):
            seen.setdefault(e.name, set()).add(_dewi_parent(e))
    assert seen == parents
    spans = stats["spans"]
    assert {k: set(v["parents"]) for k, v in spans.items()} == parents
    for name, rec in spans.items():
        children = sum(c["parents"].get(name, 0.0) for c in spans.values())
        assert rec["total_s"] >= children
        assert rec["self_s"] == pytest.approx(rec["total_s"] - children, abs=1e-6)
        assert rec["count"] == sum(e.name == name for e in events)


def _pipeline():
    cfg = {"text": {"model": "tiny", "batch_size": 4, "max_length": 64},
           "image": {"model": "tiny", "batch_size": 4, "image_size": 32, "patch_size": 8},
           "cross_modal": {"model": "tiny", "batch_size": 4},
           "redundancy": {"block_size": 8}}
    return DewiPipeline(DewiConfig.from_dict(cfg), device="cpu")


def _corpus():
    rng = np.random.default_rng(5)
    words = ["cat", "photo", "river", "entropy", "zebra", "quartz", "ü", "日本"]
    texts = [" ".join(rng.choice(words, int(rng.integers(1, 6)))) for _ in range(5)]
    texts.append(" ".join(rng.choice(words, 16)))  # past the LM's 64 tokens
    texts[3] = None
    images = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    return Corpus(ids=[f"d{i}" for i in range(6)], texts=texts, images=images)


def _process(pipe):
    corpus = _corpus()
    pipe.process_corpus(corpus)
    index = pipe.build_index_corpus(corpus)
    return corpus, index


@pytest.fixture(scope="module")
def pipe():
    return _pipeline()


@pytest.fixture(scope="module")
def index():
    """An int8 index with s8 queries whose stage 1 takes the fused block-max
    route (the plain versions on the CPU): 4 x 16384 rows of dim 64."""
    g = torch.Generator().manual_seed(11)
    n, cap = 60_000, 65_536
    emb = torch.randn((n, 64), generator=g)
    pay = torch.rand((n, 8), generator=g)
    idx = DewiIndex(dim=64, backend="int8", device="cpu", rerank_eta=0.25,
                    entropy_pref=0.1, int8_queries=True)
    idx._backend.store.attach_device([str(i) for i in range(n)], emb, pay)
    idx.build()
    assert idx._backend.store.capacity == cap
    return idx


def _queries(n):
    return torch.randn((n, 64), generator=torch.Generator().manual_seed(n))


def test_off_opens_no_range_and_records_nothing(monkeypatch, pipe, index):
    def refuse(*a, **k):
        raise AssertionError("record_function entered while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not prof.tracing()
    with prof.span("dewi.test"):
        prof.count("test.count", 3)
    _process(pipe)
    index.search_batch(_queries(40), k=10)
    index.search_batch(_queries(8), k=10)
    assert prof.trace_stats() == {"spans": {}, "counters": {}}


def test_self_time_and_parents():
    def body():
        assert prof.tracing()
        with prof.span("dewi.a"):
            for _ in range(2):
                with prof.span("dewi.b"):
                    with prof.span("dewi.c"):
                        prof.count("n", 2)
            prof.count("n")

    _, events = _traced(body)
    stats = prof.trace_stats()
    assert stats["counters"] == {"n": 5}
    _check_nesting(events, stats, {"dewi.a": {None}, "dewi.b": {"dewi.a"},
                                   "dewi.c": {"dewi.b"}})
    spans = stats["spans"]
    assert [spans[f"dewi.{k}"]["count"] for k in "abc"] == [1, 2, 2]
    assert spans["dewi.c"]["self_s"] == spans["dewi.c"]["total_s"]
    assert not prof.tracing()
    json.dumps(stats)


def test_corpus_spans_nest(pipe):
    _, events = _traced(lambda: _process(pipe))
    _check_nesting(events, prof.trace_stats(), CORPUS_PARENTS)


@pytest.mark.parametrize("nq,groups", [(40, 2), (8, 1)])
def test_search_spans_nest(index, nq, groups):
    """The fused route's stages open once a call; it counts its 32-query
    stage-1 launches."""
    _, events = _traced(lambda: index.search_batch(_queries(nq), k=10))
    stats = prof.trace_stats()
    _check_nesting(events, stats, SEARCH_PARENTS)
    assert {name: rec["count"] for name, rec in stats["spans"].items()} == \
        dict.fromkeys(SEARCH_PARENTS, 1)
    assert stats["counters"] == {"search.stage1_groups": groups}


@pytest.mark.parametrize("path", ["batch_compute_stats", "batch_compute"])
def test_counters_equal_hand_counts(path):
    est = TextEntropyEstimator("tiny", device="cpu", batch_size=4, max_length=64, chip_len=32)
    texts = SHORT[:2] + LONG[:1] + SHORT[2:] + LONG[1:]
    assert [len(est.tokenizer.encode(t, 1 << 30)) for t in SHORT + LONG] == \
        [5, 9, 17, 30, 10, 80, 41]
    _traced(lambda: getattr(est, path)(texts))
    assert prof.trace_stats()["counters"] == HAND


@pytest.mark.parametrize("path", ["batch_compute_stats", "batch_compute"])
def test_counters_pack_windows_across_documents(path):
    est = TextEntropyEstimator("tiny", device="cpu", batch_size=4, max_length=64, chip_len=32)
    assert [len(est.tokenizer.encode(t, 1 << 30)) for t in PACKED] == [41, 46, 51]
    _traced(lambda: getattr(est, path)(PACKED))
    stats = prof.trace_stats()
    assert stats["counters"] == PACKED_HAND
    assert stats["spans"]["dewi.text_entropy.long"]["count"] == 1
    assert stats["spans"]["dewi.text_entropy.fetch"]["count"] == 1


@pytest.mark.parametrize("path", ["batch_compute_stats", "batch_compute"])
def test_counters_of_packed_sequences(path):
    est = TextEntropyEstimator("moonlight-tiny", device="cpu", batch_size=4, max_length=64,
                               chip_len=32)
    _traced(lambda: getattr(est, path)(SHORT[:2] + LONG[:1] + SHORT[2:] + LONG[1:]))
    stats = prof.trace_stats()
    c = stats["counters"]
    assert {k: v for k, v in c.items() if k.startswith("text.") and k != "text.logit_chunks"} \
        == MOONLIGHT_HAND
    assert c["text.logit_chunks"] == 2 + 1  # 113 and 93 scored tokens, 96 rows a chunk
    assert c["moe.routed_rows"] == 3 * 2 * 216  # 3 experts a token, 2 MoE layers
    assert stats["spans"]["dewi.text_entropy.packed"]["count"] == 1
    assert stats["spans"]["dewi.text_entropy.fetch"]["count"] == 1


def test_results_identical_with_the_profiler_on_and_off(pipe, index):
    off = _process(pipe)
    on, _ = _traced(lambda: _process(pipe))
    (c_off, i_off), (c_on, i_on) = off, on
    for name in ("signals", "dewi", "embeddings"):
        assert np.array_equal(getattr(c_off, name), getattr(c_on, name)), name
    for t_off, t_on in zip(i_off._backend.store.device_arrays()[:3],
                           i_on._backend.store.device_arrays()[:3]):
        assert torch.equal(t_off, t_on)
    for nq in (40, 8):
        q = _queries(nq)
        s_off, r_off = index.search_batch(q, k=10)
        (s_on, r_on), _ = _traced(lambda: index.search_batch(q, k=10))
        assert torch.equal(s_off, s_on) and torch.equal(r_off, r_on)


@pytest.mark.parametrize("route", ["columnar", "stream"])
def test_cli_profile_writes_spans(tmp_path, monkeypatch, route):
    monkeypatch.setenv("DEWI_TEST_MODE", "0")
    cfg = {"text": {"model": "tiny", "batch_size": 4, "max_length": 64},
           "image": {"model": "tiny", "batch_size": 4, "image_size": 32, "patch_size": 8},
           "cross_modal": {"model": "tiny", "batch_size": 4},
           "redundancy": {"block_size": 8}, "runtime": {"profile": True}}
    (tmp_path / "cfg.yaml").write_text(yaml.dump(cfg))
    texts = tmp_path / "texts"
    texts.mkdir()
    for i in range(6):
        (texts / f"t{i}.txt").write_text("river entropy " * (i + 1))
    extra = ["--shard-size", "4"] if route == "stream" else []
    out = tmp_path / "out"
    assert cli.main(["--device", "cpu", "process", str(tmp_path / "cfg.yaml"), str(out),
                     "--texts", str(texts), *extra]) == 0
    spans = json.loads((out / "profile" / "spans.json").read_text())["spans"]
    want = ({"dewi.process_corpus"} if route == "columnar"
            else {"dewi.text_entropy", "dewi.redundancy", "dewi.score"})
    assert want <= set(spans)
    assert all(spans[k]["count"] >= 1 and spans[k]["total_s"] > 0 for k in want)
    assert list((out / "profile").glob("trace_*.json"))
