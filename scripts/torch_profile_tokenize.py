#!/usr/bin/env python3
"""Host tokenize rate of the port: the byte tokenizer against a BPE.

    python3 scripts/torch_profile_tokenize.py [--n-docs 20000] [--vocab-size 50257]

Counterpart of ``scripts/profile_tokenize.py``, through the port's
``signals/tokenizer.py`` (``ByteTokenizer`` and ``make_hf_adapter``).  CPU
only: it touches no device.  There is no network, so the BPE is a
byte-level BPE that the Rust ``tokenizers`` library trains here, at the
given vocabulary size, on a Zipf-weighted synthetic corpus (the
reference's ``synth_corpus``), into a temporary directory.  Rows (docs/s
over ``--n-docs`` docs of about ``--words`` words; best of 2 after a warm
call):

  byte_u16        ``ByteTokenizer.encode_batch_u16``
  bpe_fast_batch  the adapter's ``encode_batch`` (one Rust call a chunk)
  bpe_fast_u16    the adapter's ``encode_batch_u16`` (pad sentinel, no mask)
  bpe_per_text    the per-text encode loop, on a tenth of the corpus

plus the adapter's raw Rust route against the ``transformers`` call it
bypasses (interleaved medians of 5).  Without ``tokenizers`` and
``transformers`` the BPE rows are skipped with a message and
``byte_u16`` still runs.  Writes ``--output``
(JSON, default under ``chiprun_out/``).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def synth_corpus(n_docs: int, words_per_doc: int, seed: int = 0) -> list:
    """Zipf-weighted English-like text (syllable-composed word list)."""
    rng = np.random.default_rng(seed)
    syll = ["al", "an", "ar", "co", "de", "en", "er", "in", "ing", "ion",
            "is", "it", "le", "ment", "nd", "on", "or", "ra", "re", "se",
            "st", "te", "th", "ti", "to", "tro", "ve", "py", "dex", "sig"]
    n_vocab = 120_000
    parts = rng.integers(0, len(syll), size=(n_vocab, 4))
    lens = rng.integers(1, 5, size=n_vocab)
    vocab = np.array(["".join(syll[parts[i, j]] for j in range(lens[i]))
                      for i in range(n_vocab)])
    ranks = np.arange(1, n_vocab + 1, dtype=np.float64)
    p = ranks ** -1.1
    p /= p.sum()
    idx = rng.choice(n_vocab, size=(n_docs, words_per_doc), p=p)
    return [" ".join(vocab[row]) for row in idx]


def train_bpe(corpus: list, vocab_size: int, workdir: Path):
    """A byte-level BPE trained on ``corpus`` in ``workdir``, as a
    ``GPT2TokenizerFast``, and the seconds it took."""
    import tokenizers
    import transformers

    t0 = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)
    train_file = workdir / "train.txt"
    train_file.write_text("\n".join(corpus))
    bpe = tokenizers.implementations.ByteLevelBPETokenizer()
    bpe.train([str(train_file)], vocab_size=vocab_size, min_frequency=1)
    bpe.save_model(str(workdir))
    tok = transformers.GPT2TokenizerFast(vocab_file=str(workdir / "vocab.json"),
                                         merges_file=str(workdir / "merges.txt"))
    return tok, time.perf_counter() - t0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=20_000)
    ap.add_argument("--words", type=int, default=100)
    ap.add_argument("--vocab-size", type=int, default=50_257)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--train-docs", type=int, default=4_000)
    ap.add_argument("--output", default=str(REPO / "chiprun_out" / "tokenize.json"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from dewi_tpu_torch.signals.tokenizer import ByteTokenizer, make_hf_adapter

    print(f"== synthesizing {args.n_docs} docs x ~{args.words} words", flush=True)
    corpus = synth_corpus(args.n_docs, args.words)
    n_chars = sum(len(t) for t in corpus)
    out: dict = {"n_docs": args.n_docs, "words_per_doc": args.words, "chars_total": n_chars,
                 "max_len": args.max_len}

    def rate(label: str, fn, n: int = args.n_docs, reps: int = 2) -> float:
        fn()  # warm (allocators, the Rust thread pool)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        dps = n / best
        out[label + "_docs_per_sec"] = round(dps, 1)
        print(f"   {label}: {dps:,.0f} docs/s", flush=True)
        return dps

    bt = ByteTokenizer()
    byte_dps = rate("byte_u16", lambda: bt.encode_batch_u16(corpus, args.max_len,
                                                            pad_to=args.max_len))
    try:
        import tokenizers  # noqa: F401
        import transformers  # noqa: F401
    except ImportError:
        print("bpe: tokenizers/transformers unavailable, BPE rows skipped", flush=True)
        out["bpe_rows"] = "skipped: tokenizers/transformers unavailable"
    else:
        print(f"== training local byte-level BPE (vocab {args.vocab_size})", flush=True)
        with tempfile.TemporaryDirectory() as td:
            tok, train_s = train_bpe(corpus[:args.train_docs], args.vocab_size, Path(td))
        adapter = make_hf_adapter(tok)
        out.update(bpe_vocab_size=adapter.vocab_size, bpe_train_s=round(train_s, 1),
                   bpe_pad_is_exclusive=bool(adapter.pad_is_exclusive))
        bpe_dps = rate("bpe_fast_batch", lambda: adapter.encode_batch(
            corpus, args.max_len, pad_to=args.max_len))
        # The adapter's raw Rust route against the transformers call it
        # bypasses, interleaved so that load drift hits both sides.
        raw_ts: list = []
        tf_ts: list = []
        adapter._encode_all(corpus, args.max_len)
        tok(list(corpus), truncation=True, max_length=args.max_len)
        for _ in range(5):
            t0 = time.perf_counter()
            adapter._encode_all(corpus, args.max_len)
            raw_ts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            tok(list(corpus), truncation=True, max_length=args.max_len)["input_ids"]
            tf_ts.append(time.perf_counter() - t0)
        out["bpe_encode_raw_docs_per_sec"] = round(args.n_docs / float(np.median(raw_ts)), 1)
        out["bpe_transformers_call_docs_per_sec"] = round(
            args.n_docs / float(np.median(tf_ts)), 1)
        out["bpe_fast_vs_transformers_speedup"] = round(
            float(np.median(tf_ts)) / float(np.median(raw_ts)), 3)
        rate("bpe_fast_u16", lambda: adapter.encode_batch_u16(corpus, args.max_len,
                                                              pad_to=args.max_len))
        sub = corpus[:max(1, args.n_docs // 10)]
        rate("bpe_per_text", lambda: [adapter.encode(t, args.max_len) for t in sub], n=len(sub))
        out["byte_vs_bpe_speedup"] = round(byte_dps / max(bpe_dps, 1e-9), 2)
        out["bpe_mb_per_sec"] = round(bpe_dps * n_chars / args.n_docs / 1e6, 2)
    out["note"] = (
        "Locally trained byte-level BPE (Rust tokenizers; the hub gpt2 vocabulary "
        "is out of reach offline; BPE encode cost scales with tokens and merge "
        "depth, not the table's size). Zipf synthetic text; the host's cores are "
        "shared. Tokenizing is parallel across docs: a card needs "
        "ceil(device docs/s / bpe_fast_batch docs/s) host cores to stay fed.")
    path = Path(args.output)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2) + "\n")
    print(f"== wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
