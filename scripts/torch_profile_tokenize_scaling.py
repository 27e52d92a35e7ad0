#!/usr/bin/env python3
"""Per-text BPE encoding against the batch call across the host's cores.

    python3 scripts/torch_profile_tokenize_scaling.py [-o chiprun_out/tokenize_ci.json]

Counterpart of ``scripts/profile_tokenize_scaling.py``.  CPU only: it
touches no device.  The tokenizer is the GPT-2-shaped BPE of
``tests/fixtures/gpt2_mini`` (``GPT2TokenizerFast``), truncating at
``--max-len``; ``encode_batch_fast`` (the call the port's
``signals/tokenizer.py`` adapter makes) releases the interpreter lock
inside the Rust tokenizer, so on a host with several cores it encodes docs
in parallel, where the per-text loop (timed on an eighth of the docs,
scaled up) does not.  Writes ``cpu_count``, ``multi_core`` (4 or more
cores: only then can the ratio show scaling across cores, the reference's
meaning), ``per_text_docs_per_sec``, ``batch_docs_per_sec`` and
``batch_vs_per_text``.  Without ``transformers`` there is nothing to
measure: it says so and exits 0, as the reference does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-o", "--out", default=str(REPO / "chiprun_out" / "tokenize_ci.json"))
    ap.add_argument("--n-docs", type=int, default=4096)
    ap.add_argument("--max-len", type=int, default=512)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import transformers
    except ImportError:
        print("transformers not installed; nothing to measure", file=sys.stderr)
        return 0
    fixture = REPO / "tests" / "fixtures" / "gpt2_mini"
    fast = transformers.GPT2TokenizerFast(vocab_file=str(fixture / "vocab.json"),
                                          merges_file=str(fixture / "merges.txt"))
    bt = fast.backend_tokenizer
    bt.enable_truncation(max_length=args.max_len)
    texts = ["the quick brown fox jumps over the lazy dog " * 8] * args.n_docs
    bt.encode_batch_fast(texts[:64])  # warm (the model's lazy init)

    t0 = time.perf_counter()
    bt.encode_batch_fast(texts)
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for t in texts[:args.n_docs // 8]:
        bt.encode(t)
    per_text_s = (time.perf_counter() - t0) * 8

    cpus = os.cpu_count() or 1
    metrics = {
        "cpu_count": cpus,
        "multi_core": cpus >= 4,
        "n_docs": args.n_docs,
        "max_len": args.max_len,
        "per_text_docs_per_sec": round(args.n_docs / per_text_s, 1),
        "batch_docs_per_sec": round(args.n_docs / batch_s, 1),
        "batch_vs_per_text": round(per_text_s / batch_s, 3),
        "note": ("encode_batch_fast releases the interpreter lock inside the Rust "
                 "tokenizer; the ratio approaches the core count on a multi-core host. "
                 "multi_core=false means this run cannot show scaling across cores."),
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(metrics, indent=2) + "\n")
    print(json.dumps(metrics), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
