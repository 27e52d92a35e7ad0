"""Driver ``text_corpus``: text-only documents curated shard by shard.

The window runs ``process_corpus``, then ``build_index_corpus``, on shards
of ``runtime.shard_size`` documents back to back until ``--seconds`` have
passed; each shard's documents are generated before its call, outside its
time (``harness/textgen.py``, from the traffic file's ``text``).
``docs_per_s`` is the documents of all shards over the sum of the calls'
times.  A ``--trace 1`` run profiles one more shard after the window.

The check compares, for the shards the window processed, each signal
column with ``reference/`` in float32 (float64 where cheap): the text
surprisal mean and 0.9 quantile of a seeded sample of ``check_docs``
documents and the longest; for every document the index embedding, the
redundancy, the noise, and the image columns (MAE mean and 0.9 quantile,
CLIP ``I_hat``), which a document without an image leaves at 0.  The DEWI
scores the index holds are compared with the reference scorer over the
program's own signal columns: the scorer is checked by itself, since the
reference's surprisal covers only the sample.

Traffic keys: ``text``, ``check_docs``, ``control_shards`` (the shards a
window processes, which the control reads).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from harness import corpus
from harness import trace as tr
from harness.common import Run, end_setup, now, rng
from harness.textgen import TextGenerator
from reference import corpus as refc
from reference import models as refm
from reference import search as refs

IMAGE_COLUMNS = slice(2, 5)  # hi_mean, hi_q90, I_hat


def measure(cell: Any, seed: int, seconds: float, traced: bool, device: Any,
            t_start: float) -> Tuple[Run, Dict[str, Any]]:
    cfg, traffic = cell.config, cell.traffic
    run = Run(cell.name, traced)
    w = corpus.make_weights(cfg, seed, device)
    pipe = corpus.make_pipeline(cfg, w, device)
    shard = int(cfg["dewi_config"]["runtime"]["shard_size"])
    gen = TextGenerator(traffic["text"], rng(seed, "vocabulary"))
    # Warm-up: one shard of the same length multiset, so the same shapes.
    wr = rng(seed, "warmup")
    corpus.run_shard(pipe, cfg, [f"w{i}" for i in range(shard)], gen.shard(shard, wr), device)
    doc_rng = rng(seed, "documents")

    shards: List[Dict[str, Any]] = []
    run.setup_s = end_setup(t_start)
    t0 = now()
    busy = 0.0
    cpu0 = time.process_time()
    while now() - t0 < seconds:
        s = len(shards)
        texts = gen.shard(shard, doc_rng)
        ids = [f"{s}:{i}" for i in range(shard)]
        c0, p0 = now(), time.process_time()
        docs, index = corpus.run_shard(pipe, cfg, ids, texts, device)
        dt = now() - c0
        busy += dt
        shards.append({"texts": texts, "corpus": docs, "index": index, "seconds": dt,
                       "cpu_s": time.process_time() - p0})
    run.window_s = now() - t0
    n_docs = shard * len(shards)
    run.counts.update(docs=n_docs, shards=len(shards), busy_s=busy,
                      cpu_s=sum(x["cpu_s"] for x in shards),
                      window_cpu_s=time.process_time() - cpu0)
    run.values["doc_tokens"] = [len(t.encode("utf-8")) + 1 for x in shards for t in x["texts"]]
    if traced:
        texts = gen.shard(shard, doc_rng)
        with tr.Session(device) as session:
            with session.window():
                corpus.run_shard(pipe, cfg, [f"t{i}" for i in range(shard)], texts, device)
        run.trace = session.trace
    run.attempted, run.failed = n_docs, 0
    run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0
    run.shapes.update(lm=cfg["gpt2"], clip=cfg["clip"],
                      ctx=cfg["dewi_config"]["text"]["max_length"])
    del pipe
    return run, {"weights": w, "shards": shards}


def judge(run: Run, cell: Any, seed: int, device: Any, state: Dict[str, Any]) -> None:
    shards = state["shards"]
    picks = corpus.sample([x["texts"] for x in shards], seed, int(cell.traffic["check_docs"]))
    got = gaps(cell.config, state["weights"], corpus.program_outputs(shards), picks)
    run.checks.extend((name, value, cell.limits[name]) for name, value in got.items())


def gaps(cfg: Dict[str, Any], w: Dict[str, Any], outs: List[Dict[str, Any]],
         picks: List[Tuple[int, int]]) -> Dict[str, float]:
    """The compared numbers of ``outs`` against the float32 reference."""
    ctx = int(cfg["dewi_config"]["text"]["max_length"])
    old = refm.no_tf32()
    try:
        texts = [outs[s]["texts"][i] for s, i in picks]
        stats = refc.surprisal_stats(texts, w["lm"], cfg["gpt2"], ctx)
        got = np.array([outs[s]["signals"][i, :2] for s, i in picks])
        out = {"ht_mean_gap": float(np.abs(got[:, 0] - stats[:, 0]).max()),
               "ht_q90_gap": float(np.abs(got[:, 1] - stats[:, 1]).max())}
        sc = cfg["dewi_config"]["scoring"]
        lang = cfg["dewi_config"]["noise"]["expected_language"]
        emb_gap = red_gap = noise_gap = absent_gap = dewi_gap = 0.0
        for o in outs:
            ref_emb = refc.text_embeddings(o["texts"], w["clip"], cfg["clip"]["text_config"])
            emb_gap = max(emb_gap, float((o["emb"].to(ref_emb.device)
                                          - ref_emb.double()).abs().max()))
            red = refc.redundancy(ref_emb).cpu().numpy()
            red_gap = max(red_gap, float(np.abs(o["signals"][:, 5] - red).max()))
            noise = refc.text_noise(o["texts"], lang)
            noise_gap = max(noise_gap, float(np.abs(o["signals"][:, 6] - noise).max()))
            absent_gap = max(absent_gap, float(np.abs(o["signals"][:, IMAGE_COLUMNS]).max()))
            dewi = refs.dewi_scores(torch.from_numpy(o["signals"]),
                                    tuple(sc["weights"].values()), sc["delta"]).numpy()
            dewi_gap = max(dewi_gap, float(np.abs(o["dewi"] - dewi).max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    out.update(emb_gap=emb_gap, redundancy_gap=red_gap, noise_gap=noise_gap,
               absent_gap=absent_gap, dewi_gap=dewi_gap)
    return out


def control(cell: Any, seed: int, device: Any) -> Run:
    """The reference in the program's place, one precision below the
    deployment's: the backbones' matmuls in float8 e4m3 where the program
    computes in bfloat16, the scorer in bfloat16 where it computes in
    float32, over ``control_shards`` shards of the cell's documents."""
    cfg = cell.config
    run = Run(cell.name, False)
    w = corpus.make_weights(cfg, seed, device)
    gen = TextGenerator(cell.traffic["text"], rng(seed, "vocabulary"))
    size = int(cfg["dewi_config"]["runtime"]["shard_size"])
    doc_rng = rng(seed, "documents")
    shard_texts = [gen.shard(size, doc_rng) for _ in range(int(cell.traffic["control_shards"]))]
    picks = corpus.sample(shard_texts, seed, int(cell.traffic["check_docs"]))
    ctx = int(cfg["dewi_config"]["text"]["max_length"])
    sc = cfg["dewi_config"]["scoring"]
    lang = cfg["dewi_config"]["noise"]["expected_language"]
    outs = []
    old = refm.no_tf32()
    try:
        for s, texts in enumerate(shard_texts):
            sig = np.zeros((len(texts), 7))
            rows = [i for t, i in picks if t == s]
            if rows:
                sig[rows, :2] = refc.surprisal_stats([texts[i] for i in rows], w["lm"],
                                                     cfg["gpt2"], ctx, refm.fp8)
            emb = refc.text_embeddings(texts, w["clip"], cfg["clip"]["text_config"], refm.fp8)
            sig[:, 5] = refc.redundancy(emb).cpu().numpy()
            sig[:, 6] = refc.text_noise(texts, lang)
            dewi = refs.dewi_scores(torch.from_numpy(sig), tuple(sc["weights"].values()),
                                    sc["delta"], dtype=torch.bfloat16).double().numpy()
            outs.append({"texts": texts, "signals": sig, "emb": emb.double(), "dewi": dewi})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    for name, value in gaps(cfg, w, outs, picks).items():
        run.checks.append((name, value, cell.limits[name]))
    return run
