"""Driver ``text_corpus_moonlight``: text-only documents curated shard by
shard, the text surprisal scored by Moonlight-16B-A3B.

The window is ``text_corpus``'s: ``process_corpus``, then
``build_index_corpus``, on shards of ``runtime.shard_size`` documents back
to back until ``--seconds`` have passed, each shard generated before its
call (``harness/textgen.py``); ``docs_per_s`` is the documents of all
shards over the sum of the calls' times.  A ``--trace 1`` run profiles one
more shard after the window.

The deployment's ``dewi_config`` names ``text.model: moonlight-16b-a3b``;
the configuration file holds Moonlight's published keys at its top level.
The pipeline is built first and its text model's parameters are then
overwritten, leaf by leaf, with weights drawn on the card from the seed
(``harness/moonlight.py``), so the model is held once; a program without
the preset fails there, at once.  The CLIP text tower takes
``dewi-default``'s seeded weights.

The check compares the seven columns ``text_corpus`` compares, and the
root mean square of the surprisal means' gaps over the sample
(``ht_rms_gap``).  The surprisal of a seeded sample of ``check_docs``
documents and the longest comes from the float32 reference
(``reference/moonlight.py``, the program's windowing), which draws the same
weights again one layer at a time once the program is gone.  The seeded
weights keep the stack far from chaos (``harness/moonlight.py``), so a
token that bfloat16 sends to another expert moves its NLL by thousandths
of a nat and the program lies several times closer to the reference than
the float8 control; the readings behind each limit are in the check file.

Traffic keys: ``text``, ``check_docs``, ``control_shards``.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from harness import corpus
from harness import moonlight as hm
from harness import trace as tr
from harness import weights as wts
from harness.common import Run, end_setup, now, rng, sync, torch_generator
from harness.textgen import TextGenerator
from reference import corpus as refc
from reference import models as refm
from reference import moonlight as refl
from reference import search as refs

IMAGE_COLUMNS = slice(2, 5)  # hi_mean, hi_q90, I_hat


def make_pipeline(cfg: Dict[str, Any], seed: int, device: Any) -> Tuple[Any, Dict[str, Any]]:
    """The program's pipeline with the seeded weights; the CLIP weights
    are returned for the check."""
    from dewi_tpu_torch import DewiConfig, DewiPipeline

    t = now()
    pipe = DewiPipeline(DewiConfig.from_dict(cfg["dewi_config"]), device=device)
    sync(device)
    stage("pipeline", now() - t)
    t = now()
    model = pipe.text_entropy.model
    sync(device)
    stage("text_model_build", now() - t)
    t = now()
    hm.load_into(model, cfg, seed, device)
    sync(device)
    stage("weights", now() - t)
    clip = wts.make(wts.clip_layout(cfg["clip"]), torch_generator(seed, device, "clip"), device)
    with torch.no_grad():
        pipe.cross_modal.model.load_state_dict(clip, strict=True)
    return pipe, clip


def measure(cell: Any, seed: int, seconds: float, traced: bool, device: Any,
            t_start: float) -> Tuple[Run, Dict[str, Any]]:
    cfg, traffic = cell.config, cell.traffic
    run = Run(cell.name, traced)
    stage("imports", now() - t_start)
    pipe, clip = make_pipeline(cfg, seed, device)
    shard = int(cfg["dewi_config"]["runtime"]["shard_size"])
    gen = TextGenerator(traffic["text"], rng(seed, "vocabulary"))
    # Warm-up: one shard of the same length multiset, so the same shapes.
    t = now()
    corpus.run_shard(pipe, cfg, [f"w{i}" for i in range(shard)],
                     gen.shard(shard, rng(seed, "warmup")), device)
    stage("warmup_shard", now() - t)
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
    stage("window", run.window_s)
    n_docs = shard * len(shards)
    run.counts.update(docs=n_docs, shards=len(shards), busy_s=busy,
                      cpu_s=sum(x["cpu_s"] for x in shards),
                      window_cpu_s=time.process_time() - cpu0)
    if traced:
        t = now()
        texts = gen.shard(shard, doc_rng)
        run.values["traced_doc_tokens"] = [len(x.encode("utf-8")) + 1 for x in texts]
        with tr.Session(device) as session:
            with session.window():
                corpus.run_shard(pipe, cfg, [f"t{i}" for i in range(shard)], texts, device)
        run.trace = session.trace
        stage("traced_shard", now() - t)
    run.attempted, run.failed = n_docs, 0
    run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0
    run.shapes.update(moonlight={k: cfg[k] for k in PUBLISHED}, clip=cfg["clip"],
                      ctx=cfg["dewi_config"]["text"]["max_length"])
    del pipe
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run, {"clip": clip, "shards": shards}


# The published keys the forward and the counts read.
PUBLISHED = ("vocab_size", "hidden_size", "intermediate_size", "moe_intermediate_size",
             "num_hidden_layers", "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim",
             "qk_rope_head_dim", "v_head_dim", "n_routed_experts", "n_shared_experts",
             "num_experts_per_tok", "first_k_dense_replace", "routed_scaling_factor",
             "rope_theta", "rms_norm_eps")


def stage(name: str, seconds: float) -> None:
    """One line on stderr a stage of the run, so that a run's length can be
    read against its time limit."""
    print(f"stage {name} {seconds:.2f} s", file=sys.stderr, flush=True)


def judge(run: Run, cell: Any, seed: int, device: Any, state: Dict[str, Any]) -> None:
    t = now()
    shards = state["shards"]
    picks = corpus.sample([x["texts"] for x in shards], seed, int(cell.traffic["check_docs"]))
    outs = corpus.program_outputs(shards)
    got = gaps(cell.config, seed, state["clip"], outs, picks, device)
    run.checks.extend((name, value, cell.limits[name]) for name, value in got.items())
    stage("check", now() - t)


def gaps(cfg: Dict[str, Any], seed: int, clip: Dict[str, Any], outs: List[Dict[str, Any]],
         picks: List[Tuple[int, int]], device: Any) -> Dict[str, float]:
    """The compared numbers of ``outs`` against the float32 reference."""
    ctx = int(cfg["dewi_config"]["text"]["max_length"])
    old = refm.no_tf32()
    try:
        texts = [outs[s]["texts"][i] for s, i in picks]
        t = now()
        stats = refl.surprisal_stats(texts, hm.layer_weights(cfg, seed, device), cfg, ctx,
                                     device)
        stage("moonlight_reference", now() - t)
        got = np.array([outs[s]["signals"][i, :2] for s, i in picks])
        out = {"ht_mean_gap": float(np.abs(got[:, 0] - stats[:, 0]).max()),
               "ht_q90_gap": float(np.abs(got[:, 1] - stats[:, 1]).max()),
               "ht_rms_gap": float(np.sqrt(np.mean((got[:, 0] - stats[:, 0]) ** 2)))}
        sc = cfg["dewi_config"]["scoring"]
        lang = cfg["dewi_config"]["noise"]["expected_language"]
        emb_gap = red_gap = noise_gap = absent_gap = dewi_gap = 0.0
        for o in outs:
            ref_emb = refc.text_embeddings(o["texts"], clip, cfg["clip"]["text_config"])
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
    deployment's: every matmul of Moonlight and of the CLIP text tower in
    float8 e4m3 where the program computes in bfloat16, the scorer in
    bfloat16 where it computes in float32, over ``control_shards`` shards
    of the cell's documents."""
    cfg = cell.config
    run = Run(cell.name, False)
    clip = wts.make(wts.clip_layout(cfg["clip"]), torch_generator(seed, device, "clip"), device)
    gen = TextGenerator(cell.traffic["text"], rng(seed, "vocabulary"))
    size = int(cfg["dewi_config"]["runtime"]["shard_size"])
    doc_rng = rng(seed, "documents")
    shard_texts = [gen.shard(size, doc_rng) for _ in range(int(cell.traffic["control_shards"]))]
    picks = corpus.sample(shard_texts, seed, int(cell.traffic["check_docs"]))
    ctx = int(cfg["dewi_config"]["text"]["max_length"])
    sc = cfg["dewi_config"]["scoring"]
    lang = cfg["dewi_config"]["noise"]["expected_language"]
    weights = hm.layer_weights(cfg, seed, device)
    outs = []
    old = refm.no_tf32()
    try:
        for s, texts in enumerate(shard_texts):
            sig = np.zeros((len(texts), 7))
            rows = [i for t, i in picks if t == s]
            if rows:
                sig[rows, :2] = refl.surprisal_stats([texts[i] for i in rows], weights, cfg, ctx,
                                                     device, refm.fp8)
            emb = refc.text_embeddings(texts, clip, cfg["clip"]["text_config"], refm.fp8)
            sig[:, 5] = refc.redundancy(emb).cpu().numpy()
            sig[:, 6] = refc.text_noise(texts, lang)
            dewi = refs.dewi_scores(torch.from_numpy(sig), tuple(sc["weights"].values()),
                                    sc["delta"], dtype=torch.bfloat16).double().numpy()
            outs.append({"texts": texts, "signals": sig, "emb": emb.double(), "dewi": dewi})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    for name, value in gaps(cfg, seed, clip, outs, picks, device).items():
        run.checks.append((name, value, cell.limits[name]))
    return run
