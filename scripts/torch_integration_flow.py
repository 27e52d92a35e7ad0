#!/usr/bin/env python3
"""Every subsystem of the port in one flow, at the reference's test sizes.

    python3 scripts/torch_integration_flow.py [--device cpu] [--output out.json]

The flow of the reference's ``tests/test_integration.py``: eight sentences
(``d0`` and ``d1`` a duplicate pair) -> signals -> DEWI scores -> a
quantized index (``tiny`` presets, ``text.max_length`` 64,
``redundancy.block_size`` 8, ``index.ann: quantized``, ``refine_factor``
8) -> a text query and ``evaluate_index`` -> sharded exact search (a world
of one in this process: NCCL on the card, gloo on the CPU) -> DEWI^tau
sampling and ``submodular_pick`` -> 40 ``train_lm`` steps -> the trained
checkpoint in a ``TextEntropyEstimator``.  It holds the reference's
assertions (every signal filled, DEWI in [0, 1], the duplicates'
redundancy 1 within 1e-3, the quantized backend, the text query's top hit
in ``{d0, d1}``, recall@5 1.0, the sharded ids equal to one device's,
distinct picks, the loss falling, corpus text less surprising than
gibberish) and exits 1 if one fails.  At the reference's capacity (1,024
rows) the quantized search takes the plain route, as the reference's
gates keep Pallas off there, so the text query also runs on indexes of
the same docs at 8,192 rows (``scores_matrix``) and 65,536 rows (the fused
``bmax``), its top two held to the first; on the card it records which
search kernels each launched (``launch_counts`` and ``launched_kernels``).

``tests/test_torch_integration.py`` drives these functions on the CPU
against the reference's flow; ``chip_smoke.py`` phase 15 runs ``main`` on
the card.  Writes ``--output`` (JSON, default under ``chiprun_out/``).
"""

from __future__ import annotations

import argparse
import datetime
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CORPUS = [
    "the aurora is caused by solar particles striking the atmosphere",
    "the aurora is caused by solar particles striking the atmosphere",
    "quantum error correction encodes logical qubits redundantly",
    "fermentation converts sugars to ethanol in yeast metabolism",
    "buy cheap watches now !!! $$$ limited offer",
    "plate tectonics drives earthquakes along continental faults",
    "neural networks approximate functions with composed linear maps",
    "a b a b a b a b a b a b a b a b",
]
SHARDED_QUERY = "qubits and error correction"
GIBBERISH = "zzqx jvwp ktrr mmnb"
ETA, EP = 0.25, 0.1
TRAIN = dict(steps=40, batch_size=8, lr=3e-3, log_every=10)
DUP_TOL = 1e-3
KERNEL_CAPACITIES = (8192, 65536)
# The top-2 scores at another capacity: the f32 refine of the same rows
# (stage 1 only picks the candidates), so equal but for the order of a sum
ROUTE_SCORE_TOL = 1e-5


def config_dict(lm_checkpoint=None, clip_checkpoint=None) -> dict:
    """The reference test's config, with checkpoints where given."""
    cfg = {
        "text": {"model": "tiny", "batch_size": 4, "max_length": 64},
        "cross_modal": {"model": "tiny", "batch_size": 4},
        "redundancy": {"block_size": 8},
        "index": {"ann": "quantized", "refine_factor": 8},
    }
    if lm_checkpoint:
        cfg["text"]["checkpoint"] = str(lm_checkpoint)
    if clip_checkpoint:
        cfg["cross_modal"]["checkpoint"] = str(clip_checkpoint)
    return cfg


def build(cfg: dict, device):
    """``(pipeline, scored docs, index)`` of the corpus."""
    from dewi_tpu_torch import DewiConfig, DewiPipeline, create_document

    pipe = DewiPipeline(DewiConfig.from_dict(cfg), device=device)
    docs = [create_document(f"d{i}", text=t) for i, t in enumerate(CORPUS)]
    docs = pipe.compute_dewi_scores(pipe.compute_signals(docs))
    return pipe, docs, pipe.build_index(docs)


def doc_arrays(docs) -> tuple:
    """``(embeddings, payloads, ids)`` of the scored docs."""
    emb = np.stack([d.embedding for d in docs]).astype(np.float32)
    pay = np.stack([d.payload().to_array() for d in docs]).astype(np.float32)
    return emb, pay, [d.doc_id for d in docs]


def single_device_ids(docs, q: np.ndarray, device, k: int = 3) -> np.ndarray:
    from dewi_tpu_torch.index import ExactIndex

    emb, pay, ids = doc_arrays(docs)
    single = ExactIndex(dim=emb.shape[1], device=device)
    single.add_batch(ids, emb, pay)
    single.build()
    return np.asarray(single.search_batch(q[None], k=k, eta=ETA, entropy_pref=EP)[1].cpu())[0]


def sharded_ids(emb: np.ndarray, pay: np.ndarray, ids: list, q: np.ndarray, device=None,
                k: int = 3) -> np.ndarray:
    """The rows ``ShardedExactSearcher`` returns on the mesh of the current
    process group (a module-level function: the gloo ranks of the test run
    it)."""
    from dewi_tpu_torch.index.store import DocStore
    from dewi_tpu_torch.parallel import ShardedExactSearcher, make_mesh

    mesh = make_mesh(device=device)
    store = DocStore(emb.shape[1], device=mesh.device)
    store.add_batch(ids, emb, pay)
    searcher = ShardedExactSearcher(store, mesh, k=k)
    _, got = searcher.search_batch(q[None], eta=ETA, entropy_pref=EP)
    return np.asarray(got.cpu())[0]


def query_leg(q: np.ndarray, index, device) -> dict:
    """The text query and its eval, with the search kernels it launched."""
    from dewi_tpu_torch.eval import evaluate_index
    from dewi_tpu_torch.ops import cuda_search as cs
    from dewi_tpu_torch.utils.profiling import launched_kernels

    cs.reset_launch_counts()
    hits = index.search(q, k=2, eta=0.0)
    counts = {k: v for k, v in cs.launch_counts.items() if v}
    prof = launched_kernels(lambda: index.search(q, k=2, eta=0.0), device)
    report = evaluate_index(index, np.stack([q]), {"q0": ["d0", "d1"]})
    return {"capacity": index._backend.store.capacity, "top2": [h[0] for h in hits],
            "top2_scores": [float(h[1]) for h in hits], "recall_at_5": report["recall@5"],
            "launches": counts, "device_ops": prof["kernels"], "profile_complete": prof["complete"]}


def sampling_leg(docs, device) -> dict:
    from dewi_tpu_torch.sampling import sample_by_dewi, submodular_pick

    dewi = np.array([d.dewi_score for d in docs])
    emb = np.stack([d.embedding for d in docs])
    return {"picks": sample_by_dewi(dewi, k=4, tau=2.0, seed=0, device=device).tolist(),
            "cover": submodular_pick(emb, k=3, device=device).tolist()}


def train_leg(texts: list, device, ckpt: Path, init_checkpoint=None,
              dtype: str = "bfloat16") -> dict:
    """40 ``train_lm`` steps from the tiny LM (``init_checkpoint``'s
    weights where given), saved to ``ckpt`` with a config sidecar, then
    the checkpoint in ``TextEntropyEstimator``: a corpus sentence's and
    gibberish's mean surprisal."""
    from dewi_tpu_torch.models import init_lm, lm_config
    from dewi_tpu_torch.models.import_hf import write_sidecar_config
    from dewi_tpu_torch.models.registry import load_params
    from dewi_tpu_torch.signals import TextEntropyEstimator
    from dewi_tpu_torch.training import train_lm

    cfg = lm_config("tiny", max_len=64, dtype=dtype)
    model = init_lm(cfg, seed=0, device=device)
    if init_checkpoint:
        load_params(model, init_checkpoint)
    state = train_lm(model, list(texts) * 4, checkpoint=str(ckpt), **TRAIN)
    write_sidecar_config(ckpt, "lm", cfg)
    est = TextEntropyEstimator(model_name="tiny", max_length=64, batch_size=4,
                               checkpoint=str(ckpt), device=device)
    return {"losses": [float(v) for v in state.losses],
            "seen": est.compute_entropy(texts[0]).mean_entropy,
            "novel": est.compute_entropy(GIBBERISH).mean_entropy}


def failures(res: dict) -> list:
    """The reference's assertions that ``res`` breaks."""
    bad = []
    sig = res["signals"]
    if any(v is None for row in sig for v in (row["ht_mean"], row["redundancy"])):
        bad.append("a signal is missing")
    if not all(0.0 <= row["dewi"] <= 1.0 for row in sig):
        bad.append("a DEWI score is outside [0, 1]")
    if any(abs(sig[i]["redundancy"] - 1.0) > DUP_TOL for i in (0, 1)):
        bad.append("the duplicate pair is not redundant")
    if res["backend"] != "QuantizedIndex":
        bad.append(f"the index backend is {res['backend']}")
    if res["query"]["top2"][0] not in ("d0", "d1"):
        bad.append(f"the text query's top hit is {res['query']['top2'][0]}")
    if abs(res["query"]["recall_at_5"] - 1.0) > 1e-6:
        bad.append(f"recall@5 {res['query']['recall_at_5']}")
    for leg in res["query_kernel_routes"]:
        if leg["top2"] != res["query"]["top2"] or leg["recall_at_5"] != res["query"][
                "recall_at_5"] or max(abs(a - b) for a, b in zip(
                    leg["top2_scores"], res["query"]["top2_scores"])) > ROUTE_SCORE_TOL:
            bad.append(f"the text query at capacity {leg['capacity']} differs")
    if set(res["sharded"]["ids"]) != set(res["sharded"]["single_device_ids"]):
        bad.append("the sharded ids differ from one device's")
    if len(set(res["sampling"]["picks"])) != 4 or len(set(res["sampling"]["cover"])) != 3:
        bad.append("the picks are not distinct")
    losses = res["training"]["losses"]
    if not losses[-1] < losses[0]:
        bad.append(f"the loss did not fall: {losses}")
    if not res["training"]["seen"] < res["training"]["novel"]:
        bad.append("corpus text is not less surprising than gibberish")
    return bad


def run(device, tmp: Path, cfg: dict = None) -> dict:
    """The whole flow on ``device``; its record."""
    import torch.distributed as dist

    pipe, docs, index = build(cfg or config_dict(), device)
    res = {"n_docs": len(docs), "device": str(device),
           "signals": [{"ht_mean": d.ht_mean, "ht_q90": d.ht_q90, "I_hat": d.I_hat,
                        "redundancy": d.redundancy, "noise": d.noise, "dewi": d.dewi_score}
                       for d in docs],
           "backend": type(index._backend).__name__}
    q0 = pipe.encode_query(docs[0].text)
    res["query_vector"] = q0.tolist()
    res["query"] = query_leg(q0, index, device)
    # The same docs at capacities whose stage 1 the kernels take (at the
    # reference's capacity the plain route runs, as the reference's gates
    # keep Pallas off there): scores_matrix from SCORES_BLOCK rows, the
    # fused block max from 4 BMAX_BLOCKs.
    res["query_kernel_routes"] = [query_leg(q0, pipe.build_index(docs, capacity=cap), device)
                                  for cap in KERNEL_CAPACITIES]
    q = pipe.encode_query(SHARDED_QUERY)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        got = sharded_ids(*doc_arrays(docs), q, None if backend == "nccl" else device)
    finally:
        dist.destroy_process_group()
    res["sharded"] = {"backend": backend, "ids": got.tolist(),
                      "single_device_ids": single_device_ids(docs, q, device).tolist()}
    res["sampling"] = sampling_leg(docs, device)
    res["training"] = train_leg([d.text for d in docs], device, tmp / "lm.msgpack")
    res["failures"] = failures(res)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--output", default=str(REPO / "chiprun_out" / "integration_flow.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    from dewi_tpu_torch.utils.device import resolve_device
    from dewi_tpu_torch.utils.profiling import card_line, device_name

    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        res = run(device, Path(tmp))
    res.update(device=device_name(device), card=card_line() if device.type == "cuda" else "cpu")
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(res, indent=2))
    print(json.dumps({k: v for k, v in res.items() if k not in ("signals", "query_vector")}),
          flush=True)
    for f in res["failures"]:
        print(f"integration flow: {f}", file=sys.stderr)
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
