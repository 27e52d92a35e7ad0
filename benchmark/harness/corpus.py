"""The corpus deployment: the program's pipeline, its weights and its outputs.

The deployment (``configs/*.json``, ``"kind": "corpus_pipeline"``) is a
``DewiConfig`` (its ``dewi_config``) run through the columnar path of
``python -m dewi_tpu_torch process``, one ``process_corpus`` call, then
``build_index_corpus``, per shard of ``runtime.shard_size`` documents.
The backbones' weights are made on the card from the seed
(``weights.py``) and loaded into the program's modules; the reference
takes the same tensors.  The drivers of the corpus cells
(``drivers/*.py``) build on it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from . import weights as wts
from .common import rng, sync, torch_generator


def make_weights(cfg: Dict[str, Any], seed: int, device: Any) -> Dict[str, Dict[str, torch.Tensor]]:
    return {
        "lm": wts.make(wts.lm_layout(cfg["gpt2"]), torch_generator(seed, device, "lm"), device),
        "clip": wts.make(wts.clip_layout(cfg["clip"]),
                         torch_generator(seed, device, "clip"), device),
    }


def make_pipeline(cfg: Dict[str, Any], w: Dict[str, Dict[str, torch.Tensor]], device: Any) -> Any:
    from dewi_tpu_torch import DewiConfig, DewiPipeline

    pipe = DewiPipeline(DewiConfig.from_dict(cfg["dewi_config"]), device=device)
    with torch.no_grad():
        pipe.text_entropy.model.load_state_dict(w["lm"], strict=True)
        pipe.cross_modal.model.load_state_dict(w["clip"], strict=True)
    return pipe


def run_shard(pipe: Any, cfg: Dict[str, Any], ids: List[str], texts: List[str],
              device: Any) -> Tuple[Any, Any]:
    from dewi_tpu_torch.corpus import Corpus

    corpus = Corpus(ids=ids, texts=texts)
    with torch.profiler.record_function("bench.process_corpus"):
        pipe.process_corpus(corpus, delta=cfg["dewi_config"]["scoring"]["delta"])
    with torch.profiler.record_function("bench.build_index_corpus"):
        index = pipe.build_index_corpus(corpus)
        sync(device)
    return corpus, index


def sample(shard_texts: List[List[str]], seed: int, n: int) -> List[Tuple[int, int]]:
    """The ``(shard, row)`` of a seeded sample of ``n`` documents, and of
    the longest document, whose surprisal is compared."""
    docs = [(s, i) for s, texts in enumerate(shard_texts) for i in range(len(texts))]
    lens = np.array([len(shard_texts[s][i]) for s, i in docs])
    pick = set(rng(seed, "check").choice(len(docs), size=min(n, len(docs)),
                                         replace=False).tolist())
    pick.add(int(np.argmax(lens)))
    return [docs[j] for j in sorted(pick)]


def program_outputs(shards: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """What the program produced for each shard: its signal columns, and
    the embeddings and DEWI scores its index holds."""
    outs = []
    for x in shards:
        n = len(x["texts"])
        emb, _, pay, _ = x["index"]._backend.store.device_arrays()
        outs.append({"texts": x["texts"], "signals": x["corpus"].signals.astype(np.float64),
                     "emb": emb[:n].to(torch.float64), "dewi": pay[:n, 0].double().cpu().numpy()})
    return outs


__all__ = ["make_weights", "make_pipeline", "run_shard", "sample", "program_outputs"]
