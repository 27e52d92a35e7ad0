"""CPU fixtures of the benchmark's tests: the harness on ``sys.path``, and
each cell's files cut to a size the CPU runs in seconds."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.spec import load_cell  # noqa: E402


def tiny_search(name: str):
    cell = load_cell(name)
    cell.config = dict(cell.config, n_docs=3000, capacity=4096, dim=64)
    cell.traffic = dict(cell.traffic, queries_per_call=40, pool_calls=8, check_queries=64)
    return cell


def tiny_corpus(name: str):
    cell = load_cell(name)
    cfg = copy.deepcopy(cell.config)
    dc = cfg["dewi_config"]
    dc["text"].update(model="tiny", batch_size=8, max_length=64)
    dc["cross_modal"].update(model="tiny", batch_size=16)
    dc["runtime"]["shard_size"] = 24
    cfg["gpt2"] = {"vocab_size": 258, "n_embd": 64, "n_layer": 2, "n_head": 2, "n_inner": 256,
                   "n_positions": 64, "layer_norm_epsilon": 1e-6,
                   "activation_function": "gelu_new"}
    cfg["clip"] = {"projection_dim": 64,
                   "text_config": {"vocab_size": 258, "hidden_size": 64, "num_hidden_layers": 2,
                                   "num_attention_heads": 2, "intermediate_size": 256,
                                   "max_position_embeddings": 32, "layer_norm_eps": 1e-6,
                                   "hidden_act": "gelu_new"},
                   "vision_config": {"hidden_size": 64, "num_hidden_layers": 2,
                                     "num_attention_heads": 2, "intermediate_size": 256,
                                     "image_size": 32, "patch_size": 8, "layer_norm_eps": 1e-6,
                                     "hidden_act": "gelu_new"}}
    cell.config = cfg
    t = copy.deepcopy(cell.traffic)
    t["text"].update(median_bytes=60, min_bytes=1, max_bytes=400, vocab_words=500)
    t.update(check_docs=16, control_shards=2)
    cell.traffic = t
    return cell


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
