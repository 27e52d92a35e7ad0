"""Plain reference of Moonlight-16B-A3B's next-token NLL, at the published
widths on one card.

The same mathematics as the repository's test reference
(``tests/moonlight_reference.py``), written from the published
description (``moonshotai/Moonlight-16B-A3B``'s ``config.json``, the
DeepSeek-V3 block it names), in float32 with TF32 off and plain ``torch``
operations: no kernel, cache or fused attention of the program.  What
differs is only what makes it fit beside nothing else on the card:

* it runs layer by layer over all its sequences, asking ``weights(prefix)``
  for one layer's weights at a time (float32, upcast from the bfloat16
  the program holds), so at most one layer is held in float32;
* sequences of similar length share a right-padded batch; each row's
  attention is its own causal ``[H, T, T]`` softmax, so padding never
  reaches a real token;
* the experts run one at a time over the real tokens that chose them
  (gathered by index), each output scaled by its gate and added back:
  the per-token sum of the chosen experts, written as a loop over experts;
* the head runs over 1,024 token rows at a time, each a float64
  log-softmax over the whole vocabulary.

RoPE pairs dims ``(2i, 2i+1)`` and rotates each by ``pos * theta^(-2i/d)``
(angles in float32, as published), evens first.  Every matmul goes through
``mm`` (``models.exact``, or ``models.fp8`` for the control); the router
and norms stay in float32, as the program keeps them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .corpus import token_ids, windows
from .models import Matmul, exact

Weights = Dict[str, torch.Tensor]

TOKENS_PER_BATCH = 16384
SCORES_PER_BATCH = 1 << 26  # B * T * T, so [B, 16, T, T] float32 scores stay within 4.3 GB
HEAD_ROWS = 1024


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [B, T, H, d]``, each pair ``(x[2i], x[2i+1])`` rotated by its
    position times its frequency; evens first, then odds."""
    t, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv[None]
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.cat([even * cos - odd * sin, odd * cos + even * sin], -1)


def lin(x: torch.Tensor, w: torch.Tensor, mm: Matmul) -> torch.Tensor:
    return mm(x, w.t())


def attention(x: torch.Tensor, w: Weights, c: Dict, mm: Matmul) -> torch.Tensor:
    b, t, _ = x.shape
    h, nope, rp, dv, r = (c["num_attention_heads"], c["qk_nope_head_dim"],
                          c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"])
    q = lin(x, w["self_attn.q_proj.weight"], mm).view(b, t, h, nope + rp)
    kv_a = lin(x, w["self_attn.kv_a_proj_with_mqa.weight"], mm)
    latent = rms(kv_a[..., :r], w["self_attn.kv_a_layernorm.weight"], c["rms_norm_eps"])
    kv = lin(latent, w["self_attn.kv_b_proj.weight"], mm).view(b, t, h, nope + dv)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], c["rope_theta"])], -1).transpose(1, 2)
    k_pe = rope(kv_a[..., None, r:], c["rope_theta"]).expand(b, t, h, rp)
    k = torch.cat([kv[..., :nope], k_pe], -1).transpose(1, 2)
    v = kv[..., nope:].transpose(1, 2)
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(nope + rp)
    keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    s.masked_fill_(~keep, float("-inf"))
    o = mm(torch.softmax(s, -1), v).transpose(1, 2).reshape(b, t, h * dv)
    return lin(o, w["self_attn.o_proj.weight"], mm)


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
           mm: Matmul) -> torch.Tensor:
    return lin(F.silu(lin(x, gate, mm)) * lin(x, up, mm), down, mm)


def moe(x: torch.Tensor, w: Weights, c: Dict, mm: Matmul) -> torch.Tensor:
    """``x [N, D]``: the real tokens of every batch."""
    f, k = c["moe_intermediate_size"], c["num_experts_per_tok"]
    s = torch.sigmoid(x @ w["mlp.gate.weight"].t())
    choice = torch.topk(s + w["mlp.gate.e_score_correction_bias"], k, -1).indices
    g = s.gather(-1, choice)
    g = g / (g.sum(-1, keepdim=True) + 1e-20) * c["routed_scaling_factor"]
    out = swiglu(x, w["mlp.shared_experts.gate_proj.weight"],
                 w["mlp.shared_experts.up_proj.weight"],
                 w["mlp.shared_experts.down_proj.weight"], mm)
    for e in range(c["n_routed_experts"]):
        tok, slot = (choice == e).nonzero(as_tuple=True)
        if not len(tok):
            continue
        wgu, wd = w["mlp.w_gate_up"][e], w["mlp.w_down"][e]
        y = swiglu(x[tok], wgu[:f], wgu[f:], wd, mm)
        out.index_add_(0, tok, y * g[tok, slot, None])
    return out


def _batches(lengths: Sequence[int]) -> List[List[int]]:
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    out: List[List[int]] = []
    for i in order:
        t = lengths[i]
        if out and (len(out[-1]) + 1) * t <= TOKENS_PER_BATCH \
                and (len(out[-1]) + 1) * t * t <= SCORES_PER_BATCH:
            out[-1].append(i)
        else:
            out.append([i])
    return out


@torch.no_grad()
def token_nll(seqs: Sequence[Sequence[int]], weights: Callable[[str], Weights], c: Dict,
              device: torch.device, mm: Matmul = exact) -> List[np.ndarray]:
    """The NLL (float64) of tokens ``1..T-1`` of each sequence."""
    lengths = [len(s) for s in seqs]
    batches = _batches(lengths)
    ids, real, xs = [], [], []
    emb = weights("embed_tokens.")["weight"]
    for rows in batches:
        t = max(lengths[i] for i in rows)
        b = torch.zeros(len(rows), t, dtype=torch.long)
        m = torch.zeros(len(rows), t, dtype=torch.bool)
        for r, i in enumerate(rows):
            b[r, :lengths[i]] = torch.as_tensor(list(seqs[i]))
            m[r, :lengths[i]] = True
        ids.append(b.to(device))
        real.append(m.to(device))
        xs.append(emb[ids[-1]])
    del emb
    eps = c["rms_norm_eps"]
    for layer in range(c["num_hidden_layers"]):
        w = weights(f"layers.{layer}.")
        for j, x in enumerate(xs):
            xs[j] = x + attention(rms(x, w["input_layernorm.weight"], eps), w, c, mm)
        hs = [rms(x, w["post_attention_layernorm.weight"], eps) for x in xs]
        if layer >= c["first_k_dense_replace"]:
            flat = torch.cat([h[m] for h, m in zip(hs, real)])
            y = moe(flat, w, c, mm)
            at = 0
            for j, m in enumerate(real):
                n = int(m.sum())
                xs[j] = xs[j].index_put((m,), xs[j][m] + y[at:at + n])
                at += n
        else:
            for j, h in enumerate(hs):
                xs[j] = xs[j] + swiglu(h, w["mlp.gate_proj.weight"], w["mlp.up_proj.weight"],
                                       w["mlp.down_proj.weight"], mm)
        del w, hs
    w = weights("norm.")["weight"]
    head = weights("lm_head.")["weight"]
    out: List[np.ndarray] = [np.zeros(0)] * len(seqs)
    for rows, x, b in zip(batches, xs, ids):
        x = rms(x, w, eps)
        for r, i in enumerate(rows):
            n = lengths[i]
            nll = []
            for a in range(0, n - 1, HEAD_ROWS):
                z = min(a + HEAD_ROWS, n - 1)
                logp = torch.log_softmax(mm(x[r, a:z], head.t()).double(), -1)
                nll.append(-logp.gather(-1, b[r, a + 1:z + 1, None]).squeeze(-1))
            out[i] = torch.cat(nll).cpu().numpy() if nll else np.zeros(0)
    return out


def surprisal_stats(texts: Sequence[str], weights: Callable[[str], Weights], c: Dict, ctx: int,
                    device: torch.device, mm: Matmul = exact) -> np.ndarray:
    """``[N, 2]`` (mean, q90) of each document's token surprisal (nats),
    over the windows ``reference.corpus.windows`` cuts."""
    seqs, owner = [], []
    for d, text in enumerate(texts):
        for win, drop in windows(token_ids(text), ctx):
            seqs.append(win)
            owner.append((d, drop))
    nll = token_nll(seqs, weights, c, device, mm)
    streams: Dict[int, List[np.ndarray]] = {}
    for (d, drop), s in zip(owner, nll):
        streams.setdefault(d, []).append(s[drop:])
    out = np.zeros((len(texts), 2), np.float64)
    for d in range(len(texts)):
        s = np.concatenate(streams[d])
        out[d] = s.mean(), np.quantile(s, 0.9)
    return out


__all__ = ["token_nll", "surprisal_stats", "rope", "moe"]
