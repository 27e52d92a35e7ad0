"""Plain float32 reference of Moonlight-16B-A3B's next-token NLL.

Written from the published description (``moonshotai/Moonlight-16B-A3B``'s
``config.json``, the DeepSeek-V3 block it names) over a state dict whose
names are the port's (``layers.<i>.self_attn.q_proj.weight``, ...; the
experts stacked as ``mlp.w_gate_up [E, 2F, D]``, gate rows first, and
``mlp.w_down [E, D, F]``).  Plain ``torch`` in float32 with TF32 off, one
unpadded sequence at a time: no batching, no cache, no kernel of the port,
and it imports nothing of ``dewi_tpu_torch``.

* RoPE pairs dims ``(2i, 2i+1)`` and rotates each pair by ``pos * theta^(-2i/d)``,
  the result ordered evens first: DeepSeek-V3's de-interleave and
  rotate-half written as pairs (angles in float32 as published).
* Attention: the causal softmax of ``q.k / sqrt(qk_head_dim)`` as a full
  ``[H, T, T]`` matrix.
* MoE: each token gathers the weights of its chosen experts and applies
  them itself (a per-token gather, no sort or grouping).
* Head: full float32 logits, a float64 log-softmax.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [T, H, d]``: each pair ``(x[2i], x[2i+1])`` rotated by position
    times its frequency; evens first, then odds."""
    t, d = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    ang = torch.arange(t, dtype=torch.float32)[:, None] * inv[None]
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.cat([even * cos - odd * sin, odd * cos + even * sin], -1)


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ gate.t()) * (x @ up.t())) @ down.t()


def attention(x: torch.Tensor, w: Weights, p: str, c: Dict) -> torch.Tensor:
    t = x.shape[0]
    h, nope, rp, dv = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                       c["v_head_dim"])
    q = (x @ w[f"{p}.q_proj.weight"].t()).view(t, h, nope + rp)
    kv_a = x @ w[f"{p}.kv_a_proj_with_mqa.weight"].t()
    latent, k_pe = kv_a[:, :c["kv_lora_rank"]], kv_a[:, c["kv_lora_rank"]:]
    latent = rms(latent, w[f"{p}.kv_a_layernorm.weight"], c["rms_norm_eps"])
    kv = (latent @ w[f"{p}.kv_b_proj.weight"].t()).view(t, h, nope + dv)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], c["rope_theta"])], -1)
    k_pe = rope(k_pe[:, None], c["rope_theta"]).expand(t, h, rp)
    k = torch.cat([kv[..., :nope], k_pe], -1)
    v = kv[..., nope:]
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(nope + rp)
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v).reshape(t, h * dv)
    return o @ w[f"{p}.o_proj.weight"].t()


def moe(x: torch.Tensor, w: Weights, p: str, c: Dict) -> torch.Tensor:
    f, k = c["moe_intermediate_size"], c["num_experts_per_tok"]
    s = torch.sigmoid(x @ w[f"{p}.gate.weight"].t())
    choice = torch.topk(s + w[f"{p}.gate.e_score_correction_bias"], k, -1).indices
    g = s.gather(-1, choice)
    g = g / (g.sum(-1, keepdim=True) + 1e-20) * c["routed_scaling_factor"]
    wgu = w[f"{p}.w_gate_up"][choice]  # [T, k, 2F, D]: each token's experts
    wd = w[f"{p}.w_down"][choice]      # [T, k, D, F]
    gu = torch.einsum("td,tkfd->tkf", x, wgu)
    y = torch.einsum("tkf,tkdf->tkd", F.silu(gu[..., :f]) * gu[..., f:], wd)
    shared = swiglu(x, w[f"{p}.shared_experts.gate_proj.weight"],
                    w[f"{p}.shared_experts.up_proj.weight"],
                    w[f"{p}.shared_experts.down_proj.weight"])
    return shared + (g[..., None] * y).sum(1)


def token_nll(ids: Sequence[int], w: Weights, c: Dict) -> torch.Tensor:
    """The NLL ``[T-1]`` (float64) of tokens ``1..T-1`` of one sequence."""
    ids_t = torch.as_tensor(list(ids), dtype=torch.long)
    x = w["embed_tokens.weight"][ids_t].float()
    eps = c["rms_norm_eps"]
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}"
        x = x + attention(rms(x, w[f"{p}.input_layernorm.weight"], eps), w,
                          f"{p}.self_attn", c)
        h = rms(x, w[f"{p}.post_attention_layernorm.weight"], eps)
        if i >= c["first_k_dense_replace"]:
            x = x + moe(h, w, f"{p}.mlp", c)
        else:
            x = x + swiglu(h, w[f"{p}.mlp.gate_proj.weight"], w[f"{p}.mlp.up_proj.weight"],
                           w[f"{p}.mlp.down_proj.weight"])
    x = rms(x, w["norm.weight"], eps)
    logp = torch.log_softmax((x[:-1] @ w["lm_head.weight"].t()).double(), -1)
    return -logp.gather(-1, ids_t[1:, None]).squeeze(-1)


def float_weights(state: Weights) -> Weights:
    return {k: v.detach().float().cpu() for k, v in state.items()}


__all__ = ["token_nll", "rope", "float_weights"]
