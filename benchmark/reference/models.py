"""Plain forward passes of the corpus deployment's backbones.

Written from the published architectures (GPT-2, the CLIP text tower) as
the deployment configures them, over a weight mapping whose names are the
parameter names the port's modules load (``wte.weight``,
``encoder.block_<i>.attn.query.weight``, ...).  Plain ``torch`` operations
in float32 with TF32 off: no kernel, cache or batching of the program.

Each matmul goes through a ``Matmul``: ``exact`` is float32; ``fp8``
rounds both operands to float8 e4m3 with a per-tensor scale first, the
precision below the bfloat16 that the deployment computes in, which the
benchmark's control uses to show that its comparison can fail.

Departures from the published models, as the deployment sets them: a
pre-LN block with separate query/key/value projections (GPT-2's fused
``c_attn`` split in three), the deployment's LayerNorm epsilon and
activation, and EOT pooling at the last valid token.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

FP8_MAX = 448.0  # largest finite float8 e4m3


def exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_fp8(a.float()), _fp8(b.float()))


MATMULS = {"exact": exact, "fp8": fp8}


def gelu(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu_new":  # tanh approximation
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    if kind == "gelu":
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(f"unknown activation {kind!r}")


def linear(x: torch.Tensor, w: Weights, name: str, mm: Matmul) -> torch.Tensor:
    y = mm(x, w[f"{name}.weight"].t())
    bias = w.get(f"{name}.bias")
    return y if bias is None else y + bias


def layer_norm(x: torch.Tensor, w: Weights, name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.weight"], w[f"{name}.bias"], eps)


def block(x: torch.Tensor, w: Weights, p: str, heads: int, eps: float, act: str,
          causal: bool, mm: Matmul) -> torch.Tensor:
    """``x + attn(ln(x))``, then ``x + mlp(ln(x))``; right padding needs no
    mask under a causal mask, as no valid position attends to a later one."""
    b, t, d = x.shape
    hd = d // heads
    h = layer_norm(x, w, f"{p}.ln_attn", eps)

    def split(name: str) -> torch.Tensor:
        return linear(h, w, f"{p}.attn.{name}", mm).view(b, t, heads, hd).transpose(1, 2)

    q, k, v = split("query"), split("key"), split("value")
    att = mm(q / math.sqrt(hd), k.transpose(-1, -2))
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        att = att.masked_fill(~keep, float("-inf"))
    o = mm(torch.softmax(att, dim=-1), v).transpose(1, 2).reshape(b, t, d)
    x = x + linear(o, w, f"{p}.attn.out", mm)
    h = layer_norm(x, w, f"{p}.ln_mlp", eps)
    return x + linear(gelu(linear(h, w, f"{p}.mlp.fc_in", mm), act), w, f"{p}.mlp.fc_out", mm)


def encoder(x: torch.Tensor, w: Weights, p: str, layers: int, heads: int, eps: float,
            act: str, causal: bool, mm: Matmul) -> torch.Tensor:
    for i in range(layers):
        x = block(x, w, f"{p}.block_{i}", heads, eps, act, causal, mm)
    return layer_norm(x, w, f"{p}.ln_final", eps)


def lm_token_nll(ids: torch.Tensor, w: Weights, cfg: Dict, mm: Matmul = exact) -> torch.Tensor:
    """GPT-2's next-token NLL ``[B, T-1]`` of ``ids [B, T]`` (right-padded
    rows give meaningless values past their length)."""
    t = ids.shape[1]
    x = w["wte.weight"][ids] + w["wpe.weight"][:t][None]
    x = encoder(x, w, "encoder", cfg["n_layer"], cfg["n_head"], cfg["layer_norm_epsilon"],
                cfg["activation_function"], True, mm)
    logits = mm(x, w["wte.weight"].t())  # tied head
    logp = torch.log_softmax(logits[:, :-1].double(), dim=-1)
    return -torch.gather(logp, -1, ids[:, 1:, None]).squeeze(-1)


def clip_text_embed(ids: torch.Tensor, lengths: torch.Tensor, w: Weights, cfg: Dict,
                    mm: Matmul = exact, prefix: str = "text_tower") -> torch.Tensor:
    """L2-normalized CLIP text embeddings of right-padded ``ids [B, T]``,
    pooled at each row's last valid token."""
    t = ids.shape[1]
    x = w[f"{prefix}.wte.weight"][ids] + w[f"{prefix}.wpe.weight"][:t][None]
    x = encoder(x, w, f"{prefix}.encoder", cfg["num_hidden_layers"],
                cfg["num_attention_heads"], cfg["layer_norm_eps"], cfg["hidden_act"], True, mm)
    pooled = x[torch.arange(x.shape[0], device=x.device), (lengths - 1).clamp_min(0)]
    e = mm(pooled, w[f"{prefix}.text_proj.weight"].t())
    return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True).clamp_min(1e-12)


def no_tf32() -> Optional[tuple]:
    """Turn TF32 off for the reference; returns the settings to restore."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return old


__all__ = ["MATMULS", "exact", "fp8", "lm_token_nll", "clip_text_embed", "no_tf32", "gelu"]
