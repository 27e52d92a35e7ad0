"""Moonlight-16B-A3B in the benchmark: seeded weights, and the operations
and bytes its forward needs.

Weights.  ``layout`` lists the port's parameter names and shapes
(``dewi_tpu_torch.models.moonlight``'s state dict) from the published
keys of the configuration file, each with the standard deviation it is
drawn with.  Each leaf is drawn on the device from a generator of its
own, seeded from the run's seed and the leaf's place in the layout, so any
part of the model can be drawn again alone: the program's parameters are
overwritten leaf by leaf after the pipeline is built (``load_into``), and
the reference draws one layer at a time (``layer_weights``).  Values: one
``randn`` a leaf in float32, times ``1/sqrt(fan_in)`` for a linear or
stacked expert kernel (its last axis), times ``1/sqrt(2 * layers)`` more
for the kernels that write the residual stream (``o_proj``, the dense and
shared ``down_proj``, the experts' ``w_down``: GPT-2's scaled
initialisation), ``EMBED_SD`` for the embedding, ``1 + 0.02 n`` for a norm
scale, ``0.02 n`` for the routing bias; then rounded to bfloat16, the type
the configuration states for the weights.

Why these scales: with every kernel at ``1/sqrt(fan_in)`` and a small
embedding, each layer's update is as large as the stream it is added to,
and a random 27-layer stack is chaotic: one routing flip, which bfloat16
rounding makes at ties, changes every later layer's input, and the
float32 reference then constrains nothing (the median token moved by 0.14
nats, as far as float8 moved it).  Here the stream carries its embedding
through the stack and each layer adds an update of a few percent of it, as
in a trained model, so a flip moves the NLL by thousandths of a nat and
the bfloat16 program lies several times closer to the reference than the
float8 control does.

Counts (FLOPs two per multiply-add; bytes each read and write once):

* ``token_flops``: a real token's forward without the routed experts and
  the attention scores (attention projections, the dense layer, the
  shared experts, the router, the head);
* ``routed_row_flops``: one (token, expert) row through an expert's
  SwiGLU, ``2 * 3 * hidden * moe_intermediate``;
* ``pair_flops``: one causal (query, key) pair in every layer and head,
  ``q.k`` over 192 dims and ``p.v`` over 128;
* ``expert_gemm_bytes``: the expert weights once a layer-forward, and a
  routed row's input, gate/up output, activation and output.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from .common import seed_state

Layout = List[Tuple[str, Tuple[int, ...], Any]]

EMBED_SD = 4.0
NORM_SCALE_SD = 0.02
BIAS_SD = 0.02


def layout(c: Dict[str, Any]) -> Layout:
    """``(name, shape, sd)``: ``sd`` the standard deviation of a normal
    draw, or ``"scale"`` for a norm scale."""
    d, h, v = c["hidden_size"], c["num_attention_heads"], c["vocab_size"]
    nope, rope, dv, r = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                         c["kv_lora_rank"])
    e, f, ff = c["n_routed_experts"], c["moe_intermediate_size"], c["intermediate_size"]
    fs = f * c["n_shared_experts"]
    res = 1.0 / math.sqrt(2 * c["num_hidden_layers"])

    def kernel(n_in: int, writes_stream: bool = False) -> float:
        return (res if writes_stream else 1.0) / math.sqrt(n_in)

    out: Layout = [("embed_tokens.weight", (v, d), EMBED_SD)]
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}"
        out += [(f"{p}.input_layernorm.weight", (d,), "scale"),
                (f"{p}.self_attn.q_proj.weight", (h * (nope + rope), d), kernel(d)),
                (f"{p}.self_attn.kv_a_proj_with_mqa.weight", (r + rope, d), kernel(d)),
                (f"{p}.self_attn.kv_a_layernorm.weight", (r,), "scale"),
                (f"{p}.self_attn.kv_b_proj.weight", (h * (nope + dv), r), kernel(r)),
                (f"{p}.self_attn.o_proj.weight", (d, h * dv), kernel(h * dv, True)),
                (f"{p}.post_attention_layernorm.weight", (d,), "scale")]
        if i < c["first_k_dense_replace"]:
            out += [(f"{p}.mlp.gate_proj.weight", (ff, d), kernel(d)),
                    (f"{p}.mlp.up_proj.weight", (ff, d), kernel(d)),
                    (f"{p}.mlp.down_proj.weight", (d, ff), kernel(ff, True))]
        else:
            out += [(f"{p}.mlp.gate.weight", (e, d), kernel(d)),
                    (f"{p}.mlp.gate.e_score_correction_bias", (e,), BIAS_SD),
                    (f"{p}.mlp.w_gate_up", (e, 2 * f, d), kernel(d)),
                    (f"{p}.mlp.w_down", (e, d, f), kernel(f, True)),
                    (f"{p}.mlp.shared_experts.gate_proj.weight", (fs, d), kernel(d)),
                    (f"{p}.mlp.shared_experts.up_proj.weight", (fs, d), kernel(d)),
                    (f"{p}.mlp.shared_experts.down_proj.weight", (d, fs), kernel(fs, True))]
    return out + [("norm.weight", (d,), "scale"), ("lm_head.weight", (v, d), kernel(d))]


def draw(seed: int, at: int, shape: Tuple[int, ...], sd: Any, device: Any) -> torch.Tensor:
    """Leaf number ``at`` of the layout, in bfloat16 on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed_state(seed, "moonlight", f"{at:05d}"))
    x = torch.randn(shape, generator=g, device=device)
    if sd == "scale":
        x.mul_(NORM_SCALE_SD).add_(1.0)
    else:
        x.mul_(sd)
    return x.to(torch.bfloat16)


@torch.no_grad()
def load_into(model: torch.nn.Module, c: Dict[str, Any], seed: int, device: Any) -> int:
    """Overwrite ``model``'s parameters with the seeded weights, leaf by
    leaf (a name or shape the layout lacks raises); returns the count."""
    params = dict(model.named_parameters())
    lay = layout(c)
    if set(params) != {name for name, _, _ in lay}:
        raise KeyError(f"the program's parameters differ from the layout: "
                       f"{sorted(set(params) ^ {name for name, _, _ in lay})[:6]}")
    for at, (name, shape, sd) in enumerate(lay):
        p = params[name]
        if tuple(p.shape) != shape:
            raise ValueError(f"{name}: the program holds {tuple(p.shape)}, the layout {shape}")
        p.copy_(draw(seed, at, shape, sd, device))
    return sum(math.prod(s) for _, s, _ in lay)


def layer_weights(c: Dict[str, Any], seed: int, device: Any) -> Callable[[str], Dict[str, torch.Tensor]]:
    """``weights(prefix)``: the leaves whose names start with ``prefix``,
    drawn again, in float32, keyed by the rest of their names."""
    lay = layout(c)

    def weights(prefix: str) -> Dict[str, torch.Tensor]:
        return {name[len(prefix):]: draw(seed, at, shape, sd, device).float()
                for at, (name, shape, sd) in enumerate(lay) if name.startswith(prefix)}

    return weights


def _linear_params(c: Dict[str, Any]) -> int:
    d, h = c["hidden_size"], c["num_attention_heads"]
    nope, rope, dv, r = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                         c["kv_lora_rank"])
    attn = d * h * (nope + rope) + d * (r + rope) + r * h * (nope + dv) + h * dv * d
    dense = 3 * d * c["intermediate_size"]
    moe = 3 * d * c["moe_intermediate_size"] * c["n_shared_experts"] + d * c["n_routed_experts"]
    n_dense = c["first_k_dense_replace"]
    n_moe = c["num_hidden_layers"] - n_dense
    return c["num_hidden_layers"] * attn + n_dense * dense + n_moe * moe + d * c["vocab_size"]


def token_flops(c: Dict[str, Any]) -> int:
    return 2 * _linear_params(c)


def routed_row_flops(c: Dict[str, Any]) -> int:
    return 2 * 3 * c["hidden_size"] * c["moe_intermediate_size"]


def pair_flops(c: Dict[str, Any]) -> int:
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    return 2 * c["num_attention_heads"] * (qk + c["v_head_dim"]) * c["num_hidden_layers"]


def forward_flops(tokens: int, pairs: int, routed_rows: int, c: Dict[str, Any]) -> int:
    return tokens * token_flops(c) + routed_rows * routed_row_flops(c) + pairs * pair_flops(c)


def expert_gemm_bytes(routed_rows: int, layer_forwards: int, c: Dict[str, Any]) -> int:
    d, f = c["hidden_size"], c["moe_intermediate_size"]
    weights = c["n_routed_experts"] * 3 * d * f * 2
    return layer_forwards * weights + routed_rows * (2 * d + 3 * f) * 2


__all__ = ["layout", "draw", "load_into", "layer_weights", "token_flops", "routed_row_flops",
           "pair_flops", "forward_flops", "expert_gemm_bytes"]
