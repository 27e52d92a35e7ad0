"""Moonlight-16B-A3B: a DeepSeek-V3 decoder as a text-entropy backbone.

Written from the published description (``moonshotai/Moonlight-16B-A3B``'s
``config.json``, ``model_type: deepseek_v3``): 27 pre-norm blocks, the
first with a dense SwiGLU feed-forward and the rest with a mixture of
experts, and an untied vocabulary head.  The JAX package has no such model;
the port scores text with it through ``TextEntropyEstimator`` like GPT-2.

* **Block:** ``h = x + MLA(rmsnorm(x))``, ``x' = h + FFN(rmsnorm(h))``; the
  residual stream is float32, RMSNorm runs in float32.
* **Multi-head latent attention** (``q_lora_rank`` null): ``q = W_q x`` gives
  each head 128 dims without position and 64 rotated; ``[c_kv, k_pe] =
  W_kva x``, a 512-wide latent and one 64-dim rotated key that every head
  shares; ``[k_nope, v] = W_kvb rmsnorm(c_kv)`` per head.  RoPE pairs
  DeepSeek-V3's way: the 64 dims are de-interleaved, then rotated by halves.
  Causal softmax over ``q.k / sqrt(192)`` within each sequence.
* **Flat sequences:** the forward takes one stream of ``N`` tokens, the
  sequences' boundaries ``cu_seqlens`` and the longest's length; each
  sequence restarts its positions at 0 and attends to itself alone
  (``varlen_attn``, flash attention over the sequences, on a card; causal
  SDPA one sequence at a time on the CPU), so a forward carries no
  padding.  Flash attention takes equal q/k/v widths, so ``v`` is padded
  from 128 to 192 with zeros and the padding cut from the output.  The
  right-padded ``[B, T]`` entry point makes each row one sequence: its
  padding trails its real tokens, which the causal mask hides it from.
* **Mixture of experts:** ``s = sigmoid(W_g x)`` in float32, on the
  norm's float32 output (not its bfloat16 rounding, whose error alone
  would send a token near a routing tie to another expert); the top
  ``k`` of ``s + e_score_correction_bias`` are chosen (one group, so the
  group selection of ``noaux_tc`` is a no-op); the gates are the chosen
  ``s`` normalised to sum 1, times ``routed_scaling_factor``.  The output is
  the shared experts' SwiGLU plus the gated sum of the chosen experts'.
  No token is dropped, and padding tokens are not dispatched: their rows
  sort after the last expert's, past the grouped GEMMs' last offset.  The
  experts run as two grouped GEMMs (``torch._grouped_mm``) over the
  (token, expert) rows sorted by expert; the gate multiplies the activation
  before the down projection.  Nothing in the forward waits for the device.
* **Head:** the final RMSNorm, then ``lm_head`` over the vocabulary in
  chunks of ``logit_chunk`` token rows, each reduced to the next-token NLL
  at once: full-vocabulary float32 logits are never held.  On a flat
  stream it runs only over the tokens whose next token is in their own
  sequence.

Weights and matmuls are in ``cfg.dtype`` (bfloat16 as published); the
router, the norms and the NLL are float32.  ``init_moonlight`` builds the
model on its device without drawing on the CPU.

While a ``torch.profiler`` session records, the forward names
``dewi.lm.attention``, ``dewi.lm.moe.route``, ``dewi.lm.moe.experts`` and
``dewi.lm.head``, counts ``moe.layer_forwards`` and ``text.logit_chunks``,
and sums the routed rows and each layer's busiest expert's rows on the
device; ``flush_counts`` adds those to ``moe.routed_rows`` and
``moe.busiest_expert_rows`` where the caller copies its results anyway.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from ..utils.profiling import count, span, tracing


@dataclass(frozen=True)
class MoonlightConfig:
    """The published keys of Moonlight's ``config.json`` that shape the
    forward, and the port's own: ``max_len`` (the longest row scored, at
    most ``max_position_embeddings``), ``dtype`` (weights and matmuls) and
    ``logit_chunk`` (token rows a head chunk)."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    max_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    logit_chunk: int = 4096

    def __post_init__(self) -> None:
        if self.max_len > self.max_position_embeddings:
            raise ValueError(f"max_len {self.max_len} exceeds the model's "
                             f"{self.max_position_embeddings} positions")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


class RMSNorm(nn.Module):
    """``x / rms(x) * weight`` in float32; returns float32."""

    def __init__(self, d: int, eps: float, dtype: torch.dtype) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(d, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight.float()


def rope_tables(t: int, dim: int, theta: float, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """float32 ``(cos, sin)`` ``[t, dim]`` of positions ``0..t-1``, the
    frequencies repeated over the two halves."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=device, dtype=torch.float32) / dim)
    f = torch.outer(torch.arange(t, device=device, dtype=torch.float32), inv)
    emb = torch.cat([f, f], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's rotary embedding of ``x [..., T, H, dim]`` in float32,
    ``cos``, ``sin`` ``[T, dim]`` the angles of each token's position: the
    dims de-interleaved (``x0, x2, .., x1, x3, ..``), then
    ``x * cos + rotate_half(x) * sin``."""
    d = x.shape[-1]
    x = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def _linear(n_in: int, n_out: int, dtype: torch.dtype) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False, dtype=dtype)


def causal_varlen(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cu: torch.Tensor,
                  max_len: int, scale: float) -> torch.Tensor:
    """Causal attention of ``q, k, v [N, H, d]`` within each sequence
    ``cu [S+1]`` (int32) bounds, ``max_len`` the longest: on a card
    ``varlen_attn`` (flash attention over the sequences, no padding); on
    the CPU the plain version, causal SDPA one sequence at a time."""
    if q.device.type == "cpu":
        out = torch.empty_like(q)
        for a, b in zip(cu[:-1].tolist(), cu[1:].tolist()):
            out[a:b] = F.scaled_dot_product_attention(
                q[a:b].transpose(0, 1), k[a:b].transpose(0, 1), v[a:b].transpose(0, 1),
                is_causal=True, scale=scale).transpose(0, 1)
        return out
    from torch.nn.attention.varlen import varlen_attn

    return varlen_attn(q, k, v, cu, cu, max_len, max_len, scale=scale, window_size=(-1, 0))


def positions(cu: torch.Tensor, n: int) -> torch.Tensor:
    """``[n]`` int64: each token's position within its own sequence."""
    i = torch.arange(n, device=cu.device, dtype=cu.dtype)
    seq = torch.searchsorted(cu[1:], i, right=True)
    return i.long() - cu.long()[seq]


def scored_positions(cu: torch.Tensor, n: int) -> torch.Tensor:
    """``[n - S]`` int64: the tokens whose next token is in their own
    sequence, in order (each sequence of ``L >= 1`` tokens gives ``L - 1``)."""
    s = cu.numel() - 1
    j = torch.arange(n - s, device=cu.device, dtype=torch.int64)
    ends = cu[1:].long() - torch.arange(1, s + 1, device=cu.device)
    return j + torch.searchsorted(ends, j, right=True)


class MLA(nn.Module):
    def __init__(self, c: MoonlightConfig) -> None:
        super().__init__()
        self.c = c
        h = c.num_attention_heads
        self.q_proj = _linear(c.hidden_size, h * c.qk_head_dim, c.dtype)
        self.kv_a_proj_with_mqa = _linear(c.hidden_size, c.kv_lora_rank + c.qk_rope_head_dim,
                                          c.dtype)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps, c.dtype)
        self.kv_b_proj = _linear(c.kv_lora_rank, h * (c.qk_nope_head_dim + c.v_head_dim),
                                 c.dtype)
        self.o_proj = _linear(h * c.v_head_dim, c.hidden_size, c.dtype)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                cu: torch.Tensor, max_len: int) -> torch.Tensor:
        """``x [N, D]``, the tokens of the sequences ``cu`` bounds, each
        attending causally to its own sequence alone."""
        c, dt = self.c, self.c.dtype
        n = x.shape[0]
        h, nope, rope, dv = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, \
            c.v_head_dim
        q_nope, q_pe = self.q_proj(x).view(n, h, nope + rope).split([nope, rope], -1)
        latent, k_pe = self.kv_a_proj_with_mqa(x).split([c.kv_lora_rank, rope], -1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent).to(dt)).view(n, h, nope + dv)
        k_nope, v = kv.split([nope, dv], -1)
        q = torch.cat([q_nope, apply_rope(q_pe, cos, sin).to(dt)], -1)
        k_pe = apply_rope(k_pe[:, None], cos, sin).to(dt).expand(n, h, rope)
        k = torch.cat([k_nope, k_pe], -1)
        v = F.pad(v, (0, nope + rope - dv))
        o = causal_varlen(q, k, v, cu, max_len, c.qk_head_dim ** -0.5)
        return self.o_proj(o[..., :dv].reshape(n, h * dv))


class SwiGLU(nn.Module):
    def __init__(self, d: int, width: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.gate_proj = _linear(d, width, dtype)
        self.up_proj = _linear(d, width, dtype)
        self.down_proj = _linear(width, d, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Router(nn.Module):
    def __init__(self, c: MoonlightConfig) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c.n_routed_experts, c.hidden_size, dtype=c.dtype))
        self.e_score_correction_bias = nn.Parameter(torch.empty(c.n_routed_experts,
                                                                dtype=c.dtype))


def route(x: torch.Tensor, router: Router, k: int, scale: float) -> Tuple[torch.Tensor, ...]:
    """``(choice [N, k], gates [N, k])``: the experts chosen on
    ``sigmoid(W_g x) + bias`` and their unbiased scores, normalised and
    scaled (float32)."""
    s = torch.sigmoid(F.linear(x.float(), router.weight.float()))
    choice = torch.topk(s + router.e_score_correction_bias.float(), k, dim=-1).indices
    g = s.gather(-1, choice)
    return choice, g / (g.sum(-1, keepdim=True) + 1e-20) * scale


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``x [R, K]`` rows sorted by group times ``w [G, N, K]`` transposed:
    rows ``offs[g-1]:offs[g]`` take group ``g``; rows past ``offs[-1]`` are
    not computed (their output is undefined)."""
    return torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)


def grouped_mm_loop(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``grouped_mm`` as a loop of one matmul a group (reads the offsets on
    the host): the plain version the grouped GEMM is held to."""
    out = torch.zeros(x.shape[0], w.shape[1], dtype=x.dtype, device=x.device)
    lo = 0
    for g, hi in enumerate(offs.tolist()):
        out[lo:hi] = x[lo:hi] @ w[g].t()
        lo = hi
    return out


class MoE(nn.Module):
    def __init__(self, c: MoonlightConfig) -> None:
        super().__init__()
        self.c = c
        e, d, f = c.n_routed_experts, c.hidden_size, c.moe_intermediate_size
        self.gate = Router(c)
        # Expert weights stacked as [E, out, in]: gate and up projections in
        # one [E, 2F, D] so that one grouped GEMM computes both.
        self.w_gate_up = nn.Parameter(torch.empty(e, 2 * f, d, dtype=c.dtype))
        self.w_down = nn.Parameter(torch.empty(e, d, f, dtype=c.dtype))
        self.shared_experts = SwiGLU(d, f * c.n_shared_experts, c.dtype)
        self.counts: Optional[torch.Tensor] = None  # [routed rows, busiest rows] while tracing

    def forward(self, h: torch.Tensor, routed: torch.Tensor) -> torch.Tensor:
        """``h [N, D]``, the float32 norm output; ``routed [N]`` bool, False
        for padding tokens.  The router reads ``h`` itself; the experts
        read it in ``cfg.dtype``."""
        c = self.c
        n, d = h.shape
        e, k, f = c.n_routed_experts, c.num_experts_per_tok, c.moe_intermediate_size
        with span("dewi.lm.moe.route"):
            choice, gates = route(h, self.gate, k, c.routed_scaling_factor)
            x = h.to(c.dtype)
            # Padding tokens take the sentinel expert e: sorted last, never computed.
            expert = torch.where(routed[:, None], choice, e).flatten()
            order = torch.argsort(expert, stable=True)
            rows = torch.zeros(e + 1, dtype=torch.int64, device=x.device).scatter_add_(
                0, expert, torch.ones_like(expert))[:e]
            offs = torch.cumsum(rows, 0).to(torch.int32)
            if tracing():
                count("moe.layer_forwards")
                got = torch.stack([rows.sum(), rows.max()])
                self.counts = got if self.counts is None else self.counts + got
        with span("dewi.lm.moe.experts"):
            xs = x[order // k]
            gu = grouped_mm(xs, self.w_gate_up, offs)
            act = F.silu(gu[:, :f].float()) * gu[:, f:].float() * gates.flatten()[order, None]
            y = grouped_mm(act.to(c.dtype), self.w_down, offs)
            back = torch.empty_like(order).scatter_(
                0, order, torch.arange(order.numel(), device=x.device))
            y = y[back].view(n, k, d).sum(1).masked_fill(~routed[:, None], 0.0)
        return self.shared_experts(x) + y


class Block(nn.Module):
    def __init__(self, c: MoonlightConfig, moe: bool) -> None:
        super().__init__()
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype)
        self.self_attn = MLA(c)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype)
        self.mlp = MoE(c) if moe else SwiGLU(c.hidden_size, c.intermediate_size, c.dtype)
        self.dt = c.dtype

    def forward(self, x: torch.Tensor, routed: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, cu: torch.Tensor, max_len: int) -> torch.Tensor:
        with span("dewi.lm.attention"):
            x = x + self.self_attn(self.input_layernorm(x).to(self.dt), cos, sin, cu,
                                   max_len).float()
        h = self.post_attention_layernorm(x)
        if isinstance(self.mlp, MoE):
            return x + self.mlp(h, routed).float()
        return x + self.mlp(h.to(self.dt)).float()


class MoonlightLM(nn.Module):
    """The decoder: ``packed_nll(ids, cu, max_len)`` scores a flat stream
    of sequences, ``token_nll(ids, mask)`` right-padded rows."""

    returns_nll = True
    packs_sequences = True

    def __init__(self, cfg: MoonlightConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype)
        self.layers = nn.ModuleList(Block(cfg, i >= cfg.first_k_dense_replace)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)
        self.lm_head = _linear(cfg.hidden_size, cfg.vocab_size, cfg.dtype)

    def hidden(self, ids: torch.Tensor, cu: torch.Tensor, max_len: int,
               routed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The final norm's output ``[N, D]`` (float32) of the flat token
        stream ``ids [N]``: sequences bounded by ``cu [S+1]`` (int32, on
        ``ids``' device), the longest ``max_len`` tokens, each attending to
        itself alone with positions from 0.  ``routed [N]`` (bool) is False
        for tokens the experts skip (padding); by default every token is
        routed."""
        c, n = self.cfg, ids.shape[0]
        cos, sin = rope_tables(max_len, c.qk_rope_head_dim, c.rope_theta, ids.device)
        pos = positions(cu, n)
        cos, sin = cos[pos], sin[pos]
        if routed is None:
            routed = torch.ones(n, dtype=torch.bool, device=ids.device)
        x = self.embed_tokens(ids).float()
        for layer in self.layers:
            x = layer(x, routed, cos, sin, cu, max_len)
        return self.norm(x)

    def _head_nll(self, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """float32 NLL of ``target [M]`` under the head over ``x [M, D]``,
        ``logit_chunk`` rows at a time."""
        nll = torch.empty(target.numel(), dtype=torch.float32, device=x.device)
        step = self.cfg.logit_chunk
        with span("dewi.lm.head"):
            for a in range(0, nll.numel(), step):
                count("text.logit_chunks")
                logits = self.lm_head(x[a:a + step]).float()
                picked = logits.gather(-1, target[a:a + step, None]).squeeze(-1)
                nll[a:a + step] = torch.logsumexp(logits, -1) - picked
        return nll

    @torch.no_grad()
    def packed_nll(self, ids: torch.Tensor, cu: torch.Tensor, max_len: int) -> torch.Tensor:
        """``[N - S]`` float32: the NLL of each token after the first of
        each sequence of the flat stream ``ids [N]`` (as ``hidden``), in
        order; sequence ``s`` holds ``cu[s] - s .. cu[s+1] - s - 1``."""
        keep = scored_positions(cu, ids.shape[0])
        x = self.hidden(ids, cu, max_len)[keep].to(self.cfg.dtype)
        return self._head_nll(x, ids[keep + 1].long())

    @torch.no_grad()
    def token_nll(self, ids: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``(nll [B, T-1], valid [B, T-1])`` of right-padded ``ids [B, T]``
        as ``lm.token_nll`` returns them: position ``i`` is the NLL of token
        ``i+1``.  Each row is one sequence of the flat forward, its padding
        behind the real tokens (hidden by the causal mask) and not routed."""
        b, t = ids.shape
        cu = torch.arange(0, (b + 1) * t, t, dtype=torch.int32, device=ids.device)
        x = self.hidden(ids.reshape(-1), cu, t, mask.reshape(-1).bool()).view(b, t, -1)
        nll = self._head_nll(x[:, :-1].to(self.cfg.dtype).reshape(b * (t - 1), -1),
                             ids[:, 1:].reshape(-1).long())
        return nll.view(b, t - 1), mask[:, 1:].bool()

    def flush_counts(self) -> None:
        """Add the device-summed routing counts to ``moe.routed_rows`` and
        ``moe.busiest_expert_rows``, and clear them (one copy)."""
        held = [m for m in self.modules() if isinstance(m, MoE) and m.counts is not None]
        if not held:
            return
        routed, busiest = torch.stack([m.counts for m in held]).sum(0).tolist()
        for m in held:
            m.counts = None
        count("moe.routed_rows", routed)
        count("moe.busiest_expert_rows", busiest)


@torch.no_grad()
def init_moonlight(cfg: MoonlightConfig, seed: int = 0, device: DeviceLike = None) -> MoonlightLM:
    """The model on ``device`` in ``cfg.dtype``, built without a draw on the
    CPU: the modules are made on the meta device, then their parameters
    allocated on ``device`` and drawn there from ``seed``: linear and
    embedding rows normal with sd ``1/sqrt(fan_in)`` (the embedding's
    width), norm scales 1, the routing bias 0."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = MoonlightLM(cfg)
    model = model.to_empty(device=dev)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    for name, p in model.named_parameters():
        if name.endswith("norm.weight"):
            p.fill_(1.0)
        elif name.endswith("e_score_correction_bias"):
            p.zero_()
        else:
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[-1]), generator=g)
    return model.eval()


MOONLIGHT_PRESETS = {
    "moonlight-16b-a3b": {},
    # CPU tests: every mechanism at a few dozen dims, float32.
    "moonlight-tiny": dict(vocab_size=320, hidden_size=64, intermediate_size=128,
                           moe_intermediate_size=32, num_hidden_layers=3,
                           num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
                           qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
                           num_experts_per_tok=3, max_position_embeddings=256, max_len=256,
                           dtype=torch.float32, logit_chunk=96),
}


def moonlight_config(name: str = "moonlight-16b-a3b", **over) -> MoonlightConfig:
    if name not in MOONLIGHT_PRESETS:
        raise ValueError(f"Unknown Moonlight preset {name!r}; choose from "
                         f"{sorted(MOONLIGHT_PRESETS)}")
    return dataclasses.replace(MoonlightConfig(), **dict(MOONLIGHT_PRESETS[name], **over))


__all__ = ["MoonlightConfig", "MoonlightLM", "MOONLIGHT_PRESETS", "moonlight_config",
           "init_moonlight", "route", "rope_tables", "apply_rope", "grouped_mm",
           "grouped_mm_loop", "causal_varlen", "positions", "scored_positions"]
