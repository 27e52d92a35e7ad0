"""Training loops: causal LM, MoE LM, ViT-MAE, CLIP (InfoNCE).

Counterpart of ``dewi_tpu/training/loops.py``.  At random init the
backbones are structurally correct but content-blind; these loops pretrain
them on a user's corpus, and the checkpoint they write goes to an
estimator's ``checkpoint=``.  One step is forward, backward, clipping and
an AdamW update, with the reference's optimizer:

    optax.chain(clip_by_global_norm(1.0),
                adamw(cosine_decay_schedule(lr, max(steps, 1)), weight_decay=0.01))

* clipping is optax's: ``g / ||g||`` when ``||g|| >= 1`` (no epsilon, unlike
  ``clip_grad_norm_``), decided on the device so no step waits on the host;
* ``torch.optim.AdamW`` in one parameter group (adamw decays every leaf:
  biases, LayerNorm scales, embeddings, ``logit_scale``), betas 0.9/0.999,
  eps 1e-8 outside the square root, decay scaled by the scheduled lr;
* the cosine schedule through ``LambdaLR``: the first update uses count 0
  (the full lr), and the lr reaches 0 at ``steps``.

The model trains in place (the reference donates its params to the jitted
step) and is left in ``eval()`` mode.  The loss is read on the host only at
step 1 and every ``log_every`` steps.  Checkpoints are msgpack files
(``registry.save_params``), which the reference's ``load_params`` reads; a
path the port cannot write is refused before the first step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.lm import token_nll
from ..models.registry import refuse_orbax_write, refuse_sharded_write, save_params
from ..parallel.mesh import all_reduce, shard_group
from ..signals.tokenizer import get_tokenizer

MAX_GRAD_NORM = 1.0


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    losses: Optional[List[float]] = None


def _make_optimizer(params: Sequence[torch.Tensor], lr: float, steps: int,
                    weight_decay: float = 0.01
                    ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over every parameter and optax's ``cosine_decay_schedule(lr,
    max(steps, 1))`` as a ``LambdaLR`` factor."""
    params = list(params)
    decay_steps = max(int(steps), 1)
    fused = bool(params) and all(p.is_cuda for p in params)
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, fused=fused or None)

    def cosine(count: int) -> float:
        return 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))

    return opt, torch.optim.lr_scheduler.LambdaLR(opt, cosine)


def _clip_by_global_norm(grads: List[torch.Tensor], groups: Optional[List[Any]] = None) -> None:
    """optax's ``clip_by_global_norm(1.0)``, in place: ``g`` stays when the
    global norm is below 1, else becomes ``g / norm``.  ``groups[i]`` is the
    group that ``grads[i]``'s parameter is sharded over (tensor or expert
    parallelism, ``mesh.mark_sharded``), or ``None``: a sharded gradient is
    only this rank's part, so its squares are summed over the group and the
    replicated ones counted once, which is the norm of the whole model's
    gradient."""
    if not grads:
        return
    if groups is None or all(g is None for g in groups):
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    else:
        by_group: Dict[Any, List[torch.Tensor]] = {}
        for g, group in zip(grads, groups):
            by_group.setdefault(group, []).append(g)
        sq = torch.zeros((), device=grads[0].device)
        for group, gs in by_group.items():
            part = torch.stack(torch._foreach_norm(gs)).square().sum()
            sq = sq + (part if group is None else all_reduce(part, group))
        norm = sq.sqrt()
    torch._foreach_div_(grads, torch.where(norm >= MAX_GRAD_NORM, norm, torch.ones_like(norm)))


def _apply_update(optimizer: torch.optim.Optimizer, scheduler: Any) -> None:
    """Clip the parameters' gradients, step the optimizer and the schedule."""
    params = [p for group in optimizer.param_groups for p in group["params"]
              if p.grad is not None]
    _clip_by_global_norm([p.grad for p in params], [shard_group(p) for p in params])
    optimizer.step()
    scheduler.step()


def _run(loss_fn: Callable[..., torch.Tensor], model: nn.Module, batches: Iterable,
         lr: float, steps: int, log_every: int, progress: bool) -> TrainState:
    optimizer, scheduler = _make_optimizer(model.parameters(), lr, steps)
    losses: List[float] = []
    n = 0
    model.train()
    with torch.enable_grad():
        for batch in batches:
            loss = loss_fn(*batch)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            _apply_update(optimizer, scheduler)
            n += 1
            if n % log_every == 0 or n == 1:
                losses.append(float(loss.detach()))
                if progress:
                    print(f"step {n}: loss {losses[-1]:.4f}", flush=True)
    model.eval()
    return TrainState(model=model, optimizer=optimizer, step=n, losses=losses)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _to_device(a: Any, device: Any) -> torch.Tensor:
    """A host array or tensor on ``device``.  To the card through pinned
    memory without blocking: a copy from pageable memory would wait for the
    device to finish the previous step before the host could enqueue the
    next one."""
    t = torch.as_tensor(a)
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _finish(state: TrainState, checkpoint: Optional[str]) -> TrainState:
    if checkpoint:
        save_params(state.model, checkpoint)
    return state


# ---------------------------------------------------------------------------
# Causal LM
# ---------------------------------------------------------------------------


def lm_batches(
    texts: Sequence[str],
    tokenizer: Any,
    seq_len: int,
    batch_size: int,
    steps: int,
    seed: int = 0,
    device: Any = "cpu",
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Random-sampled padded ``[B, T]`` id/mask batches from a text corpus:
    the reference's picks (``np.random.default_rng(seed)``), as tensors on
    ``device``."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        picks = rng.integers(0, len(texts), size=batch_size)
        ids, mask = tokenizer.encode_batch([texts[i] for i in picks], seq_len, pad_to=seq_len)
        yield _to_device(ids, device), _to_device(mask, device)


def _masked_ce(logits: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    nll, valid = token_nll(logits, ids, mask)
    w = valid.to(torch.float32)
    return (nll * w).sum() / w.sum().clamp_min(1.0)


def _lm_loop(loss_fn: Callable[..., torch.Tensor], model: nn.Module,
             texts: Sequence[str], steps: int, batch_size: int, lr: float,
             tokenizer: Any, seq_len: Optional[int], checkpoint: Optional[str],
             log_every: int, progress: bool, seed: int) -> TrainState:
    """Shared LM-pretraining scaffold: tokenizer default, batch iterator,
    optimizer, run loop, checkpoint save.  ``loss_fn(ids, mask)``."""
    refuse_orbax_write(checkpoint)
    refuse_sharded_write(model, checkpoint)
    tokenizer = tokenizer or get_tokenizer("byte")
    seq_len = int(seq_len or min(model.cfg.max_len, 128))
    batches = lm_batches(texts, tokenizer, seq_len, batch_size, steps, seed, _device(model))
    return _finish(_run(loss_fn, model, batches, lr, steps, log_every, progress), checkpoint)


def train_lm(
    model: nn.Module,
    texts: Sequence[str],
    steps: int = 200,
    batch_size: int = 32,
    lr: float = 3e-4,
    tokenizer: Any = None,
    seq_len: Optional[int] = None,
    checkpoint: Optional[str] = None,
    log_every: int = 50,
    progress: bool = False,
    seed: int = 0,
) -> TrainState:
    """Next-token CE pretraining for :class:`dewi_tpu_torch.models.CausalLM`,
    in place on the model's device."""

    def loss_fn(ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return _masked_ce(model(ids, mask), ids, mask)

    return _lm_loop(loss_fn, model, texts, steps, batch_size, lr, tokenizer, seq_len,
                    checkpoint, log_every, progress, seed)


def train_moe_lm(
    model: nn.Module,
    texts: Sequence[str],
    steps: int = 200,
    batch_size: int = 32,
    lr: float = 3e-4,
    aux_weight: float = 0.01,
    tokenizer: Any = None,
    seq_len: Optional[int] = None,
    checkpoint: Optional[str] = None,
    log_every: int = 50,
    progress: bool = False,
    seed: int = 0,
) -> TrainState:
    """Pretrain :class:`dewi_tpu_torch.models.MoECausalLM`: next-token CE plus
    ``aux_weight`` times the Switch load-balance loss (over real tokens
    only: the model leaves padded positions out of routing)."""
    from ..models.moe import load_balance_loss

    def loss_fn(ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        logits = model(ids, mask)
        return _masked_ce(logits, ids, mask) + aux_weight * load_balance_loss(model)

    return _lm_loop(loss_fn, model, texts, steps, batch_size, lr, tokenizer, seq_len,
                    checkpoint, log_every, progress, seed)


# ---------------------------------------------------------------------------
# MAE
# ---------------------------------------------------------------------------


def _step_noise(seed: int, step: int, shape: Tuple[int, int], device: Any) -> torch.Tensor:
    """The masking noise of ``train_mae``'s step ``step``: uniform ``[B, P]``
    from a CPU generator seeded by ``(seed, step)``, so the CPU and the card
    draw the same masks.  The reference draws ``jax.random.uniform(
    fold_in(PRNGKey(seed), step), (B, P))``, another stream (ROADMAP.md
    section 3, "MAE masking noise")."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    g = torch.Generator().manual_seed(int(state) & ((1 << 63) - 1))
    return _to_device(torch.rand(shape, generator=g), device)


def train_mae(
    model: nn.Module,
    images: np.ndarray,
    steps: int = 200,
    batch_size: int = 16,
    lr: float = 1e-3,
    checkpoint: Optional[str] = None,
    log_every: int = 50,
    progress: bool = False,
    seed: int = 0,
) -> TrainState:
    """Masked-reconstruction pretraining for :class:`dewi_tpu_torch.models.ViTMAE`.

    ``images``: ``[N, H, W, 3]`` f32 in [0, 1], already at the model's
    ``image_size``.
    """
    refuse_orbax_write(checkpoint)
    rng = np.random.default_rng(seed)
    dev = _device(model)
    n_patches = model.cfg.num_patches

    def batches() -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        for s in range(steps):
            picks = rng.integers(0, len(images), size=batch_size)
            yield (_to_device(images[picks], dev),
                   _step_noise(seed, s, (batch_size, n_patches), dev))

    def loss_fn(imgs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return model(imgs, noise=noise).mean()

    return _finish(_run(loss_fn, model, batches(), lr, steps, log_every, progress), checkpoint)


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


def clip_loss(t: torch.Tensor, v: torch.Tensor, logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives: both softmax directions of
    ``exp(clamp(logit_scale, -5, log 100)) * t @ v.T``, averaged."""
    scale = torch.exp(torch.clamp(logit_scale, -5.0, math.log(100.0)))
    logits = scale * torch.matmul(t, v.T)                     # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def train_clip(
    model: nn.Module,
    texts: Sequence[str],
    images: np.ndarray,
    steps: int = 200,
    batch_size: int = 32,
    lr: float = 1e-3,
    tokenizer: Any = None,
    checkpoint: Optional[str] = None,
    log_every: int = 50,
    progress: bool = False,
    seed: int = 0,
) -> TrainState:
    """Symmetric-InfoNCE contrastive training for the CLIP dual encoder.

    ``texts[i]`` captions ``images[i]``; in-batch negatives, both softmax
    directions averaged (the standard CLIP objective).
    """
    if len(texts) != len(images):
        raise ValueError("texts and images must align")
    refuse_orbax_write(checkpoint)
    tokenizer = tokenizer or get_tokenizer("byte")
    text_len = model.cfg.text_len
    rng = np.random.default_rng(seed)
    dev = _device(model)

    def batches() -> Iterator[Tuple[torch.Tensor, ...]]:
        for _ in range(steps):
            picks = rng.integers(0, len(texts), size=batch_size)
            ids, mask = tokenizer.encode_batch([texts[i] for i in picks], text_len,
                                               pad_to=text_len)
            yield (_to_device(ids, dev), _to_device(mask, dev), _to_device(images[picks], dev))

    def loss_fn(ids: torch.Tensor, mask: torch.Tensor, imgs: torch.Tensor) -> torch.Tensor:
        return clip_loss(*model(ids, mask, imgs))

    return _finish(_run(loss_fn, model, batches(), lr, steps, log_every, progress), checkpoint)


__all__ = ["TrainState", "train_lm", "train_mae", "train_clip", "train_moe_lm",
           "lm_batches", "clip_loss"]
