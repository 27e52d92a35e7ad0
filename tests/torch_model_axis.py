"""Rank-side helpers of the model-axis tests (tensor and expert parallelism).

No JAX here: ``parallel.launch_local`` ranks import the module that holds
their function, and the rank functions of ``test_torch_tp.py`` and
``test_torch_moe.py`` live in or come from modules that do not load it.
"""

import numpy as np
import torch

from dewi_tpu_torch.models import registry as treg
from dewi_tpu_torch.parallel import make_mesh
from dewi_tpu_torch.parallel.mesh import all_gather, shard_group
from dewi_tpu_torch.training import train_moe_lm

RANKS = 4
CORPUS = [
    "the cat sat on the mat",
    "the dog sat on the log",
    "the cat and the dog sat together",
    "a mat and a log in the sun",
] * 8
STEP_KW = dict(steps=1, batch_size=4, seq_len=32, lr=3e-3, log_every=1)
NOISE_LED = 1e-6         # |step-1 gradient| below this share of the global norm


def full_params(sharded, like):
    """``sharded``'s parameters with each rank's shards all-gathered along
    the dim where they differ from ``like``'s (the unsharded model)."""
    shapes = {n: p.shape for n, p in like.named_parameters()}
    out = {}
    for name, p in sharded.named_parameters():
        t = p.detach()
        group = shard_group(p)
        if group is not None:
            dim = next(i for i, (a, b) in enumerate(zip(t.shape, shapes[name])) if a != b)
            t = all_gather(t.contiguous(), group, dim=dim)
        out[name] = t.numpy().copy()
    return out


def grads_of(model, loss_fn):
    model.zero_grad()
    loss_fn().backward()
    out = {n: p.grad.detach().numpy().copy() for n, p in model.named_parameters()}
    model.zero_grad()
    return out


def step_deviation(got, want, grads, lr, steps=1):
    """``(largest deviation over elements with a real gradient, over the
    largest parameter magnitude; largest deviation where the step-1
    gradient is rounding noise, over lr)``.  Adam's ``m / (sqrt(v) + eps)``
    turns noise of either sign into an update of up to ``lr``, as
    ``test_torch_training.py`` explains.  Noise here includes an exact 0 on
    one side (the attention key bias, whose true gradient is 0, can come
    out 0 unsharded and as noise from the summed shards)."""
    gnorm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in grads.values())))
    pmax = max(float(np.abs(w).max()) for w in want.values())
    real = led = 0.0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        noise = np.abs(grads[k]) < NOISE_LED * gnorm
        if (~noise).any():
            real = max(real, float(d[~noise].max()) / pmax)
        if noise.any():
            led = max(led, float(d[noise].max()) / (lr * steps))
    return real, led


def ep_worker():
    """Expert parallelism on four ranks: 8 experts (2 a rank) against the
    replicated model, ``E % n != 0`` replicated, and one ``train_moe_lm``
    step sharded against unsharded."""
    from dewi_tpu_torch.models.moe import load_balance_loss, shard_expert_params

    mesh = make_mesh(1, RANKS, device="cpu")
    cfg = treg.lm_config("tiny", max_len=16, dtype="float32")
    model = treg.init_moe_lm(cfg, n_experts=8, seed=0, device="cpu")
    ids, pad = ep_inputs()
    ep = shard_expert_params(model, mesh)
    out = {"w_in_shape": tuple(ep.block_0.moe.w_in.shape),
           "offset": ep.block_0.moe.expert_offset}
    with torch.no_grad():
        out["logits"] = ep(torch.from_numpy(ids), torch.from_numpy(pad)).numpy()
        out["aux"] = float(load_balance_loss(ep))
        odd = shard_expert_params(treg.init_moe_lm(cfg, n_experts=6, seed=0, device="cpu"), mesh)
        out["odd_w_in_shape"] = tuple(odd.block_0.moe.w_in.shape)
        out["odd_logits"] = odd(torch.from_numpy(ids), torch.from_numpy(pad)).numpy()
    tcfg = treg.lm_config("tiny", max_len=32, dtype="float32")
    plain = treg.init_moe_lm(tcfg, n_experts=4, seed=3, device="cpu")
    sharded = shard_expert_params(plain, mesh)
    i, m = (torch.from_numpy(a) for a in moe_step_batch())

    def loss():
        from dewi_tpu_torch.training import loops as tl
        return tl._masked_ce(plain(i, m), i, m) + 0.01 * load_balance_loss(plain)

    train_moe_lm(sharded, CORPUS, **STEP_KW)
    out["step_sharded"] = full_params(sharded, plain)
    if mesh.rank == 0:  # the unsharded step: only the first rank's value returns
        out["grads"] = grads_of(plain, loss)
        train_moe_lm(plain, CORPUS, **STEP_KW)
        out["step_plain"] = {n: p.detach().numpy().copy() for n, p in plain.named_parameters()}
    return out


def ep_inputs():
    ids = np.random.default_rng(0).integers(0, 258, (4, 12)).astype(np.int64)
    return ids, np.ones_like(ids, np.float32)


def moe_step_batch():
    """The first batch ``train_moe_lm`` draws with ``STEP_KW``."""
    from dewi_tpu_torch.signals.tokenizer import get_tokenizer
    from dewi_tpu_torch.training.loops import lm_batches

    ids, mask = next(lm_batches(CORPUS, get_tokenizer("byte"), STEP_KW["seq_len"],
                                STEP_KW["batch_size"], 1, 0))
    return ids.numpy(), mask.numpy()
