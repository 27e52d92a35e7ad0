"""Tensor parallelism (``dewi_tpu_torch.parallel.tp``) against
``dewi_tpu.parallel.tp``.

The port runs on four gloo ranks started once by ``parallel.launch_local``
(a module-scoped fixture; the rank function lives at module level and this
module imports JAX only inside test bodies).  The reference runs as
``tests/test_tp.py`` calls it, on a 2 x 4 mesh of the conftest's virtual
CPU devices; the port's 1 x 4 mesh splits the model axis the same 4 ways.
Weights are the port's seeded init, carried to the reference by
``convert.lm_params_to_flax``; inputs come from numpy with a seed.

The port splits whole heads (Megatron), the reference each head's
features; the outputs agree.  Tolerances:

* float32 logits: ``rtol 2e-4, atol 2e-4`` against the reference's TP
  forward and the replicated model;
* bfloat16 (the preset's dtype): the mean NLL within 5e-3 relative, the
  reference's own bound;
* one ``train_lm`` step of the TP model against the unsharded step: the
  parameters within 1e-5 of the largest magnitude, except where the
  step-1 gradient is rounding noise (within 2 lr there; see
  ``test_torch_training.py``: at most 2 lr); the clipped gradients' global norm within
  1e-6 of 1 and each gradient within 1e-5 of it (the unsharded clip's).
"""

import tempfile

import numpy as np
import pytest
import torch

from dewi_tpu_torch.models import registry as treg
from dewi_tpu_torch.models.lm import token_nll
from dewi_tpu_torch.parallel import launch_local, make_mesh
from dewi_tpu_torch.parallel.mesh import all_gather, shard_group
from dewi_tpu_torch.parallel.tp import (TensorParallelAttention, TensorParallelMLP, param_specs,
                                        shard_params)
from dewi_tpu_torch.training import loops as tl
from dewi_tpu_torch.training import train_lm
from torch_model_axis import CORPUS, RANKS, STEP_KW, full_params, grads_of, step_deviation

LAUNCH_TIMEOUT = 180.0
LOGIT_TOL = 2e-4
BF16_NLL_RTOL = 5e-3
PARAM_RTOL = 1e-5
GRAD_TOL = 1e-5          # of the global gradient norm (1 after the clip)
CLIP_NORM_TOL = 1e-6


def _inputs():
    ids = np.random.default_rng(0).integers(0, 258, (4, 32)).astype(np.int64)
    return ids, np.ones_like(ids, np.float32)


def _small(dtype):
    return treg.init_lm(treg.lm_config("small", dtype=dtype), seed=0, device="cpu")


def _tp_worker():
    mesh = make_mesh(1, RANKS, device="cpu")
    ids, pad = (torch.from_numpy(a) for a in _inputs())
    out = {}
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            out[f"logits_{dtype}"] = shard_params(_small(dtype), mesh)(ids, pad).numpy()
        tiny = treg.init_lm(treg.lm_config("tiny", dtype="float32"), seed=0, device="cpu")
        fb = shard_params(tiny, mesh)
        out["fallback_types"] = (type(fb.encoder.block_0.attn).__name__,
                                 type(fb.encoder.block_0.mlp).__name__)
        out["fallback_logits"] = fb(ids[:2, :8], pad[:2, :8]).numpy()
    small = _small("float32")
    tp = shard_params(small, mesh)
    out["local_shapes"] = {n: tuple(p.shape) for n, p in tp.named_parameters()}
    out["sharded"] = sorted(n for n, p in tp.named_parameters() if shard_group(p) is not None)
    # The clip on the sharded gradients against the unsharded ones (the
    # unsharded model runs on the first rank alone: only its value returns).
    for m in (small, tp) if mesh.rank == 0 else (tp,):
        m.zero_grad()
        tl._masked_ce(m(ids, pad), ids, pad).mul(1e3).backward()
        params = list(m.parameters())
        tl._clip_by_global_norm([p.grad for p in params], [shard_group(p) for p in params])
    got = {}
    for n, p in tp.named_parameters():
        g = p.grad
        if shard_group(p) is not None:
            dim = next(i for i, (a, b) in enumerate(zip(g.shape, small.get_parameter(n).shape))
                       if a != b)
            g = all_gather(g.contiguous(), shard_group(p), dim=dim)
        got[n] = g.numpy()
    if mesh.rank == 0:
        out["clipped"] = (got, {n: p.grad.numpy() for n, p in small.named_parameters()})
    # One train_lm step, sharded against unsharded.
    # the tiny LM: 2 heads do not split 4 ways, its MLP does
    plain = treg.init_lm(treg.lm_config("tiny", max_len=64, dtype="float32"), seed=3,
                         device="cpu")
    small_plain = treg.init_lm(treg.lm_config("small", max_len=64, dtype="float32"), seed=3,
                               device="cpu")
    batch = next(tl.lm_batches(CORPUS, tl.get_tokenizer("byte"), STEP_KW["seq_len"],
                               STEP_KW["batch_size"], 1, 0))
    for name, model in (("tiny", plain), ("small", small_plain)):
        sharded = shard_params(model, mesh)
        train_lm(sharded, CORPUS, **STEP_KW)
        full = full_params(sharded, model)
        if mesh.rank == 0:
            out[f"grads_{name}"] = grads_of(model, lambda: tl._masked_ce(model(*batch), *batch))
            train_lm(model, CORPUS, **STEP_KW)
            out[f"step_{name}"] = (full, {n: p.detach().numpy().copy()
                                          for n, p in model.named_parameters()})
    try:
        train_lm(sharded, CORPUS, steps=1, checkpoint=tempfile.mktemp(suffix=".msgpack"))
    except ValueError as e:
        out["refused"] = str(e)
    return out


@pytest.fixture(scope="module")
def port():
    return launch_local(_tp_worker, RANKS, timeout=LAUNCH_TIMEOUT, threads=1)


def _ref_tp_logits(dtype):
    import jax
    import jax.numpy as jnp

    from dewi_tpu.models import registry as jreg
    from dewi_tpu.parallel import make_mesh as j_make_mesh
    from dewi_tpu.parallel.tp import shard_params as j_shard_params
    from dewi_tpu_torch import convert

    model = _small(dtype)
    jm = jreg.CausalLM(jreg.TransformerConfig(**model.cfg.__dict__))
    mesh = j_make_mesh(n_data=2, n_model=4)
    params = j_shard_params(jax.tree.map(jnp.asarray, convert.lm_params_to_flax(model)), mesh)
    ids, pad = (jnp.asarray(a) for a in _inputs())
    with jax.set_mesh(mesh):
        return np.asarray(jax.jit(jm.apply)(params, ids.astype(jnp.int32), pad))


def _mean_nll(logits):
    ids, pad = (torch.from_numpy(a) for a in _inputs())
    nll, valid = token_nll(torch.tensor(np.asarray(logits)), ids, pad)
    return float(nll[valid].mean())


# ---- the layout -------------------------------------------------------------------


def test_param_specs_follow_megatron():
    specs = param_specs(_small("float32"))
    for name, spec in specs.items():
        if name.endswith(("query.weight", "key.weight", "value.weight", "fc_in.weight",
                          "query.bias", "key.bias", "value.bias", "fc_in.bias")):
            assert spec[0] == "model" and all(s is None for s in spec[1:]), name
        elif name.endswith(("out.weight", "fc_out.weight")):
            assert spec == (None, "model"), name
        else:  # embeddings, LayerNorms, the row-parallel biases
            assert spec == (), name
    assert sum(1 for s in specs.values() if s) == 4 * 10


def test_shard_params_holds_this_ranks_slices(port):
    shapes = port["local_shapes"]
    d, ff = 256, 1024
    assert shapes["encoder.block_0.attn.query.weight"] == (d // 4, d)
    assert shapes["encoder.block_0.attn.query.bias"] == (d // 4,)
    assert shapes["encoder.block_0.attn.out.weight"] == (d, d // 4)
    assert shapes["encoder.block_0.attn.out.bias"] == (d,)
    assert shapes["encoder.block_3.mlp.fc_in.weight"] == (ff // 4, d)
    assert shapes["encoder.block_3.mlp.fc_out.weight"] == (d, ff // 4)
    assert shapes["wte.weight"] == (258, d)
    assert len(port["sharded"]) == 4 * 10


# ---- the forward --------------------------------------------------------------------


def test_forward_matches_reference_tp_f32(port):
    got = port["logits_float32"]
    np.testing.assert_allclose(got, _ref_tp_logits("float32"), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    ids, pad = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        plain = _small("float32")(ids, pad).numpy()
    np.testing.assert_allclose(got, plain, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_forward_matches_reference_tp_bf16(port):
    got = _mean_nll(port["logits_bfloat16"])
    assert got == pytest.approx(_mean_nll(_ref_tp_logits("bfloat16")), rel=BF16_NLL_RTOL)
    ids, pad = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        assert got == pytest.approx(_mean_nll(_small("bfloat16")(ids, pad)), rel=BF16_NLL_RTOL)


def test_indivisible_dims_fall_back_to_replication(port):
    """``tiny`` has 2 heads: its attention stays replicated on 4 ranks, its
    MLP (d_ff 256) splits; the forward runs and equals the plain one."""
    assert port["fallback_types"] == ("Attention", "TensorParallelMLP")
    tiny = treg.init_lm(treg.lm_config("tiny", dtype="float32"), seed=0, device="cpu")
    ids, pad = (torch.from_numpy(a[:2, :8]) for a in _inputs())
    with torch.no_grad():
        want = tiny(ids, pad).numpy()
    assert port["fallback_logits"].shape == (2, 8, 258)
    np.testing.assert_allclose(port["fallback_logits"], want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_world_of_one_is_the_model():
    """Without a process group every layer is split one way: the forward
    is the plain one."""
    small = _small("float32")
    tp = shard_params(small, make_mesh(device="cpu"))
    assert isinstance(tp.encoder.block_0.attn, TensorParallelAttention)
    assert isinstance(tp.encoder.block_0.mlp, TensorParallelMLP)
    ids, pad = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        np.testing.assert_allclose(tp(ids, pad).numpy(), small(ids, pad).numpy(), rtol=1e-6,
                                   atol=1e-6)


# ---- training -----------------------------------------------------------------------


def test_clip_sums_the_shards(port):
    """The loss is scaled so that the clip acts: the gathered clipped
    gradients have the whole model's norm 1, and equal the unsharded ones
    within 1e-5 of it."""
    got, want = port["clipped"]
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in got.values()))
    assert norm == pytest.approx(1.0, abs=CLIP_NORM_TOL)
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= GRAD_TOL, k


@pytest.mark.parametrize("name", ["tiny", "small"])
def test_train_step_matches_unsharded(port, name):
    got, want = port[f"step_{name}"]
    real, led = step_deviation(got, want, port[f"grads_{name}"], STEP_KW["lr"])
    assert real <= PARAM_RTOL
    assert led <= 2.0


def test_sharded_checkpoint_is_refused(port):
    """A checkpoint of a rank's slices would not load as the model:
    ``train_lm(checkpoint=)`` refuses it before the first step."""
    assert "sharded over a mesh" in port["refused"]
