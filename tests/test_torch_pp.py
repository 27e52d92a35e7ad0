"""Pipeline parallelism (``dewi_tpu_torch.parallel.pp``) against
``dewi_tpu.parallel.pp``.

The port runs on four gloo ranks started once by ``parallel.launch_local``
(a module-scoped fixture; the rank function lives at module level and this
module imports JAX only inside test bodies): a ``(2 data x 2 stage)`` mesh
and a stage-only mesh of 4.  The reference runs as ``tests/test_pp.py``
calls it, on ``(2 data x 4 stage)`` and 4-stage meshes of the conftest's
virtual CPU devices; the schedules differ, the values do not.  The model
is the reference test's (``tiny``, 4 layers, float32, max_len 16), the
port's seeded init carried across by ``convert.lm_params_to_flax``; ids
come from numpy with a seed.

Tolerances: logits ``rtol 2e-4, atol 2e-4`` against the reference's
pipelined logits and the plain forward; gradients ``rtol 5e-3, atol
1e-4`` against the reference's pipelined gradients (its own bound) and the
loss within 1e-5; the stacked leaves bit for bit; the first train step's
loss within 1e-5 of a plain step's and its parameters within 1e-5 of the
largest magnitude of a plain ``torch.optim.Adam`` step's, except where the
gradient is rounding noise (within 2 lr there; see ``torch_model_axis``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from dewi_tpu_torch.models import registry as treg
from dewi_tpu_torch.models.lm import token_nll
from dewi_tpu_torch.parallel import launch_local, make_mesh
from dewi_tpu_torch.parallel.mesh import all_gather
from dewi_tpu_torch.parallel.pp import (pipelined_lm_logits, pp_loss_and_grads, pp_train_step,
                                        shard_stacked_params, stack_block_params,
                                        unstack_block_params)
from torch_model_axis import step_deviation

RANKS = 4
LAUNCH_TIMEOUT = 180.0
LOGIT_TOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
LOSS_TOL = 1e-5
PARAM_RTOL = 1e-5
LR = 1e-2
STEPS = 5


def _cfg():
    return dataclasses.replace(treg.lm_config("tiny", max_len=16, dtype="float32"), n_layers=4)


def _model():
    return treg.init_lm(_cfg(), seed=0, device="cpu")


def _inputs(pad_from=None):
    ids = np.random.default_rng(0).integers(0, 258, (8, 12)).astype(np.int64)
    pad = np.ones_like(ids, np.float32)
    if pad_from is not None:
        pad[:, pad_from:] = 0.0
    return ids, pad


def _stacked_grads(blocks, group):
    """The stage's block gradients, all-gathered over the stages into ``[L, ...]``."""
    local = stack_block_params({f"encoder.block_{j}.{k}": p.grad
                                for j, blk in enumerate(blocks)
                                for k, p in blk.named_parameters()}, len(blocks))[0]
    return {k: all_gather(v.contiguous(), group, dim=0).numpy() for k, v in local.items()}


def _pp_worker():
    cfg = _cfg()
    stacked, rest = stack_block_params(_model(), cfg.n_layers)
    out = {}
    for name, n_data, m in (("2x2", 2, 4), ("stages", 1, 1)):
        mesh = make_mesh(n_data, RANKS // n_data, device="cpu", axes=("data", "stage"))
        blocks = shard_stacked_params(cfg, stacked, mesh)
        out[f"logits_{name}"] = pipelined_lm_logits(cfg, blocks, rest, *_inputs(), mesh, m).numpy()
        if name == "2x2":
            out["layers_per_stage"] = len(blocks)
            out["logits_pad"] = pipelined_lm_logits(cfg, blocks, rest, *_inputs(8), mesh,
                                                    2).numpy()
            grad_rest = {k: v.clone().requires_grad_() for k, v in rest.items()}
            loss = pp_loss_and_grads(cfg, blocks, grad_rest, *_inputs(), mesh, 4)
            out["loss"] = float(loss)
            out["grads"] = (_stacked_grads(blocks, mesh.group("stage")),
                            {k: v.grad.numpy() for k, v in grad_rest.items()})
            train = {k: v.clone().requires_grad_() for k, v in rest.items()}
            opt = torch.optim.Adam(list(blocks.parameters()) + list(train.values()), lr=LR)
            step = pp_train_step(cfg, opt, mesh, n_microbatches=4)
            losses = []
            for s in range(STEPS):
                losses.append(float(step((blocks, train), *_inputs())))
                if s == 0:
                    local = stack_block_params({f"encoder.block_{j}.{k}": p
                                                for j, blk in enumerate(blocks)
                                                for k, p in blk.named_parameters()},
                                               len(blocks))[0]
                    full = unstack_block_params(
                        {k: all_gather(v.detach().contiguous(), mesh.group("stage"), dim=0)
                         for k, v in local.items()},
                        {k: v.detach() for k, v in train.items()}, cfg.n_layers)
                    out["step_1"] = {k: v.numpy().copy() for k, v in full.items()}
            out["losses"] = losses
            out["rest_replicated"] = float(max(
                (all_gather(v.detach()[None], mesh.group("stage"), 0) - v.detach()).abs().max()
                for v in train.values()))
    return out


@pytest.fixture(scope="module")
def port():
    return launch_local(_pp_worker, RANKS, timeout=LAUNCH_TIMEOUT, threads=1)


def _jax_mesh(shape, axes):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), axes)


def _ref_setup():
    import jax
    import jax.numpy as jnp

    from dewi_tpu.models import registry as jreg
    from dewi_tpu.parallel.pp import stack_block_params as j_stack
    from dewi_tpu_torch import convert

    cfg = jreg.TransformerConfig(**_cfg().__dict__)
    params = jax.tree.map(jnp.asarray, convert.lm_params_to_flax(_model()))
    return cfg, params, j_stack(params, cfg.n_layers)


def _plain_logits(pad_from=None):
    ids, pad = (torch.from_numpy(a) for a in _inputs(pad_from))
    with torch.no_grad():
        return _model()(ids, pad).numpy()


# ---- stacking -------------------------------------------------------------------


def test_stack_round_trip_and_reference_leaves():
    from dewi_tpu_torch import convert

    model = _model()
    stacked, rest = stack_block_params(model, 4)
    assert stacked["attn.query.weight"].shape == (4, 64, 64)
    back = unstack_block_params(stacked, rest, 4)
    state = model.state_dict()
    assert sorted(back) == sorted(state)
    assert all(torch.equal(back[k], state[k]) for k in state)
    _, _, (j_stacked, j_rest) = _ref_setup()
    want = convert.stacked_blocks_from_flax(j_stacked)
    assert sorted(want) == sorted(stacked)
    assert all(torch.equal(want[k], stacked[k]) for k in stacked)
    want_rest = convert.lm_params_from_flax(j_rest)
    assert sorted(want_rest) == sorted(rest)
    assert all(torch.equal(want_rest[k], rest[k]) for k in rest)


def test_shard_stacked_params_refuses_uneven_stages():
    cfg = dataclasses.replace(_cfg(), n_layers=3)
    stacked, _ = stack_block_params(treg.init_lm(cfg, device="cpu"), 3)
    mesh = make_mesh(device="cpu", axes=("data", "stage"))
    assert len(shard_stacked_params(cfg, stacked, mesh)) == 3
    two = type(mesh)(1, 2, 0, mesh.device, {"data": None, "stage": None}, ("data", "stage"))
    with pytest.raises(ValueError, match="stages"):
        shard_stacked_params(cfg, stacked, two)


# ---- the forward ------------------------------------------------------------------


@pytest.mark.parametrize("name,ref_shape,ref_axes,m,data_axis", [
    ("2x2", (2, 4), ("data", "stage"), 4, "data"),
    ("stages", (4,), ("stage",), 1, None)])
def test_logits_match_reference_and_plain_forward(port, name, ref_shape, ref_axes, m,
                                                  data_axis):
    from dewi_tpu.parallel.pp import pipelined_lm_logits as j_logits
    from dewi_tpu.parallel.pp import shard_stacked_params as j_shard

    cfg, _, (stacked, rest) = _ref_setup()
    mesh = _jax_mesh(ref_shape, ref_axes)
    ids, pad = _inputs()
    want = np.asarray(j_logits(cfg, j_shard(stacked, mesh), rest, ids.astype(np.int32), pad, mesh,
                               n_microbatches=m, data_axis=data_axis))
    got = port[f"logits_{name}"]
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(got, _plain_logits(), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert port["layers_per_stage"] == 2


def test_pad_mask_respected(port):
    np.testing.assert_allclose(port["logits_pad"][:, :8], _plain_logits(8)[:, :8],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_batch_must_divide_into_microbatches():
    cfg = _cfg()
    stacked, rest = stack_block_params(_model(), 4)
    mesh = make_mesh(device="cpu", axes=("data", "stage"))
    with pytest.raises(ValueError, match="microbatches"):
        pipelined_lm_logits(cfg, shard_stacked_params(cfg, stacked, mesh), rest, *_inputs(),
                            mesh, n_microbatches=3)


# ---- the backward -----------------------------------------------------------------


def test_grads_match_reference_pipeline(port):
    import jax

    from dewi_tpu.models.lm import token_nll as j_token_nll
    from dewi_tpu.parallel.pp import pipelined_lm_logits as j_logits
    from dewi_tpu_torch import convert

    cfg, _, (stacked, rest) = _ref_setup()
    mesh = _jax_mesh((2, 4), ("data", "stage"))
    ids, pad = _inputs()

    def loss(sr):
        logits = j_logits(cfg, sr[0], sr[1], ids.astype(np.int32), pad, mesh, n_microbatches=4)
        nll, valid = j_token_nll(logits, ids, pad)
        v = valid.astype(np.float32)
        return (nll * v).sum() / v.sum()

    l_ref, (gs, gr) = jax.jit(jax.value_and_grad(loss))((stacked, rest))
    assert abs(port["loss"] - float(l_ref)) <= LOSS_TOL
    got_s, got_r = port["grads"]
    want_s = convert.stacked_blocks_from_flax(gs)
    want_r = convert.lm_params_from_flax(gr)
    assert sorted(got_s) == sorted(want_s) and sorted(got_r) == sorted(want_r)
    for got, want in ((got_s, want_s), (got_r, want_r)):
        for k in want:
            np.testing.assert_allclose(got[k], want[k].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=k)


# ---- the train step ----------------------------------------------------------------


def test_train_step_loss_decreases(port):
    losses = port["losses"]
    assert len(losses) == STEPS and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert port["rest_replicated"] == 0.0  # one update of the tied weights on every stage


def test_first_step_equals_a_plain_adam_step(port):
    model = _model()
    ids, pad = (torch.from_numpy(a) for a in _inputs())
    nll, valid = token_nll(model(ids, pad), ids, pad)
    w = valid.to(torch.float32)
    loss = (nll * w).sum() / w.sum()
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    opt.step()
    assert port["losses"][0] == pytest.approx(float(loss), abs=LOSS_TOL)
    want = {k: p.detach().numpy() for k, p in model.named_parameters()}
    real, led = step_deviation(port["step_1"], want, grads, LR)
    assert real <= PARAM_RTOL
    assert led <= 2.0
