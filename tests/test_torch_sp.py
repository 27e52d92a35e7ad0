"""Sequence parallelism (``dewi_tpu_torch.parallel.sp``) against
``dewi_tpu.parallel.sp``.

The port runs on four gloo ranks started once by ``parallel.launch_local``
(a module-scoped fixture; the rank function lives at module level and this
module imports JAX only inside test bodies), on a 2 x 2 ``(data, model)``
mesh: the batch over ``data``, the sequence over ``model``.  The reference
runs ``sequence_sharded_nll`` as ``tests/test_sp.py`` calls it, on a 2 x 2
mesh of the conftest's virtual CPU devices, alone and with
``tp.shard_params``.  Weights are the port's seeded init, carried across by
``convert.lm_params_to_flax``; inputs come from numpy with a seed.

Tolerances: float32 NLL elementwise within ``rtol 2e-4, atol 2e-4`` (the
reference's logits bound) of the reference's and of the replicated
forward's; bfloat16 (the preset's dtype) mean NLL within 1e-3 relative
alone (the reference's bound) and 5e-3 composed with tensor parallelism.
"""

import numpy as np
import pytest
import torch

from dewi_tpu_torch.models import registry as treg
from dewi_tpu_torch.models.lm import token_nll
from dewi_tpu_torch.parallel import launch_local, make_mesh, sequence_sharded_nll, shard_tokens
from dewi_tpu_torch.parallel.tp import shard_params

RANKS = 4
LAUNCH_TIMEOUT = 180.0
NLL_TOL = 2e-4
BF16_RTOL = {"alone": 1e-3, "tp": 5e-3}
CASES = ("alone", "tp")


def _model(name, dtype):
    return treg.init_lm(treg.lm_config(name, max_len=64, dtype=dtype), seed=0, device="cpu")


def _inputs(seed):
    ids = np.random.default_rng(seed).integers(0, 258, (4, 64)).astype(np.int64)
    mask = np.ones((4, 64), np.float32)
    mask[1, 40:] = 0.0
    mask[3, 10:] = 0.0
    return ids, mask


def _case_model(case, dtype):
    # ``small`` has 4 heads: each rank of the model axis holds 2 under TP
    return _model("tiny" if case == "alone" else "small", dtype)


def _sp_worker():
    mesh = make_mesh(2, 2, device="cpu")
    out = {}
    ids, mask = _inputs(0)
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            for case in CASES:
                model = _case_model(case, dtype)
                if case == "tp":
                    model = shard_params(model, mesh)
                nll, valid = sequence_sharded_nll(model, ids, mask, mesh)
                out[(case, dtype)] = (nll.numpy(), valid.numpy())
    blocks = torch.arange(8 * 32).reshape(8, 32)
    ids_s, mask_s = shard_tokens(blocks, blocks > 100, mesh)
    out["block"] = (mesh.data_index, mesh.model_index, ids_s.numpy(), mask_s.numpy())
    return out


@pytest.fixture(scope="module")
def port():
    return launch_local(_sp_worker, RANKS, timeout=LAUNCH_TIMEOUT, threads=1)


def _reference(case, dtype):
    import jax
    import jax.numpy as jnp

    from jax.sharding import Mesh

    from dewi_tpu.models import registry as jreg
    from dewi_tpu.parallel.sp import sequence_sharded_nll as j_sp_nll
    from dewi_tpu.parallel.tp import shard_params as j_shard_params
    from dewi_tpu_torch import convert

    model = _case_model(case, dtype)
    jm = jreg.CausalLM(jreg.TransformerConfig(**model.cfg.__dict__))
    params = jax.tree.map(jnp.asarray, convert.lm_params_to_flax(model))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    if case == "tp":
        params = j_shard_params(params, mesh)
    ids, mask = _inputs(0)
    nll, valid = j_sp_nll(jm, params, ids.astype(np.int32), mask, mesh)
    return np.asarray(nll), np.asarray(valid)


def _plain(case, dtype):
    ids, mask = (torch.from_numpy(a) for a in _inputs(0))
    with torch.no_grad():
        nll, valid = token_nll(_case_model(case, dtype)(ids, mask), ids, mask)
    return nll.numpy(), valid.numpy()


@pytest.mark.parametrize("case", CASES)
def test_f32_matches_reference_and_replicated(port, case):
    got, valid = port[(case, "float32")]
    for want, want_valid in (_reference(case, "float32"), _plain(case, "float32")):
        assert got.shape == want.shape == (4, 63)
        np.testing.assert_array_equal(valid, want_valid)
        np.testing.assert_allclose(got[valid], want[valid], rtol=NLL_TOL, atol=NLL_TOL)


@pytest.mark.parametrize("case", CASES)
def test_bf16_mean_matches_reference_and_replicated(port, case):
    got, valid = port[(case, "bfloat16")]
    mean = float(got[valid].mean())
    for want, _ in (_reference(case, "bfloat16"), _plain(case, "bfloat16")):
        assert mean == pytest.approx(float(want[valid].mean()), rel=BF16_RTOL[case])


def test_shard_tokens_layout(port):
    """A 2 x 2 mesh: each rank holds the ``[4, 16]`` block at its data row
    and model column."""
    d, m, ids, mask = port["block"]
    want = np.arange(8 * 32).reshape(8, 32)[d * 4:(d + 1) * 4, m * 16:(m + 1) * 16]
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_array_equal(mask, want > 100)


def test_shard_tokens_refuses_what_does_not_split():
    mesh = make_mesh(device="cpu")
    ids, mask = shard_tokens(np.zeros((3, 5)), np.ones((3, 5)), mesh)
    assert ids.shape == mask.shape == (3, 5)
    four = type(mesh)(1, 4, 0, mesh.device, {"data": None, "model": None})
    with pytest.raises(ValueError, match="split"):
        shard_tokens(np.zeros((3, 6)), np.ones((3, 6)), four)
