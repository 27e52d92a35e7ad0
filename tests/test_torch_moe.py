"""The port's MoE (``dewi_tpu_torch.models.moe``) against the reference's.

Mirrors ``tests/test_moe.py`` (single expert, the routing oracle, overflow,
the aux bound, pads, a falling loss) on the port, then holds the port to
``dewi_tpu.models.moe`` on the same weights, crossed by
``convert.moe_lm_params_{from,to}_flax``, and seeded numpy inputs.
Tolerances: float32 outputs and aux losses within 1e-5 relative
(max |port - ref| / max |ref|).  In bfloat16 a token whose two best router
probabilities nearly tie can take the other expert in one package (the
router's input is the bf16 residual stream, rounded at other points), and
its logits and those of the tokens attending to it move by more: so 90% of
the tokens' logits within 3e-2 relative (the bound ``test_torch_models.py``
holds the dense LM to) and every token within 0.1 (0.072 measured), and
the aux loss within 3e-2.

Expert parallelism (``shard_expert_params``) runs on four gloo ranks
started once by ``parallel.launch_local`` (a module-scoped fixture; the
rank function is ``torch_model_axis.ep_worker``, in a module without JAX):
8 experts, 2 a rank, against the reference's ``shard_expert_params``
forward on 8 virtual devices (``rtol 2e-4, atol 2e-4``, its own bound) and
the replicated port model (1e-5 relative); ``E % n != 0`` replicates; one
``train_moe_lm`` step sharded against unsharded (parameters within 1e-5
of the largest magnitude, 2 lr where the step-1 gradient is rounding
noise, as ``test_torch_training.py`` explains).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dewi_tpu.models import moe as jmoe
from dewi_tpu.models import registry as jreg
from dewi_tpu_torch import convert
from dewi_tpu_torch.models import moe as tmoe
from dewi_tpu_torch.models import registry as treg
from dewi_tpu_torch.models.lm import token_nll
from dewi_tpu_torch.parallel import launch_local
from torch_model_axis import STEP_KW, ep_inputs, ep_worker, step_deviation

F32_RTOL = 1e-5
BF16_RTOL = 3e-2
BF16_TOKEN_SHARE = 0.9
BF16_FLIP_RTOL = 0.1


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these tiny models, restored after: the test
    workers share the host's cores, and many threads each on small ops
    spend their time waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32_cfg(**over):
    return treg.lm_config("tiny", max_len=16, dtype="float32", **over)


def ref_cfg(cfg):
    return jreg.TransformerConfig(**dataclasses.asdict(cfg))


def np_gelu(x):
    return 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi) * (x + 0.044715 * x**3)))


def port_mlp(cfg, n_experts, capacity_factor, seed=0):
    return treg._flax_init(tmoe.MoEMLP(cfg, n_experts, capacity_factor), seed, "cpu")


def rel_dev(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def weights(m):
    return {k: v.detach().numpy() for k, v in m.named_parameters()}


@torch.no_grad()
def run_mlp(m, x, pad=None):
    out = m(torch.from_numpy(x), None if pad is None else torch.from_numpy(pad))
    return out.numpy(), float(m.aux_loss)


class TestMoEMLP:
    def test_single_expert_equals_dense_mlp(self):
        cfg = f32_cfg()
        m = port_mlp(cfg, 1, 2.0)
        x = np.random.default_rng(0).normal(size=(2, 8, cfg.d_model)).astype(np.float32)
        out, _ = run_mlp(m, x)
        p = weights(m)
        ref = np_gelu(x @ p["w_in"][0] + p["b_in"][0]) @ p["w_out"][0] + p["b_out"][0]
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)

    def test_routing_matches_numpy_oracle(self):
        cfg = f32_cfg()
        e, cf = 4, 1.5
        m = port_mlp(cfg, e, cf, seed=1)
        x = np.random.default_rng(3).normal(size=(3, 8, cfg.d_model)).astype(np.float32)
        out, _ = run_mlp(m, x)
        p = weights(m)
        n, d = 24, cfg.d_model
        xf = x.reshape(n, d)
        logits = xf @ p["router.weight"].T + p["router.bias"]
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        expert, gate = probs.argmax(-1), probs.max(-1)
        cap = max(1, int(math.ceil(n / e * cf)))
        counts = np.zeros(e, int)
        ref = np.zeros((n, d), np.float32)
        for i in range(n):
            ei = expert[i]
            if counts[ei] < cap:
                counts[ei] += 1
                h = np_gelu(xf[i] @ p["w_in"][ei] + p["b_in"][ei])
                ref[i] = gate[i] * (h @ p["w_out"][ei] + p["b_out"][ei])
        np.testing.assert_allclose(out.reshape(n, d), ref, rtol=2e-3, atol=2e-3)

    def test_overflow_tokens_drop_to_zero(self):
        """cap = 1 slot per expert: the rest drop (``F.one_hot`` would raise
        on their out-of-range slots; the port never builds it)."""
        cfg = f32_cfg()
        m = port_mlp(cfg, 2, 0.01, seed=2)
        x = np.random.default_rng(5).normal(size=(1, 16, cfg.d_model)).astype(np.float32)
        out, _ = run_mlp(m, x)
        assert np.sum(np.all(np.abs(out[0]) < 1e-12, axis=-1)) >= 14

    def test_load_balance_loss_uniform_bound(self):
        cfg = f32_cfg()
        m = port_mlp(cfg, 4, 1.25, seed=3)
        x = np.random.default_rng(7).normal(size=(4, 16, cfg.d_model)).astype(np.float32)
        run_mlp(m, x)
        assert 0.99 <= float(tmoe.load_balance_loss(m)) < 4.0

    def test_pads_excluded_from_capacity_and_aux(self):
        cfg = f32_cfg()
        m = port_mlp(cfg, 2, 4.0)
        rng = np.random.default_rng(9)
        half = rng.normal(size=(1, 4, cfg.d_model)).astype(np.float32)
        full = np.concatenate([half, rng.normal(size=(1, 4, cfg.d_model)).astype(np.float32)],
                              axis=1)
        pad = np.array([[1, 1, 1, 1, 0, 0, 0, 0]], np.float32)
        out_f, aux_f = run_mlp(m, full, pad)
        out_h, aux_h = run_mlp(m, half)
        np.testing.assert_allclose(out_f[:, :4], out_h, rtol=1e-5, atol=1e-5)
        assert np.all(np.abs(out_f[:, 4:]) < 1e-12)
        np.testing.assert_allclose(aux_f, aux_h, rtol=1e-5)

    def test_no_moe_layers_means_zero_aux(self):
        lm = treg.init_lm(f32_cfg(), device="cpu")
        assert float(tmoe.load_balance_loss(lm)) == 0.0

    def test_seeded_init_matches_the_reference_distribution(self):
        """Stacked kernels draw lecun_normal over fan_in = E * d_in, as
        Flax's initializer counts the leading axis."""
        cfg = treg.lm_config("small", n_layers=1)
        m = treg.init_moe_lm(cfg, n_experts=8, device="cpu")
        moe = m.block_0.moe
        for w in (moe.w_in, moe.w_out):
            want = math.sqrt(1.0 / (w.shape[0] * w.shape[1]))
            assert abs(float(w.detach().std()) / want - 1) < 0.02
        assert float(moe.b_in.abs().max()) == 0.0


def _ref_mlp(cfg, e, cf, x, pad, seed):
    m = jmoe.MoEMLP(ref_cfg(cfg), n_experts=e, capacity_factor=cf)
    args = (jnp.asarray(x),) if pad is None else (jnp.asarray(x), jnp.asarray(pad))
    params = jax.jit(lambda k: m.init(k, *args))(jax.random.PRNGKey(seed))
    out, mut = jax.jit(lambda p: m.apply(p, *args, mutable=["aux_loss"]))(params)
    return params, np.asarray(out), float(jmoe.load_balance_loss(mut))


class TestParity:
    @pytest.mark.parametrize("e,cf,padded", [(4, 1.25, False), (4, 1.25, True),
                                              (2, 0.3, True), (8, 2.0, False)],
                             ids=["e4", "e4-pad", "e2-overflow-pad", "e8"])
    def test_moe_mlp_matches_reference(self, e, cf, padded):
        cfg = f32_cfg()
        rng = np.random.default_rng(11)
        x = rng.normal(size=(3, 10, cfg.d_model)).astype(np.float32)
        pad = None
        if padded:
            pad = np.ones((3, 10), np.float32)
            pad[0, 6:] = 0
            pad[2, 2:] = 0
        params, want, want_aux = _ref_mlp(cfg, e, cf, x, pad, seed=e)
        m = tmoe.MoEMLP(cfg, e, cf)
        m.load_state_dict(convert._state_from_flax(jax.tree.map(np.asarray, params["params"])),
                          strict=True)
        got, got_aux = run_mlp(m, x, pad)
        assert rel_dev(got, want) <= F32_RTOL
        assert abs(got_aux - want_aux) <= F32_RTOL * abs(want_aux)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_moe_causal_lm_matches_reference(self, dtype):
        cfg = treg.lm_config("tiny", max_len=16, dtype=dtype)
        model = jmoe.MoECausalLM(ref_cfg(cfg), n_experts=4, capacity_factor=1.0)
        rng = np.random.default_rng(0)
        ids = rng.integers(0, cfg.vocab_size, (4, 12)).astype(np.int32)
        pad = np.ones((4, 12), np.float32)
        pad[1, 7:] = 0
        pad[3, 3:] = 0
        params = jax.jit(lambda k: model.init(k, jnp.asarray(ids), jnp.asarray(pad)))(
            jax.random.PRNGKey(0))
        want, mut = jax.jit(lambda p: model.apply(p, ids, pad, mutable=["aux_loss"]))(params)
        tm = tmoe.MoECausalLM(cfg, n_experts=4, capacity_factor=1.0)
        tm.load_state_dict(convert.moe_lm_params_from_flax(jax.tree.map(np.asarray, params)),
                           strict=True)
        with torch.no_grad():
            got = tm(torch.from_numpy(ids), torch.from_numpy(pad))
        want = np.asarray(want)
        if dtype == "float32":
            tol = F32_RTOL
            assert rel_dev(got.numpy(), want) <= tol
        else:
            tol = BF16_RTOL
            per_token = np.abs(got.numpy() - want).max(-1) / np.abs(want).max()
            assert np.mean(per_token <= tol) >= BF16_TOKEN_SHARE
            assert per_token.max() <= BF16_FLIP_RTOL
        aux_want = float(jmoe.load_balance_loss(mut))
        assert abs(float(tmoe.load_balance_loss(tm)) - aux_want) <= tol * aux_want

    def test_converters_round_trip_the_reference_tree(self):
        cfg = f32_cfg(n_layers=2)
        model = jmoe.MoECausalLM(ref_cfg(cfg), n_experts=4)
        ids = jnp.zeros((1, 8), jnp.int32)
        params = jax.jit(lambda k: model.init(k, ids, jnp.ones((1, 8))))(jax.random.PRNGKey(1))
        tree = jax.tree.map(np.asarray, {"params": params["params"]})
        tm = tmoe.MoECausalLM(cfg, n_experts=4)
        tm.load_state_dict(convert.moe_lm_params_from_flax(tree), strict=True)
        assert tm.block_1.moe.router.weight.shape == (4, cfg.d_model)
        back = convert.moe_lm_params_to_flax(tm)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)


class TestCheckpoints:
    def _pair(self):
        cfg = f32_cfg(n_layers=2)
        ref_model = jmoe.MoECausalLM(ref_cfg(cfg), n_experts=4)
        ids = jnp.zeros((1, 8), jnp.int32)
        full = jax.jit(lambda k: ref_model.init(k, ids, jnp.ones((1, 8))))(jax.random.PRNGKey(2))
        return cfg, ref_model, {"params": full["params"]}

    def test_port_checkpoint_loads_into_the_reference(self, tmp_path):
        cfg, ref_model, template = self._pair()
        tm = treg.init_moe_lm(cfg, n_experts=4, seed=5, device="cpu")
        path = tmp_path / "moe.msgpack"
        treg.save_params(tm, path)
        loaded = jreg.load_params(template, path)
        want = convert.moe_lm_params_to_flax(tm)
        for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), b)

    def test_reference_checkpoint_loads_into_the_port(self, tmp_path):
        cfg, ref_model, params = self._pair()
        path = tmp_path / "moe.msgpack"
        jreg.save_params(params, path)
        tm = treg.load_params(tmoe.MoECausalLM(cfg, n_experts=4), path)
        ids = np.random.default_rng(1).integers(0, 258, (2, 8)).astype(np.int32)
        pad = np.ones((2, 8), np.float32)
        want, _ = jax.jit(lambda p: ref_model.apply(p, ids, pad, mutable=["aux_loss"]))(params)
        with torch.no_grad():
            got = tm(torch.from_numpy(ids), torch.from_numpy(pad))
        assert rel_dev(got.numpy(), want) <= F32_RTOL


def test_loss_decreases_with_aux():
    cfg = f32_cfg(n_layers=2)
    model = treg.init_moe_lm(cfg, n_experts=4, device="cpu").train()
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 12)).astype(np.int32))
    pad = torch.ones(8, 12)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    losses = []
    for _ in range(5):
        nll, valid = token_nll(model(ids, pad), ids, pad)
        v = valid.float()
        loss = (nll * v).sum() / v.sum() + 0.01 * tmoe.load_balance_loss(model)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# ---- expert parallelism ---------------------------------------------------------


@pytest.fixture(scope="module")
def ep():
    return launch_local(ep_worker, 4, timeout=180.0, threads=1)


def _ep_plain(n_experts):
    cfg = treg.lm_config("tiny", max_len=16, dtype="float32")
    model = treg.init_moe_lm(cfg, n_experts=n_experts, seed=0, device="cpu")
    ids, pad = ep_inputs()
    with torch.no_grad():
        logits = model(torch.from_numpy(ids), torch.from_numpy(pad)).numpy()
    return model, logits, float(tmoe.load_balance_loss(model))


class TestExpertParallel:
    def test_sharded_forward_matches_reference(self, ep):
        from jax.sharding import Mesh

        model, plain, aux = _ep_plain(8)
        assert ep["w_in_shape"] == (2, 64, 256)
        assert rel_dev(ep["logits"], plain) <= F32_RTOL
        assert abs(ep["aux"] - aux) <= F32_RTOL * aux
        jm = jmoe.MoECausalLM(ref_cfg(model.cfg), n_experts=8)
        params = jax.tree.map(jnp.asarray, convert.moe_lm_params_to_flax(model))
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(1, 8), ("data", "model"))
        sharded = jmoe.shard_expert_params(params, mesh, axis="model")
        ids, pad = ep_inputs()
        with jax.set_mesh(mesh):
            want, _ = jax.jit(lambda p, i, m: jm.apply(p, i, m, mutable=["aux_loss"]))(
                sharded, ids.astype(np.int32), pad)
        np.testing.assert_allclose(ep["logits"], np.asarray(want), rtol=2e-4, atol=2e-4)

    def test_indivisible_experts_replicate(self, ep):
        _, plain, _ = _ep_plain(6)
        assert ep["odd_w_in_shape"] == (6, 64, 256)
        assert rel_dev(ep["odd_logits"], plain) <= F32_RTOL

    def test_train_step_matches_unsharded(self, ep):
        real, led = step_deviation(ep["step_sharded"], ep["step_plain"], ep["grads"],
                                   STEP_KW["lr"])
        assert real <= F32_RTOL
        assert led <= 2.0
