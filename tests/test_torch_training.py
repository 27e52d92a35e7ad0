"""The port's training loops (``dewi_tpu_torch.training``) against the reference's.

Mirrors ``tests/test_training.py`` (falling losses, mismatched CLIP inputs,
a trained checkpoint in the estimator) on the port, across the packages
both ways, and holds the port's steps to ``dewi_tpu.training`` in layers,
from the same weights (crossed by ``convert``) and the same batches:

* ``lm_batches``: the same ids and masks;
* the optimizer alone, fed the same numpy gradients for 5 steps, against
  optax's chain: within 1e-6 of each leaf's largest magnitude;
* the step-1 gradients: within 1e-5 of the global gradient norm;
* 1 and 3 steps of each loop: the losses within 1e-5 relative, and the
  parameters after the update within 1e-5 (one step) or 1e-4 (three
  steps) of the largest parameter magnitude, except where the reference's
  step-1 gradient is nonzero but below 1e-6 of the global norm.  There the
  gradient is rounding noise (the attention key bias: a softmax does not
  move when every key shifts by one constant, so its true gradient is 0),
  and Adam's ``m / (sqrt(v) + eps)`` turns noise of either sign into an
  update of up to ``lr``; those elements (at most 5% of the parameters)
  are held to ``2 * lr * steps``.  After one step the two models differ
  there by up to ``lr``, which moves the next gradients by more than
  rounding: over three steps the other elements came within 1.3e-5 of the
  largest magnitude (CLIP and the MoE LM), hence 1e-4.

All configs are float32 (``dtype="float32"``).  ``train_mae`` takes the
reference's masking noise through ``loops._step_noise``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dewi_tpu.models import moe as jmoe
from dewi_tpu.models import registry as jreg
from dewi_tpu.signals.tokenizer import get_tokenizer as j_get_tokenizer
from dewi_tpu.training import loops as jl
from dewi_tpu_torch import convert
from dewi_tpu_torch.models import registry as treg
from dewi_tpu_torch.models.moe import load_balance_loss
from dewi_tpu_torch.signals.tokenizer import get_tokenizer
from dewi_tpu_torch.training import loops as tl
from dewi_tpu_torch.training import train_clip, train_lm, train_mae, train_moe_lm

CORPUS = [
    "the cat sat on the mat",
    "the dog sat on the log",
    "the cat and the dog sat together",
    "a mat and a log in the sun",
] * 8

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5          # of the global gradient norm
PARAM_RTOL = {1: 1e-5, 3: 1e-4}  # of the largest parameter magnitude, by steps
OPT_RTOL = 1e-6          # of each leaf's largest magnitude
NOISE_LED = 1e-6         # |step-1 gradient| below this share of the global norm
NOISE_LED_SHARE = 0.05
LR = 3e-3
BATCH = 4
SEQ = 32


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these tiny models, restored after: the test
    workers share the host's cores, and many threads each on small ops
    spend their time waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_cfg(cfg):
    """The reference's config class for a port config (same fields)."""
    table = {"TransformerConfig": jreg.TransformerConfig, "MAEConfig": jreg.MAEConfig,
             "CLIPConfig": jreg.CLIPConfig}
    return table[type(cfg).__name__](**dataclasses.asdict(cfg))


def flat(tree):
    return [(jax.tree_util.keystr(k), np.asarray(v))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def global_norm(tree):
    return float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                             for g in jax.tree.leaves(tree))))


def port_grads(model, loss):
    """The port's gradients as a reference-layout tree (the converters map
    ``.grad`` as they map the weights)."""
    model.zero_grad()
    loss.backward()
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
        tree = convert._to_flax(model, type(model))
        for n, p in model.named_parameters():
            p.copy_(saved[n])
    model.zero_grad()
    return tree


def assert_grads_match(got, want):
    tol = GRAD_TOL * global_norm(want)
    for (k, g), (_, w) in zip(flat(got), flat(want)):
        assert np.abs(g - w).max() <= tol, k


def assert_params_match(got, want, grads, lr, steps):
    gnorm = global_norm(grads)
    pmax = max(np.abs(w).max() for _, w in flat(want))
    led_total = total = 0
    for (k, g), (_, w), (_, gr) in zip(flat(got), flat(want), flat(grads)):
        d = np.abs(g - w)
        led = (gr != 0) & (np.abs(gr) < NOISE_LED * gnorm)
        if (~led).any():
            assert d[~led].max() <= PARAM_RTOL[steps] * pmax, (k, float(d[~led].max()))
        if led.any():
            assert d[led].max() <= 2 * lr * steps, (k, float(d[led].max()))
        led_total += int(led.sum())
        total += d.size
    assert led_total <= NOISE_LED_SHARE * total


def assert_losses_match(got, want):
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def ref_noise(seed, step, shape, device):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    return torch.from_numpy(np.asarray(jax.random.uniform(key, shape))).to(device)


def structured_images(n, size=32, seed=0):
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 1, size, dtype=np.float32)
    return np.stack([np.tile(base * float(rng.random()), (size, 1))[..., None].repeat(3, -1)
                     for _ in range(n)])


def concept_pairs(n=32, size=32):
    concepts = []
    for c in range(4):
        img = np.full((size, size, 3), c / 4.0, np.float32)
        img[:, : 8 * (c + 1)] = 1.0 - c / 4.0
        concepts.append((f"concept number {c} caption", img))
    return ([concepts[i % 4][0] for i in range(n)],
            np.stack([concepts[i % 4][1] for i in range(n)]))


# ---- the port alone, as tests/test_training.py -----------------------------


class TestTrainLM:
    def test_loss_decreases(self):
        model = treg.init_lm(treg.lm_config("tiny", max_len=64), seed=0, device="cpu")
        state = train_lm(model, CORPUS, steps=60, batch_size=8, lr=3e-3, log_every=10)
        assert state.step == 60 and len(state.losses) == 7
        assert state.losses[-1] < state.losses[0] - 0.5
        assert state.model is model and not model.training

    def test_trains_under_no_grad_from_a_fresh_init(self):
        """``init_*`` builds under ``no_grad`` and returns ``eval()``; a loop
        called inside ``no_grad`` still trains."""
        model = treg.init_lm(treg.lm_config("tiny", max_len=64), seed=0, device="cpu")
        before = model.wte.weight.detach().clone()
        with torch.no_grad():
            state = train_lm(model, CORPUS, steps=2, batch_size=4)
        assert not torch.equal(before, model.wte.weight.detach())
        assert isinstance(state.optimizer, torch.optim.AdamW)

    @pytest.mark.parametrize("direction", ["port", "port_to_reference", "reference_to_port"])
    def test_checkpoint_loads_into_estimator(self, tmp_path, direction):
        """A trained checkpoint makes a corpus sentence less surprising than
        a fresh model does, in the package that loads it."""
        from dewi_tpu.signals import TextEntropyEstimator as JEstimator
        from dewi_tpu_torch.signals import TextEntropyEstimator as TEstimator

        ckpt = tmp_path / "lm.msgpack"
        if direction == "reference_to_port":
            model, params = jreg.init_lm(jreg.lm_config("tiny", max_len=64), seed=0)
            jl.train_lm(model, params, CORPUS, steps=40, batch_size=8, lr=3e-3,
                        checkpoint=str(ckpt))
        else:
            model = treg.init_lm(treg.lm_config("tiny", max_len=64), seed=0, device="cpu")
            train_lm(model, CORPUS, steps=40, batch_size=8, lr=3e-3, checkpoint=str(ckpt))
        if direction == "port_to_reference":
            def estimator(**kw):
                return JEstimator(model_name="tiny", max_length=64, batch_size=4, **kw)
        else:
            def estimator(**kw):
                return TEstimator(model_name="tiny", max_length=64, batch_size=4,
                                  device="cpu", **kw)
        text = "the cat sat on the mat"
        trained = estimator(checkpoint=str(ckpt)).compute_entropy(text).mean_entropy
        fresh = estimator().compute_entropy(text).mean_entropy
        assert trained < fresh


class TestTrainMAE:
    def test_loss_decreases(self):
        model = treg.init_mae(treg.mae_config("tiny"), seed=0, device="cpu")
        state = train_mae(model, structured_images(32), steps=50, batch_size=8, lr=3e-3,
                          log_every=10)
        assert state.losses[-1] < state.losses[0]

    def test_step_noise_is_seeded_by_seed_and_step(self):
        a = tl._step_noise(0, 3, (2, 16), "cpu")
        assert torch.equal(a, tl._step_noise(0, 3, (2, 16), "cpu"))
        assert not torch.equal(a, tl._step_noise(0, 4, (2, 16), "cpu"))
        assert not torch.equal(a, tl._step_noise(1, 3, (2, 16), "cpu"))
        assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


class TestTrainCLIP:
    def test_loss_decreases_and_aligns(self):
        model = treg.init_clip(treg.clip_config("tiny"), seed=0, device="cpu")
        texts, imgs = concept_pairs()
        state = train_clip(model, texts, imgs, steps=60, batch_size=8, lr=3e-3, log_every=10)
        assert state.losses[-1] < state.losses[0]

    def test_mismatched_lengths_raise(self):
        model = treg.init_clip(treg.clip_config("tiny"), seed=0, device="cpu")
        with pytest.raises(ValueError):
            train_clip(model, ["a"], np.zeros((2, 32, 32, 3), np.float32), steps=1)


class TestMoETraining:
    def test_train_moe_lm_loss_decreases(self):
        model = treg.init_moe_lm(treg.lm_config("tiny", max_len=32), n_experts=2, device="cpu")
        texts = ["the quick brown fox jumps over the lazy dog"] * 64
        state = train_moe_lm(model, texts, steps=12, batch_size=8, seq_len=32, lr=1e-2,
                             log_every=4)
        assert state.losses and state.losses[-1] < state.losses[0]
        assert float(load_balance_loss(model).detach()) >= 0.99  # the last step's aux, kept


# ---- parity with the reference ---------------------------------------------


def test_lm_batches_match_the_reference():
    args = (CORPUS + ["é" * 50, ""], 24, 5, 3)
    want = list(jl.lm_batches(args[0], j_get_tokenizer("byte"), *args[1:], seed=7))
    got = list(tl.lm_batches(args[0], get_tokenizer("byte"), *args[1:], seed=7))
    assert len(got) == len(want) == 3
    for (gi, gm), (wi, wm) in zip(got, want):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


def test_optimizer_matches_optax():
    """clip_by_global_norm(1) -> adamw(cosine(lr, steps), 0.01) on the same
    gradients, global norms above and below 1, 5 steps."""
    rng = np.random.default_rng(0)
    shapes = [(8, 4), (4,), (3, 2, 5), ()]
    params = [np.asarray(rng.normal(size=s), np.float32) for s in shapes]
    steps, lr = 5, 1e-2
    grads = [[np.asarray(rng.normal(size=s) * scale, np.float32) for s in shapes]
             for scale in (1.0, 0.05, 0.3, 0.01, 0.13)]
    assert {global_norm(g) >= 1.0 for g in grads} == {True, False}

    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt, sched = tl._make_optimizer(tp, lr, steps)
    chain = jl._make_optimizer(lr, steps)
    jp = [jnp.asarray(p) for p in params]
    state = chain.init(jp)
    schedule = optax.cosine_decay_schedule(lr, steps)

    @jax.jit
    def update(g, state, params):
        updates, state = chain.update(g, state, params)
        return optax.apply_updates(params, updates), state
    for i, g in enumerate(grads):
        np.testing.assert_allclose(sched.get_last_lr()[0], float(schedule(i)), rtol=1e-6)
        for p, gi in zip(tp, g):
            p.grad = torch.from_numpy(gi.copy())
        tl._apply_update(opt, sched)
        jp, state = update([jnp.asarray(x) for x in g], state, jp)
        for p, w in zip(tp, jp):
            w = np.asarray(w)
            assert np.abs(p.detach().numpy() - w).max() <= OPT_RTOL * np.abs(w).max()
    assert sched.get_last_lr()[0] == 0.0


def test_clipping_has_no_epsilon():
    """A gradient of global norm exactly 2 becomes exactly half (torch's
    ``clip_grad_norm_`` would divide by 2 + 1e-6); below 1 it is untouched."""
    g = [torch.tensor([1.5, 0.0]), torch.tensor([[2.0]])]  # global norm 2.5, exactly
    tl._clip_by_global_norm(g)
    assert torch.equal(g[0], torch.tensor([0.6, 0.0])) and torch.equal(g[1], torch.tensor([[0.8]]))
    h = [torch.tensor([0.3, 0.4])]
    tl._clip_by_global_norm(h)
    assert torch.equal(h[0], torch.tensor([0.3, 0.4]))


# Each case: the port model, the reference model and params, the reference
# step-1 loss as a function of params, the port's step-1 loss, and the two
# training calls.


def _lm_case(moe):
    cfg = treg.lm_config("tiny", max_len=64, dtype="float32")
    if moe:
        tm = treg.init_moe_lm(cfg, n_experts=4, seed=3, device="cpu")
        jm = jmoe.MoECausalLM(ref_cfg(cfg), n_experts=4)
        to_flax = convert.moe_lm_params_to_flax
    else:
        tm = treg.init_lm(cfg, seed=3, device="cpu")
        jm = jreg.CausalLM(ref_cfg(cfg))
        to_flax = convert.lm_params_to_flax
    texts = CORPUS + ["x", "a much longer line that runs past the thirty-two byte window"]
    ids, mask = next(jl.lm_batches(texts, j_get_tokenizer("byte"), SEQ, BATCH, 1, 0))

    def ref_loss(p):
        if moe:
            logits, mut = jm.apply(p, ids, mask, mutable=["aux_loss"])
            return jl._masked_ce(logits, ids, mask) + 0.01 * jmoe.load_balance_loss(mut)
        return jl._masked_ce(jm.apply(p, ids, mask), ids, mask)

    def port_loss():
        i, m = torch.from_numpy(np.asarray(ids)), torch.from_numpy(np.asarray(mask))
        loss = tl._masked_ce(tm(i, m), i, m)
        return loss + 0.01 * load_balance_loss(tm) if moe else loss

    kw = dict(batch_size=BATCH, lr=LR, seq_len=SEQ, log_every=1)

    def run_ref(params, steps):
        fn = jl.train_moe_lm if moe else jl.train_lm
        return fn(jm, params, texts, steps=steps, **kw)

    def run_port(steps):
        return (train_moe_lm if moe else train_lm)(tm, texts, steps=steps, **kw)

    return tm, to_flax, ref_loss, port_loss, run_ref, run_port


def _mae_case():
    cfg = treg.mae_config("tiny", dtype="float32")
    tm = treg.init_mae(cfg, seed=3, device="cpu")
    jm = jreg.ViTMAE(ref_cfg(cfg))
    images = structured_images(12, seed=1) + np.random.default_rng(2).random(
        (12, 32, 32, 3), dtype=np.float32) * 0.1
    picks = np.random.default_rng(0).integers(0, len(images), size=BATCH)
    noise = np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(0), 0),
                                          (BATCH, cfg.num_patches)))

    def ref_loss(p):
        return jnp.mean(jm.apply(p, images[picks], None, noise))

    def port_loss():
        return tm(torch.from_numpy(images[picks]), noise=torch.from_numpy(noise)).mean()

    def run_ref(params, steps):
        return jl.train_mae(jm, params, images, steps=steps, batch_size=BATCH, lr=LR,
                            log_every=1)

    def run_port(steps):
        return train_mae(tm, images, steps=steps, batch_size=BATCH, lr=LR, log_every=1)

    return tm, convert.mae_params_to_flax, ref_loss, port_loss, run_ref, run_port


def _clip_case():
    cfg = treg.clip_config("tiny", dtype="float32")
    tm = treg.init_clip(cfg, seed=3, device="cpu")
    jm = jreg.CLIPDualEncoder(ref_cfg(cfg))
    texts, images = concept_pairs(12)
    images = images + np.random.default_rng(2).random(images.shape, dtype=np.float32) * 0.1
    picks = np.random.default_rng(0).integers(0, len(texts), size=BATCH)
    ids, mask = j_get_tokenizer("byte").encode_batch([texts[i] for i in picks], cfg.text_len,
                                                     pad_to=cfg.text_len)

    def ref_loss(p):
        t, v, scale = jm.apply(p, ids, mask, images[picks])
        logits = jnp.exp(jnp.clip(scale, -5.0, jnp.log(100.0))) * jnp.dot(t, v.T)
        labels = jnp.arange(BATCH)
        return 0.5 * (optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
                      + optax.softmax_cross_entropy_with_integer_labels(logits.T, labels).mean())

    def port_loss():
        return tl.clip_loss(*tm(torch.from_numpy(ids), torch.from_numpy(mask),
                                torch.from_numpy(images[picks])))

    def run_ref(params, steps):
        return jl.train_clip(jm, params, texts, images, steps=steps, batch_size=BATCH, lr=LR,
                             log_every=1)

    def run_port(steps):
        return train_clip(tm, texts, images, steps=steps, batch_size=BATCH, lr=LR,
                          log_every=1)

    return tm, convert.clip_params_to_flax, ref_loss, port_loss, run_ref, run_port


CASES = {"lm": lambda: _lm_case(False), "moe_lm": lambda: _lm_case(True),
         "mae": _mae_case, "clip": _clip_case}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_training_steps_match_the_reference(kind, steps, monkeypatch):
    monkeypatch.setattr(tl, "_step_noise", ref_noise)
    tm, to_flax, ref_loss, port_loss, run_ref, run_port = CASES[kind]()
    params = jax.tree.map(jnp.asarray, to_flax(tm))
    want_grads = jax.jit(jax.grad(ref_loss))(params)
    assert_grads_match(port_grads(tm, port_loss()), want_grads)

    want = run_ref(params, steps)
    got = run_port(steps)
    assert got.step == want.step == steps
    assert_losses_match(got.losses, want.losses)
    assert_params_match(to_flax(tm), want.params, want_grads, LR, steps)
