"""Orbax checkpoint directories in the port: read, never written.

The reference's ``save_params`` writes an orbax ``StandardCheckpointer``
directory for a path with no suffix or a trailing ``/``; the port's
``load_params`` reads it through ``tensorstore`` and must give the very
tensors the msgpack route gives (bit for bit).  Writing one is refused
before any training step, with a message that names msgpack and
``ROADMAP.md``.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dewi_tpu.models import moe as jmoe
from dewi_tpu.models import registry as jreg
from dewi_tpu_torch.models import registry as treg
from dewi_tpu_torch.training import train_lm


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these tiny models, restored after: the test
    workers share the host's cores, and many threads each on small ops
    spend their time waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_tree(kind):
    """A reference param tree and the port model of the same architecture."""
    if kind == "lm":
        cfg = treg.lm_config("tiny", max_len=64)
        model = jreg.CausalLM(jreg.TransformerConfig(**dataclasses.asdict(cfg)))
        args = (jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8)))
        port = treg.init_lm(cfg, seed=1, device="cpu")
    elif kind == "clip":  # a 0-d leaf (logit_scale)
        cfg = treg.clip_config("tiny")
        model = jreg.CLIPDualEncoder(jreg.CLIPConfig(**dataclasses.asdict(cfg)))
        args = (jnp.zeros((1, cfg.text_len), jnp.int32), jnp.ones((1, cfg.text_len)),
                jnp.zeros((1, cfg.image_size, cfg.image_size, 3)))
        port = treg.init_clip(cfg, seed=1, device="cpu")
    else:  # stacked [E, ...] leaves
        cfg = treg.lm_config("tiny", max_len=16)
        model = jmoe.MoECausalLM(jreg.TransformerConfig(**dataclasses.asdict(cfg)), n_experts=4)
        args = (jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8)))
        port = treg.init_moe_lm(cfg, n_experts=4, seed=1, device="cpu")
    params = jax.jit(lambda k: model.init(k, *args))(jax.random.PRNGKey(0))
    return {"params": params["params"]}, port


@pytest.mark.parametrize("kind", ["lm", "clip", "moe"])
def test_reference_orbax_directory_loads_as_msgpack_does(tmp_path, kind):
    tree, port = _ref_tree(kind)
    jreg.save_params(tree, tmp_path / "ckpt")          # orbax: no suffix
    jreg.save_params(tree, tmp_path / "ckpt.msgpack")
    from_dir = treg.load_params(port, tmp_path / "ckpt")
    want = {k: v.clone() for k, v in from_dir.state_dict().items()}
    treg.load_params(port, tmp_path / "ckpt.msgpack")
    got = port.state_dict()
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k], got[k]) for k in want)
    # and they are the reference's tensors, laid out back as its tree
    back = treg._converters(port)[0](port)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_trailing_slash_and_an_existing_directory_read_as_orbax(tmp_path):
    """``ckpt/`` is ``ckpt``, and a directory with a suffix in its name is
    read as orbax too, as the reference's ``load_params`` reads them."""
    tree, port = _ref_tree("lm")
    jreg.save_params(tree, str(tmp_path / "ckpt") + "/")
    assert (tmp_path / "ckpt").is_dir()
    treg.load_params(port, str(tmp_path / "ckpt") + "/")
    want = {k: v.clone() for k, v in port.state_dict().items()}
    (tmp_path / "ckpt").rename(tmp_path / "lm.v1")
    got = treg.load_params(treg.init_lm(port.cfg, seed=2, device="cpu"), tmp_path / "lm.v1")
    assert all(torch.equal(want[k], v) for k, v in got.state_dict().items())


def test_estimator_checkpoint_names_a_directory(tmp_path):
    from dewi_tpu_torch.signals import TextEntropyEstimator

    tree, _ = _ref_tree("lm")
    jreg.save_params(tree, tmp_path / "lm")
    jreg.save_params(tree, tmp_path / "lm.msgpack")
    text = "the cat sat on the mat"
    kw = dict(model_name="tiny", max_length=64, batch_size=4, device="cpu")
    from_dir = TextEntropyEstimator(checkpoint=str(tmp_path / "lm"), **kw)
    from_file = TextEntropyEstimator(checkpoint=str(tmp_path / "lm.msgpack"), **kw)
    fresh = TextEntropyEstimator(**kw)
    got = from_dir.compute_entropy(text).mean_entropy
    assert got == from_file.compute_entropy(text).mean_entropy
    assert got != fresh.compute_entropy(text).mean_entropy


@pytest.mark.parametrize("path", ["ckpt", "ckpt/", "existing_dir"])
def test_save_params_refuses_orbax_paths(tmp_path, path):
    (tmp_path / "existing_dir").mkdir()
    model = treg.init_lm(treg.lm_config("tiny"), device="cpu")
    with pytest.raises(NotImplementedError, match="msgpack") as err:
        treg.save_params(model, str(tmp_path / path))
    assert "ROADMAP.md" in str(err.value) and "slice" not in str(err.value)
    assert not (tmp_path / "ckpt").exists()


def test_train_refuses_an_orbax_checkpoint_before_the_first_step(tmp_path):
    model = treg.init_lm(treg.lm_config("tiny", max_len=64), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train_lm(model, ["some text"] * 4, steps=3, batch_size=2,
                 checkpoint=str(tmp_path / "lm_ckpt"))
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert not (tmp_path / "lm_ckpt").exists()


def test_missing_tensorstore_is_named(tmp_path, monkeypatch):
    tree, port = _ref_tree("lm")
    jreg.save_params(tree, tmp_path / "ckpt")
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore") as err:
        treg.load_params(port, tmp_path / "ckpt")
    assert "msgpack" in str(err.value)


def test_a_directory_without_metadata_is_not_a_checkpoint(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        treg.load_params(treg.init_lm(treg.lm_config("tiny"), device="cpu"), tmp_path / "empty")
