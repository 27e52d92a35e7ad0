"""Helpers of the tests that hold the port's profilers to the reference's.

Imported by test files only (it imports JAX inside its functions): a
script loaded from its file, the reference's scripts run in process with
``DEWI_COMPILE_CACHE=0``, and the reference's model inits jitted (its
estimators build these params eagerly, about 10 s a model on the CPU; a
jitted init gives the same params).
"""

import contextlib
import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def load_script(name: str):
    """``scripts/<name>.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference(monkeypatch, name: str, argv: list):
    """The reference's ``scripts/<name>.py`` ``main()`` on ``argv``; its module."""
    monkeypatch.setenv("DEWI_COMPILE_CACHE", "0")
    monkeypatch.setattr(sys, "argv", [name] + argv)
    mod = load_script(name)
    assert mod.main() == 0
    return mod


def _jit_init(model_cls, *args):
    import jax

    def init(cfg, seed=0):
        model = model_cls(cfg)
        built = [a(cfg) if callable(a) else a for a in args]
        return model, jax.jit(lambda k: model.init(k, *built))(jax.random.PRNGKey(seed))
    return init


@contextlib.contextmanager
def jitted_reference_inits():
    """The reference estimators' ``init_lm``/``init_mae``/``init_clip``
    jitted for the duration of the block."""
    import jax
    import jax.numpy as jnp

    from dewi_tpu.models import registry as jreg
    from dewi_tpu.signals import cross_modal as j_cross
    from dewi_tpu.signals import image_entropy as j_image
    from dewi_tpu.signals import text_entropy as j_text

    inits = {
        (j_text, "init_lm"): _jit_init(jreg.CausalLM, jnp.zeros((1, 8), jnp.int32),
                                       jnp.ones((1, 8))),
        (j_cross, "init_clip"): _jit_init(
            jreg.CLIPDualEncoder, lambda c: jnp.zeros((1, c.text_len), jnp.int32),
            lambda c: jnp.ones((1, c.text_len)),
            lambda c: jnp.zeros((1, c.image_size, c.image_size, 3))),
        (j_image, "init_mae"): _jit_init(
            jreg.ViTMAE, lambda c: jnp.zeros((1, c.image_size, c.image_size, 3)),
            jax.random.PRNGKey(1)),
    }
    with pytest.MonkeyPatch.context() as mp:
        for (mod, name), fn in inits.items():
            mp.setattr(mod, name, fn)
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's tiny models while a module that
    imports this fixture runs, restored after: the test workers share the
    host's cores, and many threads each on small ops wait on one another."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_presets_in_float32(monkeypatch) -> None:
    """The port's estimators build their presets with float32 compute."""
    from dewi_tpu_torch.models import registry
    from dewi_tpu_torch.signals import cross_modal, image_entropy, text_entropy

    for mod, name in ((text_entropy, "lm_config"), (image_entropy, "mae_config"),
                      (cross_modal, "clip_config")):
        fn = getattr(registry, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _fn=fn, **kw: _fn(*a, **{**kw, "dtype": "float32"}))


def key_diff(port: dict, ref: dict) -> tuple:
    """``(keys only the reference has, keys only the port has)``."""
    return sorted(set(ref) - set(port)), sorted(set(port) - set(ref))
