"""``scripts/torch_profile_signals.py`` against the reference's ``scripts/profile_signals.py``.

Both scripts run in this process on the same tiny inputs (128 docs of the
reference's corpus, 64 images and 128 pairs at 32 px, 512 rows of dim 64
through the redundancy scan, 64-px JPEGs for the ingest rows, the ``tiny``
presets, batch 16), the port on
the CPU with its presets in float32, the reference under
``JAX_PLATFORMS=cpu`` with its model inits jitted.  Held:

* the same metric keys, apart from the deliberate differences: every
  ``*_single_chip`` is ``*_single_card``; the reference's v5e-16 budget
  keys (``budget_min_single_chip``, ``within_budget``) are dropped; the
  port adds ``card``, ``superbatch``, ``redundancy_s_exact`` and the three
  ``*_device_vs_host_max_rel_dev``;
* the redundancy scan's 1M figure is the reference's formula,
  ``s * (TARGET_N / n) ** 2``, on the time the port measured
  (``redundancy_s_exact``), with the reference's ``TARGET_N``;
* each backbone stage's device and host rows agree per doc on their shared
  batch within 1e-5 of max(|value|, 1) (float32; the host path pads the
  texts to their length buckets, the device row to 256 tokens);
* every rate is finite and positive.

Cost, alone under ``-n 6 --dist loadfile``: about 40 s (mostly the reference's
jit compiles).
"""

import json
import math

import pytest

from torch_reference import (jitted_reference_inits, key_diff, load_script,  # noqa: F401
                             one_torch_thread, port_presets_in_float32, run_reference)

ARGS = ["--n-docs", "128", "--n-images", "64", "--n-pairs", "128", "--redundancy-n", "512",
        "--model", "tiny", "--batch-size", "16", "--image-size", "32", "--dim", "64",
        "--jpeg-size", "64"]
DROPPED = {"budget_min_single_chip", "within_budget"}
ADDED = {"card", "superbatch", "redundancy_s_exact", "text_device_vs_host_max_rel_dev",
         "image_device_vs_host_max_rel_dev", "clip_device_vs_host_max_rel_dev"}
DEVICE_HOST_TOL = 1e-5


@pytest.fixture
def float32_presets(monkeypatch):
    port_presets_in_float32(monkeypatch)


def test_matches_reference(tmp_path, monkeypatch, float32_presets):
    out = tmp_path / "port.json"
    port_mod = load_script("torch_profile_signals")
    assert port_mod.main(ARGS + ["--device", "cpu", "--output", str(out)]) == 0
    port = json.loads(out.read_text())
    with jitted_reference_inits():
        ref_mod = run_reference(monkeypatch, "profile_signals",
                                ARGS + ["--output", str(tmp_path / "ref.json")])
    ref = json.loads((tmp_path / "ref.json").read_text())

    only_ref, only_port = key_diff(port, ref)
    renamed = {k for k in ref if k.endswith("_single_chip") and k not in DROPPED}
    assert set(only_ref) == renamed | DROPPED
    assert set(only_port) == {k.replace("_single_chip", "_single_card") for k in renamed} | ADDED
    assert port["device"] == "cpu" and port["superbatch"] == 8

    n = port["redundancy_n"]
    assert n == ref["redundancy_n"] == 512 and port_mod.TARGET_N == ref_mod.TARGET_N
    assert port["redundancy_1M_s_single_card"] == round(
        port["redundancy_s_exact"] * (ref_mod.TARGET_N / n) ** 2, 1)
    for stage in ("text", "image", "clip"):
        dev = port[f"{stage}_device_vs_host_max_rel_dev"]
        assert dev <= DEVICE_HOST_TOL, (stage, dev)
    for k, v in port.items():
        if k.endswith("_per_sec") or k.startswith("full_signals"):
            assert math.isfinite(v) and v > 0, k


def test_make_texts_and_skips(tmp_path):
    """The corpus is the reference's; ``--skip`` leaves a stage's keys out."""
    import numpy as np

    port = load_script("torch_profile_signals")
    rng = np.random.default_rng(0)
    ref_texts = [" ".join(rng.choice(port.WORDS, size=rng.integers(20, 60)))
                 for _ in range(20)]
    assert port.make_texts(20, np.random.default_rng(0)) == ref_texts
    assert port.WORDS == load_script("profile_signals").WORDS
    out = tmp_path / "skip.json"
    assert port.main(ARGS + ["--device", "cpu", "--skip", "text,image,clip,ingest",
                             "--output", str(out)]) == 0
    res = json.loads(out.read_text())
    assert not any(k.startswith(("text_", "image_", "clip_", "ingest_")) for k in res)
    assert res["noise_docs_per_sec"] > 0 and res["redundancy_n"] == 512
