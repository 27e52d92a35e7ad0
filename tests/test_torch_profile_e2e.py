"""``scripts/torch_profile_e2e.py`` against the reference's ``scripts/profile_e2e.py``.

Both scripts run in this process on the same tiny inputs (64 docs of the
reference's ``make_texts`` corpus, each with one 32-px image, the ``tiny``
presets, batch 16, both pipeline paths), the port on the CPU, the
reference under ``JAX_PLATFORMS=cpu`` with its model inits jitted.  Held:

* the same metric keys, top level and per stage (the image stages and the
  upload overlap included), apart from the table of deliberate
  differences below;
* the port's object and columnar paths on the same docs:
  ``max_rel_dev_object_vs_columnar`` <= 1e-6 over every signal column
  with the models in float32 (the presets' compute dtype switched to
  float32 for the test), and DEWI within 1e-5 (its median/MAD z-scores
  magnify a 4e-8 difference in ``I_hat`` to 2.6e-6);
* the corpus: ``make_texts`` equal to the reference's; a text-only run of
  the port has no image stage.

Cost, alone under ``-n 6 --dist loadfile``: about 30 s (mostly the reference's
jit compiles).
"""

import json

import numpy as np
import pytest

from torch_reference import (jitted_reference_inits, key_diff, load_script,  # noqa: F401
                             one_torch_thread, port_presets_in_float32, run_reference)

ARGS = ["--n-docs", "64", "--model", "tiny", "--batch-size", "16"]
IMAGE_ARGS = ["--images", "--image-size", "32", "--clip-image-size", "32"]
F32_DEV = 1e-6
# reference key -> the port's name for it, and the keys the port adds
RENAMED = {"cold_s_incl_compiles": "cold_s_incl_build",
           "columnar_extrapolated_1M_min_single_chip": "columnar_extrapolated_1M_min_single_card"}
ADDED = {"card", "max_rel_dev_object_vs_columnar", "rel_dev_object_vs_columnar",
         "dewi_rel_dev_object_vs_columnar"}
DEWI_DEV = 1e-5          # DEWI's z-scores magnify the columns' float32 rounding


@pytest.fixture
def float32_presets(monkeypatch):
    port_presets_in_float32(monkeypatch)


def _port(tmp_path, extra):
    out = tmp_path / "port.json"
    assert load_script("torch_profile_e2e").main(ARGS + extra + ["--device", "cpu",
                                                                "--output", str(out)]) == 0
    return json.loads(out.read_text())


def _reference(tmp_path, monkeypatch, extra):
    out = tmp_path / "ref.json"
    with jitted_reference_inits():
        run_reference(monkeypatch, "profile_e2e", ARGS + extra + ["--output", str(out)])
    return json.loads(out.read_text())


def _check_keys(port, ref):
    only_ref, only_port = key_diff(port, ref)
    assert only_ref == sorted(RENAMED)
    assert set(only_port) == set(RENAMED.values()) | (ADDED & set(port))
    for sub in ("columnar_stage_s", "columnar_stage_host_cpu_s", "upload_overlap"):
        if sub in ref:
            assert list(port[sub]) == list(ref[sub]), sub


def test_make_texts_equals_reference():
    port, ref = load_script("torch_profile_e2e"), load_script("profile_e2e")
    assert port.WORDS == ref.WORDS
    assert port.make_texts(50, np.random.default_rng(0)) == ref.make_texts(
        50, np.random.default_rng(0))


def test_matches_reference(tmp_path, monkeypatch, float32_presets):
    port = _port(tmp_path, IMAGE_ARGS)
    ref = _reference(tmp_path, monkeypatch, IMAGE_ARGS)
    _check_keys(port, ref)
    assert port["device"] == "cpu" and port["n_docs"] == 64 and port["modality"] == "text+image"
    assert {"image_entropy", "clip_image_encode", "device_upload"} <= set(
        port["columnar_stage_s"])
    assert 0.0 <= port["upload_overlap"]["hidden_fraction"] <= 1.0
    assert port["max_rel_dev_object_vs_columnar"] <= F32_DEV, port["rel_dev_object_vs_columnar"]
    assert set(port["rel_dev_object_vs_columnar"]) == {
        "ht_mean", "ht_q90", "hi_mean", "hi_q90", "I_hat", "redundancy", "noise"}
    assert port["dewi_rel_dev_object_vs_columnar"] <= DEWI_DEV
    assert port["columnar_docs_per_sec"] > 0 and port["object_docs_per_sec"] > 0


def test_text_only_has_no_image_stage(tmp_path):
    port = _port(tmp_path, ["--skip-object"])
    assert port["modality"] == "text-only" and "upload_overlap" not in port
    assert list(port["columnar_stage_s"]) == [
        "tokenize_only", "text_entropy", "clip_text_encode", "embeddings", "redundancy",
        "noise", "score", "index_build"]
    assert "object_docs_per_sec" not in port and "max_rel_dev_object_vs_columnar" not in port
