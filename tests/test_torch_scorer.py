"""The port's scorer against ``dewi_tpu.scorer`` on the same seeded inputs.

rtol 1e-6: both sides standardize in f32 with the same association; only
the last ulp of the sigmoid may differ between the two libraries.
"""

import numpy as np
import pytest
import torch

import dewi_tpu.ops.robust as jrobust
import dewi_tpu.scorer as jscorer
from dewi_tpu_torch import scorer as tscorer
from dewi_tpu_torch.ops import robust as trobust
from dewi_tpu_torch.types import SIGNAL_FIELDS, Signals, Weights, rows_to_matrix

from test_scorer import golden_fit, golden_score

RTOL = 1e-6


def _signals(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.gamma(2, 1.5, n), rng.gamma(2.5, 1.5, n), rng.gamma(2, 1, n),
                     rng.gamma(2.5, 1, n), rng.beta(2, 5, n), rng.beta(1, 4, n),
                     rng.beta(1, 9, n)], axis=1).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 49, 50, 1001, 1000])
def test_median_mad_even_and_odd(n):
    x = _signals(n, n)
    x[:, 2] = 3.0  # zero-MAD column: floored to 1e-8
    med, mad = trobust.median_mad(torch.from_numpy(x))
    jmed, jmad = jrobust.median_mad(x)
    np.testing.assert_array_equal(med.numpy(), np.asarray(jmed))
    np.testing.assert_array_equal(mad.numpy(), np.asarray(jmad))
    np.testing.assert_allclose(med.numpy(), np.median(x, axis=0), rtol=RTOL)
    assert mad[2].item() == pytest.approx(1e-8)


def test_median_averages_the_two_middle_values():
    med, _ = trobust.median_mad(torch.tensor([[1.0], [2.0], [3.0], [4.0]]))
    assert med.item() == 2.5  # torch.median would give 2.0


@pytest.mark.parametrize("mode", ["standard", "conditional"])
def test_fit_and_score_matches_jax(mode):
    x = _signals(777, 3)
    w = Weights(alpha_t=0.7, alpha_i=1.2, alpha_m=0.9, alpha_r=1.1, alpha_n=0.8)
    port = tscorer.DewiScorer(w, delta=2.5, device="cpu")
    ref = jscorer.DewiScorer(jscorer.Weights(**vars(w)), delta=2.5)
    got = port.fit_and_score(x, mode=mode)
    want = np.asarray(ref.fit_and_score(x, mode=mode))
    assert port.stats.medians == ref.stats.medians
    assert port.stats.mads == ref.stats.mads
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_scalar_score_matches_jax_and_golden(signal_rows):
    w = Weights(alpha_t=0.7, alpha_i=1.2, alpha_m=0.9, alpha_r=1.1, alpha_n=0.8)
    port = tscorer.DewiScorer(w, delta=2.5, device="cpu")
    ref = jscorer.DewiScorer(jscorer.Weights(**vars(w)), delta=2.5)
    port.fit_stats(signal_rows)
    ref.fit_stats(signal_rows)
    med, mad = golden_fit(signal_rows)
    for sig in signal_rows[:10]:
        assert port.score(sig) == pytest.approx(ref.score(sig), rel=RTOL)
        assert port.score_conditional(sig) == pytest.approx(
            ref.score_conditional(sig), rel=RTOL)
        assert port.score(sig) == pytest.approx(golden_score(sig, med, mad, w), rel=1e-5)


def test_score_batch_accepts_rows_and_signals(signal_rows):
    port = tscorer.DewiScorer(Weights(), device="cpu")
    port.fit_stats(signal_rows)
    batch = port.score_batch(signal_rows).numpy()
    mat = port.score_batch(rows_to_matrix(signal_rows, SIGNAL_FIELDS)).numpy()
    np.testing.assert_array_equal(batch, mat)
    for i, sig in enumerate(signal_rows):
        assert batch[i] == pytest.approx(port.score(sig), abs=1e-5)
    sig_objs = [Signals(**r) for r in signal_rows]
    np.testing.assert_array_equal(port.score_batch(sig_objs).numpy(), batch)


def test_clip_and_unit_interval(signal_rows):
    port = tscorer.DewiScorer(Weights(), delta=0.5, device="cpu")
    port.fit_stats(signal_rows)
    s = port.score_batch(signal_rows).numpy()
    lo, hi = 1.0 / (1.0 + np.exp(0.5)), 1.0 / (1.0 + np.exp(-0.5))
    assert np.all(s >= lo - 1e-6) and np.all(s <= hi + 1e-6)


def test_robust_stats_payload_fit_and_serde(dummy_payloads):
    port = tscorer.RobustStats.from_payloads(dummy_payloads, device="cpu")
    ref = jscorer.RobustStats.from_payloads(dummy_payloads)
    assert port.medians == ref.medians and port.mads == ref.mads
    again = tscorer.RobustStats.from_dict(port.to_dict())
    assert again.medians == port.medians and again.keys == port.keys
    with pytest.raises(ValueError):
        tscorer.RobustStats.fit([], device="cpu")


def test_unfitted_raises_and_delta_override():
    with pytest.raises(AssertionError):
        tscorer.DewiScorer(device="cpu").score({k: 0.0 for k in SIGNAL_FIELDS})
    w = Weights(delta=7.0)
    assert tscorer.DewiScorer(w, device="cpu").weights.delta == 7.0
    assert tscorer.DewiScorer(w, delta=2.0, device="cpu").weights.delta == 2.0


def test_local_weights_matches_jax():
    s = np.random.default_rng(5).gamma(2.0, 1.0, size=200).astype(np.float32)
    np.testing.assert_allclose(tscorer.local_weights_from_surprisal(s, device="cpu"),
                               jscorer.local_weights_from_surprisal(s), rtol=1e-5)


def test_quantiles_match_numpy():
    x = np.random.default_rng(6).normal(size=(5, 41)).astype(np.float32)
    qs = np.array([0.1, 0.5, 0.9], np.float32)
    got = trobust.quantiles(torch.from_numpy(x), torch.from_numpy(qs), axis=-1)
    np.testing.assert_allclose(got.numpy(), np.quantile(x, qs, axis=-1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jrobust.quantiles(x, qs, axis=-1)),
                               rtol=1e-5, atol=1e-6)


def test_scorer_without_cuda_needs_cpu_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscorer.DewiScorer()


@pytest.mark.parametrize("entry", ["RobustStats.fit_matrix", "RobustStats.from_payloads",
                                   "local_weights_from_surprisal"])
def test_stats_entry_points_without_cuda_need_cpu_device(entry, dummy_payloads):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    calls = {
        "RobustStats.fit_matrix": lambda: tscorer.RobustStats.fit_matrix(
            _signals(10, 0), SIGNAL_FIELDS),
        "RobustStats.from_payloads": lambda: tscorer.RobustStats.from_payloads(
            dummy_payloads),
        "local_weights_from_surprisal": lambda: tscorer.local_weights_from_surprisal(
            np.ones(4, np.float32)),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
