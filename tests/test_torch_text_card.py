"""On the card: the long documents' windows, packed across documents into
full ``[64, 512]`` GPT-2 forwards, score each document as a call with that
document alone does, to float32 rounding (relative 1e-6).  The packed
forwards have the shape a lone document's forward has, so the card runs
the same kernels, and rows of a causal LM do not mix; yet a row's NLL on
the card moves by an ulp or two with the row's position in the batch, so
the two are not bit-equal.

GPT-2's published widths with random weights and the byte tokenizer, over
one 256-document shard at web-text lengths (a lognormal of median 1,246
bytes and sigma 1.0, 80 to 32,768 bytes: 81% of the documents take the
long route).  The test imports no JAX and skips without a card:
``python -m pytest --noconftest -m cuda tests/test_torch_text_card.py``.
"""

from statistics import NormalDist

import numpy as np
import pytest
import torch

from dewi_tpu_torch.signals import TextEntropyEstimator

N_DOCS = 256


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the GPT-2 forwards run on the card)")
    return torch.device("cuda")


def _web_text(n, seed=0):
    """``n`` documents of random lowercase words at the quantiles of the
    web-text lognormal, in a seeded order."""
    rng = np.random.default_rng(seed)
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    sizes = np.clip(np.round(np.exp(np.log(1246.0) + z)), 80, 32768).astype(int)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    out = []
    for size in rng.permutation(sizes):
        lens = 1 + rng.poisson(4.0, size // 3 + 8)
        text = letters[rng.integers(0, 26, int(lens.sum()))]
        text[np.cumsum(lens)[:-1]] = ord(" ")
        out.append(text[:size].tobytes().decode())
    return out


@pytest.mark.cuda
def test_packed_windows_equal_one_document_calls(cuda_device):
    est = TextEntropyEstimator("gpt2", device=cuda_device, batch_size=64, max_length=512)
    texts = _web_text(N_DOCS)
    n_long = sum(1 + len(t.encode()) > est.chip_len for t in texts)
    assert n_long > N_DOCS // 2
    packed = est.batch_compute_stats(texts)
    alone = [est.batch_compute_stats([t]) for t in texts]
    for col, got in enumerate(packed):
        want = np.array([a[col][0] for a in alone], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
