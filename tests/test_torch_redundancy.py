"""The port's redundancy signal against ``dewi_tpu.signals.redundancy``.

Same seeded numpy inputs through both packages; the port runs on the CPU.
Tolerances: the embedding scans (``max_offdiag_similarity``,
``topk_density``) within 1e-5 absolute (cosines lie in [-1, 1]); the hash
signatures (minhash, simhash, pHash) bit for bit; the hash-mode scores and
the clusters equal.  Minhash runs the numpy path in both here (both native
hashers switched off); ``tests/test_torch_native.py`` holds the two native
hashers to each other.  One test shows that the reference's native hasher
does not agree with its numpy path bit for bit.
"""

import numpy as np
import pytest

import dewi_tpu.native as j_native
import dewi_tpu_torch.native as t_native
from dewi_tpu.signals import redundancy as jr
from dewi_tpu_torch.signals import redundancy as tr

SCAN_TOL = 1e-5


@pytest.fixture(autouse=True)
def numpy_minhash(monkeypatch):
    """The numpy minhash in both packages (``DEWI_TPU_NO_NATIVE=1``
    semantics)."""
    monkeypatch.setattr(j_native, "minhash_signatures_native", lambda *a, **k: None)
    monkeypatch.setattr(t_native, "minhash_signatures_native", lambda *a, **k: None)


def _embeddings(n, d, seed, dups=()):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    for a, b in dups:
        emb[b] = emb[a] * 3.0  # the same direction: cosine 1 after normalizing
    return emb


# (block, chunk): the defaults, a chunk smaller than the corpus that leaves a
# short last tile, and a block that does not divide N (the clamped last block).
SCAN_CASES = [(n, d, block, chunk)
              for n in (1, 2, 37, 300, 1000) for d in (16, 512)
              for block, chunk in ((4096, 65536), (16, 24), (7, 300))
              if not (n == 1000 and d == 512 and block == 7)]


@pytest.mark.parametrize("n,d,block,chunk", SCAN_CASES)
def test_max_offdiag_similarity(n, d, block, chunk):
    emb = _embeddings(n, d, seed=n + d, dups=((0, n - 1),) if n > 2 else ())
    got = tr.max_offdiag_similarity(emb, block=block, chunk=chunk, device="cpu")
    want = jr.max_offdiag_similarity(emb, block=block, chunk=chunk)
    assert got.dtype == np.float32 and got.shape == (n,)
    assert np.abs(got - want).max(initial=0.0) <= SCAN_TOL
    if n > 2:  # planted duplicates reach 1.0
        assert got[0] == pytest.approx(1.0, abs=1e-6) and got[-1] == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("n,d,block,chunk", SCAN_CASES)
def test_topk_density(n, d, block, chunk):
    emb = _embeddings(n, d, seed=2 * n + d)
    got = tr.topk_density(emb, block=block, chunk=chunk, device="cpu")
    want = jr.topk_density(emb, block=block, chunk=chunk)
    assert got.shape == (n,)
    assert np.abs(got - want).max(initial=0.0) <= SCAN_TOL


@pytest.mark.parametrize("top", [1, 3, 8, 50])
def test_topk_density_top(top):
    emb = _embeddings(60, 16, seed=top, dups=((1, 2), (1, 3)))
    got = tr.topk_density(emb, top=top, block=16, chunk=24, device="cpu")
    want = jr.topk_density(emb, top=top, block=16, chunk=24)
    assert np.abs(got - want).max() <= SCAN_TOL


def test_scan_takes_a_tensor_where_it_lies():
    import torch

    emb = _embeddings(50, 16, seed=3)
    got = tr.max_offdiag_similarity(torch.from_numpy(emb), block=8)
    assert np.abs(got - jr.max_offdiag_similarity(emb, block=8)).max() <= SCAN_TOL


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    words = ["near", "duplicate", "corpus", "entropy", "zebra", "quartz", "über", "日本"]
    out = [" ".join(rng.choice(words, size=int(rng.integers(1, 25)))) for _ in range(n)]
    out[3] = out[1]                   # exact duplicate
    out[4] = out[2] + " extra"        # near duplicate
    out[5] = ""                       # empty text
    out[6] = "ab"                     # shorter than a 4-gram
    return out


def test_signatures_bit_equal():
    texts = _texts(40, 0)
    for seed in (0, 7):
        assert np.array_equal(tr.minhash_signatures(texts, 64, seed=seed),
                              jr.minhash_signatures(texts, 64, seed=seed))
    assert np.array_equal(tr.minhash_signatures(texts, 32, k=2),
                          jr.minhash_signatures(texts, 32, k=2))
    assert np.array_equal(tr.simhash_bits(texts), jr.simhash_bits(texts))
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (s, s, 3), dtype=np.uint8) for s in (16, 32, 64, 100)]
    images.append(rng.random((40, 40, 3)).astype(np.float32))
    for im in images:
        assert int(tr.phash64(im)) == int(jr.phash64(im))


def test_native_minhash_differs_from_the_numpy_path(monkeypatch):
    """The reference's native hasher does not equal its numpy path bit for
    bit: it hashes shingles with FNV-1a (``native/dewi_native.cpp``), the
    numpy path with blake2b.  The port's numpy path (its native hasher
    switched off) differs from it the same way; both give equal signatures
    to equal texts."""
    monkeypatch.undo()
    monkeypatch.setattr(t_native, "minhash_signatures_native", lambda *a, **k: None)
    texts = _texts(40, 2)
    native = j_native.minhash_signatures_native(texts, 64, seed=0, k=3)
    if native is None:
        pytest.skip("the reference's native library is not available here")
    port = tr.minhash_signatures(texts, 64, seed=0)
    assert not np.array_equal(native, port)
    assert np.array_equal(native[1], native[3]) and np.array_equal(port[1], port[3])


@pytest.mark.parametrize("text_sim", ["minhash", "simhash"])
def test_score_texts(text_sim):
    texts = _texts(60, 3)
    port = tr.RedundancyEstimator(text_sim=text_sim, device="cpu")
    ref = jr.RedundancyEstimator(text_sim=text_sim)
    got, want = port.score_texts(texts), ref.score_texts(texts)
    assert np.array_equal(got, want)
    assert got[1] == got[3] == 1.0
    assert np.array_equal(port.score_texts(texts[:1]), ref.score_texts(texts[:1]))


def test_score_images():
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(20)]
    images[7] = images[2].copy()
    images[9] = np.clip(images[3].astype(np.int16) + 1, 0, 255).astype(np.uint8)
    port = tr.RedundancyEstimator(image_sim="phash", device="cpu")
    got = port.score_images(images)
    assert np.array_equal(got, jr.RedundancyEstimator(image_sim="phash").score_images(images))
    assert got[2] == got[7] == 1.0


def test_near_duplicate_clusters():
    texts = _texts(50, 5)
    port = tr.RedundancyEstimator(device="cpu", threshold=0.5)
    ref = jr.RedundancyEstimator(threshold=0.5)
    assert port.near_duplicate_clusters(texts=texts) == ref.near_duplicate_clusters(texts=texts)
    emb = _embeddings(70, 16, seed=5, dups=((0, 9), (9, 40), (3, 4)))
    for thr in (0.5, 0.99):
        assert port.near_duplicate_clusters(embeddings=emb, threshold=thr) == \
            ref.near_duplicate_clusters(embeddings=emb, threshold=thr)
    with pytest.raises(ValueError):
        port.near_duplicate_clusters()


def test_estimator_scores():
    emb = _embeddings(90, 32, seed=6, dups=((0, 1),))
    port = tr.RedundancyEstimator(block_size=16, device="cpu")
    ref = jr.RedundancyEstimator(block_size=16)
    assert np.abs(port.fit(emb).score() - ref.fit(emb).score()).max() <= SCAN_TOL
    assert np.abs(port.score(emb[:40]) - ref.score(emb[:40])).max() <= SCAN_TOL
    assert np.abs(port.cross_modal_density_scores(emb) -
                  ref.cross_modal_density_scores(emb)).max() <= SCAN_TOL
    with pytest.raises(ValueError):
        tr.RedundancyEstimator(device="cpu").score()


def test_cross_modal_similarity_uses_the_clip_towers():
    from dewi_tpu_torch.signals import CrossModalDependency

    clip = CrossModalDependency("tiny", device="cpu", batch_size=4)
    est = tr.RedundancyEstimator(clip=clip, device="cpu")
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    texts = ["a cat", "a dog"]
    got = est.compute_cross_modal_similarity(texts, images)
    assert got.shape == (2, 3)
    assert np.allclose(got, clip.similarity_matrix(texts, images))


def test_multi_device_refused():
    """``mesh=`` takes a ``dewi_tpu_torch.parallel`` Mesh and nothing else."""
    with pytest.raises(TypeError, match="mesh"):
        tr.RedundancyEstimator(device="cpu", mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        tr.max_offdiag_similarity_sharded(np.zeros((4, 8), np.float32), mesh=object())
