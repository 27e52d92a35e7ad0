"""The port's noise signal against ``dewi_tpu.signals.noise`` and
``dewi_tpu.ops.image_noise`` on the same seeded inputs (the port on the CPU).

Tolerances: ``batched_image_noise``'s Laplacian variance within 1e-5
relative; its skin fraction within 1e-5 relative, except that a pixel whose
YCbCr gate input lies within float32 rounding of a threshold (checked here
in float64) may fall on the other side in one package: each such pixel
allows one pixel's share (1 / 4096 at 64 px), and the test reports how many
there were.  ``NoiseEstimator.batch_compute`` equal within 1e-6, except
where a blur score lies within rounding of ``blur_threshold``, which the
test names.
"""

import numpy as np
import pytest
import torch

from dewi_tpu.ops import image_noise as j_ops
from dewi_tpu.signals import noise as j_noise
from dewi_tpu_torch.io.device_images import _resize_matrix
from dewi_tpu_torch.ops import image_noise as t_ops
from dewi_tpu_torch.signals import noise as t_noise

BLUR_RTOL = 1e-5
SKIN_RTOL = 1e-5
NOISE_TOL = 1e-6
GATE_EPS = 1e-5  # float32 rounding of the gate inputs, with a margin


def _images(n, size, seed, smooth=False):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    if smooth:  # low-contrast gradients: blur scores near the threshold
        ramp = np.linspace(90, 110, size, dtype=np.float32)
        base = ramp[None, :, None, None] + ramp[None, None, :, None] * 0.3
        imgs = np.clip(base + rng.normal(0, 0.8, (n, size, size, 3)), 0, 255).astype(np.uint8)
    # skin-toned rows so that the gate has pixels on both sides
    imgs[0, : size // 2] = (232, 166, 133)
    return imgs


def _near_gate(imgs, skin_size=64):
    """Per image, the pixels whose gate inputs lie within GATE_EPS of a
    threshold (float64, the same resize weights)."""
    x = imgs.astype(np.float64) / 255.0
    h, w = x.shape[1:3]
    if (h, w) != (skin_size, skin_size):
        my = _resize_matrix(h, skin_size).astype(np.float64)
        mx = _resize_matrix(w, skin_size).astype(np.float64)
        x = np.einsum("oh,bhwc->bowc", my, x)
        x = np.einsum("bowc,sw->bosc", x, mx)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 0.564 * (b - y) + 0.5
    cr = 0.713 * (r - y) + 0.5
    near = np.zeros(y.shape, bool)
    for v, ts in ((cb, (0.30, 0.50)), (cr, (0.52, 0.68)), (y, (0.15,))):
        for t in ts:
            near |= np.abs(v - t) <= GATE_EPS
    return near.sum(axis=(1, 2))


@pytest.mark.parametrize("size", [16, 64, 100, 224])
def test_batched_image_noise(size):
    imgs = _images(6, size, seed=size)
    blur, skin = t_ops.batched_image_noise(imgs, device="cpu")
    want_blur, want_skin = j_ops.batched_image_noise(imgs)
    assert blur.dtype == skin.dtype == np.float32 and blur.shape == (6,)
    assert np.abs(blur - want_blur).max() / np.abs(want_blur).max() <= BLUR_RTOL
    near = _near_gate(imgs)
    allowed = SKIN_RTOL * np.abs(want_skin) + near / 64**2
    assert (np.abs(skin - want_skin) <= allowed).all(), f"pixels at a gate: {near}"
    assert want_skin[0] > 0.4  # the skin-toned rows pass the gate


def test_batched_image_noise_chunks_and_tensors(monkeypatch):
    """Groups of CHUNK images, and a tensor read where it lies."""
    imgs = _images(11, 24, seed=1)
    want = j_ops.batched_image_noise(imgs)
    monkeypatch.setattr(t_ops, "CHUNK", 4)
    for src in (imgs, torch.from_numpy(imgs)):
        blur, skin = t_ops.batched_image_noise(src, device="cpu")
        assert np.abs(blur - want[0]).max() / np.abs(want[0]).max() <= BLUR_RTOL
        assert np.abs(skin - want[1]).max() <= SKIN_RTOL + _near_gate(imgs).max() / 64**2
    empty = t_ops.batched_image_noise(imgs[:0], device="cpu")
    assert empty[0].shape == empty[1].shape == (0,)


def _texts():
    return ["A perfectly normal readable sentence.", "#$%@!#$%@!#$%@!", "", None,
            "über naïve café — ünïcödé", "日本語のテキスト", "x", "  \n\t ", "12345 abcde",
            None, "mixed ascii and ü", "a" * 300]


def _flip_near_threshold(est_port, images):
    """Indices whose blur score lies within rounding of the threshold."""
    out = []
    for i, im in enumerate(images):
        if im is not None:
            b = j_noise.NoiseEstimator().blur_score(im)
            if abs(b - est_port.blur_threshold) <= 1e-5 * max(b, 1.0):
                out.append(i)
    return out


@pytest.mark.parametrize("nsfw_filter", ["lite", "none"])
def test_batch_compute_per_doc_list(nsfw_filter):
    """Mixed text/image/None documents: the device-batched image path (uint8
    arrays grouped by shape) and the vectorized text path."""
    rng = np.random.default_rng(2)
    texts = _texts()
    images = [None] * len(texts)
    for i in (0, 1, 3, 5, 8):
        images[i] = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    for i in (2, 9):
        images[i] = _images(1, 48, seed=i, smooth=True)[0]
    port = t_noise.NoiseEstimator(nsfw_filter=nsfw_filter, device="cpu")
    ref = j_noise.NoiseEstimator(nsfw_filter=nsfw_filter)
    got = np.array(port.batch_compute(texts=texts, images=images))
    want = np.array(ref.batch_compute(texts=texts, images=images))
    flips = _flip_near_threshold(port, images)
    keep = [i for i in range(len(texts)) if i not in flips]
    assert np.abs(got[keep] - want[keep]).max() <= NOISE_TOL, f"near the threshold: {flips}"


def test_batch_compute_array_path():
    """One ``[N, H, W, 3]`` array with ``present``, as a host array and as a
    tensor (the device-resident corpus)."""
    texts = _texts()
    imgs = _images(len(texts), 40, seed=3)
    present = np.arange(len(texts)) % 3 != 1
    ref = j_noise.NoiseEstimator()
    want = np.array(ref.batch_compute(texts=texts, images=imgs, present=present))
    port = t_noise.NoiseEstimator(device="cpu")
    seen = []
    for src in (imgs, torch.from_numpy(imgs)):
        got = np.array(port.batch_compute(texts=texts, images=src, present=present,
                                          progress=seen.append))
        assert np.abs(got - want).max() <= NOISE_TOL
    assert seen == [len(texts)] * 2


def test_batch_compute_text_only_and_scalar_fallback():
    texts = _texts()
    port = t_noise.NoiseEstimator(device="cpu")
    ref = j_noise.NoiseEstimator()
    assert np.abs(np.array(port.batch_compute(texts=texts)) -
                  np.array(ref.batch_compute(texts=texts))).max() <= NOISE_TOL
    # An injected classifier makes the image path per-document (scalar).
    rng = np.random.default_rng(4)
    images = [rng.random((20, 20, 3)).astype(np.float32) if i % 2 else None
              for i in range(len(texts))]
    fn = lambda im: float(np.asarray(im).mean())  # noqa: E731
    port = t_noise.NoiseEstimator(nsfw_fn=fn, device="cpu")
    ref = j_noise.NoiseEstimator(nsfw_fn=fn)
    seen = []
    got = np.array(port.batch_compute(texts=texts, images=images, progress=seen.append))
    want = np.array(ref.batch_compute(texts=texts, images=images))
    assert np.abs(got - want).max() <= NOISE_TOL
    assert sum(seen) == len(texts)
    # Images the batched path does not take (float, larger than BLUR_SIZE).
    big = [rng.integers(0, 256, (240, 230, 3), dtype=np.uint8), None]
    assert np.abs(np.array(t_noise.NoiseEstimator(device="cpu").batch_compute(
        texts=["ok", "fine"], images=big)) - np.array(j_noise.NoiseEstimator().batch_compute(
            texts=["ok", "fine"], images=big))).max() <= NOISE_TOL


def test_scalar_heuristics():
    port = t_noise.NoiseEstimator(device="cpu")
    ref = j_noise.NoiseEstimator()
    for t in _texts():
        if t is not None:
            assert port.check_text_quality(t) == ref.check_text_quality(t)
            assert port.check_language(t) == ref.check_language(t)
            assert port.score(text=t) == pytest.approx(ref.score(text=t), abs=NOISE_TOL)
    rng = np.random.default_rng(5)
    for im in (rng.random((64, 64, 3)).astype(np.float32),
               rng.integers(0, 256, (30, 50, 3), dtype=np.uint8)):
        assert port.blur_score(im) == pytest.approx(ref.blur_score(im), rel=1e-6)
        assert t_noise.skin_fraction_risk(im) == j_noise.skin_fraction_risk(im)
        assert port.score(text="hi there", image=im) == pytest.approx(
            ref.score(text="hi there", image=im), abs=NOISE_TOL)
    assert t_noise.BLUR_SIZE == j_noise.BLUR_SIZE
    assert port.score() == 0.0


def test_optional_dependencies_absent_here():
    """Without ``langdetect`` the language term is 0.5; without
    ``pytesseract`` there is no OCR penalty."""
    port = t_noise.NoiseEstimator(device="cpu")
    if port._lang_detect is None:
        assert port.check_language("an english sentence") == 0.5
    if port.ocr is None:
        assert port.ocr_text(np.zeros((4, 4, 3))) == ""
        assert port.ocr_coverage_penalty(np.zeros((4, 4, 3))) == 0.0


def test_estimator_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_noise.NoiseEstimator()
