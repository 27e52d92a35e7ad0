"""The port's native runtime (``dewi_tpu_torch.native``) against the JAX
package's (``dewi_tpu.native``).

Same seeded inputs through both.  Tolerances: none.  The ``payloads.jsonl``
files are byte-identical (the port's native writer, its Python writer and
the reference's native writer); the minhash signatures equal bit for bit
(native against native, numpy against numpy); the JPEG decode pool's rows
equal the reference pool's.
"""

import json
import shutil

import numpy as np
import pytest

import dewi_tpu.native as j_native
import dewi_tpu_torch.native as t_native
from dewi_tpu.signals import redundancy as jr
from dewi_tpu_torch.signals import redundancy as tr


def _payload_matrix(n, seed):
    """Float32 payloads over many magnitudes, integral values, zeros and
    values at the float32 limits."""
    rng = np.random.default_rng(seed)
    vals = np.concatenate([
        rng.random(n * 4),
        rng.normal(size=n * 8) * 10.0 ** rng.integers(-38, 38, n * 8),
        rng.integers(-2**31, 2**31, n).astype(np.float64),
        [0.0, -0.0, 1.0, 1e-4, 1e-5, 1e20, 3.4e38, 1.4e-45, 16777217.0, 0.1, 123456789.0],
    ])
    with np.errstate(over="ignore"):
        vals = vals.astype(np.float32)
    vals = vals[np.isfinite(vals)]
    rng.shuffle(vals)
    return vals[: n * 8].reshape(n, 8)


IDS = {
    "plain": lambda n: [f"doc-{i}" for i in range(n)],
    "escaped": lambda n: [f'd{i} "q" back\\slash\ttab\x01 é 文' for i in range(n)],
    "uuid": lambda n: [f"{i:08x}-4d2e-493d-989d-50a5411bad4e" for i in range(n)],
}


@pytest.fixture(scope="module")
def port_built():
    assert t_native.available(), "the port's native library did not build"
    assert j_native.available(), "the reference's native library did not build"


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ids", sorted(IDS))
def test_jsonl_bytes_equal_three_writers(tmp_path, port_built, seed, ids):
    mat = _payload_matrix(300, seed)
    doc_ids = IDS[ids](len(mat))
    t_native.write_payloads_jsonl(tmp_path / "port.jsonl", doc_ids, mat)
    t_native._python_write(tmp_path / "python.jsonl", doc_ids, mat)
    j_native.write_payloads_jsonl(tmp_path / "ref.jsonl", doc_ids, mat)
    want = (tmp_path / "ref.jsonl").read_bytes()
    assert (tmp_path / "port.jsonl").read_bytes() == want
    assert (tmp_path / "python.jsonl").read_bytes() == want
    for line in want.decode("utf-8").splitlines():
        json.loads(line)  # every line stays valid JSON
    for reader in (t_native.read_payloads_jsonl, j_native.read_payloads_jsonl):
        got_ids, got = reader(tmp_path / "port.jsonl")
        assert got_ids == doc_ids
        np.testing.assert_array_equal(got, mat)


def test_float_text_matches_to_chars(tmp_path, port_built):
    """``float_text`` against the native writer, value by value."""
    vals = _payload_matrix(2000, 7).reshape(-1)
    mat = vals[: len(vals) // 8 * 8].reshape(-1, 8)
    t_native.write_payloads_jsonl(tmp_path / "n.jsonl", [str(i) for i in range(len(mat))], mat)
    lines = (tmp_path / "n.jsonl").read_text().splitlines()
    for line, row in zip(lines, mat):
        body = line.split('"payload": {', 1)[1].rstrip("}")
        texts = [kv.split(": ")[1] for kv in body.split(", ")]
        assert texts == [t_native.float_text(v) for v in row]


def test_newline_ids_take_the_python_codec(tmp_path, port_built):
    """An id with a newline goes through the Python writer and the Python
    reader (the native ones split ids on newlines), and round-trips."""
    mat = _payload_matrix(4, 3)
    ids = ["a\nb", "c", "d\x00e", "f"]
    t_native.write_payloads_jsonl(tmp_path / "p.jsonl", ids, mat)
    assert not t_native._native_read_safe(tmp_path / "p.jsonl")
    got_ids, got = t_native.read_payloads_jsonl(tmp_path / "p.jsonl")
    assert got_ids == ids
    np.testing.assert_array_equal(got, mat)


def test_read_tolerates_id_key_and_missing_fields(tmp_path, port_built):
    (tmp_path / "old.jsonl").write_text('{"id": "x", "payload": {"dewi": 0.5}}\n\n')
    for reader in (t_native.read_payloads_jsonl, j_native.read_payloads_jsonl):
        ids, mat = reader(tmp_path / "old.jsonl")
        assert ids == ["x"] and mat[0, 0] == 0.5 and mat[0, 1:].sum() == 0
    (tmp_path / "empty.jsonl").write_text("")
    ids, mat = t_native.read_payloads_jsonl(tmp_path / "empty.jsonl")
    assert ids == [] and mat.shape == (0, 8)


def test_index_save_writes_the_native_bytes(tmp_path, port_built):
    """``BaseIndex.save`` routes ``payloads.jsonl`` through the codec; the
    JAX package saves the same bytes and each package loads the other's."""
    from dewi_tpu import DewiIndex as JDewiIndex
    from dewi_tpu_torch import DewiIndex

    rng = np.random.default_rng(0)
    ids = [f"n{i}" for i in range(40)]
    emb = rng.normal(size=(40, 16)).astype(np.float32)
    pay = _payload_matrix(40, 5)
    port = DewiIndex(dim=16, device="cpu")
    port.add_batch(ids, emb, pay)
    port.build()
    port.save(tmp_path / "port")
    ref = JDewiIndex(dim=16)
    ref.add_batch(ids, emb, pay)
    ref.build()
    ref.save(tmp_path / "ref")
    name = "ann_index/payloads.jsonl"
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    (tmp_path / "port" / "ann_index" / "payloads.npy").unlink()  # load from the JSONL
    loaded = DewiIndex.load(tmp_path / "port", device="cpu")
    np.testing.assert_array_equal(loaded.get_payload("n3").to_array(), pay[3])
    assert JDewiIndex.load(tmp_path / "port").get_payload("n7") is not None


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    words = np.array(["Alpha", "beta", "GAMMA", "delta", "eps", "zeta", "Eta", "théta", "日本"])
    out = [" ".join(rng.choice(words, rng.integers(1, 12))) for _ in range(n)]
    out[1] = out[3]             # equal texts
    out[4] = "  ab  "           # fewer words than k: character 4-grams
    out[5] = ""                 # empty
    out[6] = "MiXeD   Case\ttabs\nnewline words here"
    return out


@pytest.mark.parametrize("seed,num_hashes,k", [(0, 64, 3), (7, 32, 2), (3, 128, 4)])
def test_native_minhash_bit_equal(port_built, seed, num_hashes, k):
    texts = _texts(60, seed)
    got = t_native.minhash_signatures_native(texts, num_hashes, seed=seed, k=k)
    want = j_native.minhash_signatures_native(texts, num_hashes, seed=seed, k=k)
    assert got is not None and got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    # minhash_signatures takes the native hasher in both packages.
    np.testing.assert_array_equal(tr.minhash_signatures(texts, num_hashes, seed=seed, k=k),
                                  jr.minhash_signatures(texts, num_hashes, seed=seed, k=k))
    np.testing.assert_array_equal(tr.minhash_signatures(texts, num_hashes, seed=seed, k=k), got)
    assert np.array_equal(got[1], got[3])


def test_numpy_minhash_bit_equal(monkeypatch):
    """With both native hashers off (``DEWI_TPU_NO_NATIVE=1`` semantics)
    both packages take the blake2b numpy path and agree."""
    monkeypatch.setattr(j_native, "minhash_signatures_native", lambda *a, **k: None)
    monkeypatch.setattr(t_native, "minhash_signatures_native", lambda *a, **k: None)
    texts = _texts(40, 11)
    np.testing.assert_array_equal(tr.minhash_signatures(texts, 64, seed=0),
                                  jr.minhash_signatures(texts, 64, seed=0))


def test_minhash_refuses_the_record_separator(port_built):
    assert t_native.minhash_signatures_native(["has \x1e separator"], 8) is None
    texts = ["has \x1e separator", "plain text here ok"]
    np.testing.assert_array_equal(tr.minhash_signatures(texts, 16),
                                  jr.minhash_signatures(texts, 16))


@pytest.mark.parametrize("text_sim", ["minhash", "simhash"])
def test_hash_redundancy_scores_equal(port_built, text_sim):
    texts = _texts(80, 4)
    port = tr.RedundancyEstimator(text_sim=text_sim, device="cpu")
    ref = jr.RedundancyEstimator(text_sim=text_sim)
    np.testing.assert_array_equal(port.score_texts(texts), ref.score_texts(texts))


def test_no_native_env(monkeypatch):
    """``DEWI_TPU_NO_NATIVE=1`` forces the Python paths, which write the
    same JSONL bytes."""
    monkeypatch.setenv("DEWI_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(t_native, "_tried", False)
    monkeypatch.setattr(t_native, "_lib", None)
    assert not t_native.available()
    assert not t_native.jpeg_pool_available()
    assert t_native.minhash_signatures_native(["a b c d"], 8) is None
    assert t_native.decode_jpeg_batch(["x.jpg"], 8) is None


# ---- JPEG decode pool ------------------------------------------------------------


def _jpegs(tmp_path, n=6):
    from PIL import Image

    rng = np.random.default_rng(9)
    paths = []
    for i in range(n):
        h, w = int(rng.integers(20, 300)), int(rng.integers(20, 300))
        base = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        img = np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR))
        img = np.clip(img + rng.integers(-20, 20, img.shape), 0, 255).astype(np.uint8)
        p = tmp_path / f"im{i}.jpg"
        Image.fromarray(img).save(p, quality=85 + i)
        paths.append(str(p))
    (tmp_path / "gray.jpg").write_bytes(b"")  # not a JPEG: the pool flags it
    return paths


@pytest.fixture
def pool():
    pytest.importorskip("PIL")
    if not t_native.jpeg_pool_available():
        pytest.skip("the port's native library was built without libjpeg here "
                    "(jpeg_pool_available() is false)")
    if not j_native.jpeg_pool_available():
        pytest.skip("the reference's native library was built without libjpeg here")


@pytest.mark.parametrize("size", [16, 48, 224])
def test_decode_pool_equals_reference_pool(tmp_path, pool, size):
    paths = _jpegs(tmp_path)
    got, ok = t_native.decode_jpeg_batch(paths + [str(tmp_path / "gray.jpg")], size, threads=3)
    want, want_ok = j_native.decode_jpeg_batch(paths + [str(tmp_path / "gray.jpg")], size,
                                               threads=2)
    np.testing.assert_array_equal(ok, want_ok)
    assert ok[:-1].all() and not ok[-1]
    np.testing.assert_array_equal(got[ok], want[ok])


def test_decode_batch_and_pack_through_the_pool(tmp_path, pool):
    """``decode_batch`` sends JPEG paths to the pool and the rest to PIL, and
    ``pack_images`` writes the same pack as the reference's."""
    from dewi_tpu.io import images as j_images
    from dewi_tpu.io import packed as j_packed
    from dewi_tpu_torch.io import images as t_images
    from dewi_tpu_torch.io import packed as t_packed

    paths = _jpegs(tmp_path)
    png = tmp_path / "x.png"
    shutil.copy(paths[0], tmp_path / "copy.jpg")
    from PIL import Image

    Image.fromarray(np.zeros((10, 12, 3), np.uint8) + 40).save(png)
    srcs = paths + [str(png), np.full((9, 9, 3), 7, np.uint8)]
    for threads in (1, 4):
        np.testing.assert_array_equal(t_images.decode_batch(srcs, 32, threads=threads),
                                      j_images.decode_batch(srcs, 32, threads=threads))
    t_meta = t_packed.pack_images(paths, 40, tmp_path / "t.npy", workers=2)
    j_meta = j_packed.pack_images(paths, 40, tmp_path / "j.npy", workers=2)
    assert t_meta == j_meta
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy"))
