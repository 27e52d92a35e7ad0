"""Redundancy: embedding-space near duplicates and hash-based dedup.

Counterpart of ``dewi_tpu/signals/redundancy.py``:

* :func:`max_offdiag_similarity` — a document's redundancy is its largest
  cosine to any *other* document.  Rows go in blocks of ``block``; each
  block scans the corpus in ``chunk``-column tiles with a running max, so
  peak memory is ``block * chunk`` float32, never ``block * N``.  The
  products are plain float32 matmuls (TF32 is off, see the package), and
  every block's result stays on the device until one copy at the end.
* :func:`topk_density` — the same scan with a running top-``top`` merge:
  the mean cosine to the ``top`` nearest other documents.
* the host part — minhash, simhash and pHash signatures, LSH banding and
  union-find clusters — copied from the reference.  Minhash takes the
  port's native shingle hasher (FNV-1a, :mod:`dewi_tpu_torch.native`) when
  its library is built, and the numpy path (blake2b) otherwise or under
  ``DEWI_TPU_NO_NATIVE=1``: the reference's own rule, so the port agrees
  with the reference in either state (the two paths do not agree with each
  other bit for bit).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import check_mesh, mesh_device
from ..utils.device import DeviceLike, resolve_device

# ---------------------------------------------------------------------------
# Embedding-space redundancy (device path)
# ---------------------------------------------------------------------------


def _normalized(embeddings: Any, device: DeviceLike) -> torch.Tensor:
    """Rows as float32 unit vectors: an array on ``device`` (``None``: the
    card), a tensor on its own device unless ``device`` names another."""
    if isinstance(embeddings, torch.Tensor):
        dev = embeddings.device if device is None else resolve_device(device)
        emb = embeddings.to(device=dev, dtype=torch.float32)
    else:
        emb = torch.as_tensor(np.asarray(embeddings, np.float32), device=resolve_device(device))
    return emb / emb.norm(dim=1, keepdim=True).clamp_min(1e-12)


def _block_starts(n: int, block: int) -> List[int]:
    """First rows of the scan's row blocks: the last one is clamped to end
    at N (its overlapping rows are recomputed, with the same values)."""
    return [min(start, n - block) for start in range(0, n, block)]


def _scan_blocks(emb: torch.Tensor, starts: Sequence[int], block: int, chunk: int,
                 reduce: Any, init: Any, finish: Any) -> torch.Tensor:
    """``[len(starts), block]``: the row blocks at ``starts`` against the
    whole corpus in ``chunk``-column tiles, ``state = reduce(state, sim)``
    per tile from ``init(block)``, with a row's own column at -inf;
    ``finish(state)`` gives a block's values.  The last tile ends at N, so
    no padded column exists to mask."""
    n = emb.shape[0]
    out = torch.empty((len(starts), block), dtype=torch.float32, device=emb.device)
    for j, s in enumerate(starts):
        rows = emb[s:s + block]
        state = init(block)
        for c0 in range(0, n, chunk):
            sim = rows @ emb[c0:c0 + chunk].T
            # Row i's own column s + i sits on the diagonal at offset s - c0.
            torch.diagonal(sim, offset=s - c0).fill_(-torch.inf)
            state = reduce(state, sim)
        out[j] = finish(state)
    return out


def _place(n: int, starts: Sequence[int], vals: torch.Tensor) -> np.ndarray:
    """The blocks' values written at their rows in order (a later block
    overwrites the rows it shares with the one before)."""
    out = torch.empty(n, dtype=torch.float32, device=vals.device)
    for s, v in zip(starts, vals):
        out[s:s + v.shape[0]] = v
    return out.cpu().numpy()


def _scan(emb: torch.Tensor, block: int, chunk: int, reduce: Any, init: Any,
          finish: Any) -> np.ndarray:
    """Every row block of ``emb`` scanned (:func:`_scan_blocks`), as ``[N]``."""
    starts = _block_starts(emb.shape[0], block)
    return _place(emb.shape[0], starts,
                  _scan_blocks(emb, starts, block, chunk, reduce, init, finish))


def _sizes(n: int, block: int, chunk: int) -> tuple:
    """The reference's block and chunk rule."""
    block = min(block, n)
    return block, min(chunk, max(block, 256))


def max_offdiag_similarity(embeddings: Any, block: int = 4096, chunk: int = 65536,
                           device: DeviceLike = None) -> np.ndarray:
    """Per-row max cosine similarity to any *other* row, clipped to [-1, 1].

    ``embeddings``: an ``[N, D]`` array or tensor; an array goes to
    ``device`` (``None``: the card), a tensor stays where it is."""
    emb = _normalized(embeddings, device)
    n = emb.shape[0]
    if n < 2:
        return np.zeros(n, dtype=np.float32)
    block, chunk = _sizes(n, block, chunk)
    return _scan(emb, block, chunk, *_running_max(emb.device))


def _running_max(device: torch.device) -> tuple:
    """``(reduce, init, finish)`` of the max off-diagonal scan."""
    return (lambda best, sim: torch.maximum(best, sim.amax(dim=1)),
            lambda b: torch.full((b,), -torch.inf, device=device),
            lambda best: best.clamp(-1.0, 1.0))


def topk_density(embeddings: Any, top: int = 8, block: int = 4096, chunk: int = 65536,
                 device: DeviceLike = None) -> np.ndarray:
    """Per-row mean cosine to its ``top`` nearest other rows."""
    emb = _normalized(embeddings, device)
    n = emb.shape[0]
    if n < 2:
        return np.zeros(n, dtype=np.float32)
    top = min(int(top), n - 1)
    block, chunk = _sizes(n, block, chunk)

    def merge(best: torch.Tensor, sim: torch.Tensor) -> torch.Tensor:
        # The top of (best | tile) is the top of (best | the tile's own top):
        # no [block, chunk + top] concatenation.
        cand = sim.topk(min(top, sim.shape[1]), dim=1).values
        return torch.cat([best, cand], dim=1).topk(top, dim=1).values

    def finish(best: torch.Tensor) -> torch.Tensor:
        finite = torch.isfinite(best)
        cnt = finite.sum(dim=1).clamp_min(1)
        vals = torch.where(finite, best.clamp(-1.0, 1.0), torch.zeros_like(best))
        return vals.sum(dim=1) / cnt

    return _scan(emb, block, chunk, reduce=merge,
                 init=lambda b: torch.full((b, top), -torch.inf, device=emb.device),
                 finish=finish)


def max_offdiag_similarity_sharded(embeddings: Any, mesh: Any, block: int = 4096,
                                   chunk: int = 65536) -> np.ndarray:
    """Mesh-sharded :func:`max_offdiag_similarity` (the O(N^2) stage).

    Every rank holds the whole normalized corpus (on the mesh's device) and
    scans its contiguous share of the single-device scan's row blocks
    against all columns, so the N^2 products split evenly over the data
    axis with no collective on the compute path; one all-gather of the
    block maxima gives every rank the ``[N]`` result.  The blocks and
    tiles are the single-device scan's, so the values are the same.
    """
    mesh = check_mesh(mesh)
    emb = _normalized(embeddings, mesh.device)
    n = emb.shape[0]
    if n < 2:
        return np.zeros(n, dtype=np.float32)
    block, chunk = _sizes(n, block, chunk)
    starts = _block_starts(n, block)
    per = -(-len(starts) // mesh.n_data)
    mine = starts[mesh.data_index * per:(mesh.data_index + 1) * per]
    vals = torch.zeros((per, block), dtype=torch.float32, device=emb.device)
    if mine:
        vals[:len(mine)] = _scan_blocks(emb, mine, block, chunk, *_running_max(emb.device))
    vals = mesh.all_gather(vals)  # [n_data * per, block], rank order
    return _place(n, starts, vals[:len(starts)])


# ---------------------------------------------------------------------------
# Hash-based text dedup (host path)
# ---------------------------------------------------------------------------

_MERSENNE = np.uint64((1 << 61) - 1)


def _shingles(text: str, k: int = 3) -> np.ndarray:
    """Word k-shingle hashes as uint64 (char 4-grams for short texts)."""
    words = text.lower().split()
    if len(words) >= k:
        grams = [" ".join(words[i : i + k]) for i in range(len(words) - k + 1)]
    else:
        t = text.lower()
        grams = [t[i : i + 4] for i in range(max(1, len(t) - 3))]
    return np.unique(np.array(
        [
            int.from_bytes(hashlib.blake2b(g.encode(), digest_size=8).digest(), "little")
            for g in grams
        ],
        dtype=np.uint64,
    ))


def minhash_signatures(
    texts: Sequence[str], num_hashes: int = 64, seed: int = 0, k: int = 3
) -> np.ndarray:
    """``[N, H]`` uint64 minhash signatures (universal hashing a*x+b mod p).

    The native shingle hasher when its library is available, else the numpy
    path below (the reference's rule at ``dewi_tpu/signals/redundancy.py``).
    """
    from ..native import minhash_signatures_native

    native = minhash_signatures_native(texts, num_hashes, seed=seed, k=k)
    if native is not None:
        return native
    rng = np.random.default_rng(seed)
    a = rng.integers(1, int(_MERSENNE), size=num_hashes, dtype=np.uint64)
    b = rng.integers(0, int(_MERSENNE), size=num_hashes, dtype=np.uint64)
    sigs = np.full((len(texts), num_hashes), np.iinfo(np.uint64).max, np.uint64)
    for i, t in enumerate(texts):
        sh = _shingles(t, k)
        if sh.size == 0:
            continue
        # (a*x + b) mod p for every (hash, shingle) pair, min over shingles.
        prod = (sh[None, :] * a[:, None] + b[:, None]) % _MERSENNE
        sigs[i] = prod.min(axis=1)
    return sigs


_DCT32 = None


def _dct_matrix(n: int = 32) -> np.ndarray:
    global _DCT32
    if _DCT32 is None:
        i = np.arange(n)
        _DCT32 = np.sqrt(2.0 / n) * np.cos(
            np.pi * (2 * i[None, :] + 1) * i[:, None] / (2 * n)
        )
        _DCT32[0] /= np.sqrt(2.0)
    return _DCT32


def phash64(image: Any, hash_size: int = 8) -> np.uint64:
    """DCT-based 64-bit perceptual hash: 32x32 luma -> 2D DCT-II -> top-left
    8x8 low-frequency block (DC excluded from the median) -> bit i =
    coef_i > median."""
    from .image_entropy import to_image_array

    arr = to_image_array(image, 32)
    luma = 0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
    d = _dct_matrix(32)
    coefs = d @ luma @ d.T
    block = coefs[:hash_size, :hash_size].ravel()
    med = np.median(block[1:])  # exclude DC
    bits = block > med
    out = np.uint64(0)
    for i, b in enumerate(bits):
        if b:
            out |= np.uint64(1) << np.uint64(i)
    return out


def phash_similarity(a: np.uint64, b: np.uint64, bits: int = 64) -> float:
    """1 - normalized Hamming distance of two perceptual hashes."""
    return 1.0 - bin(int(a) ^ int(b)).count("1") / bits


def simhash_bits(texts: Sequence[str], bits: int = 64, k: int = 3) -> np.ndarray:
    """``[N]`` uint64 simhash fingerprints over shingle hashes."""
    out = np.zeros(len(texts), dtype=np.uint64)
    weights = np.array([1 << i for i in range(bits)], dtype=np.uint64)
    for i, t in enumerate(texts):
        sh = _shingles(t, k)
        if sh.size == 0:
            continue
        bitmat = ((sh[:, None] >> np.arange(bits, dtype=np.uint64)[None, :]) & 1)
        counts = bitmat.sum(axis=0)
        majority = counts * 2 >= sh.size
        out[i] = np.sum(weights[majority], dtype=np.uint64)
    return out


def _lsh_candidate_pairs(sigs: np.ndarray, bands: int = 16) -> List[tuple]:
    """Candidate near-dup pairs by banding the signature matrix."""
    n, h = sigs.shape
    rows = h // bands
    buckets: Dict[bytes, List[int]] = {}
    for band in range(bands):
        chunk = sigs[:, band * rows : (band + 1) * rows]
        for i in range(n):
            key = bytes([band]) + chunk[i].tobytes()
            buckets.setdefault(key, []).append(i)
    pairs = set()
    for members in buckets.values():
        if len(members) < 2:
            continue
        for ai in range(len(members)):
            for bi in range(ai + 1, len(members)):
                pairs.add((members[ai], members[bi]))
    return sorted(pairs)


class _UnionFind:
    def __init__(self, n: int) -> None:
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def _band16(fps: np.ndarray) -> np.ndarray:
    """A 64-bit fingerprint as 4 x 16-bit LSH keys."""
    return np.stack(
        [(fps >> np.uint64(16 * i)) & np.uint64(0xFFFF) for i in range(4)], axis=1,
    ).astype(np.uint64)


# ---------------------------------------------------------------------------
# Estimator
# ---------------------------------------------------------------------------


class RedundancyEstimator:
    """Per-document redundancy: embedding scan, hash modes, clusters.

    ``device=None`` runs the embedding scans on the card (raising without
    one), or on the mesh's device under ``mesh=``; a mesh of more than one
    data rank splits the max off-diagonal scan over them
    (:func:`max_offdiag_similarity_sharded`).
    """

    def __init__(
        self,
        model_name: str = "small",
        device: DeviceLike = None,
        text_sim: str = "embedding",
        image_sim: str = "embedding",
        cross_modal_density: bool = True,
        block_size: int = 4096,
        threshold: float = 0.9,
        num_hashes: int = 64,
        clip: Optional[object] = None,  # a shared CrossModalDependency
        seed: int = 0,
        mesh: Any = None,
    ) -> None:
        self.mesh = check_mesh(mesh) if mesh is not None else None
        self.device = mesh_device(self.mesh, device)
        self.text_sim = text_sim
        self.image_sim = image_sim
        self.cross_modal_density = bool(cross_modal_density)
        self.block_size = int(block_size)
        self.threshold = float(threshold)
        self.num_hashes = int(num_hashes)
        self.seed = int(seed)
        self._clip = clip
        self._model_name = model_name
        self._embeddings: Optional[np.ndarray] = None
        self._scores: Optional[np.ndarray] = None

    def _get_clip(self) -> Any:
        if self._clip is None:
            from .cross_modal import CrossModalDependency

            self._clip = CrossModalDependency(model_name=self._model_name, seed=self.seed,
                                              device=self.device)
        return self._clip

    def compute_cross_modal_similarity(self, texts: Sequence[str],
                                       images: Sequence) -> np.ndarray:
        """``[N, M]`` text x image cosine matrix from the CLIP towers."""
        return self._get_clip().similarity_matrix(texts, images)

    def fit(self, embeddings: np.ndarray) -> "RedundancyEstimator":
        """Register corpus embeddings for redundancy scoring."""
        self._embeddings = np.asarray(embeddings, dtype=np.float32)
        self._scores = None
        return self

    def score(self, embeddings: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-doc redundancy in [-1, 1]: max off-diagonal cosine similarity."""
        emb = self._embeddings if embeddings is None else embeddings
        if emb is None:
            raise ValueError("Call fit(embeddings) or pass embeddings")
        if self._scores is None or embeddings is not None:
            if self.mesh is not None and self.mesh.n_data > 1:
                scores = max_offdiag_similarity_sharded(emb, self.mesh, block=self.block_size)
            else:
                scores = max_offdiag_similarity(emb, block=self.block_size, device=self.device)
            if embeddings is None:
                self._scores = scores
            return scores
        return self._scores

    def cross_modal_density_scores(self, embeddings: np.ndarray, top: int = 8) -> np.ndarray:
        """Neighbourhood density in the joint text+image embedding space: each
        multimodal doc's mean cosine to its ``top`` nearest joint neighbours."""
        return topk_density(embeddings, top=top, block=self.block_size, device=self.device)

    def score_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Hash-mode per-doc redundancy (estimated max Jaccard / simhash sim)."""
        n = len(texts)
        out = np.zeros(n, dtype=np.float32)
        if n < 2:
            return out
        if self.text_sim == "simhash":
            fps = simhash_bits(texts)
            for a, b in _lsh_candidate_pairs(_band16(fps), bands=4):
                sim = 1.0 - bin(int(fps[a]) ^ int(fps[b])).count("1") / 64.0
                out[a] = max(out[a], sim)
                out[b] = max(out[b], sim)
        else:  # minhash (default hash mode)
            sigs = minhash_signatures(texts, self.num_hashes, seed=self.seed)
            for a, b in _lsh_candidate_pairs(sigs, bands=16):
                sim = float(np.mean(sigs[a] == sigs[b]))
                out[a] = max(out[a], sim)
                out[b] = max(out[b], sim)
        return out

    def score_images(self, images: Sequence) -> np.ndarray:
        """Per-image redundancy by perceptual hash (``image_sim: "phash"``):
        each image's max hash similarity to any LSH candidate."""
        n = len(images)
        out = np.zeros(n, dtype=np.float32)
        if n < 2:
            return out
        fps = np.array([phash64(im) for im in images], dtype=np.uint64)
        for a, b in _lsh_candidate_pairs(_band16(fps), bands=4):
            sim = phash_similarity(fps[a], fps[b])
            out[a] = max(out[a], sim)
            out[b] = max(out[b], sim)
        return out

    def near_duplicate_clusters(self, texts: Optional[Sequence[str]] = None,
                                embeddings: Optional[np.ndarray] = None,
                                threshold: Optional[float] = None) -> List[List[int]]:
        """Union-find clusters of near-duplicates above ``threshold`` (by
        minhash over ``texts``, or by cosine over ``embeddings`` on the host)."""
        thr = self.threshold if threshold is None else float(threshold)
        if texts is not None:
            sigs = minhash_signatures(texts, self.num_hashes, seed=self.seed)
            pairs = [
                (a, b)
                for a, b in _lsh_candidate_pairs(sigs, bands=16)
                if float(np.mean(sigs[a] == sigs[b])) >= thr
            ]
            n = len(texts)
        elif embeddings is not None:
            emb = np.asarray(embeddings, dtype=np.float32)
            emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
            n = len(emb)
            pairs = []
            for s in range(0, n, self.block_size):
                blockrows = emb[s : s + self.block_size]
                sim = blockrows @ emb.T
                for i in range(len(blockrows)):
                    sim[i, s + i] = -1.0
                hits = np.argwhere(sim >= thr)
                pairs.extend((s + int(i), int(j)) for i, j in hits)
        else:
            raise ValueError("Provide texts or embeddings")
        uf = _UnionFind(n)
        for a, b in pairs:
            uf.union(a, b)
        clusters: Dict[int, List[int]] = {}
        for i in range(n):
            clusters.setdefault(uf.find(i), []).append(i)
        return sorted(clusters.values())


__all__ = [
    "RedundancyEstimator",
    "max_offdiag_similarity",
    "max_offdiag_similarity_sharded",
    "topk_density",
    "minhash_signatures",
    "simhash_bits",
    "phash64",
    "phash_similarity",
]
