"""Text entropy (token surprisal) from a causal LM.

Counterpart of ``dewi_tpu/signals/text_entropy.py``, with the same results
and options: documents are grouped into power-of-two length buckets, padded
to ``[batch_size, bucket]`` and scored in one forward + gather NLL + masked
mean/quantiles per batch; documents longer than the model's context are
scored over overlapping windows; domain-relative mode subtracts a second
LM's NLL.  ``batch_compute_stats`` keeps every batch's aggregates on the
device and copies them to the host once, at the end.

Under a ``mesh`` each batch runs data-parallel (``parallel.DataParallel``):
every rank tokenizes and buckets the whole batch, runs the forward on its
slice of the rows, and the per-token NLL is gathered back into the whole
batch before the aggregates, so every rank ends with every document's
values.

Documents longer than ``chip_len`` (default: the model's ``max_len``) take
the long-document path.  Under a ``ring_mesh`` one that fits the model's
positions is scored whole in one ring-attention forward over the mesh's
model axis (``parallel.ring``); the rest are scored over overlapping windows
of ``chip_len``, packed across documents into full batches.  The ring path
gathers only the ``[1, T]`` NLL, never the ``[1, T, V]`` logits.  Under a
``ring_mesh`` the estimator is collective: every rank of the mesh calls it
with the same texts and gets the same results.

``model_name`` is a GPT-2-style preset (``models.registry.LM_PRESETS``,
the vocabulary the tokenizer's) or a Moonlight preset
(``models.moonlight.MOONLIGHT_PRESETS``: its own vocabulary, which must hold
the tokenizer's ids; built on the device in its own dtype; the model
returns the NLL itself, from a head computed in token chunks).  A model
that declares ``packs_sequences`` (Moonlight) takes the packed route
without a data-parallel ``mesh``: every document of at most ``chip_len``
tokens and every window of the longer ones is one sequence of flat
forwards that carry no padding (``_compute_packed``); the buckets and the
window rows above are the other models' route.

While a ``torch.profiler`` session records, the estimator names its stages
(``dewi.text_entropy.long``, ``.buckets``, ``.packed``, ``.fetch``) and
counts the forwards, the token slots they carry, the real tokens among
them, the causal (query, key) pairs of the real tokens (a sequence's
alone on the packed route), the sequences a packed forward carries, the
long documents' windows and the forwards that carry them (``text.*``;
``utils.profiling.trace_stats``); at each ``.fetch`` it adds the counts a
model summed on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.import_hf import sidecar_config
from ..models.lm import token_nll
from ..models.moonlight import MOONLIGHT_PRESETS, init_moonlight, moonlight_config
from ..models.registry import init_lm, lm_config, maybe_load
from ..models.transformer import TransformerConfig
from ..ops.robust import masked_mean_and_quantiles
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, broadcast, check_mesh, mesh_device
from ..parallel.ring import ring_token_nll
from ..parallel.signals import DataParallel
from ..utils.device import DeviceLike
from ..utils.profiling import count, span, tracing
from .tokenizer import bucket_length, get_tokenizer


@dataclass
class TextEntropyResult:
    """Per-document surprisal record."""

    token_entropies: List[float]
    mean_entropy: float
    q90_entropy: float
    q99_entropy: float

    def to_dict(self) -> Dict[str, object]:
        """The pipeline-facing dict view."""
        return {
            "mean": self.mean_entropy,
            "quantiles": {0.9: self.q90_entropy, 0.99: self.q99_entropy},
            "token_entropies": self.token_entropies,
        }


def _result_from_stream(arr: np.ndarray) -> TextEntropyResult:
    if arr.size == 0:
        return TextEntropyResult([], 0.0, 0.0, 0.0)
    return TextEntropyResult(
        token_entropies=arr.tolist(),
        mean_entropy=float(arr.mean()),
        q90_entropy=float(np.quantile(arr, 0.9)),
        q99_entropy=float(np.quantile(arr, 0.99)),
    )


def plan_forwards(lens: np.ndarray, cap: int) -> List[slice]:
    """Cut sequences of ``lens`` tokens (each at most ``cap``), in their
    order, into the fewest forwards of at most ``cap`` tokens that hold
    them, each cut at the sequence boundary nearest an equal share of the
    tokens."""
    ends = np.cumsum(lens)
    total = int(ends[-1]) if len(ends) else 0
    k = max(-(-total // cap), 1)
    while True:
        cuts = [0]
        for j in range(1, k):
            cuts.append(max(int(np.abs(ends - total * j / k).argmin()) + 1, cuts[-1]))
        cuts.append(len(lens))
        parts = [slice(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]
        if all(int(lens[p].sum()) <= cap for p in parts):
            return parts
        k += 1


class TextEntropyEstimator:
    """LM token-NLL estimator with bucketed batch inference.

    ``device=None`` runs on the card (raising without one), or on the
    mesh's device under ``mesh=`` (or ``ring_mesh=``), where the batch size
    rounds up to a multiple of the data axis and the weights are the first
    rank's.  ``chip_len`` (at most the model's ``max_len``) is the longest
    document one forward scores; with ``ring_mesh`` a longer one that fits
    ``max_len`` is scored exactly over the ring, else over windows.
    """

    def __init__(
        self,
        model_name: str = "small",
        device: DeviceLike = None,
        domain_model_name: Optional[str] = None,
        quantiles: Sequence[float] = (0.9, 0.99),
        batch_size: int = 64,
        max_length: int = 512,
        tokenizer: Any = "byte",
        checkpoint: Optional[str] = None,
        domain_checkpoint: Optional[str] = None,
        seed: int = 0,
        ring_mesh: Any = None,
        chip_len: Optional[int] = None,
        mesh: Any = None,
    ) -> None:
        self.ring_mesh = check_mesh(ring_mesh) if ring_mesh is not None else None
        if mesh is None and self.ring_mesh is not None:
            device = mesh_device(self.ring_mesh, device)
        self._dp = DataParallel(mesh, device)
        self.device = self._dp.device
        self.quantiles = tuple(float(q) for q in quantiles)
        self.batch_size = self._dp.round_batch(batch_size)
        self.tokenizer = get_tokenizer(tokenizer)
        side = sidecar_config(checkpoint)
        moonlight = model_name in MOONLIGHT_PRESETS
        if moonlight:
            if checkpoint or domain_model_name or domain_checkpoint or ring_mesh is not None:
                raise ValueError(f"text model {model_name!r} is built from its seed alone: "
                                 "no checkpoint, domain model or ring mesh")
            cfg = moonlight_config(model_name, max_len=int(max_length))
            if self.tokenizer.vocab_size > cfg.vocab_size:
                raise ValueError(
                    f"tokenizer {tokenizer!r} has {self.tokenizer.vocab_size} ids; "
                    f"{model_name!r} embeds {cfg.vocab_size}")
        elif side is not None:
            cfg = TransformerConfig(**side["config"])
            if cfg.vocab_size != self.tokenizer.vocab_size:
                # A forward over the wrong tokenizer returns meaningless
                # surprisal with no other symptom: refuse.
                raise ValueError(
                    f"Checkpoint {checkpoint!r} expects a "
                    f"{cfg.vocab_size}-token vocabulary but tokenizer "
                    f"{tokenizer!r} has {self.tokenizer.vocab_size}. "
                    f"Configure the matching tokenizer (e.g. text.tokenizer"
                    f": gpt2 for an imported GPT-2 checkpoint)."
                )
        else:
            cfg = lm_config(model_name, vocab_size=self.tokenizer.vocab_size)
            if max_length != cfg.max_len:
                cfg = lm_config(model_name, vocab_size=self.tokenizer.vocab_size,
                                max_len=int(max_length))
        self.cfg = cfg
        self.chip_len = min(int(chip_len or cfg.max_len), cfg.max_len)
        if moonlight:
            self.model = init_moonlight(cfg, seed=seed, device=self.device)
        else:
            self.model = maybe_load(init_lm(cfg, seed=seed, device=self.device), checkpoint)
        self.domain_model = None
        if domain_model_name or domain_checkpoint:
            self.domain_cfg = lm_config(domain_model_name or model_name,
                                        vocab_size=self.tokenizer.vocab_size,
                                        max_len=cfg.max_len)
            self.domain_model = maybe_load(
                init_lm(self.domain_cfg, seed=seed + 1, device=self.device),
                domain_checkpoint)
        for m in (self.model, self.domain_model):
            if m is not None:
                self._dp.replicate(m)
                if self.ring_mesh is not None:
                    self._ring_replicate(m)
        self._qs = torch.tensor(self.quantiles, dtype=torch.float32, device=self.device)
        # A model that scores a flat stream of sequences takes the packed
        # route (one card, no data-parallel mesh); the others the buckets.
        self._packs = bool(getattr(self.model, "packs_sequences", False)) and mesh is None

    def _ring_replicate(self, module: torch.nn.Module) -> None:
        """Give ``module`` the first rank's weights on every rank of the
        ring mesh (the ring forward needs one model on the whole axis)."""
        with torch.no_grad():
            for t in module.state_dict().values():
                for axis in (MODEL_AXIS, DATA_AXIS):
                    broadcast(t, self.ring_mesh.group(axis))

    # -- scoring --------------------------------------------------------------

    @torch.no_grad()
    def _score(self, ids: np.ndarray, mask: np.ndarray, use_domain: bool) -> tuple:
        """``(nll, valid)`` of one padded batch, on the device (under a
        mesh: this rank's rows forward, the NLL gathered back)."""
        if tracing():
            lens = mask.sum(1).astype(np.int64)
            count("text.forwards")
            count("text.token_slots", ids.size)
            count("text.tokens", int(lens.sum()))
            count("text.attention_pairs", int((lens * (lens + 1) // 2).sum()))
        ids_t, mask_t = self._dp.put(ids).long(), self._dp.put(mask)
        pad_id = int(self.tokenizer.pad_id)
        if pad_id >= self.cfg.vocab_size:
            # HF adapters pad with an out-of-vocab sentinel (vocab_size), as
            # in the reference: zero it before the embedding gather.  Pad
            # positions are attention- and loss-masked, so outputs are the same.
            ids_t = torch.where(ids_t != pad_id, ids_t, 0)
        if getattr(self.model, "returns_nll", False):
            nll, valid = self.model.token_nll(ids_t, mask_t)
        else:
            nll, valid = token_nll(self.model(ids_t, mask_t), ids_t, mask_t)
        if use_domain:
            dnll, _ = token_nll(self.domain_model(ids_t, mask_t), ids_t, mask_t)
            nll = nll - dnll
        return self._dp.gather(nll), self._dp.gather(valid)

    def _flush_counts(self) -> None:
        """Count what the model summed on the device while tracing (the
        MoE's routed rows), where the results are copied to the host."""
        flush = getattr(self.model, "flush_counts", None)
        if flush is not None and tracing():
            flush()

    def _encode_padded(self, texts: Sequence[str], blen: int, bs: int) -> tuple:
        """``[bs, blen]`` ids and mask; rows past ``len(texts)`` are padding
        with an empty mask, so every batch of a bucket has one shape."""
        ids, mask = self.tokenizer.encode_batch(list(texts), self.cfg.max_len, pad_to=blen)
        pad_rows = bs - len(texts)
        if pad_rows:
            ids = np.concatenate([ids, np.full((pad_rows, blen), self.tokenizer.pad_id,
                                               dtype=np.int32)])
            mask = np.concatenate([mask, np.zeros((pad_rows, blen), np.float32)])
        return ids, mask

    def _token_count(self, text: str, max_len: int) -> int:
        fast = getattr(self.tokenizer, "encode_length", None)
        if fast is not None:
            return fast(text, max_len)
        return len(self.tokenizer.encode(text, max_len))

    def _token_counts(self, texts: Sequence[str], max_len: int) -> Sequence[int]:
        fast = getattr(self.tokenizer, "encode_lengths", None)
        if fast is not None:
            return fast(texts, max_len)
        return [self._token_count(t, max_len) for t in texts]

    def _buckets(self, texts: Sequence[str]) -> tuple:
        """``({bucket length: doc indices}, long doc indices)``."""
        buckets: Dict[int, List[int]] = {}
        long_idx = []
        for i, n in enumerate(self._token_counts(texts, self.chip_len + 1)):
            if n > self.chip_len:
                long_idx.append(i)
            else:
                buckets.setdefault(bucket_length(max(int(n), 2), max_len=self.chip_len),
                                   []).append(i)
        return buckets, long_idx

    # -- public API -----------------------------------------------------------

    def compute_entropy(self, text: str, relative_to_domain: bool = False) -> TextEntropyResult:
        """Single-document surprisal."""
        return self.batch_compute([text], relative_to_domain)[0]

    def batch_compute(self, texts: Sequence[str], relative_to_domain: bool = False,
                      batch_size: Optional[int] = None) -> List[TextEntropyResult]:
        """Bucketed surprisal for N documents, with per-token lists.

        Documents longer than the model's context are scored over
        overlapping windows and their per-token streams merged.
        """
        if not len(texts):
            return []
        bs = self._dp.round_batch(batch_size or self.batch_size)
        if self._packs:
            return self._compute_packed(texts, bs, with_tokens=True)
        use_domain = relative_to_domain and self.domain_model is not None
        buckets, long_idx = self._buckets(texts)
        results: List[Optional[TextEntropyResult]] = [None] * len(texts)
        if long_idx:
            with span("dewi.text_entropy.long"):
                for i, r in self._compute_long(texts, long_idx, relative_to_domain, bs):
                    results[i] = r
        with span("dewi.text_entropy.buckets"):
            for blen, idxs in sorted(buckets.items()):
                for start in range(0, len(idxs), bs):
                    chunk = idxs[start:start + bs]
                    nll, valid = self._score(
                        *self._encode_padded([texts[i] for i in chunk], blen, bs), use_domain)
                    mean, qs = masked_mean_and_quantiles(nll, valid, self._qs)
                    with span("dewi.text_entropy.fetch"):
                        nll, valid = nll.cpu().numpy(), valid.cpu().numpy()
                        mean, qs = mean.cpu().numpy(), qs.cpu().numpy()
                        self._flush_counts()
                    for row, doc_i in enumerate(chunk):
                        q = {self.quantiles[j]: float(qs[row, j])
                             for j in range(len(self.quantiles))}
                        results[doc_i] = TextEntropyResult(
                            token_entropies=nll[row][valid[row]].tolist(),
                            mean_entropy=float(mean[row]),
                            q90_entropy=float(q.get(0.9, qs[row, 0])),
                            q99_entropy=float(q.get(0.99, qs[row, -1])),
                        )
        return results  # type: ignore[return-value]

    def _compute_long_ring(self, ids_full: List[int], relative_to_domain: bool) -> TextEntropyResult:
        """The whole document in one ring-attention forward over the ring
        mesh's model axis: its power-of-two bucket, rounded up to a multiple
        of the axis and at least twice it, padded."""
        s_axis = self.ring_mesh.shape[MODEL_AXIS]
        n = len(ids_full)
        b = bucket_length(max(n, 2), max_len=self.cfg.max_len)
        t = max(((b + s_axis - 1) // s_axis) * s_axis, 2 * s_axis)
        ids = np.full((1, t), self.tokenizer.pad_id, dtype=np.int64)
        ids[0, :n] = ids_full
        if self.tokenizer.pad_id >= self.cfg.vocab_size:
            ids[0, n:] = 0  # an out-of-vocab pad sentinel; padding is masked
        pad = (np.arange(t) < n).astype(np.float32)[None, :]
        nll, valid = ring_token_nll(self.model, ids, pad, self.ring_mesh)
        if relative_to_domain and self.domain_model is not None:
            nll = nll - ring_token_nll(self.domain_model, ids, pad, self.ring_mesh)[0]
        with span("dewi.text_entropy.fetch"):
            stream = nll[valid].cpu().numpy()
        return _result_from_stream(stream)

    def _compute_long(self, texts: Sequence[str], idx: Sequence[int],
                      relative_to_domain: bool, bs: int) -> List[tuple]:
        """``(i, result)`` for each long document ``texts[i]``, ``i`` in
        ``idx``.  With a ring mesh, a document within the model's
        ``max_len`` is scored whole over the ring.  Otherwise: overlapping
        fixed windows, merged token stream.

        Windows of ``chip_len`` tokens advance by ``chip_len - overlap``
        (``overlap = chip_len // 4``); after a document's first window, each
        window's first ``overlap - 1`` targets are context only and dropped,
        so every kept token has at least ``overlap - 1`` tokens of left
        context.  The windows of all the documents are stacked in document
        order and forwarded ``bs`` rows at a time, so only the last forward
        carries padding rows.  Rows of a causal LM are independent and each
        forward has the shape a document alone takes, so a window's NLL is
        the one that forward gives, to float32 rounding.  The NLL stays on
        the device until one copy after the last forward.
        """
        t = self.chip_len
        overlap = t // 4
        stride = t - overlap
        out: List[tuple] = []
        windows: List[List[int]] = []
        owners: List[int] = []
        for i in idx:
            ids_full = self.tokenizer.encode(texts[i], 1 << 30)
            if self.ring_mesh is not None and len(ids_full) <= self.cfg.max_len:
                out.append((i, self._compute_long_ring(ids_full, relative_to_domain)))
                continue
            starts = range(0, max(len(ids_full) - overlap, 1), stride)
            windows.extend(ids_full[s:s + t] for s in starts)
            owners.extend([i] * len(starts))
        if not windows:
            return out
        count("text.windows", len(windows))
        rows = -(-len(windows) // bs) * bs
        ids = np.full((rows, t), self.tokenizer.pad_id, dtype=np.int32)
        mask = np.zeros((rows, t), dtype=np.float32)
        for w, win in enumerate(windows):
            ids[w, :len(win)] = win
            mask[w, :len(win)] = 1.0
        use_domain = relative_to_domain and self.domain_model is not None
        scored = []
        for start in range(0, rows, bs):
            count("text.window_forwards")
            scored.append(self._score(ids[start:start + bs], mask[start:start + bs], use_domain))
        with span("dewi.text_entropy.fetch"):
            nll = torch.cat([s[0] for s in scored]).cpu().numpy()
            valid = torch.cat([s[1] for s in scored]).cpu().numpy()
            self._flush_counts()
        toks: Dict[int, List[np.ndarray]] = {}
        for w, i in enumerate(owners):
            stream = nll[w][valid[w]]
            if i in toks:
                stream = stream[overlap - 1:]  # drop context-only targets
            toks.setdefault(i, []).append(stream)
        out.extend((i, _result_from_stream(np.concatenate(s).astype(np.float32)))
                   for i, s in toks.items())
        return out

    # -- the packed route ------------------------------------------------------

    def _compute_packed(self, texts: Sequence[str], bs: int,
                        with_tokens: bool) -> List[TextEntropyResult]:
        """Every document's result from flat forwards of whole sequences.

        Each document of at most ``chip_len`` tokens is one sequence; a
        longer one is cut into ``_compute_long``'s windows, each one
        sequence.  The sequences, sorted by length, are cut at their
        boundaries into as few forwards of at most ``bs * chip_len`` tokens
        as hold them, of near-equal sizes (``plan_forwards``); a forward
        carries real tokens alone, each sequence attending to itself.  A
        short document's mean and quantiles come from its NLL scattered into
        a ``[documents, longest]`` matrix on the device; the windows' NLL
        streams are merged on the host as ``_compute_long`` merges them.
        Everything stays on the device until one copy after the last
        forward.
        """
        t = self.chip_len
        overlap = t // 4
        stride = t - overlap
        seqs: List[np.ndarray] = []
        owner: List[int] = []  # the document of each sequence
        long_docs: List[int] = []
        for i, text in enumerate(texts):
            ids = np.asarray(self.tokenizer.encode(text, 1 << 30), dtype=np.int32)
            if len(ids) > t:
                long_docs.append(i)
                starts = range(0, max(len(ids) - overlap, 1), stride)
                seqs.extend(ids[a:a + t] for a in starts)
                owner.extend([i] * len(starts))
            elif len(ids):
                seqs.append(ids)
                owner.append(i)
        is_window = np.isin(np.asarray(owner, dtype=np.int64), long_docs)
        if long_docs:
            count("text.windows", int(is_window.sum()))
        lens = np.array([len(x) for x in seqs], dtype=np.int64)
        order = np.argsort(lens, kind="stable")
        stats: List[tuple] = []    # (documents, mean, quantiles) a forward, on the device
        streams: List[tuple] = []  # (sequences, NLL) a forward, on the device
        with span("dewi.text_entropy.packed"):
            for part in plan_forwards(lens[order], bs * t):
                picked = order[part]
                nll, docs, mean, qs = self._score_packed([seqs[j] for j in picked],
                                                         is_window[picked])
                stats.append(([owner[j] for j in picked[docs]], mean, qs))
                if with_tokens or is_window[picked].any():
                    streams.append((picked, nll))
            with span("dewi.text_entropy.fetch"):
                host_stats = [(d, m.cpu().numpy(), q.cpu().numpy()) for d, m, q in stats]
                host_streams = [(p, x.cpu().numpy()) for p, x in streams]
                self._flush_counts()
        results = [_result_from_stream(np.zeros(0, np.float32)) for _ in texts]
        q90_col = self.quantiles.index(0.9) if 0.9 in self.quantiles else 0
        for docs, mean, qs in host_stats:
            for row, i in enumerate(docs):
                results[i] = TextEntropyResult([], float(mean[row]), float(qs[row, q90_col]),
                                               float(qs[row, -1]))
        windows: Dict[int, List[tuple]] = {}
        for picked, nll in host_streams:
            at = 0
            for j in picked:
                stream = nll[at:at + lens[j] - 1]
                at += lens[j] - 1
                if is_window[j]:
                    windows.setdefault(owner[j], []).append((j, stream))
                elif with_tokens:
                    results[owner[j]].token_entropies = stream.tolist()
        for i, parts in windows.items():
            parts.sort(key=lambda x: x[0])  # the document's windows in order
            merged = [parts[0][1]] + [x[overlap - 1:] for _, x in parts[1:]]
            results[i] = _result_from_stream(np.concatenate(merged).astype(np.float32))
        return results

    def _score_packed(self, seqs: List[np.ndarray], is_window: np.ndarray) -> tuple:
        """One flat forward of ``seqs``: ``(nll, docs, mean, qs)``, the
        flat NLL (``MoonlightLM.packed_nll``), the positions in ``seqs``
        of the whole documents, and their mean and quantiles, on the
        device.  Ids, boundaries and the scatter's index go up in one copy."""
        lens = np.array([len(x) for x in seqs], dtype=np.int64)
        n, n_seq = int(lens.sum()), len(seqs)
        count("text.forwards")
        count("text.token_slots", n)
        count("text.tokens", n)
        count("text.attention_pairs", int((lens * (lens + 1) // 2).sum()))
        count("text.sequences", n_seq)
        if is_window.any():
            count("text.window_forwards")
        cu = np.zeros(n_seq + 1, dtype=np.int64)
        np.cumsum(lens, out=cu[1:])
        # Scatter index of each scored token: a document's row and column of
        # the [documents, width] matrix, a window's the spare last slot.
        docs = np.flatnonzero(~is_window)
        width = max(int(lens[docs].max(initial=1)) - 1, 1)
        row = np.full(n_seq, -1, dtype=np.int64)
        row[docs] = np.arange(len(docs))
        scored = lens - 1
        seq_of = np.repeat(np.arange(n_seq), scored)
        col = np.arange(int(scored.sum())) - np.repeat(cu[:-1] - np.arange(n_seq), scored)
        spare = len(docs) * width
        dest = np.where(row[seq_of] >= 0, row[seq_of] * width + col, spare)
        buf = torch.from_numpy(np.concatenate([np.concatenate(seqs).astype(np.int64), cu, dest]))
        if self.device.type == "cuda":
            buf = buf.pin_memory()
        buf = buf.to(self.device, non_blocking=True)
        ids, cu_t, dest_t = buf[:n], buf[n:n + n_seq + 1].to(torch.int32), buf[n + n_seq + 1:]
        nll = self.model.packed_nll(ids, cu_t, int(lens.max()))
        vals = torch.zeros(spare + 1, dtype=torch.float32, device=self.device)
        valid = torch.zeros(spare + 1, dtype=torch.float32, device=self.device)
        vals[dest_t] = nll
        valid.index_fill_(0, dest_t, 1.0)
        mean, qs = masked_mean_and_quantiles(vals[:spare].view(-1, width),
                                             valid[:spare].view(-1, width), self._qs)
        return nll, docs, mean, qs

    def batch_compute_stats(
        self,
        texts: Sequence[str],
        relative_to_domain: bool = False,
        batch_size: Optional[int] = None,
        progress: Optional[Callable[[int], None]] = None,
    ) -> tuple:
        """Per-document ``(mean, q90, q99)`` float32 arrays, without per-token
        lists.  The aggregates stay on the device until one copy at the end."""
        z = np.zeros(len(texts), np.float32)
        means, q90s, q99s = z, z.copy(), z.copy()
        if not len(texts):
            return means, q90s, q99s
        bs = self._dp.round_batch(batch_size or self.batch_size)
        if self._packs:
            for i, r in enumerate(self._compute_packed(texts, bs, with_tokens=False)):
                means[i], q90s[i], q99s[i] = r.mean_entropy, r.q90_entropy, r.q99_entropy
            if progress is not None:
                progress(len(texts))
            return means, q90s, q99s
        use_domain = relative_to_domain and self.domain_model is not None
        buckets, long_idx = self._buckets(texts)
        if long_idx:
            with span("dewi.text_entropy.long"):
                for i, r in self._compute_long(texts, long_idx, relative_to_domain, bs):
                    means[i], q90s[i], q99s[i] = r.mean_entropy, r.q90_entropy, r.q99_entropy
                    if progress is not None:
                        progress(1)
        q90_col = self.quantiles.index(0.9) if 0.9 in self.quantiles else 0
        rows: List[int] = []
        dev_means: List[torch.Tensor] = []
        dev_qs: List[torch.Tensor] = []
        with span("dewi.text_entropy.buckets"):
            for blen, idxs in sorted(buckets.items()):
                for start in range(0, len(idxs), bs):
                    chunk = idxs[start:start + bs]
                    mean, qs = masked_mean_and_quantiles(*self._score(
                        *self._encode_padded([texts[i] for i in chunk], blen, bs), use_domain),
                        self._qs)
                    rows.extend(chunk)
                    dev_means.append(mean[:len(chunk)])
                    dev_qs.append(qs[:len(chunk)])
                    if progress is not None:
                        progress(len(chunk))
            if rows:
                idx = np.asarray(rows)
                with span("dewi.text_entropy.fetch"):
                    mean_h = torch.cat(dev_means).cpu().numpy()
                    qs_h = torch.cat(dev_qs).cpu().numpy()
                    self._flush_counts()
                means[idx] = mean_h
                q90s[idx] = qs_h[:, q90_col]
                q99s[idx] = qs_h[:, -1]
        return means, q90s, q99s

    def __call__(self, text: str, **kwargs: Any) -> TextEntropyResult:
        return self.compute_entropy(text, **kwargs)


__all__ = ["TextEntropyEstimator", "TextEntropyResult", "plan_forwards"]
