"""Search kernels: CUDA wrappers, their plain versions, launch counts.

Counterpart of ``dewi_tpu/ops/pallas_search.py``.  All ten of its Pallas
kernels are ported here as hand-written CUDA (the stage-1 kernels and the
int8 streaming search in ``dewi_tpu_torch/csrc/search_kernels.cu``, the f32
streaming search and the merge both streaming searches end with in
``dewi_tpu_torch/csrc/stream_kernels.cu``):

======================  ======================================  ===============================  ============
wrapper                 replaces (dewi_tpu/ops/pallas_search)   called from                      bound, Q=1
======================  ======================================  ===============================  ============
``bmax_s4``             ``pallas_bmax_s4`` :661                 int4 tier, fused route           142.6 MB
``scores_matrix_s4``    ``pallas_scores_matrix_s4`` :470        int4 tier, unfused route         146.8 MB
``bmax``                ``pallas_bmax`` :559                    int8 tier, fused route           276.8 MB
``scores_matrix``       ``pallas_scores_matrix`` :309           exact bf16 tier; int8 unfused    549.5 MB
``bmax_s8``             ``pallas_bmax_s8`` :609                 int8-query tier, fused route     276.8 MB
``scores_matrix_s8``    ``pallas_scores_matrix_s8`` :378        int8-query tier, unfused route   281.0 MB
``bmax_t``              ``pallas_bmax_t`` :740                  int8 tier, corpus-major block    276.8 MB
``bmax_s8_t``           ``pallas_bmax_s8_t`` :793               int8-query tier, same block      276.8 MB
``stream_search``       ``pallas_fused_search`` :129            the bench's streaming section    1056 MB
``int8_stream_search``  ``pallas_int8_search`` :239             the same, over the int8 codes    292.0 MB
======================  ======================================  ===============================  ============

The eight stage-1 kernels compute their product on the tensor cores: the
float-query ones (``bmax``, ``scores_matrix``, ``bmax_t``) as ``mma.sync``
m16n8k16 in bf16 with f32 sums, int8 rows widened to bf16 exactly by a
byte permute, two masks and a packed subtract; the s8-query ones over
int8 rows (``bmax_s8``, ``scores_matrix_s8``, ``bmax_s8_t``) as m16n8k32
s8 x s8 with exact int32 sums over the bytes as they are, and over packed
int4 rows (``bmax_s4``, ``scores_matrix_s4``) the same after unpacking
each nibble plane in registers.  The rows are the 16-row operand and the
queries tiles of 8 columns, each warp a persistent worker that walks
128-row sub-blocks behind its own double-buffered ``cp.async`` ring of
8 KB slabs (32 rows x 256 bytes; 64 rows x 128 bytes of int4 rows).  With the
product there they are bound by device-memory bytes at every Q <= 32, and
one code path serves every Q, so a score does not depend on how many
queries ride with it.  ``int8_stream_search`` runs on the same kernel, its
int8 rows in a third mode that re-ranks each row group's scores, masks the
rows past ``n_valid`` and keeps each query's best k in per-warp lists (a
vote skips the selection where no score beats a list's k-th entry or the
CTA's threshold; above 8 queries a first pass over the first 32,768 rows
seeds those thresholds); the CTAs' lists are then merged.
``stream_search`` over f32 rows stays on the CUDA cores in f32 (it is the
recall reference: no TF32, no tensor cores), redesigned in the same shape:
persistent warps behind their own four-stage ``cp.async`` rings of 4 KB
slabs (32 rows x 128 bytes), the product register-tiled (each thread 4 rows
x 8 queries at Q=32, one fmaf per element in the order of the dim, so a
query's scores do not depend on how many queries ride with it), and the
same vote, per-warp lists, thresholds, seeding pass and merge.

Each kernel takes only some dims (``kernel_takes``): int8 rows a multiple
of 16, bf16 rows of 8, packed int4 rows of 32, and on the card as many as
one tile of 8 queries in shared memory.  The index gates ask it before they
route stage 1 to a kernel, so an index at another dim searches by the
plain route, as the reference's gates fall back to XLA when its probes
fail; a wrapper given such a dim on a CUDA tensor raises.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else.  On a CUDA tensor it launches its kernel on the current
stream of the tensor's device (built at first use, see ``_build.py``),
once per group of at most 32 queries (fewer where the queries of a wide
dim do not fit in shared memory), and adds one to its entry in
``launch_counts`` per launch; on a CPU tensor it returns its plain PyTorch
version, which the CPU tests hold against the JAX package and
``chip_smoke.py`` holds the kernel against on the card.  There is no
fallback from the kernel to the plain version.  The corpus-major
wrappers (``*_t``) return ``[cap/128, Q]``, the transpose of their
query-major twins.  The two streaming searches return ``[Q, k]`` scores
and row ids and read only the live rows.

Bound on an H100 (3.35 TB/s): the least time of all ten at Q <= 32 is
that of their bytes.  The last column is what each moves at 1M x 256
(int8 or packed int4 rows, bf16 rows for ``scores_matrix``, f32 rows for
``stream_search``; 1,000,000 live rows for the streaming searches), Q=1:
42.6, 43.8, 82.6, 164, 82.6, 83.9, 82.6, 82.6, 315 and 87.2 us.

torch has no integer matmul on the CPU, so the plain versions compute the
integer dots from the integer values in floating point: the s8 x s4 dot in
f32, which is exact (|acc| <= 128 * 8 * D < 2^24 for D < 16384), and the
s8 x s8 dot in f64, which is exact where f32 is not (127^2 * D passes
2^24 from D = 1041).
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

# Routing constants of the JAX package (pallas_search.py:293, 521-522).
# They only gate which algorithm an index configuration takes, so that the
# port routes as the reference does; the CUDA kernels tile as they like.
SCORES_BLOCK = 8192
BMAX_BLOCK = 16384
BLOCKMAX_SUB = 128
MAX_QUERIES = 32  # queries per launch: the kernel keeps them all on chip
# The streaming searches (pallas_search.py:42-43): the masked score is a
# finite float, not -inf; BLOCK is the reference's default ``block``.
STREAM_NEG_INF = -3.4e38
BLOCK = 1024
STREAM_MAX_K = 32       # the kernels keep lists of 32 candidates, one per lane
# CTAs of the persistent grids of ``stream_search`` and
# ``int8_stream_search``: None for as many as the card holds at once (fewer
# where the live rows are fewer), a number for at most that many (the card
# tests split duplicated rows over warps and CTAs with them).
STREAM_CTAS: Optional[int] = None
INT8_STREAM_CTAS: Optional[int] = None
# Corpus kinds of dewi_queries_per_launch.
_KIND_INT8, _KIND_BF16, _KIND_S4, _KIND_S8 = 0, 1, 2, 3
# kernel_takes' kinds: (dewi_queries_per_launch kind, the multiple the dim
# must be, so that a row is whole 16-byte copies).
_KINDS = {"int8": (_KIND_INT8, 16), "bf16": (_KIND_BF16, 8), "s8": (_KIND_S8, 16),
          "s4": (_KIND_S4, 32)}

launch_counts: Dict[str, int] = {
    "bmax_s4": 0, "scores_matrix_s4": 0, "bmax": 0, "scores_matrix": 0,
    "bmax_s8": 0, "scores_matrix_s8": 0, "bmax_t": 0, "bmax_s8_t": 0,
    "stream_search": 0, "int8_stream_search": 0,
    "probe_reduce_f32": 0,  # the probe's reduction (cuda_probe.py), no TPU kernel
}
_count_lock = threading.Lock()  # launches may come from several threads


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_common(name: str, emb: torch.Tensor, mult: torch.Tensor,
                  add: torch.Tensor, nq: int, *others: torch.Tensor) -> None:
    cap = emb.shape[0]
    _require(emb.dim() == 2, f"{name}: corpus must be 2-D, got {tuple(emb.shape)}")
    _require(cap > 0 and cap % BLOCKMAX_SUB == 0,
             f"{name}: capacity {cap} must be a positive multiple of {BLOCKMAX_SUB}")
    _require(nq >= 1, f"{name}: no queries")
    for t, what in ((mult, "mult"), (add, "add")):
        _require(t.dtype == torch.float32 and tuple(t.shape) == (cap,),
                 f"{name}: {what} must be float32 [{cap}], got "
                 f"{t.dtype} {tuple(t.shape)}")
    tensors = (emb, mult, add) + others
    for t in tensors:
        _require(t.device == emb.device,
                 f"{name}: all tensors must be on {emb.device}, got {t.device}")
        _require(t.is_contiguous(), f"{name}: tensors must be contiguous")
    _require(emb.device.type in ("cpu", "cuda"),
             f"{name}: unsupported device {emb.device}")
    if emb.device.type == "cuda":  # the kernels copy rows 16 bytes at a time
        _require(emb.data_ptr() % 16 == 0, f"{name}: corpus must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _queries_per_launch(kind: int, d: int) -> int:
    return int(_library().dewi_queries_per_launch(kind, d))


def kernel_takes(kind: str, d: int, device: Optional[torch.device] = None) -> bool:
    """Whether the stage-1 kernels of ``kind`` take dim ``d``.

    ``kind``: ``"int8"`` (int8 rows, float queries), ``"bf16"`` (bf16 rows),
    ``"s8"`` (int8 rows, s8 queries) or ``"s4"`` (packed int4 rows, s8
    queries; ``d`` is the unpacked dim).  A row must be whole 16-byte
    copies (a dim that is a multiple of 16, 8, 16 or 32), and on a CUDA
    ``device`` at least one tile of 8 queries must fit in shared memory.
    Decided from shapes alone, before any launch: the index gates route by
    it, and the wrappers raise on a CUDA tensor where it is False.
    """
    code, multiple = _KINDS[kind]
    if d <= 0 or d % multiple:
        return False
    return (device is None or torch.device(device).type != "cuda"
            or _queries_per_launch(code, d) > 0)


def _check_takes(name: str, kind: str, d: int, device: torch.device) -> None:
    if device.type == "cuda":
        _require(kernel_takes(kind, d, device),
                 f"{name}: dim {d} must be a multiple of {_KINDS[kind][1]} and "
                 "fit one tile of 8 queries in shared memory")


def _check_float_query(name: str, emb: torch.Tensor, queries: torch.Tensor) -> None:
    _require(emb.dtype in (torch.int8, torch.bfloat16),
             f"{name}: corpus must be int8 or bfloat16, got {emb.dtype}")
    _require(queries.dtype == torch.float32 and queries.dim() == 2
             and queries.shape[1] == emb.shape[1],
             f"{name}: queries must be float32 [Q, {emb.shape[1]}], got "
             f"{queries.dtype} {tuple(queries.shape)}")
    _check_takes(name, "int8" if emb.dtype == torch.int8 else "bf16", emb.shape[1],
                 emb.device)


def _check_s8_bytes(name: str, q_i8: torch.Tensor) -> None:
    """The kernels read 16 query bytes at a time."""
    if q_i8.device.type == "cuda":
        _require(q_i8.data_ptr() % 16 == 0, f"{name}: queries must be 16-byte aligned")


def _check_s4_query(name: str, emb_s4: torch.Tensor, q_i8: torch.Tensor,
                    q_scale: torch.Tensor) -> None:
    _require(emb_s4.dtype == torch.int8,
             f"{name}: packed corpus must be int8, got {emb_s4.dtype}")
    d = 2 * emb_s4.shape[1]
    _require(q_i8.dtype == torch.int8 and q_i8.dim() == 2 and q_i8.shape[1] == d,
             f"{name}: queries must be int8 [Q, {d}] (packed dim is D/2), got "
             f"{q_i8.dtype} {tuple(q_i8.shape)}")
    _require(q_scale.dtype == torch.float32
             and tuple(q_scale.shape) == (q_i8.shape[0],),
             f"{name}: q_scale must be float32 [{q_i8.shape[0]}]")
    _check_takes(name, "s4", d, emb_s4.device)
    _check_s8_bytes(name, q_i8)


def _check_s8_query(name: str, emb_i8: torch.Tensor, q_i8: torch.Tensor,
                    q_scale: torch.Tensor) -> None:
    _require(emb_i8.dtype == torch.int8,
             f"{name}: corpus must be int8, got {emb_i8.dtype}")
    d = emb_i8.shape[1]
    _require(q_i8.dtype == torch.int8 and q_i8.dim() == 2 and q_i8.shape[1] == d,
             f"{name}: queries must be int8 [Q, {d}], got "
             f"{q_i8.dtype} {tuple(q_i8.shape)}")
    _require(q_scale.dtype == torch.float32
             and tuple(q_scale.shape) == (q_i8.shape[0],),
             f"{name}: q_scale must be float32 [{q_i8.shape[0]}]")
    _check_takes(name, "s8", d, emb_i8.device)
    _check_s8_bytes(name, q_i8)


def _check_out_dtype(name: str, out_dtype: torch.dtype) -> None:
    _require(out_dtype in (torch.float32, torch.bfloat16),
             f"{name}: out_dtype must be float32 or bfloat16, got {out_dtype}")


def _library() -> object:
    from ._build import load_library

    return load_library()


def _launch(name: str, fn_name: str, device: torch.device, *args: object) -> None:
    """Launch on ``device``: the CUDA runtime's current device is per
    thread, so a launch from a worker thread or for ``cuda:1`` selects it."""
    lib = _library()
    with torch.cuda.device(device):
        rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        msg = lib.dewi_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
    with _count_lock:
        launch_counts[name] += 1


def _group(kind: int, d: int) -> int:
    """Queries per launch at dim ``d`` (a dim the checks let through):
    MAX_QUERIES unless their shared memory does not fit, then the most
    that does."""
    return min(_queries_per_launch(kind, d), MAX_QUERIES)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---- plain versions -----------------------------------------------------


def _bf16_dot(emb: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """``bf16(q) . row`` in f32: both operands are bf16-exact, so each
    product is exact and only the order of the sum differs from the kernel."""
    return queries.to(torch.bfloat16).float() @ emb.float().T


def _s4_dot(emb_s4: torch.Tensor, q_i8: torch.Tensor) -> torch.Tensor:
    """``_s4_acc``'s two plane dots (pallas_search.py:428), exact in f32."""
    hi = (emb_s4 >> 4).float()              # dims [0, D/2): signed high nibble
    lo = ((emb_s4 & 15) - 8).float()        # dims [D/2, D): low nibble - 8
    d2 = emb_s4.shape[1]
    q = q_i8.float()
    return q[:, :d2] @ hi.T + q[:, d2:] @ lo.T


def s8_dot(emb_i8: torch.Tensor, q_i8: torch.Tensor) -> torch.Tensor:
    """The s8 x s8 dot as JAX's int32 accumulator cast to f32: f64 products
    and sums of these integers are exact (|acc| <= 127^2 * D < 2^53)."""
    return (q_i8.double() @ emb_i8.double().T).float()


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` with one f32 rounding, as the kernels' ``fmaf`` and
    XLA's contracted epilogue: the f32 product is exact in f64."""
    return (a.double() * b.double() + c.double()).float()


def _blockmax(adj: torch.Tensor) -> torch.Tensor:
    nq, cap = adj.shape
    return adj.view(nq, cap // BLOCKMAX_SUB, BLOCKMAX_SUB).amax(dim=-1)


def scores_matrix_plain(emb: torch.Tensor, mult: torch.Tensor,
                        add: torch.Tensor, queries: torch.Tensor,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _fma(_bf16_dot(emb, queries), mult, add).to(out_dtype)


def bmax_plain(emb: torch.Tensor, mult: torch.Tensor, add: torch.Tensor,
               queries: torch.Tensor) -> torch.Tensor:
    return _blockmax(scores_matrix_plain(emb, mult, add, queries))


def scores_matrix_s4_plain(emb_s4: torch.Tensor, mult: torch.Tensor,
                           add: torch.Tensor, q_i8: torch.Tensor,
                           q_scale: torch.Tensor,
                           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    acc = _s4_dot(emb_s4, q_i8)
    return _fma(acc, q_scale[:, None] * mult[None, :], add).to(out_dtype)


def bmax_s4_plain(emb_s4: torch.Tensor, mult: torch.Tensor, add: torch.Tensor,
                  q_i8: torch.Tensor, q_scale: torch.Tensor) -> torch.Tensor:
    return _blockmax(scores_matrix_s4_plain(emb_s4, mult, add, q_i8, q_scale))


def scores_matrix_s8_plain(emb_i8: torch.Tensor, mult: torch.Tensor,
                           add: torch.Tensor, q_i8: torch.Tensor,
                           q_scale: torch.Tensor,
                           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    acc = s8_dot(emb_i8, q_i8)
    return _fma(acc, q_scale[:, None] * mult[None, :], add).to(out_dtype)


def bmax_s8_plain(emb_i8: torch.Tensor, mult: torch.Tensor, add: torch.Tensor,
                  q_i8: torch.Tensor, q_scale: torch.Tensor) -> torch.Tensor:
    return _blockmax(scores_matrix_s8_plain(emb_i8, mult, add, q_i8, q_scale))


def bmax_t_plain(emb: torch.Tensor, mult: torch.Tensor, add: torch.Tensor,
                 queries: torch.Tensor) -> torch.Tensor:
    return bmax_plain(emb, mult, add, queries).T.contiguous()


def bmax_s8_t_plain(emb_i8: torch.Tensor, mult: torch.Tensor, add: torch.Tensor,
                    q_i8: torch.Tensor, q_scale: torch.Tensor) -> torch.Tensor:
    return bmax_s8_plain(emb_i8, mult, add, q_i8, q_scale).T.contiguous()


def _stream_select(sim: torch.Tensor, payloads: torch.Tensor, n_valid: int,
                   eta: float, entropy_pref: float, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank ``sim [Q, cap]`` from the raw payload columns, term by term
    as ``_search_kernel`` (pallas_search.py:102-110), mask rows >=
    ``n_valid`` with -3.4e38 and take the k best: a stable descending sort
    puts the lower row first among equal scores; slots that hold no row
    above -3.4e38 are (-3.4e38, 0)."""
    dev = sim.device
    eta_t = torch.as_tensor(eta, dtype=torch.float32, device=dev)
    half_ep = torch.as_tensor(entropy_pref, dtype=torch.float32, device=dev) * 0.5
    adj = ((1.0 - eta_t) * sim + (eta_t * payloads[:, 0])[None, :]
           + (half_ep * (payloads[:, 1] + payloads[:, 3]))[None, :])
    neg = torch.full((), STREAM_NEG_INF, dtype=torch.float32, device=dev)
    col = torch.arange(sim.shape[1], device=dev)
    adj = torch.where(col[None, :] < n_valid, adj, neg)
    vals, ids = torch.sort(adj, dim=1, descending=True, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    empty = ~(vals > neg)
    return (torch.where(empty, neg, vals).contiguous(),
            torch.where(empty, torch.zeros_like(ids), ids).to(torch.int32).contiguous())


def stream_search_plain(embeddings: torch.Tensor, payloads: torch.Tensor,
                        queries: torch.Tensor, n_valid: int, eta: float,
                        entropy_pref: float, k: int = 10
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _stream_select(queries @ embeddings.T, payloads, n_valid, eta, entropy_pref, k)


def int8_stream_search_plain(emb_i8: torch.Tensor, scales: torch.Tensor,
                             payloads: torch.Tensor, queries: torch.Tensor,
                             n_valid: int, eta: float, entropy_pref: float,
                             k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    sim = _bf16_dot(emb_i8, queries) * scales[None, :]
    return _stream_select(sim, payloads, n_valid, eta, entropy_pref, k)


# ---- kernel wrappers ----------------------------------------------------


def scores_matrix(emb: torch.Tensor, mult: torch.Tensor, add: torch.Tensor,
                  queries: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Stage 1 over int8 or bf16 rows: ``[Q, cap]`` adjusted scores.

    ``adj = (bf16(q) . row) * mult + add``.  Replaces ``pallas_scores_matrix``
    (dewi_tpu/ops/pallas_search.py:309).  Bound: bytes (corpus + mult/add
    read, ``[Q, cap]`` written); the product runs on the tensor cores.
    """
    name = "scores_matrix"
    _check_common(name, emb, mult, add, queries.shape[0], queries)
    _check_float_query(name, emb, queries)
    _check_out_dtype(name, out_dtype)
    if emb.device.type == "cpu":
        return scores_matrix_plain(emb, mult, add, queries, out_dtype)
    nq, cap = queries.shape[0], emb.shape[0]
    out = torch.empty((nq, cap), dtype=out_dtype, device=emb.device)
    kind = _KIND_BF16 if emb.dtype == torch.bfloat16 else _KIND_INT8
    g = _group(kind, emb.shape[1])
    for i in range(0, nq, g):
        q, o = queries[i:i + g], out[i:i + g]
        _launch(name, "dewi_scores_matrix", emb.device, emb.data_ptr(),
                int(emb.dtype == torch.bfloat16), q.data_ptr(), mult.data_ptr(),
                add.data_ptr(), o.data_ptr(), int(out_dtype == torch.bfloat16),
                q.shape[0], emb.shape[1], cap, _stream(emb))
    return out


def bmax(emb: torch.Tensor, mult: torch.Tensor, add: torch.Tensor,
         queries: torch.Tensor) -> torch.Tensor:
    """Fused stage 1 + 128-row block max: ``[Q, cap/128]`` f32.

    Replaces ``pallas_bmax`` (dewi_tpu/ops/pallas_search.py:559).  Bound:
    bytes (corpus + mult/add read; only the maxima are written); the
    product runs on the tensor cores and the maxima never leave registers.
    """
    name = "bmax"
    _check_common(name, emb, mult, add, queries.shape[0], queries)
    _check_float_query(name, emb, queries)
    if emb.device.type == "cpu":
        return bmax_plain(emb, mult, add, queries)
    nq, cap = queries.shape[0], emb.shape[0]
    out = torch.empty((nq, cap // BLOCKMAX_SUB), dtype=torch.float32,
                      device=emb.device)
    kind = _KIND_BF16 if emb.dtype == torch.bfloat16 else _KIND_INT8
    g = _group(kind, emb.shape[1])
    for i in range(0, nq, g):
        q, o = queries[i:i + g], out[i:i + g]
        _launch(name, "dewi_bmax", emb.device, emb.data_ptr(), int(emb.dtype == torch.bfloat16),
                q.data_ptr(), mult.data_ptr(), add.data_ptr(), o.data_ptr(),
                q.shape[0], emb.shape[1], cap, _stream(emb))
    return out


def scores_matrix_s4(emb_s4: torch.Tensor, mult: torch.Tensor,
                     add: torch.Tensor, q_i8: torch.Tensor,
                     q_scale: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int4 stage 1: ``[Q, cap]`` of ``acc * (q_scale * mult) + add``.

    ``acc`` is the exact int32 dot of the s8 query with the nibble-packed
    row.  Replaces ``pallas_scores_matrix_s4``
    (dewi_tpu/ops/pallas_search.py:470).  Bound: bytes.
    """
    name = "scores_matrix_s4"
    _check_common(name, emb_s4, mult, add, q_i8.shape[0], q_i8, q_scale)
    _check_s4_query(name, emb_s4, q_i8, q_scale)
    _check_out_dtype(name, out_dtype)
    if emb_s4.device.type == "cpu":
        return scores_matrix_s4_plain(emb_s4, mult, add, q_i8, q_scale, out_dtype)
    nq, cap = q_i8.shape[0], emb_s4.shape[0]
    out = torch.empty((nq, cap), dtype=out_dtype, device=emb_s4.device)
    g = _group(_KIND_S4, q_i8.shape[1])
    for i in range(0, nq, g):
        q, qs, o = q_i8[i:i + g], q_scale[i:i + g], out[i:i + g]
        _launch(name, "dewi_scores_matrix_s4", emb_s4.device, emb_s4.data_ptr(), q.data_ptr(),
                qs.data_ptr(), mult.data_ptr(), add.data_ptr(), o.data_ptr(),
                int(out_dtype == torch.bfloat16), q.shape[0], q.shape[1], cap,
                _stream(emb_s4))
    return out


def bmax_s4(emb_s4: torch.Tensor, mult: torch.Tensor, add: torch.Tensor,
            q_i8: torch.Tensor, q_scale: torch.Tensor) -> torch.Tensor:
    """Fused int4 stage 1 + 128-row block max: ``[Q, cap/128]`` f32.

    Replaces ``pallas_bmax_s4`` (dewi_tpu/ops/pallas_search.py:661), the
    int4 tier's default stage 1.  Bound: bytes (packed corpus + mult/add).
    """
    name = "bmax_s4"
    _check_common(name, emb_s4, mult, add, q_i8.shape[0], q_i8, q_scale)
    _check_s4_query(name, emb_s4, q_i8, q_scale)
    if emb_s4.device.type == "cpu":
        return bmax_s4_plain(emb_s4, mult, add, q_i8, q_scale)
    nq, cap = q_i8.shape[0], emb_s4.shape[0]
    out = torch.empty((nq, cap // BLOCKMAX_SUB), dtype=torch.float32,
                      device=emb_s4.device)
    g = _group(_KIND_S4, q_i8.shape[1])
    for i in range(0, nq, g):
        q, qs, o = q_i8[i:i + g], q_scale[i:i + g], out[i:i + g]
        _launch(name, "dewi_bmax_s4", emb_s4.device, emb_s4.data_ptr(), q.data_ptr(),
                qs.data_ptr(), mult.data_ptr(), add.data_ptr(), o.data_ptr(),
                q.shape[0], q.shape[1], cap, _stream(emb_s4))
    return out


def scores_matrix_s8(emb_i8: torch.Tensor, mult: torch.Tensor,
                     add: torch.Tensor, q_i8: torch.Tensor,
                     q_scale: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """s8-query stage 1: ``[Q, cap]`` of ``acc * (q_scale * mult) + add``.

    ``acc`` is the exact int32 dot of the s8 query with the int8 row.
    Replaces ``pallas_scores_matrix_s8`` (dewi_tpu/ops/pallas_search.py:378).
    Bound: bytes (corpus + mult/add read, ``[Q, cap]`` written); the
    product runs on the int8 tensor cores.
    """
    name = "scores_matrix_s8"
    _check_common(name, emb_i8, mult, add, q_i8.shape[0], q_i8, q_scale)
    _check_s8_query(name, emb_i8, q_i8, q_scale)
    _check_out_dtype(name, out_dtype)
    if emb_i8.device.type == "cpu":
        return scores_matrix_s8_plain(emb_i8, mult, add, q_i8, q_scale, out_dtype)
    nq, (cap, d) = q_i8.shape[0], emb_i8.shape
    out = torch.empty((nq, cap), dtype=out_dtype, device=emb_i8.device)
    g = _group(_KIND_S8, d)
    for i in range(0, nq, g):
        q, qs, o = q_i8[i:i + g], q_scale[i:i + g], out[i:i + g]
        _launch(name, "dewi_scores_matrix_s8", emb_i8.device, emb_i8.data_ptr(),
                q.data_ptr(), qs.data_ptr(), mult.data_ptr(), add.data_ptr(),
                o.data_ptr(), int(out_dtype == torch.bfloat16), q.shape[0], d, cap,
                _stream(emb_i8))
    return out


def bmax_s8(emb_i8: torch.Tensor, mult: torch.Tensor, add: torch.Tensor,
            q_i8: torch.Tensor, q_scale: torch.Tensor) -> torch.Tensor:
    """Fused s8-query stage 1 + 128-row block max: ``[Q, cap/128]`` f32.

    Replaces ``pallas_bmax_s8`` (dewi_tpu/ops/pallas_search.py:609), the
    stage 1 of the int8 tier with ``int8_queries``.  Bound: bytes (corpus +
    mult/add; only the maxima are written); the product runs on the int8
    tensor cores and the maxima never leave registers.
    """
    name = "bmax_s8"
    _check_common(name, emb_i8, mult, add, q_i8.shape[0], q_i8, q_scale)
    _check_s8_query(name, emb_i8, q_i8, q_scale)
    if emb_i8.device.type == "cpu":
        return bmax_s8_plain(emb_i8, mult, add, q_i8, q_scale)
    nq, (cap, d) = q_i8.shape[0], emb_i8.shape
    out = torch.empty((nq, cap // BLOCKMAX_SUB), dtype=torch.float32, device=emb_i8.device)
    g = _group(_KIND_S8, d)
    for i in range(0, nq, g):
        q, qs, o = q_i8[i:i + g], q_scale[i:i + g], out[i:i + g]
        _launch(name, "dewi_bmax_s8", emb_i8.device, emb_i8.data_ptr(), q.data_ptr(),
                qs.data_ptr(), mult.data_ptr(), add.data_ptr(), o.data_ptr(),
                q.shape[0], d, cap, _stream(emb_i8))
    return out


def bmax_s8_t(emb_i8: torch.Tensor, mult: torch.Tensor, add: torch.Tensor,
              q_i8: torch.Tensor, q_scale: torch.Tensor) -> torch.Tensor:
    """Corpus-major :func:`bmax_s8`: ``[cap/128, Q]`` f32.

    Replaces ``pallas_bmax_s8_t`` (dewi_tpu/ops/pallas_search.py:793), taken
    where the stream block is not a multiple of 16384 rows.  Bound: bytes.
    The same kernel as :func:`bmax_s8` with other store strides, so equal
    to it transposed bit for bit.
    """
    name = "bmax_s8_t"
    _check_common(name, emb_i8, mult, add, q_i8.shape[0], q_i8, q_scale)
    _check_s8_query(name, emb_i8, q_i8, q_scale)
    if emb_i8.device.type == "cpu":
        return bmax_s8_t_plain(emb_i8, mult, add, q_i8, q_scale)
    nq, (cap, d) = q_i8.shape[0], emb_i8.shape
    out = torch.empty((cap // BLOCKMAX_SUB, nq), dtype=torch.float32, device=emb_i8.device)
    g = _group(_KIND_S8, d)
    for i in range(0, nq, g):  # a group writes columns i .. i+g of out
        q, qs = q_i8[i:i + g], q_scale[i:i + g]
        _launch(name, "dewi_bmax_s8_t", emb_i8.device, emb_i8.data_ptr(), q.data_ptr(),
                qs.data_ptr(), mult.data_ptr(), add.data_ptr(), out[:, i:].data_ptr(),
                nq, q.shape[0], d, cap, _stream(emb_i8))
    return out


def bmax_t(emb: torch.Tensor, mult: torch.Tensor, add: torch.Tensor,
           queries: torch.Tensor) -> torch.Tensor:
    """Corpus-major :func:`bmax`: ``[cap/128, Q]`` f32.

    Replaces ``pallas_bmax_t`` (dewi_tpu/ops/pallas_search.py:740), taken
    where the stream block is not a multiple of 16384 rows.  Bound: bytes.
    The same kernel as :func:`bmax` with other store strides, so equal to
    it transposed bit for bit.
    """
    name = "bmax_t"
    _check_common(name, emb, mult, add, queries.shape[0], queries)
    _check_float_query(name, emb, queries)
    if emb.device.type == "cpu":
        return bmax_t_plain(emb, mult, add, queries)
    nq, cap = queries.shape[0], emb.shape[0]
    out = torch.empty((cap // BLOCKMAX_SUB, nq), dtype=torch.float32, device=emb.device)
    kind = _KIND_BF16 if emb.dtype == torch.bfloat16 else _KIND_INT8
    g = _group(kind, emb.shape[1])
    for i in range(0, nq, g):  # a group writes columns i .. i+g of out
        q = queries[i:i + g]
        _launch(name, "dewi_bmax_t", emb.device, emb.data_ptr(),
                int(emb.dtype == torch.bfloat16), q.data_ptr(), mult.data_ptr(),
                add.data_ptr(), out[:, i:].data_ptr(), nq, q.shape[0], emb.shape[1],
                cap, _stream(emb))
    return out


def _check_stream(name: str, emb: torch.Tensor, emb_dtype: torch.dtype,
                  payloads: torch.Tensor, queries: torch.Tensor, k: int, block: int,
                  *others: torch.Tensor) -> None:
    _require(emb.dim() == 2 and emb.dtype == emb_dtype,
             f"{name}: corpus must be 2-D {emb_dtype}, got {emb.dtype} {tuple(emb.shape)}")
    cap, d = emb.shape
    _require(cap > 0 and cap % BLOCKMAX_SUB == 0,
             f"{name}: capacity {cap} must be a positive multiple of {BLOCKMAX_SUB}")
    _require(block > 0 and cap % block == 0,
             f"{name}: capacity {cap} must be a multiple of {block}")
    _require(payloads.dtype == torch.float32 and tuple(payloads.shape) == (cap, 8),
             f"{name}: payloads must be float32 [{cap}, 8], got "
             f"{payloads.dtype} {tuple(payloads.shape)}")
    _require(queries.dtype == torch.float32 and queries.dim() == 2
             and queries.shape[1] == d and queries.shape[0] >= 1,
             f"{name}: queries must be float32 [Q >= 1, {d}], got "
             f"{queries.dtype} {tuple(queries.shape)}")
    _require(1 <= k <= min(STREAM_MAX_K, cap),
             f"{name}: k must be in [1, {min(STREAM_MAX_K, cap)}], got {k}")
    for t in (emb, payloads, queries) + others:
        _require(t.device == emb.device,
                 f"{name}: all tensors must be on {emb.device}, got {t.device}")
        _require(t.is_contiguous(), f"{name}: tensors must be contiguous")
    _require(emb.device.type in ("cpu", "cuda"), f"{name}: unsupported device {emb.device}")
    if emb.device.type == "cuda":  # the kernels copy rows 16 bytes at a time
        _require(emb.data_ptr() % 16 == 0 and payloads.data_ptr() % 16 == 0,
                 f"{name}: corpus and payloads must be 16-byte aligned")
        step = 16 // emb.element_size()
        _require(d % step == 0, f"{name}: dim {d} must be a multiple of {step}")


def _stream_scalars(eta: float, entropy_pref: float) -> Tuple[float, float, float]:
    """(1 - eta, eta, entropy_pref / 2), rounded as the reference's f32
    scalars; they go to the kernels by value."""
    eta32 = np.float32(eta)
    return (float(np.float32(1.0) - eta32), float(eta32),
            float(np.float32(entropy_pref) * np.float32(0.5)))


# The streaming searches' library entry points: the search, the queries
# one launch takes at a dim, the CTAs the card holds of one launch.
_STREAM_FNS = {
    "stream_search": ("dewi_stream_search", "dewi_stream_queries_per_launch",
                      "dewi_stream_max_ctas"),
    "int8_stream_search": ("dewi_int8_stream_search", "dewi_int8_stream_queries_per_launch",
                           "dewi_int8_stream_max_ctas"),
}


@functools.lru_cache(maxsize=None)
def _stream_group(fn_name: str, d: int) -> int:
    return int(getattr(_library(), fn_name)(d))


def stream_queries_per_launch(name: str, d: int) -> int:
    """Queries per launch of the streaming search ``name``
    (``"stream_search"`` or ``"int8_stream_search"``) at dim ``d`` on the
    card: at most ``MAX_QUERIES``, fewer where the kernel's shared memory
    (staged queries, and the rings and top-k lists of at least four warps)
    does not hold that many, 0 where it holds not even one (one query for
    ``stream_search``, one tile of 8 for ``int8_stream_search``).  The
    wrapper launches once per group of this many queries."""
    return min(_stream_group(_STREAM_FNS[name][1], d), MAX_QUERIES)


@functools.lru_cache(maxsize=None)
def _stream_held(name: str, device: torch.device, nq: int, d: int) -> int:
    """CTAs the card holds at once of the streaming kernel ``name`` for
    ``nq`` queries at dim ``d``: the most its persistent grid takes."""
    lib = _library()
    with torch.cuda.device(device):
        n = int(getattr(lib, _STREAM_FNS[name][2])(nq, d))
    if n <= 0:
        raise RuntimeError(f"{name}: no launch configuration at Q={nq}, D={d} "
                           f"({-n}: {lib.dewi_error_string(-n).decode()})")
    return n


def stream_plan(nq: int, group: int, held: Callable[[int], int],
                limit: Optional[int]) -> Tuple[range, int]:
    """The launches of a streaming search of ``nq`` queries, ``group`` at a
    time (the first query of each), and the rows of its partial lists: the
    most CTAs any of its launches takes (``held(queries)``: as many as the
    card holds at once), at most ``limit`` (None: no limit)."""
    starts = range(0, nq, group)
    ctas = max(held(min(group, nq - i)) for i in starts)
    return starts, ctas if limit is None else min(ctas, limit)


def _stream_launch(name: str, rows: Tuple[torch.Tensor, ...], payloads: torch.Tensor,
                   queries: torch.Tensor, n_valid: int, eta: float, entropy_pref: float,
                   k: int, limit: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the streaming search ``name`` over ``rows`` (f32 rows, or
    int8 rows and their scales) once per query group: its kernel on a
    persistent grid of at most ``limit`` CTAs (as many as the card holds at
    once when None), then the merge of their lists, both inside one library
    call."""
    emb = rows[0]
    nq, (cap, d) = queries.shape[0], emb.shape
    dev = emb.device
    g = stream_queries_per_launch(name, d)
    what = "one query" if name == "stream_search" else "one tile of 8 queries"
    _require(g > 0, f"{name}: dim {d} too wide for {what} in shared memory")
    _require(limit is None or limit >= 1,
             f"{name}: its CTA limit must be None or at least 1, got {limit}")
    starts, ctas = stream_plan(nq, g, lambda s: _stream_held(name, dev, s, d), limit)
    part_s = torch.empty((ctas, min(g, nq), STREAM_MAX_K), dtype=torch.float32, device=dev)
    part_i = torch.empty((ctas, min(g, nq), STREAM_MAX_K), dtype=torch.int32, device=dev)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    for i in starts:
        q = queries[i:i + g]
        _launch(name, _STREAM_FNS[name][0], dev, *(t.data_ptr() for t in rows),
                payloads.data_ptr(), q.data_ptr(), q.shape[0], d, cap, int(n_valid),
                *_stream_scalars(eta, entropy_pref), k, ctas, part_s.data_ptr(),
                part_i.data_ptr(), out_s[i:i + g].data_ptr(), out_i[i:i + g].data_ptr(),
                _stream(emb))
    return out_s, out_i


def stream_search(embeddings: torch.Tensor, payloads: torch.Tensor,
                  queries: torch.Tensor, n_valid: int, eta: float,
                  entropy_pref: float, k: int = 10, block: int = BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact streaming DEWI search: ``([Q, k]`` f32 scores, ``[Q, k]`` i32 rows).

    Replaces ``pallas_fused_search`` (dewi_tpu/ops/pallas_search.py:129).
    ``embeddings [cap, D]`` and ``queries [Q, D]`` are pre-normalized f32;
    ``adj = (1 - eta) * (q . row) + eta * pay[:, 0] + entropy_pref * 0.5 *
    (pay[:, 1] + pay[:, 3])``, rows >= ``n_valid`` at -3.4e38.  Results are
    in descending score and, among equal scores, the lower row first,
    however the corpus is chunked; with fewer than ``k`` live rows the
    remaining slots are (-3.4e38, 0).  (The reference gives those slots row
    0 when it runs in one block and repeats the best row's id when in
    several; the port's answer is the same for every chunking.)
    ``n_valid``, ``eta`` and ``entropy_pref`` are Python numbers and go to
    the kernel by value.  ``block`` is kept for parity: ``cap % block != 0``
    raises, and it does not set the kernel's tiling.  ``k`` is at most 32.
    Bound: bytes (the live rows and their payloads read once).
    """
    name = "stream_search"
    _check_stream(name, embeddings, torch.float32, payloads, queries, k, block)
    if embeddings.device.type == "cpu":
        return stream_search_plain(embeddings, payloads, queries, n_valid, eta,
                                   entropy_pref, k)
    return _stream_launch(name, (embeddings,), payloads, queries, n_valid, eta, entropy_pref,
                          k, STREAM_CTAS)


def int8_stream_search(emb_i8: torch.Tensor, scales: torch.Tensor,
                       payloads: torch.Tensor, queries: torch.Tensor, n_valid: int,
                       eta: float, entropy_pref: float, k: int = 10, block: int = 2048
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`stream_search` over int8 rows with per-row f32 ``scales``.

    Replaces ``pallas_int8_search`` (dewi_tpu/ops/pallas_search.py:239):
    ``sim = (bf16(q) . row) * scale[row]`` with an f32 sum of exact
    products, then the same re-rank, mask, order and empty slots.  Bound:
    bytes (the live int8 rows, their scales and payloads read once).  On
    the card the dot runs on the tensor cores (the stage-1 kernel's int8
    rows in its top-k mode), so it is summed in another order than the
    plain version's and may differ from it by a few ulps; the dim must be a
    multiple of 16 and one tile of 8 queries must fit in shared memory
    (``stream_queries_per_launch``), or it raises.
    """
    name = "int8_stream_search"
    _check_stream(name, emb_i8, torch.int8, payloads, queries, k, block, scales)
    _require(scales.dtype == torch.float32 and tuple(scales.shape) == (emb_i8.shape[0],),
             f"{name}: scales must be float32 [{emb_i8.shape[0]}]")
    if emb_i8.device.type == "cpu":
        return int8_stream_search_plain(emb_i8, scales, payloads, queries, n_valid, eta,
                                        entropy_pref, k)
    return _stream_launch(name, (emb_i8, scales), payloads, queries, n_valid, eta,
                          entropy_pref, k, INT8_STREAM_CTAS)


__all__ = [
    "SCORES_BLOCK", "BMAX_BLOCK", "BLOCKMAX_SUB", "MAX_QUERIES", "BLOCK",
    "STREAM_NEG_INF", "STREAM_MAX_K",
    "STREAM_CTAS", "INT8_STREAM_CTAS",
    "launch_counts", "reset_launch_counts", "kernel_takes", "stream_queries_per_launch",
    "stream_plan",
    "scores_matrix", "bmax", "scores_matrix_s4", "bmax_s4",
    "scores_matrix_s8", "bmax_s8", "bmax_t", "bmax_s8_t",
    "stream_search", "int8_stream_search",
    "scores_matrix_plain", "bmax_plain", "scores_matrix_s4_plain",
    "bmax_s4_plain", "scores_matrix_s8_plain", "bmax_s8_plain",
    "bmax_t_plain", "bmax_s8_t_plain", "s8_dot",
    "stream_search_plain", "int8_stream_search_plain",
]
