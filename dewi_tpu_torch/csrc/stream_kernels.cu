// Streaming top-k search kernels for Hopper (sm_90a).
//
// Hand-written CUDA ports of the two Pallas kernels of
// dewi_tpu/ops/pallas_search.py that search in one pass:
//
//   dewi_stream_search      <- pallas_fused_search (:129, _search_kernel :70)
//   dewi_int8_stream_search <- pallas_int8_search  (:239, _int8_search_kernel :181)
//
// both with _topk_via_max (:46) as the selection.  For every query q and
// corpus row r they compute
//
//   sim[q, r] = sum_d q[q, d] * row[r, d]                     (f32 rows)
//   sim[q, r] = (sum_d bf16(q[q, d]) * row[r, d]) * scale[r]  (int8 rows)
//   adj[q, r] = (1 - eta) * sim + eta * pay[r, 0]
//               + (entropy_pref * 0.5) * (pay[r, 1] + pay[r, 3])
//
// with rows r >= n_valid at -3.4e38 (a finite float), and return the k best
// (adj, r) per query: descending score, and among equal scores the lower
// row first.  With fewer than k rows above -3.4e38 the remaining slots are
// (-3.4e38, 0).  The dot is an f32 sum of f32 products on the CUDA cores
// (for int8 rows both operands are bf16-exact, so every product is exact);
// the re-rank is evaluated term by term with one rounding per operation,
// as the plain PyTorch versions in dewi_tpu_torch/ops/cuda_search.py do,
// so given the same dot the scores agree bit for bit.
//
// Bound on this card: both read the corpus once and do 2*Q operations per
// element at Q <= 32, so they are bound by device-memory bytes: the live
// rows, their payloads (and scales) read once; the output is Q*k pairs.
//
// Design.  The TPU kernel walks the corpus in order and carries one
// running [Q, k] buffer; here the live rows are split over `chunks` CTAs.
// A CTA of 128 threads walks its 128-row tiles as the stage-1 kernels do
// (one thread per row, rows staged 256 bytes at a time with cp.async, the
// queries in shared memory as f32, one accumulator per query in registers)
// and writes each tile's adjusted scores to shared memory.  Selection is
// by warp: warp w owns queries w, w+4, ... and keeps, for each, a sorted
// list of 32 (score, row) pairs, entry j in lane j's registers.  A tile's
// 128 scores are offered to the list 32 at a time: one ballot finds the
// lanes whose candidate precedes the list's tail (after the first tiles,
// usually none), and each of those is inserted by a ballot for its
// position and one shuffle.  A CTA ends by writing its lists as
// [chunks, Q, 32] partial results.  Tiles from ceil(n_valid / 128) on are
// never read.  A second kernel merges the partials: one CTA per query,
// eight warps each merging a strided share of the chunks' lists with the
// same insertion, then warp 0 merging the eight.  The order (score, then
// row) is total, so the result does not depend on how the rows are chunked.

#include "common.cuh"

namespace {

using namespace dewi;

constexpr float kNegInf = -3.4e38f;    // NEG_INF of pallas_search.py
constexpr int kListLen = 32;           // list entries: one per lane; k <= 32
constexpr int kWarps = kThreads / 32;
constexpr int kMergeWarps = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

enum RowKind { kF32 = 0, kI8 = 1 };

// (as, ai) stands before (bs, bi) in the result: higher score, then lower row.
__device__ __forceinline__ bool precedes(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// Offer one candidate per lane to the warp's sorted list (entry j in lane
// j).  A candidate enters only if it precedes the list's last entry; an
// empty slot is (-3.4e38, 0), which no candidate of score -3.4e38 precedes,
// so masked rows never enter.  An insertion whose candidate no longer
// precedes the tail finds position 32 and changes nothing.
__device__ __forceinline__ void list_offer(float& ls, int& li, float cs, int ci, int lane) {
  const float ts = __shfl_sync(kFull, ls, kListLen - 1);
  const int ti = __shfl_sync(kFull, li, kListLen - 1);
  unsigned m = __ballot_sync(kFull, precedes(cs, ci, ts, ti));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float s = __shfl_sync(kFull, cs, src);
    const int i = __shfl_sync(kFull, ci, src);
    const int p = __popc(__ballot_sync(kFull, precedes(ls, li, s, i)));
    const float us = __shfl_up_sync(kFull, ls, 1);
    const int ui = __shfl_up_sync(kFull, li, 1);
    if (lane > p) {
      ls = us;
      li = ui;
    } else if (lane == p) {
      ls = s;
      li = i;
    }
  }
}

template <int KIND, int QT>
__global__ void __launch_bounds__(kThreads)
stream_partial_kernel(const uint8_t* __restrict__ emb, int row_bytes,
                      const float* __restrict__ scales,  // [cap] (int8 rows)
                      const float* __restrict__ pay,     // [cap, 8]
                      const float* __restrict__ q,       // [nq, d]
                      int nq, int d, int n_valid, float one_minus_eta, float eta,
                      float half_ep, int sub_per_chunk, int nsub,
                      float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tile = smem;
  float* qs = reinterpret_cast<float*>(smem + kTileBytes);  // [QT, d]
  float* sc = qs + QT * d;                                  // [QT, kThreads]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Stage the queries, zero-padded to QT rows; over int8 rows they are
  // rounded to bf16 here, as the TPU kernel casts them before the dot.
  for (int i = tid; i < QT * d; i += kThreads) {
    float v = (i / d) < nq ? q[i] : 0.f;
    if constexpr (KIND == kI8) v = __bfloat162float(__float2bfloat16_rn(v));
    qs[i] = v;
  }

  constexpr int kLists = (QT + kWarps - 1) / kWarps;  // lists per warp
  float ls[kLists];
  int li[kLists];
#pragma unroll
  for (int j = 0; j < kLists; ++j) {
    ls[j] = kNegInf;
    li[j] = 0;
  }

  const uint8_t* my = tile + tid * kStride;
  const int sub0 = blockIdx.x * sub_per_chunk;
  const int sub1 = min(sub0 + sub_per_chunk, nsub);
  for (int sb_i = sub0; sb_i < sub1; ++sb_i) {
    const long long row0 = static_cast<long long>(sb_i) * kSub;
    const long long row = row0 + tid;

    float acc[QT];
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) acc[qi] = 0.f;

    for (int s0 = 0; s0 < row_bytes; s0 += kSlabBytes) {
      const int sb = min(kSlabBytes, row_bytes - s0);
      const int cpr = sb / 16;
      stage_slab(tile, emb, row0, row_bytes, s0, sb, tid);
      for (int c = 0; c < cpr; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(my + c * 16);
        constexpr int kElems = KIND == kI8 ? 16 : 4;
        float x[kElems];
        if constexpr (KIND == kI8) {
          s8x16_to_f32(raw, x);
        } else {
          x[0] = __uint_as_float(raw.x);
          x[1] = __uint_as_float(raw.y);
          x[2] = __uint_as_float(raw.z);
          x[3] = __uint_as_float(raw.w);
        }
        const int dim0 = (s0 + c * 16) / (KIND == kI8 ? 1 : 4);
#pragma unroll
        for (int qi = 0; qi < QT; ++qi) {
          const float4* qv = reinterpret_cast<const float4*>(qs + qi * d + dim0);
          float a = acc[qi];
#pragma unroll
          for (int v = 0; v < kElems / 4; ++v) {
            const float4 t = qv[v];
            a = fmaf(x[4 * v], t.x, a);
            a = fmaf(x[4 * v + 1], t.y, a);
            a = fmaf(x[4 * v + 2], t.z, a);
            a = fmaf(x[4 * v + 3], t.w, a);
          }
          acc[qi] = a;
        }
      }
    }

    // Re-rank from the raw payload columns (dewi 0, ht_mean 1, hi_mean 3:
    // the row's first 16 bytes), term by term, and mask the rows past the
    // live count.
    const float4 p = *reinterpret_cast<const float4*>(pay + row * 8);
    const float dewi = __fmul_rn(eta, p.x);
    const float ent = __fmul_rn(half_ep, __fadd_rn(p.y, p.w));
    const bool live = row < n_valid;
    float scale = 1.f;
    if constexpr (KIND == kI8) scale = scales[row];
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
      float sim = acc[qi];
      if constexpr (KIND == kI8) sim = __fmul_rn(sim, scale);
      const float adj = __fadd_rn(__fadd_rn(__fmul_rn(one_minus_eta, sim), dewi), ent);
      sc[qi * kThreads + tid] = live ? adj : kNegInf;
    }
    __syncthreads();

    // sc is written again only after the next tile's staging barriers.
#pragma unroll
    for (int j = 0; j < kLists; ++j) {
      const int qi = warp + j * kWarps;
      if (qi < nq) {
#pragma unroll
        for (int c = 0; c < kThreads / 32; ++c) {
          list_offer(ls[j], li[j], sc[qi * kThreads + c * 32 + lane],
                     static_cast<int>(row0) + c * 32 + lane, lane);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kLists; ++j) {
    const int qi = warp + j * kWarps;
    if (qi < nq) {
      const long long o = (static_cast<long long>(blockIdx.x) * nq + qi) * kListLen + lane;
      part_s[o] = ls[j];
      part_i[o] = li[j];
    }
  }
}

// [chunks, nq, 32] sorted partial lists -> out [nq, k]: one CTA per query.
__global__ void __launch_bounds__(kMergeWarps * 32)
stream_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                    int chunks, int nq, int k, float* __restrict__ out_s,
                    int* __restrict__ out_i) {
  __shared__ float ms[kMergeWarps][kListLen];
  __shared__ int mi[kMergeWarps][kListLen];
  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kAhead = 4;  // chunks whose lists are loaded before any is merged

  float ls = kNegInf;
  int li = 0;
  for (int c0 = warp; c0 < chunks; c0 += kMergeWarps * kAhead) {
    float cs[kAhead];
    int ci[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = c0 + u * kMergeWarps;
      cs[u] = kNegInf;
      ci[u] = 0;
      if (c < chunks) {
        const long long o = (static_cast<long long>(c) * nq + qi) * kListLen + lane;
        cs[u] = part_s[o];
        ci[u] = part_i[o];
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) list_offer(ls, li, cs[u], ci[u], lane);
  }
  ms[warp][lane] = ls;
  mi[warp][lane] = li;
  __syncthreads();
  if (warp == 0) {
    ls = kNegInf;
    li = 0;
    for (int w = 0; w < kMergeWarps; ++w) list_offer(ls, li, ms[w][lane], mi[w][lane], lane);
    if (lane < k) {
      out_s[qi * k + lane] = ls;
      out_i[qi * k + lane] = li;
    }
  }
}

struct StreamArgs {
  const void* emb;
  int row_bytes;
  const float* scales;
  const float* pay;
  const float* q;
  int nq;
  int d;
  long long cap;
  int n_valid;
  float one_minus_eta;
  float eta;
  float half_ep;
  int k;
  int chunks;
  float* part_s;
  int* part_i;
  float* out_s;
  int* out_i;
};

// Dynamic shared memory of one CTA: the row tile, QT f32 queries and the
// tile's QT x 128 adjusted scores.
size_t stream_smem(int qt, int d) {
  return kTileBytes + sizeof(float) * qt * (static_cast<size_t>(d) + kThreads);
}

template <int KIND, int QT>
int stream_launch_qt(const StreamArgs& a, cudaStream_t stream) {
  static std::atomic<int> smem_set_on[kMaxDevices];  // zero: static storage
  static std::mutex smem_mu;
  const size_t smem = stream_smem(QT, a.d);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto fn = stream_partial_kernel<KIND, QT>;
  if (smem > 48 * 1024) {
    cudaError_t e = opt_in_smem(fn, smem, smem_set_on, smem_mu);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long live = a.n_valid < 0 ? 0 : (a.n_valid < a.cap ? a.n_valid : a.cap);
  const int nsub = static_cast<int>((live + kSub - 1) / kSub);
  const int sub_per_chunk = nsub > 0 ? (nsub + a.chunks - 1) / a.chunks : 1;
  fn<<<a.chunks, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(a.emb), a.row_bytes, a.scales, a.pay, a.q, a.nq, a.d,
      a.n_valid, a.one_minus_eta, a.eta, a.half_ep, sub_per_chunk, nsub, a.part_s, a.part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stream_merge_kernel<<<a.nq, kMergeWarps * 32, 0, stream>>>(
      a.part_s, a.part_i, a.chunks, a.nq, a.k, a.out_s, a.out_i);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int stream_launch(const StreamArgs& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.cap <= 0 || a.cap % kSub != 0 || a.cap > 0x7FFFFFFFLL || a.row_bytes % 16 != 0 ||
      a.nq < 1 || a.k < 1 || a.k > kListLen || a.chunks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.nq <= 1) return stream_launch_qt<KIND, 1>(a, st);
  if (a.nq <= 2) return stream_launch_qt<KIND, 2>(a, st);
  if (a.nq <= 4) return stream_launch_qt<KIND, 4>(a, st);
  if (a.nq <= 8) return stream_launch_qt<KIND, 8>(a, st);
  if (a.nq <= 16) return stream_launch_qt<KIND, 16>(a, st);
  if (a.nq <= 32) return stream_launch_qt<KIND, 32>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// pallas_fused_search: emb [cap, d] f32 (pre-normalized), pay [cap, 8] f32,
// q [nq, d] f32 -> out_s [nq, k] f32, out_i [nq, k] i32.  part_s/part_i are
// [chunks, nq, 32] scratch.
int dewi_stream_search(const float* emb, const float* pay, const float* q, int nq, int d,
                       long long cap, int n_valid, float one_minus_eta, float eta,
                       float half_ep, int k, int chunks, float* part_s, int* part_i,
                       float* out_s, int* out_i, void* stream) {
  StreamArgs a{emb, d * 4, nullptr, pay, q, nq, d, cap, n_valid, one_minus_eta, eta, half_ep,
               k, chunks, part_s, part_i, out_s, out_i};
  return stream_launch<kF32>(a, stream);
}

// pallas_int8_search: emb [cap, d] int8, scales [cap] f32; otherwise as
// dewi_stream_search.
int dewi_int8_stream_search(const int8_t* emb, const float* scales, const float* pay,
                            const float* q, int nq, int d, long long cap, int n_valid,
                            float one_minus_eta, float eta, float half_ep, int k, int chunks,
                            float* part_s, int* part_i, float* out_s, int* out_i,
                            void* stream) {
  StreamArgs a{emb, d, scales, pay, q, nq, d, cap, n_valid, one_minus_eta, eta, half_ep,
               k, chunks, part_s, part_i, out_s, out_i};
  return stream_launch<kI8>(a, stream);
}

// The most queries one streaming launch takes at dim d (a power of two up
// to 32), 0 when not even one fits; the same for both row kinds, since the
// queries are staged as f32.
int dewi_stream_queries_per_launch(int d) {
  for (int qt = 32; qt >= 1; qt >>= 1) {
    if (stream_smem(qt, d) <= kMaxSmem) return qt;
  }
  return 0;
}

}  // extern "C"
