// Streaming top-k search kernel for Hopper (sm_90a) over f32 rows, and the
// merge that both streaming searches end with.
//
// Hand-written CUDA port of the Pallas kernel of
// dewi_tpu/ops/pallas_search.py that searches f32 rows in one pass:
//
//   dewi_stream_search <- pallas_fused_search (:129, _search_kernel :70)
//
// with _topk_via_max (:46) as the selection.  (Its int8 twin,
// dewi_int8_stream_search <- pallas_int8_search, runs on the tensor cores
// in search_kernels.cu and ends with the same merge, stream_merge.)  For
// every query q and corpus row r it computes
//
//   sim[q, r] = sum_d q[q, d] * row[r, d]
//   adj[q, r] = (1 - eta) * sim + eta * pay[r, 0]
//               + (entropy_pref * 0.5) * (pay[r, 1] + pay[r, 3])
//
// with rows r >= n_valid at -3.4e38 (a finite float), and returns the k
// best (adj, r) per query: descending score, and among equal scores the
// lower row first.  With fewer than k rows above -3.4e38 the remaining
// slots are (-3.4e38, 0).  The dot is an f32 sum of f32 products on the
// CUDA cores; the re-rank is evaluated term by term with one rounding per
// operation, as the plain PyTorch version in
// dewi_tpu_torch/ops/cuda_search.py does, so given the same dot the scores
// agree bit for bit.
//
// Bound on this card: it reads the corpus once and does 2*Q operations per
// element at Q <= 32, so it is bound by device-memory bytes: the live rows
// and their payloads read once; the output is Q*k pairs.
//
// Design.  The TPU kernel walks the corpus in order and carries one
// running [Q, k] buffer; here the live rows are split over `chunks` CTAs.
// A CTA of 128 threads walks its 128-row tiles (one thread per row, rows
// staged 256 bytes at a time with cp.async, the queries in shared memory as
// f32, one accumulator per query in registers) and writes each tile's
// adjusted scores to shared memory.  Selection is by warp: warp w owns
// queries w, w+4, ... and keeps, for each, a sorted list of 32 (score, row)
// pairs, entry j in lane j's registers (list_offer, common.cuh).  A tile's
// 128 scores are offered to the list 32 at a time: one ballot finds the
// lanes whose candidate precedes the list's tail (after the first tiles,
// usually none), and each of those is inserted by a ballot for its
// position and one shuffle.  A CTA ends by writing its lists as
// [chunks, Q, 32] partial results.  Tiles from ceil(n_valid / 128) on are
// never read.  A second kernel merges the partials: one CTA per query,
// eight warps each merging a strided share of the chunks' lists (a
// bitonic merge of two sorted lists, list_merge), then warp 0 merging the
// eight.  The order (score, then
// row) is total, so the result does not depend on how the rows are chunked.

#include "common.cuh"

namespace {

using namespace dewi;

constexpr float kNegInf = kStreamNegInf;
constexpr int kWarps = kThreads / 32;
constexpr int kMergeWarps = 8;
constexpr unsigned kFull = kFullMask;

template <int QT>
__global__ void __launch_bounds__(kThreads)
stream_partial_kernel(const uint8_t* __restrict__ emb, int row_bytes,
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

  // Stage the queries, zero-padded to QT rows.
  for (int i = tid; i < QT * d; i += kThreads) qs[i] = (i / d) < nq ? q[i] : 0.f;

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
        const float x[4] = {__uint_as_float(raw.x), __uint_as_float(raw.y),
                            __uint_as_float(raw.z), __uint_as_float(raw.w)};
        const int dim0 = (s0 + c * 16) / 4;
#pragma unroll
        for (int qi = 0; qi < QT; ++qi) {
          const float4 t = *reinterpret_cast<const float4*>(qs + qi * d + dim0);
          float a = acc[qi];
          a = fmaf(x[0], t.x, a);
          a = fmaf(x[1], t.y, a);
          a = fmaf(x[2], t.z, a);
          a = fmaf(x[3], t.w, a);
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
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
      const float adj = __fadd_rn(__fadd_rn(__fmul_rn(one_minus_eta, acc[qi]), dewi), ent);
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
    for (int u = 0; u < kAhead; ++u) list_merge(ls, li, cs[u], ci[u], lane);
  }
  ms[warp][lane] = ls;
  mi[warp][lane] = li;
  __syncthreads();
  if (warp == 0) {
    ls = kNegInf;
    li = 0;
    for (int w = 0; w < kMergeWarps; ++w) list_merge(ls, li, ms[w][lane], mi[w][lane], lane);
    if (lane < k) {
      out_s[qi * k + lane] = ls;
      out_i[qi * k + lane] = li;
    }
  }
}

struct StreamArgs {
  const float* emb;
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

template <int QT>
int stream_launch_qt(const StreamArgs& a, cudaStream_t stream) {
  static std::atomic<int> smem_set_on[kMaxDevices];  // zero: static storage
  static std::mutex smem_mu;
  const size_t smem = stream_smem(QT, a.d);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto fn = stream_partial_kernel<QT>;
  if (smem > 48 * 1024) {
    cudaError_t e = opt_in_smem(fn, smem, smem_set_on, smem_mu);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long live = a.n_valid < 0 ? 0 : (a.n_valid < a.cap ? a.n_valid : a.cap);
  const int nsub = static_cast<int>((live + kSub - 1) / kSub);
  const int sub_per_chunk = nsub > 0 ? (nsub + a.chunks - 1) / a.chunks : 1;
  fn<<<a.chunks, kThreads, smem, stream>>>(
      reinterpret_cast<const uint8_t*>(a.emb), a.d * 4, a.pay, a.q, a.nq, a.d, a.n_valid,
      a.one_minus_eta, a.eta, a.half_ep, sub_per_chunk, nsub, a.part_s, a.part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return stream_merge(a.part_s, a.part_i, a.chunks, a.nq, a.k, a.out_s, a.out_i, stream);
}

int stream_launch(const StreamArgs& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.cap <= 0 || a.cap % kSub != 0 || a.cap > 0x7FFFFFFFLL || a.d % 4 != 0 ||
      a.nq < 1 || a.k < 1 || a.k > kListLen || a.chunks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.nq <= 1) return stream_launch_qt<1>(a, st);
  if (a.nq <= 2) return stream_launch_qt<2>(a, st);
  if (a.nq <= 4) return stream_launch_qt<4>(a, st);
  if (a.nq <= 8) return stream_launch_qt<8>(a, st);
  if (a.nq <= 16) return stream_launch_qt<16>(a, st);
  if (a.nq <= 32) return stream_launch_qt<32>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

namespace dewi {

int stream_merge(const float* part_s, const int* part_i, int chunks, int nq, int k,
                 float* out_s, int* out_i, cudaStream_t stream) {
  stream_merge_kernel<<<nq, kMergeWarps * 32, 0, stream>>>(part_s, part_i, chunks, nq, k,
                                                            out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dewi

extern "C" {

// pallas_fused_search: emb [cap, d] f32 (pre-normalized), pay [cap, 8] f32,
// q [nq, d] f32 -> out_s [nq, k] f32, out_i [nq, k] i32.  part_s/part_i are
// [chunks, nq, 32] scratch.
int dewi_stream_search(const float* emb, const float* pay, const float* q, int nq, int d,
                       long long cap, int n_valid, float one_minus_eta, float eta,
                       float half_ep, int k, int chunks, float* part_s, int* part_i,
                       float* out_s, int* out_i, void* stream) {
  StreamArgs a{emb, pay, q, nq, d, cap, n_valid, one_minus_eta, eta, half_ep,
               k, chunks, part_s, part_i, out_s, out_i};
  return stream_launch(a, stream);
}

// The most queries one dewi_stream_search launch takes at dim d (a power of
// two up to 32), 0 when not even one fits.
int dewi_stream_queries_per_launch(int d) {
  for (int qt = 32; qt >= 1; qt >>= 1) {
    if (stream_smem(qt, d) <= kMaxSmem) return qt;
  }
  return 0;
}

}  // extern "C"
