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
// CUDA cores, one fmaf per element in the order of d, so a query's scores
// do not depend on how many queries ride with it or how the rows are
// split; the re-rank is evaluated term by term with one rounding per
// operation, as the plain PyTorch version in
// dewi_tpu_torch/ops/cuda_search.py does, so given the same dot the scores
// agree bit for bit.  No TF32 and no tensor cores: this is the exact f32
// tier, the recall reference.
//
// Bound on this card: it reads the live rows and their payloads once
// (1.056 GB at 1,000,000 x 256, 0.315 ms at 3.35 TB/s) and does 2 * Q
// operations per element (at Q=32, 0.245 ms at the 67 TFLOP/s of f32 FMA),
// so bytes bound it at every Q <= 32; at Q=32 the FMAs alone take 78% of
// that time at the f32 peak, so they must run in most cycles, overlapped
// with the copies.
//
// Design (stream_topk_kernel).  The TPU kernel walks the corpus in order
// and carries one running [Q, k] buffer; here every warp is a persistent
// worker that walks 32-row groups w, w + W, ... of the live rows (W warps
// in a grid of as many CTAs as the card holds at once; groups from
// ceil(n_valid / 32) on are never read).
//   * The queries, zero-padded to QT = 1, 2, 4, 8, 16 or 32 rows, are
//     staged once per CTA in shared memory, with a row stride of 4 floats
//     past a multiple of 32, so the 4 queries a load instruction reads sit
//     on distinct banks.
//   * Each warp streams its groups through its own ring of kStages stages
//     of 4 KB: 32 rows x 128 bytes (a slab of 32 floats of each row),
//     filled by 16-byte cp.async copies kStages - 1 slabs ahead, across
//     groups, so the next group's copies overlap this group's FMAs and its
//     selection.  The 16-byte chunks of a slab row are XOR-swizzled by the
//     row's low 3 bits: the copies and the reads are free of bank
//     conflicts without padding.  A warp waits only on its own copies (no
//     CTA barrier in the main loop).  Measured on an H100 at 2^20 x 256
//     with 1M live rows: four stages beat three by 3% at Q <= 4 and tied
//     above; 256-byte slabs in three stages leave room for only 6 warps at
//     Q=32 (0.79 ms against 0.57); padded rows in place of the swizzle, 12
//     warps per CTA, or a partly unrolled chunk loop were no better.
//   * The product is register-tiled: the lanes form kRG row lanes by kQG
//     query lanes, and each thread computes kR rows x kC queries (4 x 8 at
//     QT=32, one row and one query at QT=1).  Per 16-byte chunk it loads
//     kR row vectors and kC query vectors (broadcast to the lanes that
//     share them) for 4 * kR * kC FMAs: 12 loads for 128 FMAs at QT=32.
//   * When a group's last slab is done, each thread re-ranks its scores in
//     registers (the payload's first 16 bytes, loaded a group ahead) and
//     masks the rows past n_valid.  Each warp keeps, per query, a sorted
//     list of 32 (score, row) in shared memory (entry j at lane j;
//     common.cuh) and the CTA a threshold per query: the largest entry
//     k - 1 of its warps' lists.  A warp's rows come in increasing order,
//     so one compare of each score with its list's entry k - 1 and the
//     threshold, and one OR across the warp, decide whether the group
//     offers anything; only then are the group's scores transposed through
//     the ring stage just read (to [query][row], XOR-swizzled) and each
//     passing query offered its 32 rows (list_offer_many), one code path
//     for every query.  Above 8 queries and 131,072 live rows a first pass
//     over the first 32,768 rows is merged first and each query's k-th
//     score from it starts the thresholds of the full pass: k rows score
//     at least that, with this kernel's own arithmetic, so pruning below
//     it is exact (without it Q=32 took 0.68 ms in place of 0.57).
//   * At the end each CTA merges its warps' lists into one per query,
//     [grid, Q, 32]; a second kernel (stream_merge) merges those: one CTA
//     per query, eight warps each merging a strided share of the lists (a
//     bitonic merge of two sorted lists, list_merge), then warp 0 merging
//     the eight.  The order (score, then row) is total, so the result does
//     not depend on how the rows were split over warps and CTAs.

#include "common.cuh"

namespace {

using namespace dewi;

constexpr float kNegInf = kStreamNegInf;
constexpr int kMergeWarps = 8;
constexpr unsigned kFull = kFullMask;

constexpr int kGroupRows = 32;                        // rows of a warp's unit: one per lane
constexpr int kSlabFloats = 32;                       // floats of each row per ring stage
constexpr int kSlabBytes = kSlabFloats * 4;
constexpr int kSlabChunks = kSlabBytes / 16;          // 16-byte chunks of a slab row
constexpr int kStageBytes = kGroupRows * kSlabBytes;  // one stage: 4 KB
constexpr int kStages = 4;
constexpr int kRingBytes = kStages * kStageBytes;     // per warp
constexpr int kMaxWarps = 8;
constexpr int kMinWarps = 4;
static_assert(kSlabChunks <= 16 && 32 % kSlabChunks == 0, "a slab row is 64 to 256 bytes");
static_assert(32 * kGroupRows * 4 <= kStageBytes, "the selection tile fits in a stage");

// How a warp's lanes split QT queries and 32 rows: kQG query lanes by kRG
// row lanes (lane = rg + kRG * qg); thread (rg, qg) computes rows rg + kRG
// * i (i < kR) against queries qg + kQG * j (j < kC).
template <int QT>
struct Tiling {
  static constexpr int kQG = QT < 4 ? QT : 4;
  static constexpr int kRG = 32 / kQG;
  static constexpr int kR = kGroupRows / kRG;
  static constexpr int kC = QT / kQG;
  static_assert(kR * kC == QT && kRG * kR == kGroupRows, "the lanes cover QT x 32");
};

// Floats between staged queries: the dim rounded up to 32, plus 4.
__host__ __device__ constexpr int query_stride(int d) { return (d + 31) / 32 * 32 + 4; }
__host__ __device__ constexpr size_t query_bytes(int qt, int d) {
  return static_cast<size_t>(qt) * query_stride(d) * 4;
}
// Per warp: a ring and its lists ([QT][kListStride] scores, as many rows);
// a CTA holds its warps' rings, then their lists.
__host__ __device__ constexpr int list_bytes(int qt) { return 2 * qt * kListStride * 4; }
__host__ __device__ constexpr int warp_bytes(int qt) { return kRingBytes + list_bytes(qt); }

// Dynamic shared memory of one CTA: the queries, the warps' rings and
// lists, one threshold per query.
size_t stream_smem(int qt, int d, int warps) {
  return query_bytes(qt, d) + static_cast<size_t>(warps) * warp_bytes(qt) + 4 * qt;
}

// The warps of a CTA at this query size and dim: as many as fit beside the
// queries, at most kMaxWarps; 0 below kMinWarps.
int stream_warps(int qt, int d) {
  const size_t fixed = query_bytes(qt, d) + 4 * qt;
  if (fixed + static_cast<size_t>(kMinWarps) * warp_bytes(qt) > kMaxSmem) return 0;
  const int fit = static_cast<int>((kMaxSmem - fixed) / warp_bytes(qt));
  return fit < kMaxWarps ? fit : kMaxWarps;
}

template <int QT>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
stream_topk_kernel(const float* __restrict__ emb,  // [cap, d]
                   const float* __restrict__ pay,  // [cap, 8]
                   const float* __restrict__ q,    // [nq, d]
                   int nq, int d, long long groups, int n_valid, float one_minus_eta,
                   float eta, float half_ep, int k, const float* __restrict__ seed,
                   float* __restrict__ part_s, int* __restrict__ part_i) {
  using T = Tiling<QT>;
  constexpr int R = T::kR, C = T::kC, QG = T::kQG, RG = T::kRG;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cta_warps = blockDim.x >> 5;
  const int rg = lane % RG;
  const int qg = lane / RG;
  const int qstride = query_stride(d);
  const size_t qbytes = query_bytes(QT, d);
  float* qs = reinterpret_cast<float*>(smem);
  uint8_t* ring = smem + qbytes + warp * kRingBytes;
  float* wls = reinterpret_cast<float*>(smem + qbytes + cta_warps * kRingBytes +
                                        warp * list_bytes(QT));
  int* wli = reinterpret_cast<int*>(wls + QT * kListStride);
  int* thr = reinterpret_cast<int*>(smem + qbytes + cta_warps * warp_bytes(QT));

  // The queries, zeros past nq and d.  The CTA's threshold of each query
  // (as order_key): entry k - 1 of the seed or of some warp's list; k rows
  // score at least that (the seed's scores are this kernel's own, over the
  // same rows), so no score below it is among the k best.  A warp's list
  // of a query past nq starts at +inf, so that nothing is offered to it.
  for (int i = tid; i < QT * qstride; i += blockDim.x) {
    const int r = i / qstride;
    const int c = i - r * qstride;
    qs[i] = r < nq && c < d ? q[static_cast<long long>(r) * d + c] : 0.f;
  }
  for (int i = tid; i < QT; i += blockDim.x) {
    thr[i] = order_key(seed != nullptr && i < nq ? seed[i * k + k - 1] : -INFINITY);
  }
  for (int i = 0; i < QT; ++i) {
    wls[i * kListStride + lane] = i < nq ? kNegInf : INFINITY;
    wli[i * kListStride + lane] = 0;
  }
  __syncthreads();

  const int nwarps = gridDim.x * cta_warps;
  const int wid = blockIdx.x * cta_warps + warp;
  const int nslab = (d + kSlabFloats - 1) / kSlabFloats;
  const long long mine = wid < groups ? (groups - wid + nwarps - 1) / nwarps : 0;
  const long long total = mine * nslab;  // slabs this warp walks

  // Producer: slab p_s of group p_g into a ring stage, kCopyRows rows per
  // copy instruction, chunk p_c of a row at p_c ^ (row & 7).
  constexpr int kCopyRows = 32 / kSlabChunks;
  const int p_row = lane / kSlabChunks;
  const int p_c = lane % kSlabChunks;
  long long p_g = wid;
  int p_s = 0;
  auto fetch = [&](int stage) {
    const int col = p_s * kSlabFloats + 4 * p_c;
    if (col < d) {  // a slab past the end of the row holds fewer chunks
      const float* src = emb + (p_g * kGroupRows + p_row) * d + col;
      uint8_t* dst = ring + stage * kStageBytes;
#pragma unroll
      for (int i = 0; i < kGroupRows / kCopyRows; ++i) {
        const int r = p_row + i * kCopyRows;
        cp_async16(dst + r * kSlabBytes + ((p_c ^ (r & 7)) << 4),
                   src + static_cast<long long>(i) * kCopyRows * d);
      }
    }
    if (++p_s == nslab) {
      p_s = 0;
      p_g += nwarps;
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) fetch(i);
    cp_async_commit();
  }

  // Consumer state: the thread's kR x kC sums, and the re-rank terms of its
  // rows, eta * pay[r, 0] and (entropy_pref / 2) * (pay[r, 1] + pay[r, 3]),
  // each rounded once as the plain version computes them, loaded a group
  // ahead.
  float acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
  }
  float a[R], en[R];
  auto load_terms = [&](long long row0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(pay + (row0 + rg + RG * i) * 8);
      a[i] = __fmul_rn(eta, p.x);
      en[i] = __fmul_rn(half_ep, __fadd_rn(p.y, p.w));
    }
  };
  const int last = k - 1;
  long long c_g = wid;
  int c_s = 0, stage = 0;
  if (total > 0) load_terms(c_g * kGroupRows);

  for (long long it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();  // this lane's copies of slab `it` have landed
    __syncwarp();                  // ... and every lane's; the stage read last is free
    if (it + kStages - 1 < total) fetch(stage == 0 ? kStages - 1 : stage - 1);
    cp_async_commit();

    uint8_t* st = ring + stage * kStageBytes;
    const float* qk = qs + c_s * kSlabFloats;
    // One 16-byte chunk: elements 4c .. 4c + 3 of the slab, in order.
    auto chunk = [&](int c) {
      float4 x[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = rg + RG * i;
        x[i] = *reinterpret_cast<const float4*>(st + r * kSlabBytes + ((c ^ (r & 7)) << 4));
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float4 t = *reinterpret_cast<const float4*>(qk + (qg + QG * j) * qstride + 4 * c);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float s = acc[i][j];
          s = fmaf(x[i].x, t.x, s);
          s = fmaf(x[i].y, t.y, s);
          s = fmaf(x[i].z, t.z, s);
          s = fmaf(x[i].w, t.w, s);
          acc[i][j] = s;
        }
      }
    };
    const int nc = min(kSlabChunks, (d - c_s * kSlabFloats) / 4);
    if (nc == kSlabChunks) {
#pragma unroll
      for (int c = 0; c < kSlabChunks; ++c) chunk(c);
    } else {
      for (int c = 0; c < nc; ++c) chunk(c);
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
    if (++c_s < nslab) continue;

    // The group is complete.  Re-rank, mask, and find the queries for
    // which some score beats its list's entry k - 1 and the CTA's
    // threshold (a later row's equal score does not precede the list's).
    c_s = 0;
    const long long row0 = c_g * kGroupRows;
    unsigned qbits = 0;  // bit q: query q has a passing score in this thread
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int qq = qg + QG * j;
      const float tail = wls[qq * kListStride + last];
      const float cut = order_value(thr[qq]);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float v =
            __fadd_rn(__fadd_rn(__fmul_rn(one_minus_eta, acc[i][j]), a[i]), en[i]);
        const float sc = row0 + rg + RG * i < n_valid ? v : kNegInf;
        acc[i][j] = sc;
        if (sc > tail && sc >= cut) qbits |= 1u << qq;
      }
    }
    const unsigned passing = __reduce_or_sync(kFull, qbits);
    if (passing) {
      // Transpose the group's scores through the stage just read (only
      // this warp reads it, and its next copy starts after the next
      // __syncwarp): score (row r, query q) at q * 32 + (r ^ kRG * (q %
      // kQG)), which puts the 32 stores of an instruction on 32 banks; lane
      // j then reads row j of each passing query.
      float* sel = reinterpret_cast<float*>(st);
      __syncwarp();  // every lane has read its rows from the stage
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int qq = qg + QG * j;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          sel[qq * 32 + ((rg + RG * i) ^ (RG * (qq % QG)))] = acc[i][j];
        }
      }
      __syncwarp();
      offer_group(
          passing, [&](int qq) { return sel[qq * 32 + (lane ^ (RG * (qq % QG)))]; }, wls, wli,
          thr, static_cast<int>(row0), lane, last);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
    }
    c_g += nwarps;
    if (it + 1 < total) load_terms(c_g * kGroupRows);
  }

  // Merge the CTA's lists into its partial result part[blockIdx.x, q, 32].
  __syncthreads();
  merge_cta_lists(smem + qbytes + cta_warps * kRingBytes, list_bytes(QT), QT, cta_warps, nq,
                  warp, lane, part_s, part_i);
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
  int n_valid;
  float one_minus_eta;
  float eta;
  float half_ep;
  int k;
  const float* seed;  // null, or [nq, k] scores whose entry k - 1 starts each threshold
  float* part_s;
  int* part_i;
};

// The kernel at QT readied for a launch on the current device: its warps,
// its dynamic shared memory (opted in) and how many CTAs the card holds.
struct Ready {
  int warps;
  size_t smem;
  long long held;
};

template <int QT>
cudaError_t ready(int d, Ready* r) {
  static std::atomic<int> smem_set_on[kMaxDevices];  // zero: static storage
  static std::mutex smem_mu;
  r->warps = stream_warps(QT, d);
  if (r->warps == 0) return cudaErrorInvalidValue;
  r->smem = stream_smem(QT, d, r->warps);
  return cta_capacity(stream_topk_kernel<QT>, r->warps * 32, r->smem, smem_set_on, smem_mu,
                      &r->held);
}

// One pass over `groups` 32-row groups on a persistent grid: as many CTAs
// as the card holds, fewer where the groups are fewer than its warps, at
// most max_ctas.  The grid launched goes to *ctas.
template <int QT>
int pass_qt(const StreamArgs& a, long long groups, int max_ctas, int* ctas,
            cudaStream_t stream) {
  Ready r;
  cudaError_t e = ready<QT>(a.d, &r);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long grid = (groups + r.warps - 1) / r.warps;
  if (grid > r.held) grid = r.held;
  if (grid > max_ctas) grid = max_ctas;
  if (grid < 1) grid = 1;  // writes its lists, empty, with no live row
  *ctas = static_cast<int>(grid);
  stream_topk_kernel<QT><<<dim3(static_cast<unsigned>(grid)), r.warps * 32, r.smem, stream>>>(
      a.emb, a.pay, a.q, a.nq, a.d, groups, a.n_valid, a.one_minus_eta, a.eta, a.half_ep, a.k,
      a.seed, a.part_s, a.part_i);
  return static_cast<int>(cudaGetLastError());
}

int pass(const StreamArgs& a, long long groups, int max_ctas, int* ctas, cudaStream_t st) {
  if (a.nq <= 1) return pass_qt<1>(a, groups, max_ctas, ctas, st);
  if (a.nq <= 2) return pass_qt<2>(a, groups, max_ctas, ctas, st);
  if (a.nq <= 4) return pass_qt<4>(a, groups, max_ctas, ctas, st);
  if (a.nq <= 8) return pass_qt<8>(a, groups, max_ctas, ctas, st);
  if (a.nq <= 16) return pass_qt<16>(a, groups, max_ctas, ctas, st);
  return pass_qt<32>(a, groups, max_ctas, ctas, st);
}

template <int QT>
int held_qt(int d) {
  Ready r{};
  const cudaError_t e = ready<QT>(d, &r);
  return e == cudaSuccess ? static_cast<int>(r.held) : -static_cast<int>(e);
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
// q [nq, d] f32 (nq <= 32) -> out_s [nq, k] f32, out_i [nq, k] i32, k <= 32.
// The kernel walks the live rows on a persistent grid of at most max_ctas
// CTAs, each of which writes its lists to part_s/part_i ([max_ctas, nq, 32]
// scratch); stream_merge then merges them.
int dewi_stream_search(const float* emb, const float* pay, const float* q, int nq, int d,
                       long long cap, int n_valid, float one_minus_eta, float eta,
                       float half_ep, int k, int max_ctas, float* part_s, int* part_i,
                       float* out_s, int* out_i, void* stream) {
  if (cap <= 0 || cap % kSub != 0 || cap > 0x7FFFFFFFLL || d <= 0 || d % 4 != 0 || nq < 1 ||
      nq > 32 || k < 1 || k > kListLen || max_ctas < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long live = n_valid < 0 ? 0 : (n_valid < cap ? n_valid : cap);
  StreamArgs a{emb, pay, q, nq, d, n_valid, one_minus_eta, eta, half_ep, k,
               nullptr, part_s, part_i};
  int ctas = 0, rc = 0;
  if (live > kSeedMinRows && nq > kSeedMinQueries) {
    // Seed: search the first kSeedRows rows (all live) into out, whose
    // entry k - 1 per query then starts the thresholds of the full pass.
    if ((rc = pass(a, kSeedRows / kGroupRows, max_ctas, &ctas, st)) != 0) return rc;
    if ((rc = stream_merge(part_s, part_i, ctas, nq, k, out_s, out_i, st)) != 0) return rc;
    a.seed = out_s;
  }
  const long long groups = (live + kGroupRows - 1) / kGroupRows;  // groups past these are not read
  if ((rc = pass(a, groups, max_ctas, &ctas, st)) != 0) return rc;
  return stream_merge(part_s, part_i, ctas, nq, k, out_s, out_i, st);
}

// The most queries one dewi_stream_search launch takes at dim d (a power of
// two up to 32): the queries and the rings and lists of at least kMinWarps
// warps must fit in shared memory.  0 when not even one query fits or d is
// not a multiple of 4.
int dewi_stream_queries_per_launch(int d) {
  if (d <= 0 || d % 4 != 0) return 0;
  for (int qt = 32; qt >= 1; qt >>= 1) {
    if (stream_warps(qt, d) > 0) return qt;
  }
  return 0;
}

// The most CTAs a dewi_stream_search launch of nq queries at dim d takes on
// the current device (its partial lists need that many rows); minus the
// CUDA error where there is one.
int dewi_stream_max_ctas(int nq, int d) {
  if (d <= 0 || d % 4 != 0 || nq < 1 || nq > 32) return -static_cast<int>(cudaErrorInvalidValue);
  if (nq <= 1) return held_qt<1>(d);
  if (nq <= 2) return held_qt<2>(d);
  if (nq <= 4) return held_qt<4>(d);
  if (nq <= 8) return held_qt<8>(d);
  if (nq <= 16) return held_qt<16>(d);
  return held_qt<32>(d);
}

}  // extern "C"
