// Helpers shared by the search kernels (search_kernels.cu, stream_kernels.cu):
// the tile height, cp.async copies, the tensor-core primitives, the row
// unpacks, the streaming searches' top-k lists and the shared-memory
// opt-in.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace dewi {

constexpr int kSub = 128;                  // rows per tile == BLOCKMAX_SUB
constexpr int kMaxSmem = 232448;           // per-block limit on sm_90
constexpr int kMaxDevices = 64;

// A 16-byte cp.async from gmem to smem (both 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// A 16-byte cp.async that copies src_bytes (0 or 16) from gmem and fills
// the rest with zeros; gmem must be a valid address even for 0 bytes.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D += A * B on the tensor cores: A 16x16 bf16 (row-major fragments),
// B 16x8 bf16, D 16x8 f32.  With g = lane / 4 and t = lane % 4 a thread
// holds a[0] = A[g][2t, 2t+1], a[1] = A[g+8][2t, 2t+1], a[2] = A[g][2t+8,
// 2t+9], a[3] = A[g+8][2t+8, 2t+9]; b0 = B[2t, 2t+1][g], b1 = B[2t+8,
// 2t+9][g]; c[0], c[1] = D[g][2t, 2t+1], c[2], c[3] = D[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A * B on the tensor cores in exact integers: A 16x32 s8 (row-major
// fragments), B 32x8 s8, D 16x8 s32.  The lanes own what they own in
// mma_bf16_16816, four s8 to a register where that has two bf16: a[0] =
// A[g][4t .. 4t+3], a[1] = A[g+8][4t .. 4t+3], a[2] = A[g][4t+16 .. 4t+19],
// a[3] = A[g+8][4t+16 .. 4t+19]; b0 = B[4t .. 4t+3][g], b1 = B[4t+16 ..
// 4t+19][g]; c as there.  No .satfinite: the s32 sum wraps as JAX's int32
// dot does, and |acc| <= 127 * 128 * D cannot overflow below D = 2^17.
__device__ __forceinline__ void mma_s8_16832(int (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four s8 values (one word) to two bf16 pairs, exactly: lo = {v0, v1},
// hi = {v2, v3}.  A permute puts 0x43 above each byte b.  With bit 7 of b
// cleared that half reads as the bf16 128 + (b & 127); with the low seven
// bits cleared, as 128 + (b & 128), since bit 7 of the half is the
// exponent's lowest bit.  Their difference is (b & 127) - (b & 128), the
// value of the s8 byte, and is exact in bf16.  Full-rate permutes, logic
// and one packed subtract per pair in place of the quarter-rate int ->
// float conversion.
__device__ __forceinline__ uint32_t s8_halves_to_bf16x2(uint32_t p) {
  const uint32_t x = p & 0xFF7FFF7Fu;
  const uint32_t y = p & 0xFF80FF80u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                                   *reinterpret_cast<const __nv_bfloat162*>(&y));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void s8x4_to_bf16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo = s8_halves_to_bf16x2(__byte_perm(w, 0x43434343u, 0x4140));
  hi = s8_halves_to_bf16x2(__byte_perm(w, 0x43434343u, 0x4342));
}

// One nibble plane of four plane-packed int4 bytes (one word) as four s8,
// each 16 times its value: the high nibbles (signed) are b & 0xF0 as they
// sit; the low nibbles (biased by 8) are (b << 4) ^ 0x80, since
// 16 * ((b & 15) - 8) = ((b & 15) << 4) - 128.  Exact: 16 * [-8, 7] is
// [-128, 112].  One logic operation (high) or a shift and one (low) per
// word, where the sign extension of the values themselves takes a packed
// subtract.
__device__ __forceinline__ uint32_t nibble_plane16(uint32_t w, bool low) {
  return low ? ((w << 4) & 0xF0F0F0F0u) ^ 0x80808080u : w & 0xF0F0F0F0u;
}

// ---- the streaming searches' top-k lists --------------------------------

constexpr float kStreamNegInf = -3.4e38f;  // NEG_INF of pallas_search.py: finite
constexpr int kListLen = 32;               // list entries: one per lane; k <= 32
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// (as, ai) stands before (bs, bi) in the result: higher score, then lower row.
__device__ __forceinline__ bool precedes(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// Inserts the candidates of the lanes in m (one per lane) into the warp's
// sorted list (entry j in lane j), one at a time: a ballot finds each one's
// place among all 32 entries and one shuffle moves the entries after it, so
// the whole list stays sorted; a candidate that no longer precedes any
// entry finds position 32 and changes nothing.
__device__ __forceinline__ void list_insert(float& ls, int& li, float cs, int ci, int lane,
                                           unsigned m) {
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float s = __shfl_sync(kFullMask, cs, src);
    const int i = __shfl_sync(kFullMask, ci, src);
    const int p = __popc(__ballot_sync(kFullMask, precedes(ls, li, s, i)));
    const float us = __shfl_up_sync(kFullMask, ls, 1);
    const int ui = __shfl_up_sync(kFullMask, li, 1);
    if (lane > p) {
      ls = us;
      li = ui;
    } else if (lane == p) {
      ls = s;
      li = i;
    }
  }
}

// Compare-exchange of one bitonic step between lanes lane and lane ^ d:
// the lane that should hold the earlier entry (lower lane of a descending
// block, upper lane of an ascending one) takes its partner's where the
// partner's precedes.
__device__ __forceinline__ void bitonic_step(float& s, int& i, int d, bool earlier) {
  const float ps = __shfl_xor_sync(kFullMask, s, d);
  const int pi = __shfl_xor_sync(kFullMask, i, d);
  if (earlier == precedes(ps, pi, s, i)) {
    s = ps;
    i = pi;
  }
}

// Sorts one (score, row) per lane into a list, entry j in lane j: a
// bitonic network of 15 steps.
__device__ __forceinline__ void list_sort(float& s, int& i, int lane) {
#pragma unroll
  for (int k = 2; k <= kListLen; k <<= 1) {
#pragma unroll
    for (int d = k >> 1; d > 0; d >>= 1) {
      bitonic_step(s, i, d, ((lane & d) == 0) == ((lane & k) == 0));  // k-blocks alternate
    }
  }
}

// Merges the sorted list (os, oi) into the sorted list (ls, li), keeping
// the 32 entries of the two that come first, in order: the better of entry
// j of one and entry 31 - j of the other is among them and forms a bitonic
// sequence, which five steps sort.
__device__ __forceinline__ void list_merge(float& ls, int& li, float os, int oi, int lane) {
  const float rs = __shfl_sync(kFullMask, os, kListLen - 1 - lane);
  const int ri = __shfl_sync(kFullMask, oi, kListLen - 1 - lane);
  if (precedes(rs, ri, ls, li)) {
    ls = rs;
    li = ri;
  }
#pragma unroll
  for (int d = kListLen / 2; d > 0; d >>= 1) bitonic_step(ls, li, d, (lane & d) == 0);
}

// Offers one candidate per lane to the warp's sorted list, of which only
// the first k entries are wanted: a candidate counts only if it precedes
// entry `last` = k - 1 (an empty slot is (-3.4e38, 0), which no candidate
// of score -3.4e38 precedes, so masked rows never enter),
// so the first k entries are exactly the k best offered and those after
// them are offered pairs in order, which a merge may take in without harm.
// Up to kInsertMax such candidates are inserted one by one; more are
// sorted and merged in (about as costly as five insertions, whatever their
// number), which keeps the 32 that come first of the list and all
// candidates.  Measured on an H100 at 2^20 x 256, Q=8: always inserting
// was 9% slower, always sorting 29%.
constexpr int kInsertMax = 5;
__device__ __forceinline__ void list_offer_many(float& ls, int& li, float cs, int ci,
                                                int lane, int last) {
  const float ts = __shfl_sync(kFullMask, ls, last);
  const int ti = __shfl_sync(kFullMask, li, last);
  const unsigned m = __ballot_sync(kFullMask, precedes(cs, ci, ts, ti));
  if (__popc(m) > kInsertMax) {
    list_sort(cs, ci, lane);
    list_merge(ls, li, cs, ci, lane);
  } else {
    list_insert(ls, li, cs, ci, lane, m);
  }
}

// A float's order as an int, for atomicMax: order_key(a) < order_key(b)
// exactly where a < b (no NaN); order_value inverts it.
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float order_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

// The streaming searches' seeding pass: the first kSeedRows rows, searched
// first where more than kSeedMinRows rows are live and a launch has more
// than kSeedMinQueries queries; each query's k-th score from it starts the
// thresholds of the full pass.
constexpr long long kSeedRows = 32768;
constexpr long long kSeedMinRows = 4 * kSeedRows;
constexpr int kSeedMinQueries = 8;

// A warp's lists in shared memory, one per query: [n][kListStride] scores,
// then as many rows, entry j of list q at q * kListStride + j (the stride
// spreads the lanes' reads of entry k - 1 of several lists over the banks).
constexpr int kListStride = kListLen + 1;

// Offers each query q of qmask (the same in every lane) the 32 rows row0 +
// lane of a group, lane j's score score(q) for row row0 + j, to the warp's
// lists.  thr[q] is the CTA's threshold of query q (an order_key): scores
// below it, and masked rows, are offered as empty slots, which never
// enter; each offer then raises it to the list's entry last = k - 1.
template <typename Score>
__device__ __forceinline__ void offer_group(unsigned qmask, Score score, float* wls, int* wli,
                                            int* thr, int row0, int lane, int last) {
  while (qmask) {
    const int q = __ffs(qmask) - 1;
    qmask &= qmask - 1;
    const float sc = score(q);
    const bool keep = sc >= order_value(thr[q]) && sc > kStreamNegInf;
    float ls = wls[q * kListStride + lane];
    int li = wli[q * kListStride + lane];
    list_offer_many(ls, li, keep ? sc : kStreamNegInf, keep ? row0 + lane : 0, lane, last);
    wls[q * kListStride + lane] = ls;
    wli[q * kListStride + lane] = li;
    const float ts = __shfl_sync(kFullMask, ls, last);
    if (lane == 0) atomicMax(thr + q, order_key(ts));
  }
}

// Merges a CTA's lists of each query q < nq (warp w's nlists lists at
// lists + w * stride bytes) into its partial result part[blockIdx.x, q,
// 32]: warp `warp` of `warps` merges queries warp, warp + warps, ...  Call
// after a barrier that follows the last offer.
__device__ __forceinline__ void merge_cta_lists(const uint8_t* lists, int stride, int nlists,
                                                int warps, int nq, int warp, int lane,
                                                float* part_s, int* part_i) {
  for (int q = warp; q < nq; q += warps) {
    float s = kStreamNegInf;
    int i = 0;
    for (int w = 0; w < warps; ++w) {
      const float* ws = reinterpret_cast<const float*>(lists + w * stride);
      const int* wi = reinterpret_cast<const int*>(ws + nlists * kListStride);
      list_merge(s, i, ws[q * kListStride + lane], wi[q * kListStride + lane], lane);
    }
    const long long o = (static_cast<long long>(blockIdx.x) * nq + q) * kListLen + lane;
    part_s[o] = s;
    part_i[o] = i;
  }
}

// Merges [chunks, nq, 32] sorted partial lists into out [nq, k] on
// `stream` (stream_kernels.cu); returns the launch's cudaError_t.
int stream_merge(const float* part_s, const int* part_i, int chunks, int nq, int k,
                 float* out_s, int* out_i, cudaStream_t stream);

// Opts fn in to smem bytes of dynamic shared memory on the calling thread's
// current device.  The opt-in holds per device and launches come from any
// thread, so each instantiation keeps the largest size set on each device:
// cudaFuncSetAttribute runs only when a launch needs more than that.  The
// size only grows, and is stored after the call succeeds, under the lock,
// so a launch that reads a size >= its own needs no call.
template <typename Fn>
cudaError_t opt_in_smem(Fn fn, size_t smem, std::atomic<int>* set_on, std::mutex& mu) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int want = static_cast<int>(smem);
  if (dev >= kMaxDevices) {
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
  }
  if (set_on[dev].load(std::memory_order_acquire) >= want) return cudaSuccess;
  std::lock_guard<std::mutex> lock(mu);
  if (set_on[dev].load(std::memory_order_relaxed) >= want) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
  if (e == cudaSuccess) set_on[dev].store(want, std::memory_order_release);
  return e;
}

// How many CTAs of fn, at `threads` threads and `smem` bytes of dynamic
// shared memory (opted in first: opt_in_smem), the current device holds at
// once, into *held.
template <typename Fn>
cudaError_t cta_capacity(Fn fn, int threads, size_t smem, std::atomic<int>* set_on,
                         std::mutex& mu, long long* held) {
  cudaError_t e = opt_in_smem(fn, smem, set_on, mu);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *held = static_cast<long long>(sms) * per_sm;
  return cudaSuccess;
}

}  // namespace dewi
