// Helpers shared by the search kernels (search_kernels.cu, stream_kernels.cu):
// the row-tile geometry, cp.async staging and the shared-memory opt-in.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace dewi {

constexpr int kSub = 128;                  // rows per tile == BLOCKMAX_SUB
constexpr int kThreads = kSub;             // one thread per corpus row
constexpr int kSlabBytes = 256;            // bytes of each row staged per pass
constexpr int kStride = kSlabBytes + 16;   // padded shared-memory row stride
constexpr int kTileBytes = kSub * kStride;
constexpr int kMaxSmem = 232448;           // per-block limit on sm_90
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Stage bytes [s0, s0 + sb) of the kSub rows from row0 on into the tile,
// 16 bytes a copy, neighbouring threads on neighbouring addresses.  Ends
// with the tile visible to every thread of the CTA.
__device__ __forceinline__ void stage_slab(uint8_t* tile, const uint8_t* emb, long long row0,
                                           int row_bytes, int s0, int sb, int tid) {
  const int cpr = sb / 16;  // 16-byte chunks per row in this slab
  __syncthreads();          // the previous slab has been consumed
  for (int i = tid; i < kSub * cpr; i += kThreads) {
    const int r = i / cpr;
    const int c = i - r * cpr;
    cp_async16(tile + r * kStride + c * 16, emb + (row0 + r) * row_bytes + s0 + c * 16);
  }
  cp_async_wait_all();
  __syncthreads();
}

// Eight bf16 values (little-endian pairs in four words) to f32.
__device__ __forceinline__ void bf16x8_to_f32(const uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

// Sixteen int8 values (four words) to f32.
__device__ __forceinline__ void s8x16_to_f32(const uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      f[4 * k + b] = static_cast<float>(static_cast<int8_t>((w[k] >> (8 * b)) & 0xFFu));
    }
  }
}

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

}  // namespace dewi
