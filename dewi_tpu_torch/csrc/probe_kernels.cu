// The memory-rate probe's read-once reduction: the f32 sum of an int8 array.
//
// Replaces no TPU kernel.  scripts/probe_hbm_bw.py's reduce_sum_f32 row
// (r_sum, :113) is sum(a.astype(float32)) over a 256 MB int8 array, which
// XLA fuses into one pass at the memory rate; the port's probe
// (scripts/torch_probe_hbm_bw.py) times this kernel in that row, so that the
// row reads a memory rate.  Its plain version and wrapper are
// dewi_tpu_torch/ops/cuda_probe.py.
//
// Bound: the bytes, read once (n / 3.35 TB/s on an H100; 80 us at 256 MB).
// The elements are integers, so the sum is kept exact: each thread reads
// 16 bytes at a time through the read-only path (__ldg, ld.global.nc),
// four loads in flight, sums each 16 bytes with four __dp4a (one
// instruction a 4 bytes, where a convert and an f32 add a byte would be
// 16 conversions a load, near the card's conversion rate at 3 TB/s), and
// adds them to a 64-bit accumulator.  A warp shuffle and a block sum give
// each CTA's partial; a second, one-CTA pass sums the partials in a fixed
// order and rounds the total to f32 once.  So the result is the exact sum
// rounded once, the same in every run (an f32 atomicAdd across CTAs would
// not be), and equal to the plain version's f64 sum cast to f32.  The grid
// (the wrapper's choice) is a few CTAs a streaming multiprocessor.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // 16-byte loads in flight per thread

__device__ __forceinline__ int sum16(int4 v) {
  int s = __dp4a(v.x, 0x01010101, 0);
  s = __dp4a(v.y, 0x01010101, s);
  s = __dp4a(v.z, 0x01010101, s);
  return __dp4a(v.w, 0x01010101, s);
}

// The block's sum in thread 0 (kThreads a block).
__device__ __forceinline__ long long block_sum(long long v) {
  __shared__ long long warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
reduce_i8_partials(const int8_t* __restrict__ x, long long n, long long* __restrict__ partials) {
  const int4* v = reinterpret_cast<const int4*>(x);
  const long long nv = n >> 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long acc = 0;
  for (; i + (kUnroll - 1) * stride < nv; i += kUnroll * stride) {
    int4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldg(v + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += sum16(r[u]);
  }
  for (; i < nv; i += stride) acc += sum16(__ldg(v + i));
  if (blockIdx.x == 0 && threadIdx.x < (n & 15)) acc += x[(nv << 4) + threadIdx.x];
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
reduce_partials(const long long* __restrict__ partials, int n, float* __restrict__ out) {
  long long acc = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = static_cast<float>(acc);
}

}  // namespace

extern "C" {

// x: n int8 values, 16-byte aligned; partials: n_ctas int64 scratch;
// out: one float.  Returns a cudaError_t (0 on success).
int dewi_probe_reduce_sum(const void* x, long long n, void* partials, int n_ctas, void* out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  reduce_i8_partials<<<n_ctas, kThreads, 0, s>>>(static_cast<const int8_t*>(x), n,
                                                 static_cast<long long*>(partials));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_partials<<<1, kThreads, 0, s>>>(static_cast<const long long*>(partials), n_ctas,
                                         static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Threads a CTA of the first pass (the wrapper sizes the grid by it).
int dewi_probe_threads() { return kThreads; }

}  // extern "C"
