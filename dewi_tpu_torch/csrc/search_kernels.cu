// Stage-1 search kernels for Hopper (sm_90a).
//
// Hand-written CUDA ports of the eight stage-1 Pallas kernels of
// dewi_tpu/ops/pallas_search.py (its two streaming searches are in
// stream_kernels.cu):
//
//   dewi_bmax_s4          <- pallas_bmax_s4          (:661, _bmax_kernel_s4 :651, _s4_acc :428)
//   dewi_scores_matrix_s4 <- pallas_scores_matrix_s4 (:470, _scores_kernel_s4 :458)
//   dewi_bmax             <- pallas_bmax             (:559, _bmax_kernel :535)
//   dewi_scores_matrix    <- pallas_scores_matrix    (:309, _scores_kernel :296)
//   dewi_bmax_s8          <- pallas_bmax_s8          (:609, _bmax_kernel_s8 :545)
//   dewi_scores_matrix_s8 <- pallas_scores_matrix_s8 (:378, _scores_kernel_s8 :362)
//   dewi_bmax_t           <- pallas_bmax_t           (:740, _bmax_kernel_t :713)
//   dewi_bmax_s8_t        <- pallas_bmax_s8_t        (:793, _bmax_kernel_s8_t :725)
//
// Each computes, for every query q and corpus row r,
//
//   adj[q, r] = acc[q, r] * mult[r] + add[r]                  (float queries)
//   adj[q, r] = float(acc[q, r]) * (q_scale[q] * mult[r]) + add[r]   (s8 queries)
//
// and writes either the full [Q, cap] matrix (f32 or bf16) or the max of
// each 128-row sub-block: [Q, cap/128] f32, or [cap/128, Q] for the
// corpus-major (_t) entry points, which differ from the query-major ones
// only in the strides of that store.  The accumulator is
//   * float queries over int8 or bf16 rows: sum_d bf16(q[d]) * row[d] in
//     f32.  Both operands are bf16-exact, so every product is exact in f32
//     and only the order of the sum differs from the TPU kernel;
//   * s8 queries over int8 rows: the exact int32 sum of s8 x s8, by __dp4a
//     over the quads of the query and the row as they are stored;
//   * s8 queries over nibble-packed int4 rows: the exact int32 sum of
//     s8 x s4, by __dp4a over unpacked s8 quads.  Byte j of a row holds dim
//     j in its high nibble (signed) and dim j + D/2 in its low nibble
//     (biased by 8).
// The epilogue keeps the TPU kernel's association, with the multiply-add
// fused into one rounding (q_scale * mult is rounded first), as XLA on the
// CPU contracts the Pallas kernels' epilogue; the plain PyTorch versions in
// dewi_tpu_torch/ops/cuda_search.py compute the same fused form, so given
// the same accumulator the results agree bit for bit.
//
// Bound on this card: all of them stream the corpus once and do little
// work per byte (2*Q operations per element at Q <= 32), so they are bound
// by device-memory bytes: the corpus, mult and add read once, the output
// written once.
//
// Design: one CTA of 128 threads per 128-row sub-block, one thread per
// corpus row.  Each row is staged into shared memory 256 bytes at a time
// with 16-byte cp.async copies (neighbouring threads on neighbouring
// addresses), rows padded by 16 bytes so the per-thread 16-byte reads are
// free of bank conflicts.  All Q <= 32 queries sit in shared memory and are
// read as broadcasts; each thread keeps one accumulator per query in
// registers.  The sub-block max is a warp-shuffle reduction plus one
// shared-memory step across the four warps.  The staged queries are s8 for
// s8 queries, bf16 for float queries over int8 rows (they are rounded to
// bf16 anyway; half the shared-memory reads made this kind faster on an
// H100) and f32 for bf16 rows (converting bf16 queries as well as bf16 rows
// made that kind slower).  Where QT queries of dim d do not fit in shared
// memory, dewi_queries_per_launch tells the wrapper how many do, and it
// launches once per group of that many; a corpus-major launch then writes
// columns q0 .. q0+g of its [cap/128, ldo] output.  Speed work (wgmma, TMA,
// persistent CTAs) is left for later.

#include "common.cuh"

namespace {

using namespace dewi;

enum Kind { kInt8 = 0, kBf16 = 1, kS4 = 2, kS8 = 3 };

__host__ __device__ constexpr bool s8_query(int kind) { return kind == kS4 || kind == kS8; }

template <int KIND, bool BMAX, int QT>
__global__ void __launch_bounds__(kThreads)
stage1_kernel(const uint8_t* __restrict__ emb, int row_bytes,
              const float* __restrict__ qf,       // [nq, d] f32 (float queries)
              const int8_t* __restrict__ q8,      // [nq, d] s8 (s8 queries)
              const float* __restrict__ qscale,   // [nq] (s8 queries)
              const float* __restrict__ mult, const float* __restrict__ add,
              void* __restrict__ out, int out_bf16, int nq, int d,
              long long cap, long long out_qstride, long long out_bstride) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red[QT][kThreads / 32];
  uint8_t* tile = smem;
  uint8_t* qsm = smem + kTileBytes;

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kSub;
  const long long row = row0 + tid;

  // Stage the queries, zero-padded to QT rows.  Float queries are rounded
  // to bf16 here, as the TPU kernel casts them before the dot.
  if constexpr (s8_query(KIND)) {
    int8_t* qs8 = reinterpret_cast<int8_t*>(qsm);
    for (int i = tid; i < QT * d; i += kThreads) {
      qs8[i] = (i / d) < nq ? q8[i] : static_cast<int8_t>(0);
    }
  } else if constexpr (KIND == kBf16) {
    float* qsf = reinterpret_cast<float*>(qsm);
    for (int i = tid; i < QT * d; i += kThreads) {
      qsf[i] = (i / d) < nq ? __bfloat162float(__float2bfloat16_rn(qf[i])) : 0.f;
    }
  } else {
    __nv_bfloat16* qsb = reinterpret_cast<__nv_bfloat16*>(qsm);
    for (int i = tid; i < QT * d; i += kThreads) {
      qsb[i] = __float2bfloat16_rn((i / d) < nq ? qf[i] : 0.f);
    }
  }

  float facc[QT];
  int iacc[QT];
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    facc[qi] = 0.f;
    iacc[qi] = 0;
  }

  const uint8_t* my = tile + tid * kStride;
  for (int s0 = 0; s0 < row_bytes; s0 += kSlabBytes) {
    const int sb = min(kSlabBytes, row_bytes - s0);
    const int cpr = sb / 16;  // 16-byte chunks per row in this slab
    stage_slab(tile, emb, row0, row_bytes, s0, sb, tid);

    for (int c = 0; c < cpr; ++c) {
      const uint4 raw = *reinterpret_cast<const uint4*>(my + c * 16);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      const int byte0 = s0 + c * 16;
      if constexpr (KIND == kS4) {
        // hi = signed high nibble (dims byte0..+15), lo = low nibble - 8
        // (dims D/2 + byte0..+15), four s8 lanes per 32-bit word.
        uint32_t hq[4], lq[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          hq[k] = __vsub4(((w[k] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
          lq[k] = __vsub4(w[k] & 0x0F0F0F0Fu, 0x08080808u);
        }
        const int8_t* qs8 = reinterpret_cast<const int8_t*>(qsm);
#pragma unroll
        for (int qi = 0; qi < QT; ++qi) {
          const int4 a = *reinterpret_cast<const int4*>(qs8 + qi * d + byte0);
          const int4 b = *reinterpret_cast<const int4*>(qs8 + qi * d + (d >> 1) + byte0);
          int acc = iacc[qi];
          acc = __dp4a(static_cast<int>(hq[0]), a.x, acc);
          acc = __dp4a(static_cast<int>(hq[1]), a.y, acc);
          acc = __dp4a(static_cast<int>(hq[2]), a.z, acc);
          acc = __dp4a(static_cast<int>(hq[3]), a.w, acc);
          acc = __dp4a(static_cast<int>(lq[0]), b.x, acc);
          acc = __dp4a(static_cast<int>(lq[1]), b.y, acc);
          acc = __dp4a(static_cast<int>(lq[2]), b.z, acc);
          acc = __dp4a(static_cast<int>(lq[3]), b.w, acc);
          iacc[qi] = acc;
        }
      } else if constexpr (KIND == kS8) {
        // Sixteen s8 dims of the row (byte0..+15) against the same dims of
        // each query: four __dp4a, exact in int32.
        const int8_t* qs8 = reinterpret_cast<const int8_t*>(qsm);
#pragma unroll
        for (int qi = 0; qi < QT; ++qi) {
          const int4 a = *reinterpret_cast<const int4*>(qs8 + qi * d + byte0);
          int acc = iacc[qi];
          acc = __dp4a(static_cast<int>(w[0]), a.x, acc);
          acc = __dp4a(static_cast<int>(w[1]), a.y, acc);
          acc = __dp4a(static_cast<int>(w[2]), a.z, acc);
          acc = __dp4a(static_cast<int>(w[3]), a.w, acc);
          iacc[qi] = acc;
        }
      } else {
        constexpr int kElems = KIND == kInt8 ? 16 : 8;
        float x[kElems];
        if constexpr (KIND == kInt8) {
          s8x16_to_f32(raw, x);
        } else {
          bf16x8_to_f32(raw, x);
        }
        const int dim0 = KIND == kInt8 ? byte0 : (byte0 >> 1);
#pragma unroll
        for (int qi = 0; qi < QT; ++qi) {
          float acc = facc[qi];
          if constexpr (KIND == kBf16) {
            const float4* qv =
                reinterpret_cast<const float4*>(reinterpret_cast<const float*>(qsm) + qi * d + dim0);
#pragma unroll
            for (int v = 0; v < kElems / 4; ++v) {
              const float4 t = qv[v];
              acc = fmaf(x[4 * v], t.x, acc);
              acc = fmaf(x[4 * v + 1], t.y, acc);
              acc = fmaf(x[4 * v + 2], t.z, acc);
              acc = fmaf(x[4 * v + 3], t.w, acc);
            }
          } else {
            const uint4* qv = reinterpret_cast<const uint4*>(
                reinterpret_cast<const __nv_bfloat16*>(qsm) + qi * d + dim0);
#pragma unroll
            for (int v = 0; v < kElems / 8; ++v) {
              float t[8];
              bf16x8_to_f32(qv[v], t);
#pragma unroll
              for (int e = 0; e < 8; ++e) acc = fmaf(x[8 * v + e], t[e], acc);
            }
          }
          facc[qi] = acc;
        }
      }
    }
  }

  const float m = mult[row];
  const float a = add[row];
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    float v;
    if constexpr (s8_query(KIND)) {
      const float qs = qscale[qi < nq ? qi : 0];
      v = __fmaf_rn(__int2float_rn(iacc[qi]), __fmul_rn(qs, m), a);
    } else {
      v = __fmaf_rn(facc[qi], m, a);
    }
    if constexpr (BMAX) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
      }
      if (lane == 0) red[qi][warp] = v;
    } else if (qi < nq) {
      const long long o = static_cast<long long>(qi) * cap + row;
      if (out_bf16) {
        reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
      } else {
        reinterpret_cast<float*>(out)[o] = v;
      }
    }
  }
  if constexpr (BMAX) {
    __syncthreads();
    if (tid < nq) {
      float v = red[tid][0];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) v = fmaxf(v, red[tid][w]);
      reinterpret_cast<float*>(out)[tid * out_qstride + blockIdx.x * out_bstride] = v;
    }
  }
}

struct Args {
  const void* emb;
  int row_bytes;
  const float* qf;
  const int8_t* q8;
  const float* qscale;
  const float* mult;
  const float* add;
  void* out;
  int out_bf16;
  int nq;
  int d;
  long long cap;
  long long out_qstride;  // block-max store: out[q * out_qstride + b * out_bstride]
  long long out_bstride;
};

// Dynamic shared memory of one CTA: the row tile and QT staged queries
// (s8 for s8 queries, bf16 for float queries over int8 rows, f32 for bf16
// rows).
size_t dyn_smem(int kind, int qt, int d) {
  const int qbytes = s8_query(kind) ? 1 : (kind == kInt8 ? 2 : 4);
  return kTileBytes + static_cast<size_t>(qt) * d * qbytes;
}

bool fits(int kind, int qt, int d) {
  return dyn_smem(kind, qt, d) + sizeof(float) * qt * (kThreads / 32) <= kMaxSmem;
}

template <int KIND, bool BMAX, int QT>
int launch_qt(const Args& a, cudaStream_t stream) {
  static std::atomic<int> smem_set_on[kMaxDevices];  // zero: static storage
  static std::mutex smem_mu;
  if (!fits(KIND, QT, a.d)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dyn_smem(KIND, QT, a.d);
  auto fn = stage1_kernel<KIND, BMAX, QT>;
  if (smem > 48 * 1024) {
    cudaError_t e = opt_in_smem(fn, smem, smem_set_on, smem_mu);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(a.cap / kSub));
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(a.emb), a.row_bytes, a.qf, a.q8, a.qscale,
      a.mult, a.add, a.out, a.out_bf16, a.nq, a.d, a.cap, a.out_qstride,
      a.out_bstride);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, bool BMAX>
int launch(const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.cap <= 0 || a.cap % kSub != 0 || a.row_bytes % 16 != 0 || a.nq < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.nq <= 1) return launch_qt<KIND, BMAX, 1>(a, st);
  if (a.nq <= 2) return launch_qt<KIND, BMAX, 2>(a, st);
  if (a.nq <= 4) return launch_qt<KIND, BMAX, 4>(a, st);
  if (a.nq <= 8) return launch_qt<KIND, BMAX, 8>(a, st);
  if (a.nq <= 16) return launch_qt<KIND, BMAX, 16>(a, st);
  if (a.nq <= 32) return launch_qt<KIND, BMAX, 32>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// pallas_scores_matrix: emb [cap, d] int8 (emb_bf16 = 0) or bf16 (emb_bf16 = 1),
// q [nq, d] f32, mult/add [cap] f32 -> out [nq, cap] f32 or bf16 (out_bf16).
int dewi_scores_matrix(const void* emb, int emb_bf16, const float* q,
                       const float* mult, const float* add, void* out,
                       int out_bf16, int nq, int d, long long cap, void* stream) {
  Args a{emb, d * (emb_bf16 ? 2 : 1), q, nullptr, nullptr, mult, add, out, out_bf16,
         nq, d, cap, 0, 0};
  return emb_bf16 ? launch<kBf16, false>(a, stream) : launch<kInt8, false>(a, stream);
}

// pallas_bmax: as dewi_scores_matrix, out [nq, cap / 128] f32 sub-block maxima.
int dewi_bmax(const void* emb, int emb_bf16, const float* q, const float* mult,
              const float* add, float* out, int nq, int d, long long cap,
              void* stream) {
  Args a{emb, d * (emb_bf16 ? 2 : 1), q, nullptr, nullptr, mult, add, out, 0, nq, d,
         cap, cap / kSub, 1};
  return emb_bf16 ? launch<kBf16, true>(a, stream) : launch<kInt8, true>(a, stream);
}

// pallas_bmax_t: as dewi_bmax, corpus-major: the maxima of these nq queries
// go to columns 0..nq-1 of out [cap / 128, ldo] f32 (ldo >= nq).
int dewi_bmax_t(const void* emb, int emb_bf16, const float* q, const float* mult,
                const float* add, float* out, int ldo, int nq, int d,
                long long cap, void* stream) {
  if (ldo < nq) return static_cast<int>(cudaErrorInvalidValue);
  Args a{emb, d * (emb_bf16 ? 2 : 1), q, nullptr, nullptr, mult, add, out, 0, nq, d,
         cap, 1, ldo};
  return emb_bf16 ? launch<kBf16, true>(a, stream) : launch<kInt8, true>(a, stream);
}

// pallas_scores_matrix_s8: emb [cap, d] int8, q8 [nq, d] int8, qscale [nq]
// f32 -> out [nq, cap] f32 or bf16 (out_bf16).
int dewi_scores_matrix_s8(const void* emb, const int8_t* q8, const float* qscale,
                          const float* mult, const float* add, void* out,
                          int out_bf16, int nq, int d, long long cap, void* stream) {
  Args a{emb, d, nullptr, q8, qscale, mult, add, out, out_bf16, nq, d, cap, 0, 0};
  return launch<kS8, false>(a, stream);
}

// pallas_bmax_s8: as dewi_scores_matrix_s8, out [nq, cap / 128] f32.
int dewi_bmax_s8(const void* emb, const int8_t* q8, const float* qscale,
                 const float* mult, const float* add, float* out, int nq, int d,
                 long long cap, void* stream) {
  Args a{emb, d, nullptr, q8, qscale, mult, add, out, 0, nq, d, cap, cap / kSub, 1};
  return launch<kS8, true>(a, stream);
}

// pallas_bmax_s8_t: as dewi_bmax_s8, corpus-major into out [cap / 128, ldo].
int dewi_bmax_s8_t(const void* emb, const int8_t* q8, const float* qscale,
                   const float* mult, const float* add, float* out, int ldo,
                   int nq, int d, long long cap, void* stream) {
  if (ldo < nq) return static_cast<int>(cudaErrorInvalidValue);
  Args a{emb, d, nullptr, q8, qscale, mult, add, out, 0, nq, d, cap, 1, ldo};
  return launch<kS8, true>(a, stream);
}

// pallas_scores_matrix_s4: packed [cap, d / 2] int8, q8 [nq, d] int8,
// qscale [nq] f32 -> out [nq, cap] f32 or bf16 (out_bf16).
int dewi_scores_matrix_s4(const void* packed, const int8_t* q8,
                          const float* qscale, const float* mult,
                          const float* add, void* out, int out_bf16, int nq,
                          int d, long long cap, void* stream) {
  if (d % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{packed, d / 2, nullptr, q8, qscale, mult, add, out, out_bf16, nq, d, cap, 0, 0};
  return launch<kS4, false>(a, stream);
}

// pallas_bmax_s4: as dewi_scores_matrix_s4, out [nq, cap / 128] f32.
int dewi_bmax_s4(const void* packed, const int8_t* q8, const float* qscale,
                 const float* mult, const float* add, float* out, int nq,
                 int d, long long cap, void* stream) {
  if (d % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{packed, d / 2, nullptr, q8, qscale, mult, add, out, 0, nq, d, cap, cap / kSub, 1};
  return launch<kS4, true>(a, stream);
}

// The most queries one launch takes at dim d (a power of two up to 32):
// the wrappers launch once per group of this many.  kind: 0 int8 rows with
// float queries, 1 bf16 rows, 2 packed int4 rows, 3 int8 rows with s8
// queries.  0 when not even one query fits.
int dewi_queries_per_launch(int kind, int d) {
  for (int qt = 32; qt >= 1; qt >>= 1) {
    if (fits(kind, qt, d)) return qt;
  }
  return 0;
}

const char* dewi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
