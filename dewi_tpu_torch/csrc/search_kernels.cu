// Stage-1 search kernels and the int8 streaming search for Hopper (sm_90a).
//
// Hand-written CUDA ports of the eight stage-1 Pallas kernels of
// dewi_tpu/ops/pallas_search.py and of its streaming search over int8 rows
// (the one over f32 rows, and the merge both streaming searches end with,
// are in stream_kernels.cu):
//
//   dewi_bmax_s4          <- pallas_bmax_s4          (:661, _bmax_kernel_s4 :651, _s4_acc :428)
//   dewi_scores_matrix_s4 <- pallas_scores_matrix_s4 (:470, _scores_kernel_s4 :458)
//   dewi_bmax             <- pallas_bmax             (:559, _bmax_kernel :535)
//   dewi_scores_matrix    <- pallas_scores_matrix    (:309, _scores_kernel :296)
//   dewi_bmax_s8          <- pallas_bmax_s8          (:609, _bmax_kernel_s8 :545)
//   dewi_scores_matrix_s8 <- pallas_scores_matrix_s8 (:378, _scores_kernel_s8 :362)
//   dewi_bmax_t           <- pallas_bmax_t           (:740, _bmax_kernel_t :713)
//   dewi_bmax_s8_t        <- pallas_bmax_s8_t        (:793, _bmax_kernel_s8_t :725)
//   dewi_int8_stream_search <- pallas_int8_search    (:239, _int8_search_kernel :181,
//                                                      _topk_via_max :46)
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
//   * s8 queries over int8 rows: the exact int32 sum of s8 x s8, on the
//     tensor cores (mma m16n8k32 s8 x s8 -> s32) over the bytes of the
//     query and the row as they are stored;
//   * s8 queries over nibble-packed int4 rows: the exact int32 sum of
//     s8 x s4, on the same tensor cores after an unpack in registers.
//     Byte j of a row holds dim j in its high nibble (signed) and dim
//     j + D/2 in its low nibble (biased by 8).
// The epilogue keeps the TPU kernel's association, with the multiply-add
// fused into one rounding (q_scale * mult is rounded first), as XLA on the
// CPU contracts the Pallas kernels' epilogue; the plain PyTorch versions in
// dewi_tpu_torch/ops/cuda_search.py compute the same fused form, so given
// the same accumulator the results agree bit for bit.
//
// Bound on this card: all of them stream the corpus once and do little
// work per byte (2*Q operations per element at Q <= 32), so the least time
// is that of the device-memory bytes: the corpus, mult and add read once,
// the output written once (the int8 streaming search: the live rows, their
// scales and payloads read once, Q * k pairs written).  On the CUDA cores
// that holds only for a few queries (32 multiply-adds per element are 0.26 ms of f32 work at 2^20 x
// 256, three times the memory time, and 2.1 G __dp4a at Q=32 were 0.15-0.2
// ms of issue time for the int4 kinds); on the tensor cores the same
// product is a fifth (bf16) or a tenth (s8) of the memory time, so every
// kind runs there.
//
// Design (stage1_mma_kernel, every entry point).  The product runs as
// mma.sync, m16n8k16 bf16 x bf16 -> f32 for float queries and m16n8k32
// s8 x s8 -> s32 for s8 queries, with the corpus rows as the 16-row
// operand and the queries, zero-padded to tiles of 8, as the 8-column one,
// so one pass over the rows serves every query of the launch (1, 2 or 4
// query tiles) and a score does not depend on how many queries ride with
// it.
//   * Each warp is a worker of its own: it walks units w, w + W, ... of
//     the W warps of a persistent grid, one row group at a time: 32 rows
//     (two 16-row tiles), or 64 (four) of packed int4 rows.  For the block
//     max a unit is a whole 128-row sub-block, whose running maximum the
//     warp keeps in registers, so the block max needs no shared memory and
//     the main loop no CTA barrier; for the [Q, cap] f32 store a unit is
//     one row group, so the grid reads and writes one contiguous range at a
//     time (unit_groups).
//   * Loads stay in flight while the warp computes: a double-buffered ring
//     of 8 KB slabs per warp (a row group by 256 bytes of int8 or bf16
//     rows, or by 128 bytes of int4 rows: one contiguous range where a row
//     is that wide) filled by 16-byte cp.async copies, the next slab always
//     in flight, across row groups and sub-blocks, so a group's epilogue
//     overlaps the next one's loads.  One CTA of 8 warps per SM keeps 64 KB
//     in flight.  Measured on an H100 at 2^20 x 256: slab rows of 64, 128
//     and 256 bytes gave 0.147, 0.110 and 0.098 ms at Q=1 over int8 rows
//     (wide contiguous requests matter more than the number of warps or
//     stages), 8 warps beat 4, 6, 10 and 12, and a third stage gained
//     nothing.
//   * A thread feeds its fragments from 16 consecutive bytes of a row (its
//     quad covers 64): a dot product does not care in which order k runs,
//     so those bytes take the k slots of 4 (int8 rows, float queries; int4
//     rows), or 2 (bf16 rows; int8 rows with s8 queries) mma steps and the
//     queries are laid out once per CTA in the same order, one 16-byte
//     vector per lane, tile and step pair (bf16 for float queries, s8 bytes
//     as they are; for int4 rows from the two halves of the query that
//     match the two nibble planes).  The 16-byte chunks of a slab row are
//     XOR-swizzled by the row's parity, which makes both the copies and the
//     reads free of bank conflicts; a k tail is zero-filled by the copy
//     (zero rows against zero-padded queries).
//   * With float queries int8 rows become bf16 once per element
//     (s8x4_to_bf16x4: a byte permute, two masks and one packed subtract
//     per pair, all full rate); every s8 value is exact in bf16, so the
//     products stay exact in f32.  With s8 queries int8 row bytes are the A
//     fragments as they are, and int4 rows become s8 once per element, 16
//     times their value (nibble_plane16: one or two logic operations and a
//     shift per word), shared by every query tile.
//   * The epilogue is one fmaf(acc, mult, add) per score, mult/add loaded
//     a row group ahead (s8 queries: fmaf(float(acc), q_scale * mult,
//     add), each lane's q_scale loaded once); the maxima of a sub-block are
//     reduced over the accumulator fragments by three shuffles.  The
//     [Q, cap] store writes whole 32-byte sectors (8 consecutive rows of a
//     query) from the accumulator layout; streaming (.cs) stores and 4 or 6
//     warps per SM were slower there (an H100 at Q=32).
//   * RowOperand<KIND> is all that knows the operand type (bytes to
//     fragments, where in the query each fragment's values sit, the query
//     and accumulator types, the mma): the ring, the walk and the reduction
//     do not.
//   * The int8 streaming search is the int8-row kind in a third mode
//     (kTopK), over the tiles that hold live rows only (ceil(n_valid /
//     128) of them; the grid is sized by those), one row group per unit of
//     work.  It computes
//       sim[q, r] = acc[q, r] * scale[r]
//       adj[q, r] = (1 - eta) * sim + eta * pay[r, 0]
//                   + (entropy_pref * 0.5) * (pay[r, 1] + pay[r, 3])
//     term by term, one rounding per operation as its plain version, with
//     rows r >= n_valid at -3.4e38 (finite), and keeps the k <= 32 best
//     (adj, r) per query: descending score, the lower row first among equal
//     ones, empty slots (-3.4e38, 0).  The scale and the payload's first 16
//     bytes are loaded a row group ahead.  Each warp keeps one sorted list
//     of 32 (score, row) per query in shared memory (entry j at lane j;
//     common.cuh), and the CTA a threshold per query: the largest entry
//     k - 1 of its warps' lists.  A warp's rows come in increasing order,
//     so one compare of each score with its list's entry k - 1 and the
//     threshold, and one __any_sync per row group, decide whether the
//     group offers anything; only then does the warp transpose the group's
//     scores through a tile in the ring stage it has just read and offer
//     each such query its 32 rows (a few by insertion, more by a bitonic
//     sort and merge), in one loop over the passing queries, so the code
//     is not repeated per query (32 unrolled copies, with the lists in
//     registers at 230 a lane, were much slower at Q=32).  A warp's
//     own list fills from ~1,000 rows, so at Q=32 about half its groups
//     still offered something; so where the launch has more than 8
//     queries and many live rows, a first pass of the same kernel over the
//     first kSeedRows rows is merged first, and each query's k-th score
//     from it starts the thresholds of the full pass: k rows score at
//     least that, with this kernel's own arithmetic, so pruning below it
//     is exact.  At the end each CTA merges its warps' lists into one per
//     query, [grid, Q, 32]; stream_merge merges those.  The order (score,
//     then row) is total, so the result does not depend on how the rows
//     were split.
// In f32 the tensor cores add the 16 exact products of a step and the
// running sum in their own order and precision, so a float-query result may
// differ from an f32 sum in sequence by a few ulps of the largest partial
// sum; the s32 sums of the s8 and int4 kinds are exact, so those results
// equal the plain versions' and the TPU kernels' bit for bit.
//
// Where the queries of a launch at dim d do not fit in shared memory,
// dewi_queries_per_launch tells the wrapper how many do, and it launches
// once per group of that many; a corpus-major launch then writes columns
// q0 .. q0+g of its [cap/128, ldo] output.

#include "common.cuh"

namespace {

using namespace dewi;

enum Kind { kInt8 = 0, kBf16 = 1, kS4 = 2, kS8 = 3 };
// What stage1_mma_kernel does with a row group's scores: store [Q, cap],
// keep 128-row block maxima, or keep each query's best k (the streaming
// search over int8 rows).
enum Mode { kStore = 0, kBlockMax = 1, kTopK = 2 };

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

// ---- every kind: mma.sync on the tensor cores --------------------------------

constexpr int kMmaWarps = 8;                  // workers per CTA, fewer where the queries are wide
constexpr int kMmaMinWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kChunkBytes = 64;               // bytes of a row a quad feeds per chunk
// A lane reads vector 4c + t of rows g, g + 8, ...: eight lanes (two rows,
// four vectors each) must cover all 32 banks, so vector j of a slab row
// sits at j ^ kSwizzle * (row & 1).
constexpr int kSwizzle = 4;
constexpr int kQueryTile = 8;                 // queries per mma column tile

// The ring: kStages stages of 8 KB per warp, kStages - 1 in flight.  A
// stage is one row group (the rows a warp multiplies at a time) by the
// bytes of each row it holds (a slab): 32 rows x 256 bytes of int8 or
// bf16 rows, 64 rows x 128 bytes of packed int4 rows, which are half as
// wide (128 bytes at D 256), so the copy lanes fill whole rows and a stage
// is one contiguous range where a row is one slab.  Measured on an H100 at
// 2^20 x 256, int4 rows: 32 rows x 128 bytes in three stages (the same
// bytes in flight) was 2.5% slower for bmax_s4 at every Q, in four stages
// no faster.
constexpr int kStages = 2;
constexpr int kStageBytes = 8192;
constexpr int kRingBytes = kStages * kStageBytes;  // per warp
__host__ __device__ constexpr int slab_bytes(int kind) { return kind == kS4 ? 128 : 256; }
__host__ __device__ constexpr int group_rows(int kind) { return kStageBytes / slab_bytes(kind); }
// 16-byte query vectors per lane, query tile and chunk: a lane's 16 row
// bytes hold 16 int8 elements (2 vectors of bf16 queries), 8 bf16 (1), 16
// int8 for s8 queries (1), or 32 int4 (2 vectors of s8 queries).
__host__ __device__ constexpr int query_vecs(int kind) {
  return kind == kInt8 || kind == kS4 ? 2 : 1;
}

// All that the tensor-core kernel knows of the rows' type: how many 16-byte
// query vectors and mma k-steps a lane's 16 row bytes make, where in the
// query each vector sits, how those bytes become the A fragments of step j
// (rows g and g + 8 of an m16 tile), the query type (f32 rounded to bf16,
// or s8 as it is), the accumulator, and the mma itself.
template <int KIND>
struct RowOperand;

// Rows whose elements lie in order, kLaneElems to a lane's 16 bytes: vector
// v of chunk c for lane t holds query elements (4c + t) * kLaneElems + 8v
// on (8 bf16 or, with one vector, 16 s8); -1 past d.  d is a multiple of 8
// (bf16 rows) or 16 (int8 rows), so a vector is all in or all out.
template <int kLaneElems>
struct ContiguousQuery {
  static __device__ __forceinline__ int query_elem(int c, int t, int v, int d) {
    const int e = (4 * c + t) * kLaneElems + 8 * v;
    return e < d ? e : -1;
  }
};

struct Bf16Mma {
  using Acc = float;
  static constexpr bool kS8Queries = false;
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_bf16_16816(c, a, b0, b1);
  }
};

// m16n8k32 s8 x s8 -> s32 without saturation, for s8 queries.  The sum is
// the operand's kAccShift bits left of the exact int32 dot, and shifted
// back before the epilogue.
struct S8Mma {
  using Acc = int;
  static constexpr bool kS8Queries = true;
  static __device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_s8_16832(c, a, b0, b1);
  }
};

// The four words of a lane's rows g and g + 8 two at a time, as they are:
// the A fragments of bf16 rows (two bf16 a word) and of s8 rows (four s8).
struct WordPairFrag {
  static __device__ __forceinline__ void a_frag(const uint4& lo, const uint4& hi, int j,
                                                uint32_t (&a)[4]) {
    const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w};
    const uint32_t wh[4] = {hi.x, hi.y, hi.z, hi.w};
    a[0] = wl[2 * j];
    a[2] = wl[2 * j + 1];
    a[1] = wh[2 * j];
    a[3] = wh[2 * j + 1];
  }
};

template <>
struct RowOperand<kInt8> : Bf16Mma, ContiguousQuery<16> {
  static constexpr int kQueryVecs = 2;  // 16 bf16 of the query
  static constexpr int kSteps = 4;
  static __device__ __forceinline__ void a_frag(const uint4& lo, const uint4& hi, int j,
                                                uint32_t (&a)[4]) {
    const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w};
    const uint32_t wh[4] = {hi.x, hi.y, hi.z, hi.w};
    s8x4_to_bf16x4(wl[j], a[0], a[2]);
    s8x4_to_bf16x4(wh[j], a[1], a[3]);
  }
};

template <>
struct RowOperand<kBf16> : Bf16Mma, WordPairFrag, ContiguousQuery<8> {
  static constexpr int kQueryVecs = 1;  // 8 bf16 of the query
  static constexpr int kSteps = 2;
};

// s8 queries over int8 rows: the bytes go to mma m16n8k32 as they are and
// the sum is the exact int32 dot, as JAX's.
template <>
struct RowOperand<kS8> : S8Mma, WordPairFrag, ContiguousQuery<16> {
  static constexpr int kAccShift = 0;
  static constexpr int kQueryVecs = 1;  // 16 s8 of the query
  static constexpr int kSteps = 2;
};

// s8 queries over plane-packed int4 rows: a lane's 16 row bytes at b are
// dims b .. b+15 (high nibbles) and D/2 + b .. (low nibbles), unpacked in
// registers to s8 at 16 times their value (nibble_plane16), which feed mma
// m16n8k32 in four k-steps: the high plane's words in steps 0-1, the low
// plane's in 2-3, each in WordPairFrag order.  The query vectors match:
// vector 0 at element b, vector 1 at D/2 + b, zeros where b is past D/2
// (also where the ring zero-filled a k tail, whose zero bytes read as -8
// in the low plane).  The sum is 16 times the exact int32 dot and below
// 2^31 (|dot| <= 128 * 8 * D, and the queries of a launch fit in shared
// memory only far below D = 2^17), so shifting it right by 4 gives the dot
// exactly, as JAX's.
template <>
struct RowOperand<kS4> : S8Mma {
  static constexpr int kAccShift = 4;
  static constexpr int kQueryVecs = 2;
  static constexpr int kSteps = 4;
  static __device__ __forceinline__ int query_elem(int c, int t, int v, int d) {
    const int b = (4 * c + t) * 16;
    return b < (d >> 1) ? b + v * (d >> 1) : -1;
  }
  static __device__ __forceinline__ void a_frag(const uint4& lo, const uint4& hi, int j,
                                                uint32_t (&a)[4]) {
    const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w};
    const uint32_t wh[4] = {hi.x, hi.y, hi.z, hi.w};
    const int w = 2 * (j & 1);
    const bool low = j >= 2;
    a[0] = nibble_plane16(wl[w], low);
    a[2] = nibble_plane16(wl[w + 1], low);
    a[1] = nibble_plane16(wh[w], low);
    a[3] = nibble_plane16(wh[w + 1], low);
  }
};

// Dynamic shared memory of one CTA: the queries in fragment order (one
// 16-byte vector per lane, query tile, chunk and query vector), then per
// warp a ring (and in the top-k mode its lists), then in the top-k mode one
// threshold per query column.
__host__ __device__ constexpr size_t mma_query_bytes(int kind, int nt, int row_bytes) {
  return static_cast<size_t>(nt) * ((row_bytes + kChunkBytes - 1) / kChunkBytes) *
         query_vecs(kind) * 32 * 16;
}

// The top-k mode's selection tile: a row group's scores by query, one row
// of kSelStride floats per query (32 rows used), in the ring stage the
// group has just been read from.  A stride of 36 puts the 32 scores a warp
// writes at once (8 rows g by 4 query pairs t) on 32 distinct banks: 36 t
// + g = 4 t + g mod 32.
constexpr int kSelStride = 36;
static_assert(4 * kQueryTile * kSelStride * 4 <= kStageBytes, "the tile fits in a stage");
// The top-k mode's lists, per warp: [QT][kListStride] scores, then as
// many rows; a stride of 33 spreads the lanes' reads of entry k - 1 of
// their query columns (8 nt + 2t + e) over the banks.
constexpr int kListStride = kListLen + 1;
__host__ __device__ constexpr int list_bytes(int nt) {
  return 2 * nt * kQueryTile * kListStride * 4;
}
__host__ __device__ constexpr int warp_bytes(int mode, int nt) {
  return kRingBytes + (mode == kTopK ? list_bytes(nt) : 0);
}
// The top-k mode's per-CTA bytes: one threshold per query column.
__host__ __device__ constexpr int cta_bytes(int mode, int nt) {
  return mode == kTopK ? nt * kQueryTile * static_cast<int>(sizeof(int)) : 0;
}

// Row groups in a warp's unit of work.  Walking one row group at a time
// made the [Q, cap] store 2% faster than whole sub-blocks with f32 out and
// 1% slower with bf16 out (an H100 at Q=32).  The top-k mode walks one
// group at a time too: whole sub-blocks were 4-5% slower there at Q 1-32
// (an H100, with the lists then in registers).
__host__ __device__ constexpr int unit_groups(int kind, int mode, int out_bf16) {
  return mode == kBlockMax || out_bf16 ? kSub / group_rows(kind) : 1;
}

// The warps of a CTA at this query size: as many rings (and top-k lists)
// as fit beside the queries, at most kMmaWarps; below kMmaMinWarps the
// queries do not fit.
int mma_warps(int kind, int nt, int row_bytes, int mode) {
  const size_t q = mma_query_bytes(kind, nt, row_bytes) + cta_bytes(mode, nt);
  const size_t per_warp = warp_bytes(mode, nt);
  if (q + kMmaMinWarps * per_warp > kMaxSmem) return 0;
  const int fit = static_cast<int>((kMaxSmem - q) / per_warp);
  return fit < kMmaWarps ? fit : kMmaWarps;
}

// The top-k mode's own arguments (zero in the other modes): the re-rank's
// payloads and weights, the live rows, k, the CTA's [grid, nq, 32] partial
// lists, and the seed: null, or the [nq, k] scores of a pass over a prefix
// of the rows, whose entry k - 1 starts each query's threshold.
struct TopK {
  const float* pay;  // [cap, 8]
  int n_valid;
  float one_minus_eta;
  float eta;
  float half_ep;
  int k;
  float* part_s;
  int* part_i;
  const float* seed;
};

// The seeding pass of the int8 streaming search: its first kSeedRows rows
// (1024 row groups: one per warp of a full grid) are searched first where
// the live rows are more than kSeedMinRows and the launch has more than one
// tile of queries.  Measured on an H100 at 2^20 x 256 with 1M live rows:
// Q=32 0.279 -> 0.172 ms, Q=16 0.176 -> 0.142, Q=8 0.133 -> 0.130, but Q=1
// 0.113 -> 0.125 (the pass and its merge cost about 12 us), and seeds of
// 16,384 or 65,536 rows were no better.
constexpr long long kSeedRows = 32768;
constexpr long long kSeedMinRows = 4 * kSeedRows;

template <int KIND, int MODE, int NT>
__global__ void __launch_bounds__(kMmaThreads, 1)
stage1_mma_kernel(const uint8_t* __restrict__ emb, int row_bytes,
                  const float* __restrict__ qf,      // [nq, d] f32 (float kinds)
                  const int8_t* __restrict__ q8,     // [nq, d] s8 (kS8, kS4)
                  const float* __restrict__ qscale,  // [nq] (kS8, kS4)
                  const float* __restrict__ mult,    // [cap]; kTopK: the row scales
                  const float* __restrict__ add,     // [cap]; kTopK: unused
                  void* __restrict__ out, int out_bf16, int nq, int d, long long cap,
                  long long out_qstride, long long out_bstride, const TopK tk) {
  constexpr bool BMAX = MODE == kBlockMax;
  constexpr bool TOPK = MODE == kTopK;
  static_assert(!TOPK || KIND == kInt8, "the top-k mode is the int8 streaming search");
  using Op = RowOperand<KIND>;
  using Acc = typename Op::Acc;
  constexpr int QV = Op::kQueryVecs;
  static_assert(QV == query_vecs(KIND), "query_vecs sizes the staged queries");
  constexpr int kGroupRows = group_rows(KIND);
  constexpr int kMTiles = kGroupRows / 16;  // m16 tiles of a row group
  constexpr int kSlabRowBytes = slab_bytes(KIND);
  constexpr int kSlabChunks = kSlabRowBytes / kChunkBytes;
  constexpr int kSlabVecs = kSlabRowBytes / 16;  // 16-byte vectors of a slab row
  static_assert(kSlabVecs == 8 || kSlabVecs == 16 || kSlabVecs == 32,
                "a slab row is 128, 256 or 512 bytes");
  extern __shared__ __align__(16) uint8_t smem[];
  uint4* qfrag = reinterpret_cast<uint4*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // row of the fragment
  const int t = lane & 3;   // its k slots
  const int nchunks = (row_bytes + kChunkBytes - 1) / kChunkBytes;

  // Stage the queries once per CTA in the order the lanes read them: vector
  // v of lane (g, t) for tile nt and chunk c holds the elements of query
  // 8 nt + g from Op::query_elem(c, t, v, d) on, zeros past nq and where
  // that is -1.  Float queries are rounded to bf16 as the TPU kernel casts
  // them before the dot; s8 queries are their bytes (16-byte aligned, as
  // the wrapper checks).
  for (int i = tid; i < NT * nchunks * QV * 32; i += blockDim.x) {
    const int ln = i & 31;
    int r = i >> 5;
    const int v = r % QV;
    r /= QV;
    const int c = r % nchunks;
    const int q = (r / nchunks) * kQueryTile + (ln >> 2);
    const int e0 = Op::query_elem(c, ln & 3, v, d);
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (q < nq && e0 >= 0) {
      if constexpr (Op::kS8Queries) {
        w = *reinterpret_cast<const uint4*>(q8 + static_cast<long long>(q) * d + e0);
      } else {
        const float* src = qf + static_cast<long long>(q) * d + e0;
        uint32_t b[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const __nv_bfloat162 pr = __floats2bfloat162_rn(src[2 * k], src[2 * k + 1]);
          b[k] = *reinterpret_cast<const uint32_t*>(&pr);
        }
        w = make_uint4(b[0], b[1], b[2], b[3]);
      }
    }
    qfrag[i] = w;
  }
  // kTopK: the CTA's threshold of each query column (as order_key): entry
  // k - 1 of the seed or of some warp's list.  k rows score at least that
  // (the seed's scores are this kernel's own, over the same rows), so no
  // score below it is among the k best.
  int* thr = reinterpret_cast<int*>(smem + mma_query_bytes(KIND, NT, row_bytes) +
                                    (blockDim.x >> 5) * warp_bytes(MODE, NT));
  if constexpr (TOPK) {
    for (int i = tid; i < NT * kQueryTile; i += blockDim.x) {
      const bool seeded = tk.seed != nullptr && i < nq;
      thr[i] = order_key(seeded ? tk.seed[i * tk.k + tk.k - 1] : -INFINITY);
    }
  }
  __syncthreads();

  // A warp's unit of work (unit_groups(), in row groups): a whole
  // sub-block where it keeps the block max, one row group where it stores
  // [Q, cap] f32, so that there the warps of the grid read and write one
  // contiguous range at a time.
  const int ugroups = unit_groups(KIND, MODE, out_bf16);
  const int urows = ugroups * kGroupRows;
  const size_t qbytes = mma_query_bytes(KIND, NT, row_bytes);
  const int cta_warps = blockDim.x >> 5;
  uint8_t* ring = smem + qbytes + warp * kRingBytes;
  constexpr int kLists = NT * kQueryTile;  // kTopK: one list per query column
  float* wls = reinterpret_cast<float*>(smem + qbytes + cta_warps * kRingBytes +
                                        warp * list_bytes(NT));
  int* wli = reinterpret_cast<int*>(wls + kLists * kListStride);
  const long long nunits = cap / urows;  // kTopK: cap is the rows to walk
  const int nwarps = gridDim.x * cta_warps;
  const int wid = blockIdx.x * cta_warps + warp;
  const int nslab = (row_bytes + kSlabRowBytes - 1) / kSlabRowBytes;
  const long long mine = wid < nunits ? (nunits - wid + nwarps - 1) / nwarps : 0;
  const long long total = mine * ugroups * nslab;  // slabs this warp walks

  // Producer: slab p_s of row group p_g of unit p_u goes to a ring stage,
  // kCopyRows rows per copy instruction (kSlabVecs lanes x 16 bytes a row).
  constexpr int kCopyRows = 32 / kSlabVecs;
  long long p_u = wid;
  int p_g = 0, p_s = 0;
  const int p_row = lane / kSlabVecs;
  const int p_vec = lane % kSlabVecs;
  const int p_dst = p_row * kSlabRowBytes + ((p_vec ^ ((p_row & 1) * kSwizzle)) << 4);
  auto fetch = [&](int stage) {
    const int col = p_s * kSlabRowBytes + p_vec * 16;
    if (col < nchunks * kChunkBytes) {            // the chunks that are read
      const int nbytes = col < row_bytes ? 16 : 0;  // a k tail is zero-filled
      const uint8_t* src =
          emb + (p_u * urows + p_g * kGroupRows + p_row) * row_bytes + (nbytes ? col : 0);
      uint8_t* dst = ring + stage * kStageBytes + p_dst;
#pragma unroll
      for (int i = 0; i < kGroupRows / kCopyRows; ++i) {
        cp_async16_zfill(dst + i * kCopyRows * kSlabRowBytes,
                         src + static_cast<long long>(i) * kCopyRows * row_bytes, nbytes);
      }
    }
    if (++p_s == nslab) {
      p_s = 0;
      if (++p_g == ugroups) {
        p_g = 0;
        p_u += nwarps;
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) fetch(i);
    cp_async_commit();
  }

  // Consumer state: the accumulators of the row group (kMTiles m16 tiles by
  // NT query tiles), the sub-block's running maxima, the q_scale of this
  // lane's query columns 8 nt + 2t + e (s8 queries), and mult/add of the
  // group's rows 8 i + g, loaded a group ahead.
  Acc acc[kMTiles][NT][4];
  float best[NT][2];
  float qsc[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    best[nt][0] = best[nt][1] = -INFINITY;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = nt * kQueryTile + 2 * t + e;
      qsc[nt][e] = (Op::kS8Queries && q < nq) ? qscale[q] : 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = Acc(0);
    }
  }
  // kTopK: m is the row's scale, a and en its two re-rank terms, eta *
  // pay[r, 0] and (entropy_pref / 2) * (pay[r, 1] + pay[r, 3]) (the first
  // 16 bytes of the payload row), each rounded once as the plain version
  // computes them.
  float m[2 * kMTiles], a[2 * kMTiles], en[2 * kMTiles];
  auto load_mult_add = [&](long long row0) {
#pragma unroll
    for (int i = 0; i < 2 * kMTiles; ++i) {
      const long long r = row0 + 8 * i + g;
      m[i] = mult[r];
      if constexpr (TOPK) {
        const float4 p = *reinterpret_cast<const float4*>(tk.pay + r * 8);
        a[i] = __fmul_rn(tk.eta, p.x);
        en[i] = __fmul_rn(tk.half_ep, __fadd_rn(p.y, p.w));
      } else {
        a[i] = add[r];
      }
    }
  };
  // kTopK: the warp's list of each query column in shared memory (entry
  // j at lane j), of which the first k are the k best rows the warp has
  // offered; a column past nq starts at +inf, so that nothing is offered
  // to it.
  const int last = tk.k - 1;
  if constexpr (TOPK) {
    for (int q = 0; q < kLists; ++q) {
      wls[q * kListStride + lane] = q < nq ? kStreamNegInf : INFINITY;
      wli[q * kListStride + lane] = 0;
    }
  }
  long long c_u = wid;
  int c_g = 0, c_s = 0, stage = 0;
  if (total > 0) load_mult_add(c_u * urows);

  for (long long it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();  // this lane's copies of slab `it` have landed
    __syncwarp();                  // ... and every lane's; the stage read last is free
    if (it + kStages - 1 < total) fetch(stage == 0 ? kStages - 1 : stage - 1);
    cp_async_commit();

    uint8_t* st = ring + stage * kStageBytes;
    const int left = row_bytes - c_s * kSlabRowBytes;  // bytes of the row from this slab on
    const int nc = left >= kSlabRowBytes ? kSlabChunks : (left + kChunkBytes - 1) / kChunkBytes;
    for (int c = 0; c < nc; ++c) {
      // 16 bytes of rows g, g + 8, ... of the group and the matching queries.
      uint4 rows[2 * kMTiles];
#pragma unroll
      for (int i = 0; i < 2 * kMTiles; ++i) {
        rows[i] = *reinterpret_cast<const uint4*>(
            st + (8 * i + g) * kSlabRowBytes + (((4 * c + t) ^ ((g & 1) * kSwizzle)) << 4));
      }
      uint32_t qw[NT][4 * QV];
      const uint4* qsrc = qfrag + (c_s * kSlabChunks + c) * QV * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int v = 0; v < QV; ++v) {
          const uint4 x = qsrc[(nt * nchunks * QV + v) * 32];
          qw[nt][4 * v] = x.x;
          qw[nt][4 * v + 1] = x.y;
          qw[nt][4 * v + 2] = x.z;
          qw[nt][4 * v + 3] = x.w;
        }
      }
#pragma unroll
      for (int j = 0; j < Op::kSteps; ++j) {
        uint32_t af[kMTiles][4];
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) Op::a_frag(rows[2 * mt], rows[2 * mt + 1], j, af[mt]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt) {
            Op::mma(acc[mt][nt], af[mt], qw[nt][2 * j], qw[nt][2 * j + 1]);
          }
        }
      }
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
    if (++c_s < nslab) continue;

    // The row group is complete: one rounding per score (for s8 queries
    // after q_scale * mult, as the TPU kernel associates it), then the
    // maxima or the [Q, cap] store (8 consecutive rows of a query per quad
    // row); in the top-k mode the re-ranked scores go to the lists.
    c_s = 0;
    const long long row0 = c_u * urows + c_g * kGroupRows;
    if constexpr (TOPK) {
      // Score row 8 i + g against query 8 nt + 2t + e: sim = acc * scale,
      // then the re-rank term by term, one rounding per operation; rows
      // past n_valid get -3.4e38.  A warp walks its rows in increasing
      // order, so a score equal to a list's entry k - 1 comes from a later
      // row and does not precede it: one compare per score decides whether
      // the group offers anything, and one vote skips the selection when
      // nothing does.
      unsigned pass = 0;  // bit 2 nt + e: a score of that column beats its tail
      float tail[NT][2];  // entry k - 1 of the lists of this lane's query columns
      float cut[NT][2];   // the CTA's thresholds of the same columns
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = nt * kQueryTile + 2 * t + e;
          tail[nt][e] = wls[q * kListStride + last];
          cut[nt][e] = order_value(thr[q]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 2 * mt + (e >> 1);
            const float sim = __fmul_rn(acc[mt][nt][e], m[i]);
            const float v = __fadd_rn(__fadd_rn(__fmul_rn(tk.one_minus_eta, sim), a[i]), en[i]);
            const float sc = row0 + 8 * i + g < tk.n_valid ? v : kStreamNegInf;
            acc[mt][nt][e] = sc;
            if (sc > tail[nt][e & 1] && sc >= cut[nt][e & 1]) pass |= 1u << (2 * nt + (e & 1));
          }
        }
      }
      if (__any_sync(kFullMask, pass != 0)) {
        // Transpose the group's scores through the selection tile (in the
        // ring stage just read), then offer each query column with a
        // passing score its 32 rows, lane j row0 + j: one code path for
        // every column, walked by a mask that is the same in every lane.
        float* sel = reinterpret_cast<float*>(st);
        __syncwarp();  // every lane has read its rows from the stage
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sel[(nt * kQueryTile + 2 * t + (e & 1)) * kSelStride + 16 * mt + 8 * (e >> 1) + g] =
                  acc[mt][nt][e];
            }
          }
        }
        unsigned qmask = 0;  // bit q: query column q has a passing score
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const unsigned lanes = __ballot_sync(kFullMask, (pass >> (2 * nt + e)) & 1u);
#pragma unroll
            for (int tt = 0; tt < 4; ++tt) {
              if (lanes & (0x11111111u << tt)) qmask |= 1u << (nt * kQueryTile + 2 * tt + e);
            }
          }
        }
        __syncwarp();
        while (qmask) {
          const int q = __ffs(qmask) - 1;
          qmask &= qmask - 1;
          // Scores below the CTA's threshold, and masked rows, are offered
          // as empty slots, which never enter.
          const float sc = sel[q * kSelStride + lane];
          const bool keep = sc >= order_value(thr[q]) && sc > kStreamNegInf;
          float ls = wls[q * kListStride + lane];
          int li = wli[q * kListStride + lane];
          list_offer_many(ls, li, keep ? sc : kStreamNegInf,
                          keep ? static_cast<int>(row0) + lane : 0, lane, last);
          wls[q * kListStride + lane] = ls;
          wli[q * kListStride + lane] = li;
          const float ts = __shfl_sync(kFullMask, ls, last);
          if (lane == 0) atomicMax(thr + q, order_key(ts));
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = Acc(0);
        }
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float mr = m[2 * mt + (e >> 1)], ar = a[2 * mt + (e >> 1)];
            if constexpr (Op::kS8Queries) {
              v[e] = __fmaf_rn(__int2float_rn(acc[mt][nt][e] >> Op::kAccShift),
                               __fmul_rn(qsc[nt][e & 1], mr), ar);
            } else {
              v[e] = __fmaf_rn(acc[mt][nt][e], mr, ar);
            }
            acc[mt][nt][e] = Acc(0);
          }
          if constexpr (BMAX) {
            best[nt][0] = fmaxf(best[nt][0], fmaxf(v[0], v[2]));
            best[nt][1] = fmaxf(best[nt][1], fmaxf(v[1], v[3]));
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = nt * kQueryTile + 2 * t + (e & 1);
              if (q < nq) {
                const long long o = q * cap + row0 + 16 * mt + 8 * (e >> 1) + g;
                if (out_bf16) {
                  reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v[e]);
                } else {
                  reinterpret_cast<float*>(out)[o] = v[e];
                }
              }
            }
          }
        }
      }
    }
    if (++c_g == ugroups) {
      if constexpr (BMAX) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = best[nt][e];
            v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 4));
            v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 8));
            v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 16));
            const int q = nt * kQueryTile + 2 * t + e;
            if (g == 0 && q < nq) {
              reinterpret_cast<float*>(out)[q * out_qstride + c_u * out_bstride] = v;
            }
            best[nt][e] = -INFINITY;
          }
        }
      }
      c_g = 0;
      c_u += nwarps;
    }
    if (it + 1 < total) load_mult_add(c_u * urows + c_g * kGroupRows);
  }

  if constexpr (TOPK) {
    // Merge the CTA's lists: warp w merges queries w, w + cta_warps, ...
    // over every warp's list (list_merge) into the CTA's partial result
    // part[blockIdx.x, q, 32].
    __syncthreads();
    for (int q = warp; q < nq; q += cta_warps) {
      float s = kStreamNegInf;
      int i = 0;
      for (int w = 0; w < cta_warps; ++w) {
        const float* ws = reinterpret_cast<const float*>(smem + qbytes + cta_warps * kRingBytes +
                                                         w * list_bytes(NT));
        const int* wi = reinterpret_cast<const int*>(ws + kLists * kListStride);
        list_merge(s, i, ws[q * kListStride + lane], wi[q * kListStride + lane], lane);
      }
      const long long o = (static_cast<long long>(blockIdx.x) * nq + q) * kListLen + lane;
      tk.part_s[o] = s;
      tk.part_i[o] = i;
    }
  }
}

// The kernel of this kind, mode and query tiles at row_bytes, readied for
// a launch on the current device: its warps, its dynamic shared memory
// (opted in: the rings alone pass 48 KB) and how many of its CTAs the card
// holds at once.
struct Ready {
  int warps;
  size_t smem;
  long long held;
};

template <int KIND, int MODE, int NT>
cudaError_t ready(int row_bytes, Ready* r) {
  static std::atomic<int> smem_set_on[kMaxDevices];  // zero: static storage
  static std::mutex smem_mu;
  r->warps = mma_warps(KIND, NT, row_bytes, MODE);
  if (r->warps == 0) return cudaErrorInvalidValue;
  r->smem = mma_query_bytes(KIND, NT, row_bytes) + r->warps * warp_bytes(MODE, NT) +
            cta_bytes(MODE, NT);
  auto fn = stage1_mma_kernel<KIND, MODE, NT>;
  cudaError_t e = opt_in_smem(fn, r->smem, smem_set_on, smem_mu);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, r->warps * 32, r->smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  r->held = static_cast<long long>(sms) * per_sm;
  return cudaSuccess;
}

// A persistent grid: as many CTAs as the card holds at once, or fewer
// where the rows have fewer units of work than that many warps, and at
// most max_ctas (0: no limit).  The grid launched goes to *ctas.
template <int KIND, int MODE, int NT>
int launch_mma_nt(const Args& a, const TopK& tk, int max_ctas, int* ctas,
                  cudaStream_t stream) {
  Ready r;
  cudaError_t e = ready<KIND, MODE, NT>(a.row_bytes, &r);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long units = a.cap / (unit_groups(KIND, MODE, a.out_bf16) * group_rows(KIND));
  long long grid = (units + r.warps - 1) / r.warps;
  if (grid > r.held) grid = r.held;
  if (max_ctas > 0 && grid > max_ctas) grid = max_ctas;
  if (grid < 1) grid = 1;  // the top-k mode writes its lists, empty, with no live row
  *ctas = static_cast<int>(grid);
  stage1_mma_kernel<KIND, MODE, NT><<<dim3(static_cast<unsigned>(grid)), r.warps * 32, r.smem,
                                      stream>>>(
      static_cast<const uint8_t*>(a.emb), a.row_bytes, a.qf, a.q8, a.qscale, a.mult, a.add,
      a.out, a.out_bf16, a.nq, a.d, a.cap, a.out_qstride, a.out_bstride, tk);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, int MODE>
int launch_mma(const Args& a, void* stream, const TopK& tk = TopK{}, int max_ctas = 0,
               int* ctas = nullptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int launched = 0;
  if (ctas == nullptr) ctas = &launched;
  // The top-k mode walks the live rows' tiles, which may be none.
  if (a.cap < (MODE == kTopK ? 0 : 1) || a.cap % kSub != 0 || a.row_bytes % 16 != 0 ||
      a.nq < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.nq <= 1 * kQueryTile) return launch_mma_nt<KIND, MODE, 1>(a, tk, max_ctas, ctas, st);
  if (a.nq <= 2 * kQueryTile) return launch_mma_nt<KIND, MODE, 2>(a, tk, max_ctas, ctas, st);
  if (a.nq <= 4 * kQueryTile) return launch_mma_nt<KIND, MODE, 4>(a, tk, max_ctas, ctas, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many CTAs of the kind and mode the card holds at once for nq queries
// at row_bytes; minus the CUDA error where there is one.
template <int KIND, int MODE>
int held_ctas(int nq, int row_bytes) {
  Ready r{};
  cudaError_t e = cudaErrorInvalidValue;
  if (nq >= 1 && nq <= 1 * kQueryTile) e = ready<KIND, MODE, 1>(row_bytes, &r);
  else if (nq >= 1 && nq <= 2 * kQueryTile) e = ready<KIND, MODE, 2>(row_bytes, &r);
  else if (nq >= 1 && nq <= 4 * kQueryTile) e = ready<KIND, MODE, 4>(row_bytes, &r);
  return e == cudaSuccess ? static_cast<int>(r.held) : -static_cast<int>(e);
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
  return emb_bf16 ? launch_mma<kBf16, kStore>(a, stream)
                  : launch_mma<kInt8, kStore>(a, stream);
}

// pallas_bmax: as dewi_scores_matrix, out [nq, cap / 128] f32 sub-block maxima.
int dewi_bmax(const void* emb, int emb_bf16, const float* q, const float* mult,
              const float* add, float* out, int nq, int d, long long cap,
              void* stream) {
  Args a{emb, d * (emb_bf16 ? 2 : 1), q, nullptr, nullptr, mult, add, out, 0, nq, d,
         cap, cap / kSub, 1};
  return emb_bf16 ? launch_mma<kBf16, kBlockMax>(a, stream)
                  : launch_mma<kInt8, kBlockMax>(a, stream);
}

// pallas_bmax_t: as dewi_bmax, corpus-major: the maxima of these nq queries
// go to columns 0..nq-1 of out [cap / 128, ldo] f32 (ldo >= nq).
int dewi_bmax_t(const void* emb, int emb_bf16, const float* q, const float* mult,
                const float* add, float* out, int ldo, int nq, int d,
                long long cap, void* stream) {
  if (ldo < nq) return static_cast<int>(cudaErrorInvalidValue);
  Args a{emb, d * (emb_bf16 ? 2 : 1), q, nullptr, nullptr, mult, add, out, 0, nq, d,
         cap, 1, ldo};
  return emb_bf16 ? launch_mma<kBf16, kBlockMax>(a, stream)
                  : launch_mma<kInt8, kBlockMax>(a, stream);
}

// pallas_scores_matrix_s8: emb [cap, d] int8, q8 [nq, d] int8, qscale [nq]
// f32 -> out [nq, cap] f32 or bf16 (out_bf16).
int dewi_scores_matrix_s8(const void* emb, const int8_t* q8, const float* qscale,
                          const float* mult, const float* add, void* out,
                          int out_bf16, int nq, int d, long long cap, void* stream) {
  Args a{emb, d, nullptr, q8, qscale, mult, add, out, out_bf16, nq, d, cap, 0, 0};
  return launch_mma<kS8, kStore>(a, stream);
}

// pallas_bmax_s8: as dewi_scores_matrix_s8, out [nq, cap / 128] f32.
int dewi_bmax_s8(const void* emb, const int8_t* q8, const float* qscale,
                 const float* mult, const float* add, float* out, int nq, int d,
                 long long cap, void* stream) {
  Args a{emb, d, nullptr, q8, qscale, mult, add, out, 0, nq, d, cap, cap / kSub, 1};
  return launch_mma<kS8, kBlockMax>(a, stream);
}

// pallas_bmax_s8_t: as dewi_bmax_s8, corpus-major into out [cap / 128, ldo].
int dewi_bmax_s8_t(const void* emb, const int8_t* q8, const float* qscale,
                   const float* mult, const float* add, float* out, int ldo,
                   int nq, int d, long long cap, void* stream) {
  if (ldo < nq) return static_cast<int>(cudaErrorInvalidValue);
  Args a{emb, d, nullptr, q8, qscale, mult, add, out, 0, nq, d, cap, 1, ldo};
  return launch_mma<kS8, kBlockMax>(a, stream);
}

// pallas_scores_matrix_s4: packed [cap, d / 2] int8, q8 [nq, d] int8,
// qscale [nq] f32 -> out [nq, cap] f32 or bf16 (out_bf16).
int dewi_scores_matrix_s4(const void* packed, const int8_t* q8,
                          const float* qscale, const float* mult,
                          const float* add, void* out, int out_bf16, int nq,
                          int d, long long cap, void* stream) {
  if (d % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{packed, d / 2, nullptr, q8, qscale, mult, add, out, out_bf16, nq, d, cap, 0, 0};
  return launch_mma<kS4, kStore>(a, stream);
}

// pallas_bmax_s4: as dewi_scores_matrix_s4, out [nq, cap / 128] f32.
int dewi_bmax_s4(const void* packed, const int8_t* q8, const float* qscale,
                 const float* mult, const float* add, float* out, int nq,
                 int d, long long cap, void* stream) {
  if (d % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{packed, d / 2, nullptr, q8, qscale, mult, add, out, 0, nq, d, cap, cap / kSub, 1};
  return launch_mma<kS4, kBlockMax>(a, stream);
}

// The most queries one launch takes at dim d, in whole tiles of 8 (8, 16
// or 32): the wrappers launch once per group of this many.  kind: 0 int8
// rows with float queries, 1 bf16 rows, 2 packed int4 rows, 3 int8 rows
// with s8 queries.  0 when not even one tile fits.
int dewi_queries_per_launch(int kind, int d) {
  const int row_bytes = kind == kBf16 ? 2 * d : kind == kS4 ? d / 2 : d;
  for (int nt = 4; nt >= 1; nt >>= 1) {
    if (mma_warps(kind, nt, row_bytes, kStore) > 0) return nt * kQueryTile;
  }
  return 0;
}

// pallas_int8_search: emb [cap, d] int8, scales [cap] f32, pay [cap, 8] f32,
// q [nq, d] f32 (nq <= 32) -> out_s [nq, k] f32, out_i [nq, k] i32, k <= 32.
// The tensor-core kernel in its top-k mode walks the tiles that hold live
// rows on a persistent grid of at most max_ctas CTAs, each of which writes
// its lists to part_s/part_i ([max_ctas, nq, 32] scratch); stream_merge then
// merges them.
int dewi_int8_stream_search(const int8_t* emb, const float* scales, const float* pay,
                            const float* q, int nq, int d, long long cap, int n_valid,
                            float one_minus_eta, float eta, float half_ep, int k,
                            int max_ctas, float* part_s, int* part_i, float* out_s,
                            int* out_i, void* stream) {
  if (cap <= 0 || cap % kSub != 0 || cap > 0x7FFFFFFFLL || d <= 0 || d % 16 != 0 ||
      nq < 1 || nq > 4 * kQueryTile || k < 1 || k > kListLen || max_ctas < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long live = n_valid < 0 ? 0 : (n_valid < cap ? n_valid : cap);
  const long long rows = (live + kSub - 1) / kSub * kSub;  // tiles past these are not read
  Args a{emb, d, q, nullptr, nullptr, scales, nullptr, nullptr, 0, nq, d, rows, 0, 0};
  TopK tk{pay, n_valid, one_minus_eta, eta, half_ep, k, part_s, part_i, nullptr};
  int ctas = 0, rc = 0;
  if (live > kSeedMinRows && nq > kQueryTile) {
    // Seed: search the first kSeedRows rows (all live) into out, whose
    // entry k - 1 per query then starts the thresholds of the full pass,
    // so that its warps offer almost nothing from their first rows on.
    Args seed = a;
    seed.cap = kSeedRows;
    if ((rc = launch_mma<kInt8, kTopK>(seed, stream, tk, max_ctas, &ctas)) != 0) return rc;
    if ((rc = stream_merge(part_s, part_i, ctas, nq, k, out_s, out_i, st)) != 0) return rc;
    tk.seed = out_s;
  }
  if ((rc = launch_mma<kInt8, kTopK>(a, stream, tk, max_ctas, &ctas)) != 0) return rc;
  return stream_merge(part_s, part_i, ctas, nq, k, out_s, out_i, st);
}

// The most queries one dewi_int8_stream_search launch takes at dim d, in
// whole tiles of 8 (8, 16 or 32): the queries, the rings and the selection
// tiles of at least kMmaMinWarps warps must fit in shared memory.  0 when
// not even one tile fits or d is not a multiple of 16.
int dewi_int8_stream_queries_per_launch(int d) {
  if (d <= 0 || d % 16 != 0) return 0;
  for (int nt = 4; nt >= 1; nt >>= 1) {
    if (mma_warps(kInt8, nt, d, kTopK) > 0) return nt * kQueryTile;
  }
  return 0;
}

// The most CTAs a dewi_int8_stream_search launch of nq queries at dim d
// takes on the current device (its partial lists need that many rows);
// minus the CUDA error where there is one.
int dewi_int8_stream_max_ctas(int nq, int d) { return held_ctas<kInt8, kTopK>(nq, d); }

const char* dewi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
