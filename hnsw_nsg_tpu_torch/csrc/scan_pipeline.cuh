// The ring pipeline of the grouped scan's fast kernels, one dtype pair's
// instantiations a file so that they compile in parallel:
// grouped_scan_bf16.cu and grouped_scan_sq8.cu (a bf16 query with bf16 or
// int8 slabs, on mma.sync bf16 tensor cores), grouped_scan_i8.cu (int8 x
// int8 on mma.sync s8 tensor cores, exact s32 sums), grouped_scan_f32.cu
// (f32 x f32 in exact FMAs on CUDA cores). Notes on the kernels' function
// are at the top of grouped_scan.cu.
//
// A block takes one cluster and up to 32 of its query rows, so at
// cap <= 32 a slab is read once. scan_products is the product warps'
// pipeline:
//   * Up to d = max_d<QT>() (the resident mode) the query rows are
//     gathered by pointer into shared memory once per block (zero for pad
//     slots and past d), where they stay for the whole run; a bf16 or int8
//     query at d <= 128 is also kept as mma A fragments in registers.
//     Past max_d (the streamed mode) the 32 rows do not fit beside the
//     ring: each ring stage carries the d chunk of the query rows beside
//     the slab's, copied by the same cp.async group, so no width is out of
//     reach. The query chunk is read again for every slab tile, from L2
//     (a block's 32 rows); the HBM stream stays the slab's.
//   * The slab streams through a cp.async ring of [64 rows x 256 bytes]
//     stages (128 d of bf16, 64 d of f32; 128 d of int8 in 128 bytes),
//     rows padded by 16 bytes so that a warp's shared loads hit distinct
//     banks; 16-byte copies when every row starts on 16 bytes, else 8- or
//     4-byte ones where the rows allow them, else plain loads and stores;
//     the tail of d is zero-filled.
//   * Four product warps take 16 slab rows of a 64-row tile each against
//     the 32 query rows, summing over the d chunks of the tile:
//     - bf16 slab: mma.sync m16n8k16 bf16 -> f32, f32 sums of exact
//       products, B fragments by ldmatrix;
//     - int8 slab (SQ8): the same, the B fragments read as words and
//       upcast (every int8 is a bf16);
//     - int8 slab and int8 query: mma.sync m16n8k32 s8 -> s32, A and B
//       fragments read as words and used as they are; the s32 sums are
//       exact, so their order does not matter;
//     - f32 slab: each thread forms the 16 sums of its 4 query rows and 4
//       slab rows (the mma accumulator layout) in fmaf, its operands read
//       as float4 along d: 8 16-byte shared loads for 64 FMAs. Each sum
//       runs in increasing d, one fmaf at a time from 0 (no TF32, no split
//       sums: F-H1), so it is one sum bit for bit in every mode and equals
//       that of the CUDA-core kernels the pipeline replaced.
// Two epilogues take a tile's distances: per-row heaps and a heap warp
// (scan_heap_body, k <= 32) or select_topk.cuh's running buffers filled by
// 8 top-k warps (scan_general_body, any k).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_helpers.cuh"
#include "select_topk.cuh"

// A launch of the scan: device pointers (scratch: the general kernel's
// global buffers, or null) and the shape.
struct ScanArgs {
  const void *qc, *qidx, *slabs, *bias;
  void *vals, *idx, *scratch;
  int n_clusters, cap, qn, d, maxc, k;
  float scale;
};

namespace {

constexpr int kRows = 32;        // query rows per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPT = 128;         // 4 product warps: 16 slab rows of a tile each
constexpr int kHT = 32;          // 1 heap warp: one thread a query row
constexpr int kTN = 64;          // slab rows per ring stage
constexpr int kNarrowD = 128;    // a small query tile: more blocks an SM

// d values a ring stage holds: 256 bytes of a bf16 or f32 row, 128 of int8
template <typename ST>
__host__ __device__ constexpr int chunk_d() {
  return sizeof(ST) == 4 ? 64 : 128;
}
// The widest d of the resident mode with a query of type QT: the query
// tile, 32 rows of up to 3,840 bytes (123 KB), must fit beside the ring
// (f32: 960, bf16: 1920, int8: 3840). Past it, the streamed mode.
template <typename QT>
__host__ __device__ constexpr int max_d() {
  return 3840 / static_cast<int>(sizeof(QT));
}

// A ring stage: the [kTN x chunk_d] slab tile, rows padded by 16 bytes so
// that a warp's shared loads hit distinct banks (bf16: ldmatrix's 8 rows
// of 16 bytes; int8: a quarter warp's 16-byte loads from two rows; f32: a
// quarter warp's float4 loads from 4 rows 2 apart), then the tile's f32
// bias.
template <typename ST>
__host__ __device__ constexpr int stage_row_bytes() {
  return chunk_d<ST>() * static_cast<int>(sizeof(ST)) + 16;
}
template <typename ST>
__host__ __device__ constexpr int stage_bytes() {
  return kTN * (stage_row_bytes<ST>() + 4);
}

// The query tile: kRows rows of n_dc chunks, each row padded by 16 bytes
// (a warp's loads from 8 rows hit distinct banks); ld in elements.
template <typename QT, typename ST>
__host__ __device__ constexpr int q_ld(int n_dc) {
  return n_dc * chunk_d<ST>() + 16 / static_cast<int>(sizeof(QT));
}
template <typename QT, typename ST>
__host__ __device__ constexpr size_t q_tile_bytes(int n_dc) {
  return static_cast<size_t>(kRows) * q_ld<QT, ST>(n_dc) * sizeof(QT);
}

// A stage of the streamed mode: the slab's part, then the d chunk of the
// 32 query rows, each padded by 16 bytes as q_ld pads them (bf16: 26,368
// bytes in place of 17,664; SQ8 18,176; int8 x int8 14,080; f32 26,368).
template <typename QT, typename ST, bool kStream>
__host__ __device__ constexpr int ring_stage_bytes() {
  return stage_bytes<ST>()
         + (kStream ? kRows * q_ld<QT, ST>(1) * static_cast<int>(sizeof(QT))
                    : 0);
}

// Ring stages and blocks an SM of the k <= 32 kernels. d <= 128: a small
// query tile leaves room for several blocks an SM (bf16 and int8 slabs: 3
// of 2 stages; f32: 2 of 3 stages), whose phases (wait, products,
// staging) overlap one another; that measured faster than fewer blocks of
// more stages. int8 x int8 measured 1-2% faster at 3 blocks than at 4
// (~52 KB each at k = 32; 5 do not fit), and 3 stages gained nothing.
// Above, the query tile fills the SM's shared memory and the ring is all
// the overlap there is. The streamed mode holds no query tile: 2 blocks
// of 3 stages (~106 KB each at k = 32), so that one block's epilogue
// overlaps the other's products. The general kernels are alone on their
// SM (their rows' buffers fill it) and take 3 stages (bf16 and int8
// slabs: 2 in the resident mode above d = 128); 3 streamed stages leave
// the rows' buffers shared memory up to k = 216 (bf16 and f32).
template <typename ST>
__host__ __device__ constexpr int ring_stages(bool narrow, bool stream) {
  return stream ? 3 : narrow ? (sizeof(ST) == 4 ? 3 : 2) : 4;
}
template <typename ST>
__host__ __device__ constexpr int blocks_per_sm(bool narrow, bool stream) {
  return stream ? 2 : narrow ? (sizeof(ST) == 4 ? 2 : 3) : 1;
}
template <typename ST>
__host__ __device__ constexpr int general_ring_stages(bool narrow,
                                                      bool stream) {
  return narrow || stream || sizeof(ST) == 4 ? 3 : 2;
}

// Copy 16 bytes of a row (8 bf16, 16 int8 or 4 f32) into shared memory;
// elements at n_valid and past it (n_valid may be <= 0 or past the piece)
// become zero. kAsync: 16-byte cp.async, which every row start must allow;
// else cp.async in pieces of gran bytes (8 or 4: what every row start
// allows, row_granule), or plain element loads and stores (gran 0).
template <bool kAsync, typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, int n_valid,
                                       const T* safe, int gran) {
  constexpr int kN = 16 / sizeof(T);
  constexpr int kT = static_cast<int>(sizeof(T));
  if constexpr (kAsync) {
    const int nv = min(max(n_valid, 0), kN);
    cp_async16(smem_addr(dst), nv > 0 ? src : safe, nv * kT);
  } else if (gran != 0) {
    const uint32_t d0 = smem_addr(dst);
    const char* s0 = reinterpret_cast<const char*>(src);
    const int nb = min(max(n_valid, 0), kN) * kT;   // valid bytes
    for (int o = 0; o < 16; o += gran) {
      const int b = min(max(nb - o, 0), gran);
      const void* from = b > 0 ? static_cast<const void*>(s0 + o) : safe;
      if (gran == 8) cp_async8(d0 + o, from, b);
      else cp_async4(d0 + o, from, b);
    }
  } else {
    using Bits = std::conditional_t<
        sizeof(T) == 4, uint32_t,
        std::conditional_t<sizeof(T) == 2, uint16_t, uint8_t>>;
    const Bits* s = reinterpret_cast<const Bits*>(src);
    Bits* o = reinterpret_cast<Bits*>(dst);
#pragma unroll
    for (int u = 0; u < kN; ++u) o[u] = u < n_valid ? s[u] : Bits(0);
  }
}

// The widest granule (16, 8, 4 bytes, else 0) on which every row start of
// qc and slabs lies: what copy16's cp.async may copy at a time.
template <typename QT, typename ST>
__host__ __device__ int row_granule(const void* qc, const void* slabs,
                                    int d) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(qc) |
                       reinterpret_cast<uintptr_t>(slabs) |
                       static_cast<uintptr_t>(d) * sizeof(QT) |
                       static_cast<uintptr_t>(d) * sizeof(ST);
  return at % 16 == 0 ? 16 : at % 8 == 0 ? 8 : at % 4 == 0 ? 4 : 0;
}

// Four int8 (one word) as two bf16 pairs, exactly: every int8 is a bf16.
// Byte b + 128 under the exponent of 2^23 is the f32 2^23 + 128 + x, less
// 2^23 + 128 is x, whose low 16 bits are zero, so its bf16 is its high half.
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float magic = 8388736.f;   // 2^23 + 128
  const uint32_t f0 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540)) - magic);
  const uint32_t f1 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7541)) - magic);
  const uint32_t f2 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7542)) - magic);
  const uint32_t f3 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7543)) - magic);
  lo = __byte_perm(f0, f1, 0x7632);
  hi = __byte_perm(f2, f3, 0x7632);
}

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(int v) { return __int2float_rn(v); }

// acc[mi][ni][hr * 2 + h] += a[mi * 2 + hr] . b[ni * 2 + h] over the 4 d
// values of the float4s, one fmaf at a time in increasing d
__device__ __forceinline__ void ffma_4x4(float (&acc)[2][2][4],
                                         const float4 (&a)[4],
                                         const float4 (&b)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& c = acc[mi][ni][hr * 2 + h];
            c = fmaf((&a[mi * 2 + hr].x)[u], (&b[ni * 2 + h].x)[u], c);
          }
}

// a named barrier of n threads, waited on or only arrived at: barrier 1
// is the product warps' own, 2 and up pass tiles of survivors between
// them and the warps that take them
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void product_warps_sync() { named_sync(1, kPT); }

// The product warps' pipeline, shared by the kernels of both files.
//   * The block's 32 query rows (qrow_s: the gathered row, -1 for a pad)
//     are copied into q_s, [rows][q_ld] of QT, zero for pad rows and past
//     d. A bf16 or int8 query at d <= 128 (kNarrow) is kept as mma A
//     fragments in registers for the whole run. kStream (d > max_d): no
//     q_s; each stage carries its d chunk of the query rows, [rows][q_ld(1)]
//     after the slab's part, and the A operands are read from there.
//   * The slab (rows slab_row0 .. + maxc) streams through a cp.async ring
//     of kRing stages of [64 rows x chunk_d] (bf16 and int8: 128 d; f32:
//     64 d), the tail of d zero-filled.
//   * Each of the 4 warps takes 16 slab rows of a tile against all the
//     query rows, the sums running over the d chunks of a tile (d = 960:
//     8 bf16 chunks, 15 f32 ones). bf16 slab: mma.sync m16n8k16 bf16 ->
//     f32, B fragments by ldmatrix. int8 slab: the tile is copied as it is
//     (half the bytes) and each thread reads its B fragments as words and
//     upcasts them (i8x4_to_bf16x2), which needs no second pass over the
//     stage: the thread's 32 bytes of a row's d chunk hold its 4 values of
//     each of the chunk's 8 k-steps, and the query's A fragments are read
//     in the same order, so the k order within a chunk is permuted alike
//     on both sides. int8 slab and int8 query: mma.sync m16n8k32 s8 ->
//     s32 on the words as they are: the thread's 32 bytes of a row's d
//     chunk are two 16-byte halves, each the B words of 2 of the chunk's 4
//     k-steps, and its A words are read in the same order from 16-byte
//     loads of the query tile. f32 slab: ffma_4x4 on float4 loads of the
//     thread's 4 query rows and 4 slab rows, in increasing d.
//   * At the end of tile t, epi(t, dist) takes its distances:
//     dist[mi][hr][ni][h] is query row mi * 16 + hr * 8 + lane / 4 against
//     tile slot wn * 16 + ni * 8 + (lane % 4) * 2 + h, rounded as the plain
//     version rounds bias - scale * dot (an s32 dot converted to f32 in
//     one rounding); +inf past maxc.
template <typename QT, typename ST, bool kAsync, bool kNarrow, bool kStream,
          int kRing, typename Epi>
__device__ __forceinline__ void scan_products(
    QT* q_s, unsigned char* ring, const int* qrow_s,
    const QT* __restrict__ qc, const ST* __restrict__ slabs,
    const float* __restrict__ bias, long long slab_row0, int d, int maxc,
    float scale, int tid, Epi&& epi) {
  static_assert(!(kNarrow && kStream), "the streamed mode is only wide");
  constexpr bool kI8 = sizeof(ST) == 1;
  constexpr bool kI8I8 = kI8 && sizeof(QT) == 1;   // s8 mma, s32 sums
  constexpr bool kF32 = sizeof(ST) == 4;
  constexpr bool kAReg = kNarrow && !kF32;    // A fragments in registers
  constexpr int kKSteps = kI8I8 ? 4 : 8;      // mma k-steps a d chunk
  constexpr int kTD = chunk_d<ST>();
  constexpr int kRB = stage_row_bytes<ST>();
  constexpr int kSlabB = stage_bytes<ST>();   // a stage's slab part
  constexpr int kSB = ring_stage_bytes<QT, ST, kStream>();
  constexpr int kEl = 16 / sizeof(ST);        // elements a 16-byte piece
  constexpr int kPieces = kTD / kEl;          // pieces a row of a d chunk
  constexpr int kRowsPass = kPT / kPieces;    // rows a pass of the threads
  constexpr int kQEl = 16 / sizeof(QT);
  constexpr int kQPieces = kTD / kQEl;        // pieces a query row's chunk
  const int lane = tid & 31;
  const int wn = tid >> 5;   // slab rows wn * 16 .. + 15 of the tile
  const int n_dc = (d + kTD - 1) / kTD;
  // the pitch of the A operand's rows: the query tile's, or a stage's
  const int ldq = q_ld<QT, ST>(kStream ? 1 : n_dc);
  const int n_tiles = (maxc + kTN - 1) / kTN;
  const int steps = n_tiles * n_dc;
  const int gran = kAsync ? 16 : row_granule<QT, ST>(qc, slabs, d);

  // the query tile: row r, kQEl elements from column kQEl * piece
  if constexpr (!kStream) {
    const int q_pieces = n_dc * kQPieces;
    for (int i = tid; i < kRows * q_pieces; i += kPT) {
      const int row = i / q_pieces, col = (i - row * q_pieces) * kQEl;
      const int qi = qrow_s[row];
      copy16<kAsync>(q_s + row * ldq + col,
                     qc + static_cast<long long>(qi < 0 ? 0 : qi) * d + col,
                     qi < 0 ? 0 : d - col, qc, gran);
    }
  }

  // this thread's pieces of a slab tile: rows c_row + kRowsPass * p,
  // elements c_col .. + kEl - 1 of the stage's d chunk
  const int c_row = tid / kPieces, c_col = (tid % kPieces) * kEl;
  int l_t = 0, l_dc = 0, l_stage = 0;   // the next step to load
  auto issue = [&]() {
    if (l_t < n_tiles) {
      unsigned char* st = ring + l_stage * kSB;
      const int m0 = l_t * kTN;
      const int col = l_dc * kTD + c_col;
#pragma unroll
      for (int p = 0; p < kTN / kRowsPass; ++p) {
        const int row = c_row + kRowsPass * p;
        const bool ok = m0 + row < maxc;
        copy16<kAsync>(reinterpret_cast<ST*>(st + row * kRB) + c_col,
                       slabs + (slab_row0 + (ok ? m0 + row : 0)) * d + col,
                       ok ? d - col : 0, slabs, gran);
      }
      if (l_dc == n_dc - 1 && tid < kTN) {   // the tile's bias, 0 past maxc
        const bool ok = m0 + tid < maxc;
        cp_async4(smem_addr(st + kTN * kRB) + tid * 4,
                  ok ? bias + slab_row0 + m0 + tid : bias, ok ? 4 : 0);
      }
      if constexpr (kStream) {
        // the same d chunk of the query rows, zero for pad rows and past d
        QT* sq = reinterpret_cast<QT*>(st + kSlabB);
#pragma unroll
        for (int j = 0; j < kRows * kQPieces / kPT; ++j) {
          const int i = tid + j * kPT;
          const int row = i / kQPieces;
          const int qcol = (i - row * kQPieces) * kQEl;
          const int qi = qrow_s[row];
          const int gcol = l_dc * kTD + qcol;
          copy16<kAsync>(sq + row * ldq + qcol,
                         qc + static_cast<long long>(qi < 0 ? 0 : qi) * d
                             + gcol,
                         qi < 0 ? 0 : d - gcol, qc, gran);
        }
      }
      if (++l_dc == n_dc) {
        l_dc = 0;
        ++l_t;
      }
      l_stage = l_stage == kRing - 1 ? 0 : l_stage + 1;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) issue();

  using Acc = std::conditional_t<kI8I8, int, float>;
  Acc acc[2][2][4];
  uint32_t af[kAReg ? kKSteps : 1][2][4];   // the resident query
  // bf16: ldmatrix lane offsets: A rows lane % 16, columns (lane / 16) * 8;
  // B rows (lane / 16) * 8 + lane % 8, columns ((lane / 8) % 2) * 8
  const int a_off = (lane & 15) * ldq + (lane >> 4) * 8;
  const int b_off = kF32  ? (wn * 16 + (lane & 3) * 2) * kRB
                    : kI8 ? (wn * 16 + (lane >> 2)) * kRB + (lane & 3) * 32
                          : (wn * 16 + ((lane >> 4) << 3) + (lane & 7)) * kRB
                                + ((lane >> 3) & 1) * 16;
  // int8 slabs: the A words of a chunk for this thread, row mi * 16 +
  // lane / 4 (+ 8), from column (lane % 4) * 32 of the A rows at qa:
  // SQ8's bf16 pairs of k-step kk at kk * 4 .. + 3; int8 x int8's words
  // of k-steps 2 h and 2 h + 1 in the 16 bytes at h * 16
  const int a8_off = (lane >> 2) * ldq + (lane & 3) * 32;
  auto load_a8 = [&](uint32_t (&a)[4], const QT* qa, int mi, int col) {
    const QT* a8 = qa + a8_off;
    const uint2 lo = *reinterpret_cast<const uint2*>(a8 + mi * 16 * ldq
                                                     + col);
    const uint2 hi = *reinterpret_cast<const uint2*>(a8 + (mi * 16 + 8) * ldq
                                                     + col);
    a[0] = lo.x;
    a[1] = hi.x;
    a[2] = lo.y;
    a[3] = hi.y;
  };
  auto load_a16 = [&](uint32_t (&a0)[4], uint32_t (&a1)[4], const QT* qa,
                      int mi, int col) {
    const QT* a8 = qa + a8_off;
    const uint4 lo = *reinterpret_cast<const uint4*>(a8 + mi * 16 * ldq
                                                     + col);
    const uint4 hi = *reinterpret_cast<const uint4*>(a8 + (mi * 16 + 8) * ldq
                                                     + col);
    a0[0] = lo.x;
    a0[1] = hi.x;
    a0[2] = lo.y;
    a0[3] = hi.y;
    a1[0] = lo.z;
    a1[1] = hi.z;
    a1[2] = lo.w;
    a1[3] = hi.w;
  };
  const int d16 = (d + 15) / 16;   // k-steps in all of d

  int t = 0, dc = 0, stage = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kRing - 2>();
    product_warps_sync();
    issue();

    const unsigned char* st = ring + stage * kSB;
    // the A rows of this d chunk: the query tile from column qcol, or the
    // stage's query part
    const QT* qa = kStream ? reinterpret_cast<const QT*>(st + kSlabB) : q_s;
    const int qcol = kStream ? 0 : dc * kTD;
    if (dc == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] = Acc(0);
    }
    if constexpr (kF32) {
      // the thread's query rows lane / 4 + 8 j and slab rows b_off / kRB
      // + {0, 1, 8, 9}, float4 steps up to the last that holds some of d
      // (its tail is zero on both sides)
      const float* qp = qa + (lane >> 2) * ldq + qcol;
      const unsigned char* sp = st + b_off;
      const int n4 = min(kTD / 4, (d - dc * kTD + 3) / 4);
#pragma unroll 4
      for (int kk = 0; kk < n4; ++kk) {
        float4 a[4], b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a[j] = *reinterpret_cast<const float4*>(qp + j * 8 * ldq + kk * 4);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          b[n] = *reinterpret_cast<const float4*>(
              sp + ((n >> 1) * 8 + (n & 1)) * kRB + kk * 16);
        ffma_4x4(acc, a, b);
      }
    } else if constexpr (kI8I8) {
      // every k-step of a chunk, as SQ8 below; k-step 2 h + q takes words
      // 2 q and 2 q + 1 of the 16-byte half h, on both sides
      const unsigned char* bp = st + b_off;
      if constexpr (kAReg) {
        if (s == 0) {   // the query tile landed with the first stage
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              load_a16(af[2 * h][mi], af[2 * h + 1][mi], q_s, mi, h * 16);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint4 w[2];
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          w[ni] = *reinterpret_cast<const uint4*>(bp + ni * 8 * kRB + h * 16);
        uint32_t a[2][2][4];   // [q][mi]
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if constexpr (kAReg) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              a[0][mi][j] = af[2 * h][mi][j];
              a[1][mi][j] = af[2 * h + 1][mi][j];
            }
          } else {
            load_a16(a[0][mi], a[1][mi], qa, mi, qcol + h * 16);
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_s8(acc[mi][0], a[q][mi], (&w[0].x)[2 * q],
                   (&w[0].x)[2 * q + 1]);
            mma_s8(acc[mi][1], a[q][mi], (&w[1].x)[2 * q],
                   (&w[1].x)[2 * q + 1]);
          }
      }
    } else if constexpr (kI8) {
      // every k-step of a chunk: the permuted order mixes the tail of d
      // (zero on both sides) into all of them
      const unsigned char* bp = st + b_off;
      if constexpr (kAReg) {
        if (s == 0) {   // the query tile landed with the first stage
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              load_a8(af[kk][mi], q_s, mi, kk * 4);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint4 w[2];
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          w[ni] = *reinterpret_cast<const uint4*>(bp + ni * 8 * kRB
                                                  + half * 16);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = half * 4 + q;
          uint32_t b[2][2];
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
            i8x4_to_bf16x2((&w[ni].x)[q], b[ni][0], b[ni][1]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            uint32_t a[4];
            if constexpr (kAReg) {
#pragma unroll
              for (int j = 0; j < 4; ++j) a[j] = af[kk][mi][j];
            } else {
              load_a8(a, qa, mi, qcol + kk * 4);
            }
            mma_bf16(acc[mi][0], a, b[0][0], b[0][1]);
            mma_bf16(acc[mi][1], a, b[1][0], b[1][1]);
          }
        }
      }
    } else {
      const uint32_t b_base = smem_addr(st + b_off);
      const uint32_t a_base = smem_addr(qa + a_off);
      const int ksteps = min(kTD / 16, d16 - dc * (kTD / 16));
      if constexpr (kAReg) {
        if (s == 0) {   // the query tile landed with the first stage
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              ldmatrix_x4(af[kk][mi], a_base + (mi * 16 * ldq + kk * 16) * 2);
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if (kk < ksteps) {
            uint32_t b[4];
            ldmatrix_x4(b, b_base + kk * 32);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_bf16(acc[mi][0], af[kk][mi], b[0], b[1]);
              mma_bf16(acc[mi][1], af[kk][mi], b[2], b[3]);
            }
          }
        }
      } else {
#pragma unroll 2
        for (int kk = 0; kk < ksteps; ++kk) {
          uint32_t a[2][4], b[4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            ldmatrix_x4(a[mi], a_base + (mi * 16 * ldq + qcol + kk * 16)
                                            * 2);
          ldmatrix_x4(b, b_base + kk * 32);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][0], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][1], a[mi], b[2], b[3]);
          }
        }
      }
    }

    if (dc == n_dc - 1) {
      // Accumulator entry j of tile (mi, ni) is query row mi * 16 + (j / 2)
      // * 8 + lane / 4 and slab row ni * 8 + (lane % 4) * 2 + j % 2 of the
      // warp's 16.
      const float* bias_s = reinterpret_cast<const float*>(st + kTN * kRB);
      const int m0 = t * kTN;
      float fb[2][2];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int bt = wn * 16 + ni * 8 + (lane & 3) * 2 + h;
          fb[ni][h] = m0 + bt < maxc ? bias_s[bt] : INFINITY;
        }
      float dist[2][2][2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              dist[mi][hr][ni][h] = __fsub_rn(
                  fb[ni][h],
                  __fmul_rn(scale, as_f32(acc[mi][ni][hr * 2 + h])));
      epi(t, dist);
    }
    if (++dc == n_dc) {
      dc = 0;
      ++t;
    }
    stage = stage == kRing - 1 ? 0 : stage + 1;
  }
  cp_async_wait<0>();
}

// ---- k <= 32: scan_heap_body ------------------------------------------------

template <typename QT, typename ST, bool kNarrow, bool kStream>
size_t scan_heap_smem_bytes(int n_dc, int k) {
  return (kStream ? 0 : q_tile_bytes<QT, ST>(n_dc))          // query tile
         + static_cast<size_t>(ring_stages<ST>(kNarrow, kStream))
               * ring_stage_bytes<QT, ST, kStream>()         // the ring
         + static_cast<size_t>(kRows) * k * 8                // the heaps
         + 2 * kTN * kRows * 5          // two candidate buffers: f32 + u8
         + kRows * 12;                  // query rows, 2 x candidate counts
}

// The body of the k <= 32 kernels (scan_mma_kernel, scan_i8_kernel,
// scan_f32_kernel).
template <typename QT, typename ST, bool kAsync, bool kNarrow, bool kStream>
__device__ __forceinline__ void scan_heap_body(
    const QT* __restrict__ qc, const int* __restrict__ qidx,
    const ST* __restrict__ slabs, const float* __restrict__ bias,
    float* __restrict__ vals, int* __restrict__ idx, int cap, int qn, int d,
    int maxc, int k, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRing = ring_stages<ST>(kNarrow, kStream);
  const int n_dc = (d + chunk_d<ST>() - 1) / chunk_d<ST>();
  QT* q_s = reinterpret_cast<QT*>(smem);
  unsigned char* ring = smem + (kStream ? 0 : q_tile_bytes<QT, ST>(n_dc));
  Key* heap = reinterpret_cast<Key*>(
      ring + kRing * ring_stage_bytes<QT, ST, kStream>());
  // survivors of a tile, two buffers: value [2][kTN][kRows] f32 and slot
  // within the tile [2][kTN][kRows] u8, counts [2][kRows]. Tile 0 sorts
  // its keys in the same bytes, as [kRows][kTN] keys.
  float* cand_v = reinterpret_cast<float*>(heap + kRows * k);
  uint8_t* cand_s = reinterpret_cast<uint8_t*>(cand_v + 2 * kTN * kRows);
  Key* cand = reinterpret_cast<Key*>(cand_v);
  int* cand_n = reinterpret_cast<int*>(cand_s + 2 * kTN * kRows);
  int* qrow_s = cand_n + 2 * kRows;   // the gathered query row, -1 for a pad

  const int c = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_tiles = (maxc + kTN - 1) / kTN;
  const int q_valid = cap - r0;   // rows of this block that exist
  const long long slab_row0 = static_cast<long long>(c) * maxc;

  if (tid < kRows) {
    int qi = -1;
    if (tid < q_valid) qi = qidx[static_cast<long long>(c) * cap + r0 + tid];
    qrow_s[tid] = (qi >= 0 && qi < qn) ? qi : -1;
    cand_n[tid] = cand_n[kRows + tid] = 0;
  }
  __syncthreads();

  // Two roles. The product warps sort the first tile themselves and leave
  // each row's k best in its heap, which is full from then on (with +inf
  // keys where the tile has fewer finite slots). For every later tile t
  // the roles meet at one block barrier: the product warps have staged
  // the tile's survivors into buffer t % 2, and the heap warp has pushed
  // every tile before t. The heap warp then pushes tile t while the
  // product warps go on with tile t + 1 and stage it into the other
  // buffer. The product warps read the heaps' roots while the heap warp
  // works: a root only falls, so a stale one lets more through, never
  // less, and the heap compares whole keys.
  if (warp >= kPT / 32) {
    const int row = tid - kPT;
    Key* h = heap + row;
    named_sync(2, kPT + kHT);   // tile 0 is in the heaps
    for (int t = 1; t < n_tiles; ++t) {
      named_sync(2, kPT + kHT);
      const int buf = t & 1;
      const float* cv = cand_v + buf * kTN * kRows;
      const uint8_t* cs = cand_s + buf * kTN * kRows;
      const int n = cand_n[buf * kRows + row];
      for (int u = 0; u < n; ++u) {
        const Key x = make_key(cv[u * kRows + row],
                               t * kTN + cs[u * kRows + row]);
        if (x < h[0]) heap_sift<kRows>(h, k, k, x);
      }
      cand_n[buf * kRows + row] = 0;
    }
  } else {
    const int wn = warp;
    scan_products<QT, ST, kAsync, kNarrow, kStream, kRing>(
        q_s, ring, qrow_s, qc, slabs, bias, slab_row0, d, maxc, scale, tid,
        [&](int t, const float (&dist)[2][2][2][2]) {
          if (t == 0) {
            // The first tile has no bar yet and every slot would be a
            // survivor: sort each row's 64 keys here, in parallel (a
            // bitonic network in shared memory, cand as [kRows][kTN]), and
            // make the k smallest the row's heap. In descending order they
            // are a heap.
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                const int row = mi * 16 + hr * 8 + (lane >> 2);
#pragma unroll
                for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    const int bt = wn * 16 + ni * 8 + (lane & 3) * 2 + h;
                    cand[row * kTN + bt] = make_key(dist[mi][hr][ni][h], bt);
                  }
              }
            product_warps_sync();
            for (int span = 2; span <= kTN; span <<= 1)
              for (int j = span >> 1; j > 0; j >>= 1) {
                for (int p = tid; p < kRows * (kTN / 2); p += kPT) {
                  const int row = p / (kTN / 2), q = p % (kTN / 2);
                  const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
                  Key* at = cand + row * kTN;
                  const Key lo = at[i], hi = at[i | j];
                  if ((lo > hi) == ((i & span) == 0)) {
                    at[i] = hi;
                    at[i | j] = lo;
                  }
                }
                product_warps_sync();
              }
            for (int p = tid; p < kRows * k; p += kPT) {
              const int row = p / k, j = p - row * k;
              heap[(k - 1 - j) * kRows + row] = cand[row * kTN + j];
            }
            named_sync(2, kPT + kHT);   // tile 0 is in the heaps
            return;
          }
          float* cv = cand_v + (t & 1) * kTN * kRows;
          uint8_t* cs = cand_s + (t & 1) * kTN * kRows;
          int* cn = cand_n + (t & 1) * kRows;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = mi * 16 + hr * 8 + (lane >> 2);
              // the bar: the k-th, the heap's root; rows past cap take
              // nothing
              const float kth =
                  row >= q_valid
                      ? -INFINITY
                      : key_value(*reinterpret_cast<volatile Key*>(heap + row));
              unsigned take = 0;
#pragma unroll
              for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  take |= static_cast<unsigned>(dist[mi][hr][ni][h] < kth)
                          << (ni * 2 + h);
              int slot = take ? atomicAdd(&cn[row], __popc(take)) : 0;
#pragma unroll
              for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  if (take >> (ni * 2 + h) & 1) {
                    cv[slot * kRows + row] = dist[mi][hr][ni][h];
                    cs[slot * kRows + row] = static_cast<uint8_t>(
                        wn * 16 + ni * 8 + (lane & 3) * 2 + h);
                    ++slot;
                  }
            }
          named_sync(2, kPT + kHT);
        });
  }
  __syncthreads();   // the last tile is in the heaps

  // heap sort each row into ascending (value, slot) order
  if (tid >= kPT) {
    const int row = tid - kPT;
    Key* h = heap + row;
    for (int size = k; size > 1; --size) {
      const Key top = h[0];
      heap_sift<kRows>(h, size - 1, k, h[(size - 1) * kRows]);
      h[(size - 1) * kRows] = top;
    }
  }
  __syncthreads();

  // a slot past maxc or with a +inf bias scores +inf: it comes out as
  // (+inf, 0), as a row with fewer than k finite slots has it
  for (int i = tid; i < kRows * k; i += kPT + kHT) {
    const int row = i / k, j = i - row * k;
    if (row >= q_valid) continue;
    const Key key = heap[j * kRows + row];
    const float v = key_value(key);
    const long long o = (static_cast<long long>(c) * cap + r0 + row) * k + j;
    vals[o] = v;
    idx[o] = v == INFINITY ? 0 : static_cast<int>(key & 0xffffffffu);
  }
}

// ---- k > 32: scan_general_body ----------------------------------------------
//
// The products of the heap kernels (scan_products: a block takes one
// cluster and 32 query rows, so at cap <= 32 a slab is read once), and in
// place of their per-row heaps, sized for k <= 32, select_topk.cuh's
// running buffers: a row keeps its candidates below its bar in a buffer of
// 2k + 32 (value, slot) keys, in shared memory while the block's 32
// buffers fit beside the kernel's own bytes and in global scratch above,
// and selects its k smallest when more than 2k are held. At the end of
// each tile the product warps stage the tile's survivors, the distances
// below their row's bar, as a value in a [32 rows][64 slots] buffer and a
// 64-bit mask a row; 8 top-k warps, 4 rows each, append them in slot order
// (so that equal values keep the lower slot) and select. The buffers form
// a queue of kNB tiles, passed back and forth by named barriers, so the
// product warps go on with the next tiles while the top-k warps work
// through a burst of selections (a block's rows reach theirs at about the
// same tile). The bar is the row's k-th key since its last selection,
// published in shared memory; the product warps read it as it stands (a
// stale bar lets more through, never less), and the first ceil(2k / 64)
// tiles, before a row's first selection, pass every slot, +inf ones too,
// so that a row with fewer than k finite slots ends with the lowest +inf
// slots, as the plain version's stable sort has them. At the end every
// warp takes rows and writes their k smallest, ascending. Pad rows and
// rows past cap take nothing and come out as (+inf, 0).

// 8 top-k warps, 4 rows each
constexpr int kGT = 8;
constexpr int kGThreads = kPT + 32 * kGT;
// survivor buffers between the product warps and the top-k warps: the
// product warps run up to kNB tiles ahead, through a row's selection
constexpr int kNB = 4;

// the kernel's own shared memory, beside the rows' buffers; the mode
// goes by d (narrow: d <= 128; streamed: d > max_d)
template <typename QT, typename ST>
size_t general_own_bytes(int d) {
  const int n_dc = (d + chunk_d<ST>() - 1) / chunk_d<ST>();
  const bool stream = d > max_d<QT>();
  return (stream ? 0 : q_tile_bytes<QT, ST>(n_dc))           // query tile
         + static_cast<size_t>(general_ring_stages<ST>(d <= kNarrowD,
                                                       stream))
               * (stream ? ring_stage_bytes<QT, ST, true>()
                         : stage_bytes<ST>())                // the ring
         + kNB * kRows * kTN * 4   // the survivor buffers' values
         + kNB * kRows * 8         // and masks
         + kRows * 16;             // bars, sizes, query rows
}

// The body of the general kernels (scan_general_mma_kernel,
// scan_general_i8_kernel, scan_general_f32_kernel).
template <typename QT, typename ST, bool kAsync, bool kNarrow, bool kStream>
__device__ __forceinline__ void scan_general_body(
    const QT* __restrict__ qc, const int* __restrict__ qidx,
    const ST* __restrict__ slabs, const float* __restrict__ bias,
    float* __restrict__ vals, int* __restrict__ idx, Key* scratch, int cap,
    int qn, int d, int maxc, int k, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRing = general_ring_stages<ST>(kNarrow, kStream);
  constexpr int kR = kRows;
  constexpr int kNT = kGThreads;
  constexpr int kRTW = kR / kGT;                   // rows of a top-k warp
  const int n_dc = (d + chunk_d<ST>() - 1) / chunk_d<ST>();
  const int c = blockIdx.x;
  const int r0 = blockIdx.y * kR;
  const long long blk = static_cast<long long>(c) * gridDim.y + blockIdx.y;
  Key* bufs = scratch != nullptr ? scratch + blk * kR * topk_buf(k)
                                 : reinterpret_cast<Key*>(smem);
  unsigned char* own = smem + (scratch != nullptr ? 0
                                                  : topk_bufs_bytes(kR, k));
  QT* q_s = reinterpret_cast<QT*>(own);
  unsigned char* ring = own + (kStream ? 0 : q_tile_bytes<QT, ST>(n_dc));
  // survivors of a tile, kNB buffers: values [kNB][kR][kTN] and masks
  // [kNB][kR] (bit s: slot s of the tile), the mask as 4 u16, one a
  // product warp. Tile t goes to buffer t % kNB; named barriers 2 + b
  // (full) and 2 + kNB + b (empty) pass buffer b back and forth.
  float* cand_v = reinterpret_cast<float*>(
      ring + kRing * ring_stage_bytes<QT, ST, kStream>());
  unsigned long long* cand_m =
      reinterpret_cast<unsigned long long*>(cand_v + kNB * kR * kTN);
  Key* bar_s = reinterpret_cast<Key*>(cand_m + kNB * kR);
  int* size_s = reinterpret_cast<int*>(bar_s + kR);
  int* qrow_s = size_s + kR;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_tiles = (maxc + kTN - 1) / kTN;
  const int q_valid = cap - r0;
  const long long slab_row0 = static_cast<long long>(c) * maxc;

  if (tid < kR) {
    int qi = -1;
    if (tid < q_valid) qi = qidx[static_cast<long long>(c) * cap + r0 + tid];
    qi = (qi >= 0 && qi < qn) ? qi : -1;
    qrow_s[tid] = qi;
    bar_s[tid] = qi >= 0 ? kNoKey : 0;   // no key is below 0
  }
  __syncthreads();

  if (warp >= kPT / 32) {
    const int tw = warp - kPT / 32;   // rows tw + kGT * j
    Key* buf[kRTW];
    int size[kRTW];
    Key bar[kRTW];
    bool live[kRTW];
#pragma unroll
    for (int j = 0; j < kRTW; ++j) {
      const int row = tw + kGT * j;
      buf[j] = bufs + static_cast<long long>(row) * topk_buf(k);
      size[j] = 0;
      bar[j] = kNoKey;
      live[j] = qrow_s[row] >= 0;
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int b = t % kNB;
      named_sync(2 + b, kNT);   // tile t is staged in buffer b
#pragma unroll
      for (int j = 0; j < kRTW; ++j) {
        const int row = tw + kGT * j;
        const unsigned long long mask = cand_m[b * kR + row];
        if (!live[j] || mask == 0) continue;   // warp-uniform
        const float* cv = cand_v + (b * kR + row) * kTN;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int slot = h * 32 + lane;
          const bool v = (mask >> slot) & 1;
          warp_push(buf[j], size[j], bar[j], k,
                    v ? make_key(cv[slot], t * kTN + slot) : kNoKey, v, lane);
        }
        if (lane == 0) *reinterpret_cast<volatile Key*>(bar_s + row) = bar[j];
      }
      if (t + kNB < n_tiles) named_arrive(2 + kNB + b, kNT);   // b is free
    }
#pragma unroll
    for (int j = 0; j < kRTW; ++j)
      if (lane == 0) size_s[tw + kGT * j] = size[j];
  } else {
    const int wn = warp;
    scan_products<QT, ST, kAsync, kNarrow, kStream, kRing>(
        q_s, ring, qrow_s, qc, slabs, bias, slab_row0, d, maxc, scale, tid,
        [&](int t, const float (&dist)[2][2][2][2]) {
          const int b = t % kNB;
          if (t >= kNB) named_sync(2 + kNB + b, kNT);   // tile t - kNB taken
          uint16_t* mk = reinterpret_cast<uint16_t*>(cand_m + b * kR);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = mi * 16 + hr * 8 + (lane >> 2);
              const Key bar = *reinterpret_cast<volatile Key*>(bar_s + row);
              float* cv = cand_v + (b * kR + row) * kTN;
              unsigned take = 0;
#pragma unroll
              for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int bit = ni * 8 + (lane & 3) * 2 + h;
                  const int m = t * kTN + wn * 16 + bit;
                  const float v = dist[mi][hr][ni][h];
                  if (m < maxc && make_key(v, m) < bar) {
                    take |= 1u << bit;
                    cv[wn * 16 + bit] = v;
                  }
                }
              take |= __shfl_xor_sync(kFull, take, 1);
              take |= __shfl_xor_sync(kFull, take, 2);
              if ((lane & 3) == 0) mk[row * 4 + wn] = static_cast<uint16_t>(take);
            }
          __threadfence_block();
          named_arrive(2 + b, kNT);
        });
  }
  __syncthreads();   // every tile is in the buffers

  for (int row = warp; row < kR && row < q_valid; row += kNT / 32) {
    const long long o = (static_cast<long long>(c) * cap + r0 + row) * k;
    if (qrow_s[row] < 0) {
      for (int i = lane; i < k; i += 32) {
        vals[o + i] = INFINITY;
        idx[o + i] = 0;
      }
      continue;
    }
    Key* buf = bufs + static_cast<long long>(row) * topk_buf(k);
    warp_sort_smallest(buf, size_s[row], k, lane);
    for (int i = lane; i < k; i += 32) {
      const Key key = buf[i];
      vals[o + i] = key_value(key);
      idx[o + i] = static_cast<int>(key & 0xffffffffu);
    }
  }
}

// ---- the kernels and their launches ----------------------------------------
//
// Each kernel has three modes of its query rows, chosen by d alone:
// kNarrow (d <= 128, A fragments in registers), resident (up to max_d)
// and kStream (past max_d, the query's d chunks through the ring).

// a bf16 query with a bf16 or an int8 slab, on tensor cores
template <typename ST, bool kAsync, bool kNarrow, bool kStream>
__global__ void __launch_bounds__(kPT + kHT,
                                  blocks_per_sm<ST>(kNarrow, kStream))
scan_mma_kernel(const __nv_bfloat16* __restrict__ qc,
                const int* __restrict__ qidx, const ST* __restrict__ slabs,
                const float* __restrict__ bias, float* __restrict__ vals,
                int* __restrict__ idx, int cap, int qn, int d, int maxc,
                int k, float scale) {
  scan_heap_body<__nv_bfloat16, ST, kAsync, kNarrow, kStream>(
      qc, qidx, slabs, bias, vals, idx, cap, qn, d, maxc, k, scale);
}

template <typename ST, bool kAsync, bool kNarrow, bool kStream>
__global__ void __launch_bounds__(kGThreads, 1)
scan_general_mma_kernel(const __nv_bfloat16* __restrict__ qc,
                        const int* __restrict__ qidx,
                        const ST* __restrict__ slabs,
                        const float* __restrict__ bias,
                        float* __restrict__ vals, int* __restrict__ idx,
                        Key* scratch, int cap, int qn, int d, int maxc, int k,
                        float scale) {
  scan_general_body<__nv_bfloat16, ST, kAsync, kNarrow, kStream>(
      qc, qidx, slabs, bias, vals, idx, scratch, cap, qn, d, maxc, k, scale);
}

// int8 x int8 on s8 tensor cores, exact s32 sums (notes in
// grouped_scan_i8.cu)
template <bool kAsync, bool kNarrow, bool kStream>
__global__ void __launch_bounds__(kPT + kHT,
                                  blocks_per_sm<int8_t>(kNarrow, kStream))
scan_i8_kernel(const int8_t* __restrict__ qc, const int* __restrict__ qidx,
               const int8_t* __restrict__ slabs,
               const float* __restrict__ bias, float* __restrict__ vals,
               int* __restrict__ idx, int cap, int qn, int d, int maxc, int k,
               float scale) {
  scan_heap_body<int8_t, int8_t, kAsync, kNarrow, kStream>(
      qc, qidx, slabs, bias, vals, idx, cap, qn, d, maxc, k, scale);
}

template <bool kAsync, bool kNarrow, bool kStream>
__global__ void __launch_bounds__(kGThreads, 1)
scan_general_i8_kernel(const int8_t* __restrict__ qc,
                       const int* __restrict__ qidx,
                       const int8_t* __restrict__ slabs,
                       const float* __restrict__ bias,
                       float* __restrict__ vals, int* __restrict__ idx,
                       Key* scratch, int cap, int qn, int d, int maxc, int k,
                       float scale) {
  scan_general_body<int8_t, int8_t, kAsync, kNarrow, kStream>(
      qc, qidx, slabs, bias, vals, idx, scratch, cap, qn, d, maxc, k, scale);
}

// f32 x f32 in exact FMAs on CUDA cores (notes in grouped_scan_f32.cu)
template <bool kAsync, bool kNarrow, bool kStream>
__global__ void __launch_bounds__(kPT + kHT,
                                  blocks_per_sm<float>(kNarrow, kStream))
scan_f32_kernel(const float* __restrict__ qc, const int* __restrict__ qidx,
                const float* __restrict__ slabs,
                const float* __restrict__ bias, float* __restrict__ vals,
                int* __restrict__ idx, int cap, int qn, int d, int maxc,
                int k, float scale) {
  scan_heap_body<float, float, kAsync, kNarrow, kStream>(
      qc, qidx, slabs, bias, vals, idx, cap, qn, d, maxc, k, scale);
}

template <bool kAsync, bool kNarrow, bool kStream>
__global__ void __launch_bounds__(kGThreads, 1)
scan_general_f32_kernel(const float* __restrict__ qc,
                        const int* __restrict__ qidx,
                        const float* __restrict__ slabs,
                        const float* __restrict__ bias,
                        float* __restrict__ vals, int* __restrict__ idx,
                        Key* scratch, int cap, int qn, int d, int maxc, int k,
                        float scale) {
  scan_general_body<float, float, kAsync, kNarrow, kStream>(
      qc, qidx, slabs, bias, vals, idx, scratch, cap, qn, d, maxc, k, scale);
}



// Launch the pair (QT, ST)'s heap kernel (general false: k <= 32) or its
// general kernel (any k), the instantiation that 16-byte copies (every
// row start on 16 bytes) and the mode of d pick: narrow up to 128,
// resident up to max_d<QT>(), streamed past it (kWide, compiled apart).
template <typename QT, typename ST, bool kWide>
int launch_pipeline(bool general, const ScanArgs& a, cudaStream_t st) {
  if ((a.cap + kRows - 1) / kRows > 65535 ||   // the grid's y
      kWide != (a.d > max_d<QT>()))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto go = [&](auto async, auto narrow, auto stream) {
    constexpr bool kA = decltype(async)::value, kN = decltype(narrow)::value;
    constexpr bool kS = decltype(stream)::value;
    constexpr bool kF32 = std::is_same<QT, float>::value;
    constexpr bool kI8I8 = std::is_same<QT, int8_t>::value;
    // the pair's kernels: f32 and int8 x int8 have names of their own
    const auto heap = [] {
      if constexpr (kF32) return scan_f32_kernel<kA, kN, kS>;
      else if constexpr (kI8I8) return scan_i8_kernel<kA, kN, kS>;
      else return scan_mma_kernel<ST, kA, kN, kS>;
    }();
    const auto gen = [] {
      if constexpr (kF32) return scan_general_f32_kernel<kA, kN, kS>;
      else if constexpr (kI8I8) return scan_general_i8_kernel<kA, kN, kS>;
      else return scan_general_mma_kernel<ST, kA, kN, kS>;
    }();
    const dim3 grid(a.n_clusters, (a.cap + kRows - 1) / kRows);
    const auto qc = static_cast<const QT*>(a.qc);
    const auto qidx = static_cast<const int*>(a.qidx);
    const auto slabs = static_cast<const ST*>(a.slabs);
    const auto bias = static_cast<const float*>(a.bias);
    const auto vals = static_cast<float*>(a.vals);
    const auto idx = static_cast<int*>(a.idx);
    cudaError_t err;
    if (!general) {
      const int n_dc = (a.d + chunk_d<ST>() - 1) / chunk_d<ST>();
      const size_t smem = scan_heap_smem_bytes<QT, ST, kN, kS>(n_dc, a.k);
      err = cudaFuncSetAttribute(
          heap, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      heap<<<grid, kPT + kHT, smem, st>>>(qc, qidx, slabs, bias, vals, idx,
                                          a.cap, a.qn, a.d, a.maxc, a.k,
                                          a.scale);
    } else {
      const size_t own = general_own_bytes<QT, ST>(a.d);
      if (topk_needs_scratch(kRows, a.k, own) != (a.scratch != nullptr))
        return cudaErrorInvalidValue;
      const size_t smem = topk_smem_bytes(kRows, a.k, own);
      err = cudaFuncSetAttribute(
          gen, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      gen<<<grid, kGThreads, smem, st>>>(
          qc, qidx, slabs, bias, vals, idx, static_cast<Key*>(a.scratch),
          a.cap, a.qn, a.d, a.maxc, a.k, a.scale);
    }
    return cudaGetLastError();
  };
  using Y = std::true_type;
  using N = std::false_type;
  const bool async = row_granule<QT, ST>(a.qc, a.slabs, a.d) == 16;
  cudaError_t err;
  if constexpr (kWide)
    err = async ? go(Y{}, N{}, Y{}) : go(N{}, N{}, Y{});
  else if (a.d <= kNarrowD)
    err = async ? go(Y{}, Y{}, N{}) : go(N{}, Y{}, N{});
  else
    err = async ? go(Y{}, N{}, N{}) : go(N{}, N{}, N{});
  return static_cast<int>(err);
}

}  // namespace

// One pair's launch_pipeline a file, its streamed mode (d past max_d) in
// a second one, so that the eight compile in parallel:
// grouped_scan_bf16[_wide].cu (a bf16 query with bf16 slabs),
// grouped_scan_sq8[_wide].cu (a bf16 query with int8 slabs),
// grouped_scan_i8[_wide].cu (int8 x int8), grouped_scan_f32[_wide].cu.
int launch_scan_bf16(bool general, const ScanArgs& a, cudaStream_t st);
int launch_scan_sq8(bool general, const ScanArgs& a, cudaStream_t st);
int launch_scan_i8(bool general, const ScanArgs& a, cudaStream_t st);
int launch_scan_f32(bool general, const ScanArgs& a, cudaStream_t st);
int launch_scan_bf16_wide(bool general, const ScanArgs& a, cudaStream_t st);
int launch_scan_sq8_wide(bool general, const ScanArgs& a, cudaStream_t st);
int launch_scan_i8_wide(bool general, const ScanArgs& a, cudaStream_t st);
int launch_scan_f32_wide(bool general, const ScanArgs& a, cudaStream_t st);
