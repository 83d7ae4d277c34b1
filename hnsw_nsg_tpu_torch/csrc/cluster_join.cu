// Cluster join with bucketed top-k, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _join_kernel behind cluster_join_topk
// (hnsw_nsg_tpu/ops/pallas_scan.py:98, pallas_call :203), the kernel of
// the cluster-join kNN-graph builder (models/knn_ivf.py). For cluster c
// and each member row r of qv[c] ([maxc, d]), against the stacked
// candidate slabs stacks[c] ([mm, d]):
//   dist[m] = bias[c, m] - scale * <qv[c, r], stacks[c, m]>
// The mm slots fall into g = mm / group comb buckets, bucket b holding the
// slots {b + e * g : e < group}. Each bucket keeps its minimum, the lowest
// e winning a tie (strict < in increasing e). The k smallest buckets,
// ordered by (value, b) (the first minimum wins, as jnp.argmin), are
// returned as vals [C, maxc, k] and idx = e * g + b. Slots of a bucket
// after its minimum are never returned: this is the TPU kernel's bucket
// rule (pallas_scan.py:129-142), kept because it decides which slots can
// come back. Entries past the finite buckets are +inf with idx 0; the
// caller masks them.
//
// Two kernels for k <= 64, one per operand type, and a general kernel for
// any k (at the end of this file), all exact products summed in f32 as
// pallas_scan.py:_dots specifies:
//
// bf16 x bf16 (the build path), join_mma_kernel: tensor cores.
//   A block takes one cluster and 128 member rows and walks the buckets in
//   tiles of 64. Eight product warps (4 x 2, each a 32-row x 32-bucket
//   tile) compute, for each bucket tile and each e, the products with the
//   stack rows e * g + b0 .. + 63, which stream through a 3-stage cp.async
//   ring (rows padded by 16 bytes, so ldmatrix reads hit distinct banks).
//   When d <= 128 a ring step is the whole of d and each product warp
//   keeps its 32 query rows as mma fragments in registers for the whole
//   run (setmaxnreg moves registers from the heap warps to the product
//   warps); above that (d = 960, gist) the query streams beside the stack
//   in 64-wide d chunks. Products are mma.sync m16n8k16 bf16 -> f32, B
//   (and a streamed A) from ldmatrix, into one of two accumulator sets.
//   The other set, the previous e, is folded meanwhile into per-(row,
//   bucket) running minima and their e, in registers and in the
//   accumulator's own layout (C fragment: row lane / 4 (+ 8), columns
//   2 (lane % 4) + {0, 1}), so no [rows, g] state exists and the fold runs
//   while the tensor cores work. When a bucket tile is done, only the
//   minima that beat their row's current k-th are staged, and four heap
//   warps, one thread a row, push them into per-row 4-ary max-heaps of
//   packed (value, b, e) keys in shared memory while the product warps go
//   on with the next tile. A row takes ~k (1 + ln(g / k)) pushes in all
//   (~240 at the build shape, for data in random order), not k per
//   tile. Buckets arrive in increasing b, so a candidate tying the k-th
//   loses, as it must.
//
//   What bounds it on the H100: the tensor-core products. Only slots with
//   a finite bias need one: a +inf slot scores +inf whatever its dot. At
//   the 1M build shape (C = 1091, maxc = 2112, M = 8, mm = 16,896,
//   d = 128, k = 52) every slot is 2 * C * maxc * mm * d = 9.97 TFLOP;
//   chip_smoke.py phase 6 leaves about 3/4 of the slots finite, so the
//   join needs ~7.5 TFLOP, ~7.6 ms at the 989 TFLOP/s bf16 peak (its
//   input and output take ~1.9 ms at 3.35 TB/s). Measured there
//   (chip_smoke.py phase 6, H100 80GB HBM3 at 700 W): ~59 ms, ~13% of
//   the bound, against ~860 ms for the plain version. The kernel makes
//   every product, pad slots included, at ~170 TFLOP/s: mma.sync from 8
//   warps of 32 x 32 tiles, fed by ldmatrix, stays far below the peak.
//   What is left for a later step, largest first on the real build path:
//   in a 1M build the slabs are ~43% full (1M rows in 1091 slabs of
//   2112), so skipping the bucket tiles past a stack's fullest slab, and
//   the all-pad row tiles (which needs each cluster's member count),
//   would cut most of the products; then warpgroup wgmma fed by TMA; larger row tiles to
//   cut the L2 traffic (each block reads its cluster's stack once per
//   128 rows, ~80 GB at that shape); and a cheaper top-k, whose heap
//   warps take issue slots from the product warps.
//
// f32 x f32, join_fma_kernel: exact f32 FMAs on CUDA cores (no TF32, no
//   3xTF32: F-H1). A block takes one cluster and 32 member rows and walks
//   128-bucket tiles through shared memory in 32-wide d chunks, folds a
//   4 x 4 register tile of dots into per-bucket minima, and merges each
//   tile into each row's k-list (two entries per lane) by k warp-wide
//   (value, bucket) passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_helpers.cuh"
#include "select_topk.cuh"

namespace {

constexpr int kMaxK = 64;
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1 };

// (value, bucket) order: the lower bucket wins a tie
__device__ __forceinline__ bool before(float av, int ab, float bv, int bb) {
  return av < bv || (av == bv && ab < bb);
}

// ---- f32 x f32: CUDA-core FMAs ---------------------------------------------

constexpr int kThreads = 256;   // 8 warps
constexpr int kRows = 32;       // member rows per block: 4 per warp
constexpr int kTileB = 128;     // buckets per tile: 4 per lane
constexpr int kDC = 32;         // d elements per shared-memory chunk

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// acc = the products of the warp's 4 member rows (r0 + warp * 4 + i; zero
// past maxc) with this lane's 4 buckets' stack rows (e_row0 + b0 + lane +
// 32 u; zero past g) over all of d, exact products summed in f32 FMAs, the
// rows staged through shared memory 32 d values at a time. Starts with a
// barrier, so the caller's last reads of q_s / s_s come first.
template <typename T>
__device__ __forceinline__ void tile_products(
    float (&acc)[4][4], float (*q_s)[kDC + 1], float (*s_s)[kDC + 1],
    const T* __restrict__ qv, const T* __restrict__ stacks, long long q_row0,
    int r0, int maxc, long long e_row0, int b0, int g, int d, int t) {
  const int lane = t & 31;
  const int warp = t >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kDC) {
    __syncthreads();  // previous chunk consumed
#pragma unroll
    for (int p = 0; p < (kRows * kDC) / kThreads; ++p) {
      const int el = t + p * kThreads;
      const int row = el / kDC, col = el % kDC;
      const int r = r0 + row;
      float v = 0.f;
      if (r < maxc && d0 + col < d)
        v = as_f32(qv[(q_row0 + r) * d + d0 + col]);
      q_s[row][col] = v;
    }
#pragma unroll
    for (int p = 0; p < (kTileB * kDC) / kThreads; ++p) {
      const int el = t + p * kThreads;
      const int row = el / kDC, col = el % kDC;
      const int b = b0 + row;
      float v = 0.f;
      if (b < g && d0 + col < d)
        v = as_f32(stacks[(e_row0 + b) * d + d0 + col]);
      s_s[row][col] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kDC; ++j) {
      float a[4], s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[warp * 4 + i][j];
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] = s_s[lane + 32 * u][j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][u] = fmaf(a[i], s[u], acc[i][u]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
join_fma_kernel(const float* __restrict__ qv, const float* __restrict__ stacks,
                const float* __restrict__ bias, float* __restrict__ vals,
                int* __restrict__ idx, int maxc, int d, int mm, int k,
                int group, float scale) {
  __shared__ float q_s[kRows][kDC + 1];
  __shared__ float s_s[kTileB][kDC + 1];

  const int c = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = mm / group;
  const long long q_row0 = static_cast<long long>(c) * maxc;
  const long long s_row0 = static_cast<long long>(c) * mm;

  // running sorted k-list of each of the warp's 4 rows
  float lv[4][2];
  int lb[4][2], le[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lv[i][h] = INFINITY;
      lb[i][h] = INT_MAX;
      le[i][h] = 0;
    }
  const int kth_lane = (k - 1) & 31, kth_half = (k - 1) >> 5;

  for (int b0 = 0; b0 < g; b0 += kTileB) {
    float bmin[4][4];
    int be[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bmin[i][j] = INFINITY;
        be[i][j] = 0;
      }

    for (int e = 0; e < group; ++e) {
      float acc[4][4];
      tile_products(acc, q_s, s_s, qv, stacks, q_row0, r0, maxc,
                    s_row0 + static_cast<long long>(e) * g, b0, g, d, t);

      // fold slot e * g + b into bucket b: strict <, so the lowest e wins
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int b = b0 + lane + 32 * u;
        if (b < g) {
          const float bs = bias[s_row0 + static_cast<long long>(e) * g + b];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float dist = bs - scale * acc[i][u];
            if (dist < bmin[i][u]) {
              bmin[i][u] = dist;
              be[i][u] = e;
            }
          }
        }
      }
    }

    // merge the tile's bucket minima into each row's running k-list
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float cv[4];
      int cb[4], ce[4];
      bool any = false;
      const float kth = __shfl_sync(kFull, kth_half ? lv[i][1] : lv[i][0],
                                    kth_lane);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int b = b0 + lane + 32 * u;
        const bool ok = b < g;
        cv[u] = ok ? bmin[i][u] : INFINITY;
        cb[u] = ok ? b : INT_MAX;
        ce[u] = be[i][u];
        any |= cv[u] < kth;
      }
      if (!__any_sync(kFull, any)) continue;
      float m0v = lv[i][0], m1v = lv[i][1];
      int m0b = lb[i][0], m1b = lb[i][1], m0e = le[i][0], m1e = le[i][1];
      float nv0 = INFINITY, nv1 = INFINITY;
      int nb0 = INT_MAX, nb1 = INT_MAX, ne0 = 0, ne1 = 0;
      for (int j = 0; j < k; ++j) {
        float bv = m0v;
        int bb = m0b, bE = m0e;
        if (before(m1v, m1b, bv, bb)) {
          bv = m1v; bb = m1b; bE = m1e;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (before(cv[u], cb[u], bv, bb)) {
            bv = cv[u]; bb = cb[u]; bE = ce[u];
          }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(kFull, bv, off);
          const int ob = __shfl_xor_sync(kFull, bb, off);
          const int oE = __shfl_xor_sync(kFull, bE, off);
          if (before(ov, ob, bv, bb)) {
            bv = ov; bb = ob; bE = oE;
          }
        }
        if (lane == (j & 31)) {
          if (j < 32) {
            nv0 = bv; nb0 = bb; ne0 = bE;
          } else {
            nv1 = bv; nb1 = bb; ne1 = bE;
          }
        }
        if (bb == INT_MAX) break;  // nothing finite left (warp-uniform)
        // buckets are unique, so the winner leaves exactly one place
        if (m0b == bb) { m0v = INFINITY; m0b = INT_MAX; }
        if (m1b == bb) { m1v = INFINITY; m1b = INT_MAX; }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (cb[u] == bb) { cv[u] = INFINITY; cb[u] = INT_MAX; }
      }
      lv[i][0] = nv0; lb[i][0] = nb0; le[i][0] = ne0;
      lv[i][1] = nv1; lb[i][1] = nb1; le[i][1] = ne1;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + warp * 4 + i;
    if (r >= maxc) continue;
    const long long o = (q_row0 + r) * k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      if (j < k) {
        vals[o + j] = lv[i][h];
        idx[o + j] = lb[i][h] == INT_MAX ? 0 : le[i][h] * g + lb[i][h];
      }
    }
  }
}

// ---- bf16 x bf16: mma.sync tensor cores -------------------------------------

constexpr int kMT = 256;          // 8 product warps: 4 rows x 2 buckets
constexpr int kHeapT = 128;       // 4 heap warps: one thread a row
constexpr int kMRows = 128;       // member rows per block
constexpr int kMTB = 64;          // buckets per tile
constexpr int kStages = 3;
constexpr int kBiasVals = kMTB * 2;     // the tile's f32 bias, in bf16 units

// Shapes of a d chunk of kDC values: 128 when d <= 128 (one chunk, the
// query tile resident), else 64 (the query chunk streams with the stack).
template <int kDC>
struct Chunk {
  static constexpr int kLd = kDC + 8;          // padded smem row (bf16)
  static constexpr int kSegs = kDC / 8;        // 16-byte copies a row
  static constexpr int kQ = kMRows * kLd;      // bf16 in a query chunk
  static constexpr int kS = kMTB * kLd;        // bf16 in a stack chunk
  static constexpr bool kResident = kDC == 128;
  static constexpr int kStage = kS + (kResident ? 0 : kQ) + kBiasVals;
};

// acc (+)= the product of one d chunk: the warp's 32 rows x 32 buckets as
// 2 x 4 m16n8k16 tiles, kDC / 16 k-steps
template <int kDC>
__device__ __forceinline__ void mma_chunk(float (&acc)[2][4][4],
                                          uint32_t a_base, uint32_t b_base,
                                          bool first) {
  constexpr int kLd = Chunk<kDC>::kLd;
#pragma unroll
  for (int kk = 0; kk < kDC / 16; ++kk) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], a_base + (mi * 16 * kLd + kk * 16) * 2);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      ldmatrix_x4(b[nj], b_base + (nj * 16 * kLd + kk * 16) * 2);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint32_t b0 = b[ni >> 1][(ni & 1) * 2];
        const uint32_t b1 = b[ni >> 1][(ni & 1) * 2 + 1];
        if (kk == 0 && first) mma_bf16_first(acc[mi][ni], a[mi], b0, b1);
        else mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
  }
}

// acc = the product over the whole of d <= 128, with the A fragments (the
// resident query) in registers
__device__ __forceinline__ void mma_chunk_areg(float (&acc)[2][4][4],
                                               const uint32_t (&af)[8][2][4],
                                               uint32_t b_base) {
  constexpr int kLd = Chunk<128>::kLd;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t b[2][4];
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      ldmatrix_x4(b[nj], b_base + (nj * 16 * kLd + kk * 16) * 2);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint32_t b0 = b[ni >> 1][(ni & 1) * 2];
        const uint32_t b1 = b[ni >> 1][(ni & 1) * 2 + 1];
        if (kk == 0) mma_bf16_first(acc[mi][ni], af[kk][mi], b0, b1);
        else mma_bf16(acc[mi][ni], af[kk][mi], b0, b1);
      }
  }
}

// Fold slot e * g + b into bucket b: strict <, so the lowest e wins. One
// fma: the same value as the plain version's bias - scale * dot whenever
// scale is a power of two (l2: 2, ip: 1), where the product is exact.
// Accumulator entry j of tile (mi, ni) is row mi * 16 + (j / 2) * 8 +
// lane / 4 and bucket ni * 8 + (lane % 4) * 2 + j % 2 of the warp's tile.
// Entry q = (mi * 4 + ni) * 4 + j keeps the e of its minimum in byte j of
// be[mi * 4 + ni]; erep is e in all four bytes.
__device__ __forceinline__ void fold(const float (&acc)[2][4][4],
                                     float (&bmin)[2][4][4],
                                     uint32_t (&be)[8],
                                     const float (&bs)[4][2], uint32_t erep,
                                     float scale) {
  constexpr uint32_t kSetByte[4] = {0x3214u, 0x3240u, 0x3410u, 0x4210u};
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dist = fmaf(-scale, acc[mi][ni][j], bs[ni][j & 1]);
        if (dist < bmin[mi][ni][j]) {
          bmin[mi][ni][j] = dist;
          be[mi * 4 + ni] = __byte_perm(be[mi * 4 + ni], erep, kSetByte[j]);
        }
      }
}

// A finished bucket tile (starting at b0): append the minima that beat
// their row's k-th (the heap root, +inf until the heap is full) to the
// row's candidates, one shared atomic per thread and row; reset them.
__device__ __forceinline__ void stage_tile(
    float (&bmin)[2][4][4], uint32_t (&be)[8], const Key* heap,
    const int* heap_n, Key* cand, int* cand_n, int k,
    int q_valid, int b0, int wm, int wn, int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = wm * 32 + mi * 16 + hr * 8 + (lane >> 2);
      // the bar: the k-th (the root), or any finite value while the heap
      // is not full; rows past maxc take nothing
      const float kth = row >= q_valid ? -INFINITY
                        : heap_n[row] < k ? INFINITY
                                          : key_value(heap[row]);
      unsigned take = 0;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          take |= static_cast<unsigned>(bmin[mi][ni][hr * 2 + h] < kth)
                  << (ni * 2 + h);
      int slot = take ? atomicAdd(&cand_n[row], __popc(take)) : 0;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = hr * 2 + h;
          if (take >> (ni * 2 + h) & 1) {
            const int b = b0 + wn * 32 + ni * 8 + (lane & 3) * 2 + h;
            const int e = (be[mi * 4 + ni] >> (8 * j)) & 0xff;
            cand[slot * kMRows + row] = make_key(bmin[mi][ni][j], b * 8 + e);
            ++slot;
          }
          bmin[mi][ni][j] = INFINITY;
        }
    }
#pragma unroll
  for (int w = 0; w < 8; ++w) be[w] = 0;
}

// the product warps' own barrier (named barrier 1), apart from the heap
// warps; and the hand-over barrier of both roles (named barrier 2)
__device__ __forceinline__ void mma_warps_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kMT) : "memory");
}
__device__ __forceinline__ void hand_over_sync() {
  asm volatile("bar.sync 2, %0;\n" :: "n"(kMT + kHeapT) : "memory");
}

template <int kDC>
size_t mma_smem_bytes(int k) {
  using Ch = Chunk<kDC>;
  return (Ch::kResident ? Ch::kQ * 2 : 0) + kStages * Ch::kStage * 2
         + static_cast<size_t>(kMRows) * k * 8   // the heaps
         + kMRows * kMTB * 8                     // candidates
         + kMRows * 8;                           // candidate, heap counts
}

template <int kDC>
__global__ void __launch_bounds__(kMT + kHeapT, 1)
join_mma_kernel(const __nv_bfloat16* __restrict__ qv,
                const __nv_bfloat16* __restrict__ stacks,
                const float* __restrict__ bias, float* __restrict__ vals,
                int* __restrict__ idx, int maxc, int d, int mm, int k,
                int group, float scale) {
  using Ch = Chunk<kDC>;
  constexpr int kLd = Ch::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  // a ring stage: the stack chunk, the query chunk when it streams, and
  // the bias of the stage's (tile, e)
  __nv_bfloat16* q_res = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = q_res + (Ch::kResident ? Ch::kQ : 0);
  Key* heap = reinterpret_cast<Key*>(ring + kStages * Ch::kStage);
  Key* cand = heap + kMRows * k;
  int* cand_n = reinterpret_cast<int*>(cand + kMRows * kMTB);
  int* heap_n = cand_n + kMRows;   // entries in each row's heap

  const int c = blockIdx.y;
  const int r0 = blockIdx.x * kMRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = mm / group;
  const int n_tiles = (g + kMTB - 1) / kMTB;
  const long long q_row0 = static_cast<long long>(c) * maxc + r0;
  const long long s_row0 = static_cast<long long>(c) * mm;
  const int q_valid = maxc - r0;

  // each row's heap (see heap_push) starts empty
  for (int i = tid; i < kMRows * k; i += kMT + kHeapT) heap[i] = kNoKey;
  for (int i = tid; i < kMRows; i += kMT + kHeapT) cand_n[i] = heap_n[i] = 0;
  __syncthreads();

  // Two roles, which meet at two block barriers a bucket tile: (A) the
  // heaps hold every earlier tile, (B) the product warps have staged the
  // tile's candidates. The heap warps then push them while the product
  // warps go on with the next tile.
  if (warp >= kMT / 32) {
    // the heap warpgroup gives registers to the two product warpgroups:
    // 128 x 80 + 256 x 208 <= 384 x 168, the launch's allocation
    asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n" ::: "memory");
    // heap warps: one thread a row; each push costs O(log k), and only
    // candidates ahead of the root get in. A candidate tying the root
    // loses, as buckets arrive in increasing b (within a tile, (value, p)
    // order decides).
    const int row = tid - kMT;
    Key* h = heap + row;
    int size = 0;
    for (int t = 0; t < n_tiles; ++t) {
      hand_over_sync();   // A
      hand_over_sync();   // B
      const int n = cand_n[row];
      for (int q = 0; q < n; ++q) {
        const Key x = cand[q * kMRows + row];
        if (size < k) heap_push<kMRows>(h, size++, x);
        else if (x < h[0]) heap_sift<kMRows>(h, size, k, x);
      }
      cand_n[row] = 0;
      heap_n[row] = size;
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n" ::: "memory");
    const int wm = warp >> 1;     // rows wm * 32 .. + 31
    const int wn = warp & 1;      // buckets wn * 32 .. + 31 of the tile
    const int n_dc = Ch::kResident ? 1 : (d + kDC - 1) / kDC;
    const int steps = n_tiles * group * n_dc;

    // this thread's 16-byte copies of a chunk: rows c_row + p * kRowStep,
    // columns c_col .. + 7
    constexpr int kRowStep = kMT / Ch::kSegs;
    constexpr int kSCopies = kMTB / kRowStep;
    constexpr int kQCopies = kMRows / kRowStep;
    const int c_row = tid / Ch::kSegs, c_col = (tid % Ch::kSegs) * 8;
    auto load_query = [&](__nv_bfloat16* dst, int d0) {
#pragma unroll
      for (int p = 0; p < kQCopies; ++p) {
        const int row = c_row + p * kRowStep;
        const bool ok = row < q_valid && d0 + c_col < d;
        cp_async16(smem_addr(dst + row * kLd + c_col),
                   ok ? qv + (q_row0 + row) * d + d0 + c_col : qv,
                   ok ? 16 : 0);
      }
    };

    // the next step to load: chunk l_dc of slot range e * g + l_b0 ..
    int l_dc = 0, l_e = 0, l_b0 = 0, l_stage = 0;
    auto issue = [&]() {
      if (l_b0 < g) {
        __nv_bfloat16* st = ring + l_stage * Ch::kStage;
        const long long e_row0 = s_row0 + static_cast<long long>(l_e) * g
                                 + l_b0;
        const __nv_bfloat16* src = stacks + (e_row0 + c_row) * d
                                   + l_dc * kDC + c_col;
        const int valid = g - l_b0;
        const bool col_ok = l_dc * kDC + c_col < d;
#pragma unroll
        for (int p = 0; p < kSCopies; ++p) {
          const bool ok = col_ok && c_row + p * kRowStep < valid;
          cp_async16(smem_addr(st + (c_row + p * kRowStep) * kLd + c_col),
                     ok ? src + p * kRowStep * d : stacks, ok ? 16 : 0);
        }
        if (!Ch::kResident) load_query(st + Ch::kS, l_dc * kDC);
        if (l_dc == n_dc - 1 && tid < kMTB) {   // the fold's bias, 0 past g
          const bool ok = tid < valid;
          cp_async4(smem_addr(st + Ch::kS + (Ch::kResident ? 0 : Ch::kQ))
                        + tid * 4,
                    ok ? bias + e_row0 + tid : bias, ok ? 4 : 0);
        }
        if (++l_dc == n_dc) {
          l_dc = 0;
          if (++l_e == group) {
            l_e = 0;
            l_b0 += kMTB;
          }
        }
        l_stage = l_stage == kStages - 1 ? 0 : l_stage + 1;
      }
      cp_async_commit();
    };

    if (Ch::kResident) load_query(q_res, 0);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) issue();

    float acc0[2][4][4], acc1[2][4][4];   // one set fills, one folds
    uint32_t af[Ch::kResident ? 8 : 1][2][4];   // the resident query
    float bmin[2][4][4];
    uint32_t be[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    float fb[4][2];   // the bias of the e-group waiting for its fold
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) bmin[mi][ni][j] = INFINITY;

    // ldmatrix lane offsets: A rows lane % 16, columns (lane / 16) * 8;
    // B rows (lane / 16) * 8 + lane % 8, columns ((lane / 8) % 2) * 8
    const int a_off = (wm * 32 + (lane & 15)) * kLd + (lane >> 4) * 8;
    const int b_off = (wn * 32 + ((lane >> 4) << 3) + (lane & 7)) * kLd
                      + ((lane >> 3) & 1) * 8;
    auto hand_over = [&](int tb0) {
      hand_over_sync();   // A
      stage_tile(bmin, be, heap, heap_n, cand, cand_n, k,
                 q_valid, tb0, wm, wn, lane);
      hand_over_sync();   // B
    };

    // An e-group's fold waits one step, so that it runs while the next
    // group's products are in the tensor cores.
    int dc = 0, e = 0, b0 = 0, par = 0, stage = 0, fe = 0;
    bool fold_due = false;
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kStages - 2>();
      mma_warps_sync();
      issue();

      const __nv_bfloat16* st = ring + stage * Ch::kStage;
      const uint32_t a_base = smem_addr(
          (Ch::kResident ? q_res : st + Ch::kS) + a_off);
      const uint32_t b_base = smem_addr(st + b_off);
      if constexpr (Ch::kResident) {
        if (s == 0) {   // the query tile landed with the first stage
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              ldmatrix_x4(af[kk][mi],
                          a_base + (mi * 16 * kLd + kk * 16) * 2);
        }
        if (par) mma_chunk_areg(acc1, af, b_base);
        else mma_chunk_areg(acc0, af, b_base);
      } else {
        if (par) mma_chunk<kDC>(acc1, a_base, b_base, dc == 0);
        else mma_chunk<kDC>(acc0, a_base, b_base, dc == 0);
      }

      if (fold_due) {   // the previous e-group
        if (par) fold(acc0, bmin, be, fb, fe * 0x01010101u, scale);
        else fold(acc1, bmin, be, fb, fe * 0x01010101u, scale);
        fold_due = false;
        if (fe == group - 1) hand_over(b0 - kMTB);   // a new tile began
      }
      if (dc == n_dc - 1) {   // this e-group's products are all issued
        const float* bias_s = reinterpret_cast<const float*>(
            st + Ch::kS + (Ch::kResident ? 0 : Ch::kQ));
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int bt = wn * 32 + ni * 8 + (lane & 3) * 2 + h;
            fb[ni][h] = b0 + bt < g ? bias_s[bt] : INFINITY;
          }
        fe = e;
        fold_due = true;
        par ^= 1;
      }
      if (++dc == n_dc) {
        dc = 0;
        if (++e == group) {
          e = 0;
          b0 += kMTB;
        }
      }
      stage = stage == kStages - 1 ? 0 : stage + 1;
    }
    cp_async_wait<0>();
    if (par) fold(acc0, bmin, be, fb, fe * 0x01010101u, scale);
    else fold(acc1, bmin, be, fb, fe * 0x01010101u, scale);
    hand_over(b0 - kMTB);
  }
  __syncthreads();   // the last tile is in the heaps

  // heap sort each row into ascending (value, b) order; entries past the
  // finite buckets stay (+inf, empty)
  if (tid >= kMT) {
    const int row = tid - kMT;
    Key* h = heap + row;
    for (int size = heap_n[row]; size > 1; --size) {
      const Key top = h[0];
      heap_sift<kMRows>(h, size - 1, k, h[(size - 1) * kMRows]);
      h[(size - 1) * kMRows] = top;
    }
  }
  __syncthreads();

  for (int i = tid; i < kMRows * k; i += kMT + kHeapT) {
    const int row = i / k, j = i - row * k;
    if (row >= q_valid) continue;
    const Key key = heap[j * kMRows + row];
    const int p = static_cast<int>(key & 0xffffffffu);
    const long long o = (q_row0 + row) * k + j;
    vals[o] = key == kNoKey ? INFINITY : key_value(key);
    idx[o] = key == kNoKey ? 0 : (p & 7) * g + (p >> 3);
  }
}

template <int kDC>
int launch_mma(const void* qv, const void* stacks, const void* bias,
               void* vals, void* idx, int n_clusters, int maxc, int d, int mm,
               int k, int group, float scale, cudaStream_t st) {
  const size_t smem = mma_smem_bytes<kDC>(k);
  cudaError_t err = cudaFuncSetAttribute(
      join_mma_kernel<kDC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((maxc + kMRows - 1) / kMRows, n_clusters);
  join_mma_kernel<kDC><<<grid, kMT + kHeapT, smem, st>>>(
      static_cast<const __nv_bfloat16*>(qv),
      static_cast<const __nv_bfloat16*>(stacks),
      static_cast<const float*>(bias), static_cast<float*>(vals),
      static_cast<int*>(idx), maxc, d, mm, k, group, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- any k: the general kernel ---------------------------------------------
//
// The two kernels above hold each row's k best in two entries a lane or in
// heaps sized for k <= 64. For k > 64 (a kNN graph of k > 62, which an NSG
// with L > 52 asks for) this kernel takes any 1 <= k <= g, f32 or bf16.
// Its products and fold are join_fma_kernel's (tile_products: a block
// takes one cluster and 32 member rows, walks 128-bucket tiles through
// shared memory in 32-wide d chunks, each thread a 4 x 4 register tile of
// exact products summed in f32 on CUDA cores, folded into per-bucket
// minima with the lowest e winning a tie), each distance rounded as the
// plain version rounds bias - scale * dot. The top-k is select_topk.cuh's
// running one over (value, b * 8 + e) keys, which order as (value, b): a
// warp keeps its 4 rows' candidates below their bar in buffers of 2k + 32
// keys, shared memory up to k = 396 and global scratch above, and sorts
// each row's k smallest at the end. A bucket whose every slot is +inf
// comes out as (+inf, b), as it does from the plain version. Simple and
// not tuned.

// the kernel's own shared memory: the member-row and bucket tiles
constexpr size_t kGeneralSmem = (kRows + kTileB) * (kDC + 1) * 4;

// two blocks an SM (at most 128 registers a thread): with one, 8 warps
// could not hide the shared-memory and load latency of the products
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
join_general_kernel(const T* __restrict__ qv, const T* __restrict__ stacks,
                    const float* __restrict__ bias, float* __restrict__ vals,
                    int* __restrict__ idx, Key* scratch, int maxc, int d,
                    int mm, int k, int group, float scale) {
  extern __shared__ __align__(16) unsigned char smem_g[];
  const int n_tiles = (maxc + kRows - 1) / kRows;
  const int c = blockIdx.x / n_tiles;
  const int r0 = (blockIdx.x - c * n_tiles) * kRows;
  Key* bufs = topk_block_bufs(smem_g, scratch, kRows, k);
  unsigned char* rest = smem_g + topk_own_offset(scratch, kRows, k);
  float (*q_s)[kDC + 1] = reinterpret_cast<float (*)[kDC + 1]>(rest);
  float (*s_s)[kDC + 1] =
      reinterpret_cast<float (*)[kDC + 1]>(rest + kRows * (kDC + 1) * 4);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = mm / group;
  const long long q_row0 = static_cast<long long>(c) * maxc;
  const long long s_row0 = static_cast<long long>(c) * mm;

  Key* buf[4];
  int size[4];
  Key bar[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    buf[i] = bufs + static_cast<long long>(warp * 4 + i) * topk_buf(k);
    size[i] = 0;
    bar[i] = kNoKey;
  }

  for (int b0 = 0; b0 < g; b0 += kTileB) {
    float bmin[4][4];
    int be[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        bmin[i][u] = INFINITY;
        be[i][u] = 0;
      }
    for (int e = 0; e < group; ++e) {
      float acc[4][4];
      const long long e_row0 = s_row0 + static_cast<long long>(e) * g;
      tile_products(acc, q_s, s_s, qv, stacks, q_row0, r0, maxc, e_row0, b0,
                    g, d, t);
      // fold slot e * g + b into bucket b: strict <, so the lowest e wins
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int b = b0 + lane + 32 * u;
        if (b < g) {
          const float bs = bias[e_row0 + b];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float dist = __fsub_rn(bs, __fmul_rn(scale, acc[i][u]));
            if (dist < bmin[i][u]) {
              bmin[i][u] = dist;
              be[i][u] = e;
            }
          }
        }
      }
    }
    // the tile's bucket minima, pushed in bucket order (u outer, lane inner)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int b = b0 + lane + 32 * u;
        warp_push(buf[i], size[i], bar[i], k,
                  make_key(bmin[i][u], b * 8 + be[i][u]), b < g, lane);
      }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + warp * 4 + i;
    if (r >= maxc) continue;   // warp-uniform
    const long long o = (q_row0 + r) * k;
    warp_emit_smallest(buf[i], size[i], k, lane, [&](int rank, Key key) {
      const int p = static_cast<int>(key & 0xffffffffu);
      vals[o + rank] = key_value(key);
      idx[o + rank] = (p & 7) * g + (p >> 3);
    });
  }
}

template <typename T>
int launch_general(const void* qv, const void* stacks, const void* bias,
                   void* vals, void* idx, void* scratch, int n_clusters,
                   int maxc, int d, int mm, int k, int group, float scale,
                   cudaStream_t st) {
  if (topk_needs_scratch(kRows, k, kGeneralSmem) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = topk_smem_bytes(kRows, k, kGeneralSmem);
  const cudaError_t err = cudaFuncSetAttribute(
      join_general_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(n_clusters) * ((maxc + kRows - 1) / kRows);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  join_general_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                           st>>>(
      static_cast<const T*>(qv), static_cast<const T*>(stacks),
      static_cast<const float*>(bias), static_cast<float*>(vals),
      static_cast<int*>(idx), static_cast<Key*>(scratch), maxc, d, mm, k,
      group, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers:
// qv [C, maxc, d] and stacks [C, mm, d] of one dtype (0 f32, 1 bf16),
// bias [C, mm] f32; outputs vals [C, maxc, k] f32 and idx [C, maxc, k]
// int32, allocated by the caller. bf16 needs d % 8 == 0 and 16-byte
// aligned qv and stacks (the wrapper pads d). Launches on `stream` without
// synchronising and returns the CUDA error of the launch (0 on success).
extern "C" int cluster_join(const void* qv, const void* stacks,
                            const void* bias, void* vals, void* idx,
                            int n_clusters, int maxc, int d, int mm, int k,
                            int group, float scale, int dtype, void* stream) {
  if (n_clusters < 1 || n_clusters > 65535 || maxc < 1 || d < 1 || mm < 1 ||
      k < 1 || k > kMaxK || group < 1 || group > 8 || mm % group != 0 ||
      k > mm / group)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    const dim3 grid((maxc + kRows - 1) / kRows, n_clusters);
    join_fma_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(qv), static_cast<const float*>(stacks),
        static_cast<const float*>(bias), static_cast<float*>(vals),
        static_cast<int*>(idx), maxc, d, mm, k, group, scale);
  } else if (dtype == kBF16) {
    if (d % 8 != 0 || (reinterpret_cast<uintptr_t>(qv) & 15) ||
        (reinterpret_cast<uintptr_t>(stacks) & 15) ||
        static_cast<long long>(mm / group) * 8 + 7 > INT_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    return d <= 128 ? launch_mma<128>(qv, stacks, bias, vals, idx, n_clusters,
                                      maxc, d, mm, k, group, scale, st)
                    : launch_mma<64>(qv, stacks, bias, vals, idx, n_clusters,
                                     maxc, d, mm, k, group, scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The general kernel's entry point (any 1 <= k <= mm / group): the
// arguments of cluster_join, and `scratch`, global memory for the rows'
// buffers of cluster_join_general_scratch(n_clusters, maxc, k) bytes when
// that is not 0, else null. No alignment or d condition.
extern "C" int cluster_join_general(const void* qv, const void* stacks,
                                    const void* bias, void* vals, void* idx,
                                    void* scratch, int n_clusters, int maxc,
                                    int d, int mm, int k, int group,
                                    float scale, int dtype, void* stream) {
  if (n_clusters < 1 || maxc < 1 || d < 1 || mm < 1 || k < 1 || group < 1 ||
      group > 8 || mm % group != 0 || k > mm / group ||
      static_cast<long long>(mm / group) * 8 + 7 > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_general<float>(qv, stacks, bias, vals, idx, scratch,
                                 n_clusters, maxc, d, mm, k, group, scale, st);
  if (dtype == kBF16)
    return launch_general<__nv_bfloat16>(qv, stacks, bias, vals, idx, scratch,
                                         n_clusters, maxc, d, mm, k, group,
                                         scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of global scratch cluster_join_general needs for this shape: 0
// when the rows' buffers fit shared memory.
extern "C" long long cluster_join_general_scratch(int n_clusters, int maxc,
                                                  int k) {
  return topk_scratch_bytes(
      static_cast<long long>(n_clusters) * ((maxc + kRows - 1) / kRows), kRows,
      k, kGeneralSmem);
}
