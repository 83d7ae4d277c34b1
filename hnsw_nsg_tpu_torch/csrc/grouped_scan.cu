// Grouped cluster scan with fused exact top-k, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of hnsw_nsg_tpu/ops/pallas_scan.py
// that compute one function:
//   * _scan_kernel_gq      (grouped_cluster_topk_gq,      pallas_scan.py:244)
//   * _scan_kernel_gq_dblk (grouped_cluster_topk_gq_dblk, pallas_scan.py:354)
//   * _scan_kernel         (grouped_cluster_topk,         pallas_scan.py:81)
// For each cluster c and each query slot j of c's list qidx[c, :]:
//   dist[m] = bias[c, m] - scale * <qc[qidx[c, j]], slabs[c, m]>
// and the k smallest (dist, slot m) ascending, equal values in slot order
// (jnp.argmin returns the first minimum). Slots with qidx < 0 score a zero
// query; the caller masks them. The TPU's one-hot MXU gather and its
// d-blocking for VMEM are not needed here: a block gathers its query rows
// by pointer, and the d loop below serves every d.
//
// Operand types, as pallas_scan.py:_dots:
//   f32 x f32 -> f32 sums;  bf16 x bf16 -> f32 sums of exact products;
//   int8 x int8 -> int32 sums (exact);  int8 slab x bf16 query -> f32 sums.
//
// What bounds it on the H100: every probed slab is read once per batch
// (C x maxc x d elements, ~0.6 GB at the sift1m bench shape in bf16, about
// 0.2 ms at 3.35 TB/s), while the products (2 x C x cap x maxc x d, ~19
// GFLOP there) are far under the tensor cores' rate. The bound is memory
// bandwidth: a design has to keep enough slab bytes in flight on every SM
// and do the products and the top-k in the shadow of the loads.
//
// Four kernels: two on tensor cores, two on CUDA cores, each pair one for
// k <= 32 and one for any k <= maxc. Which runs goes by the dtype pair, d
// and k alone (on_tensor_cores, the entry points at the end).
//
// A bf16 query with a bf16 or an int8 slab (the CNNS path, and SQ8: int8
// slabs of non-integral data) up to d = 1920, on mma.sync tensor cores (an
// int8 is a bf16, so SQ8's products are exact bf16 products). A block
// takes one cluster and up to 32 of its query rows, so at cap <= 32 a slab
// is read once. scan_products is the pipeline of both kernels:
//   * The query rows are gathered by pointer into shared memory (zero for
//     pad slots and past d) and, when d <= 128, kept as mma A fragments in
//     registers for the whole run.
//   * The slab streams through a cp.async ring of [64 rows x 128 d] tiles
//     (rows padded by 16 bytes so that a warp's shared loads hit distinct
//     banks; 16-byte copies when every row starts on 16 bytes, else plain
//     loads and stores; the tail of d is zero-filled). An int8 tile is
//     copied as it is, half the bytes of bf16, and upcast while the B
//     fragments are built from it.
//   * Four product warps take 16 slab rows each: mma.sync m16n8k16 bf16
//     -> f32 over the 32 query rows, f32 sums of exact products. For
//     d > 128 the accumulators run over the d chunks of a tile (d = 960:
//     8 chunks) with the query read from shared memory.
// k <= 32, scan_mma_kernel: top-k follows the survivors, not the tiles.
// The first tile has no bar yet, so the product warps sort its 64 keys a
// row themselves (a bitonic network in shared memory) and the k smallest
// become the row's 4-ary max-heap of (value, slot) keys. From then on,
// when a tile's distances are ready, only those below their row's current
// k-th, the heap's root (strict <: a tie with the k-th has a later slot
// and loses), are staged, and a fifth warp, one thread a query row, pushes
// them into the heap while the product warps go on with the next tile,
// which they stage into a second buffer: the two roles meet at one barrier
// a tile. The keys order by value, then slot, so neither the order in
// which a tile's survivors arrive nor a bar that is one tile old matters.
// A row sees ~k ln(maxc / 64) survivors after the first tile. At the end
// each heap is sorted into the output. When d <= 128 the ring has 2 stages
// and three blocks share an SM (~70 KB each in bf16), so their loads,
// products and staging overlap; above, 4 stages and one block.
// Any k, scan_general_mma_kernel: the same products, and in place of the
// heaps select_topk.cuh's running buffers, filled by 8 top-k warps (its
// notes are with the kernel).
//
// The other pairs (f32 x f32, which must stay exact FMAs; int8 x int8;
// and the bf16-query pairs past d = 1920), grouped_scan_kernel for
// k <= 32: one block of 256 threads takes one cluster and up to 32 of its
// query rows, streams the slab through shared memory in [128 x 32] tiles,
// and each thread forms a 4 x 4 register tile of dot products with
// CUDA-core FMAs. A warp owns 4 query rows and merges each 128-slot tile
// into the row's sorted k-list by k warp-wide (min, lowest-slot argmin)
// passes, skipping a tile when no value beats the current k-th. For any
// k, scan_general_kernel (at the end of this file, with its notes). int8
// x int8 on s8 tensor cores is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_helpers.cuh"
#include "select_topk.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRows = 32;       // query rows per block: 4 per warp
constexpr int kTileM = 128;     // slab rows per tile: 4 per lane
constexpr int kDC = 32;         // d elements per shared-memory chunk
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename AT, typename T>
__device__ __forceinline__ AT as_acc(T v);
template <>
__device__ __forceinline__ float as_acc<float, float>(float v) { return v; }
template <>
__device__ __forceinline__ float as_acc<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float as_acc<float, int8_t>(int8_t v) {
  return static_cast<float>(v);
}
template <>
__device__ __forceinline__ int as_acc<int, int8_t>(int8_t v) {
  return static_cast<int>(v);
}

// (value, slot) lexicographic order: the lower slot wins a tie.
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

// acc = the products of the warp's 4 query rows (warp * 4 + i of the
// block's 32; zero for pad rows) with this lane's 4 slab rows (m0 + lane +
// 32 e; zero past maxc) over all of d, the query rows and the [128 x 32]
// slab tile staged through shared memory 32 d values at a time. Starts
// with a barrier, so the caller's last reads of q_s / s_s and its writes
// of qrow_s are ordered before the staging.
template <typename QT, typename ST, typename AT>
__device__ __forceinline__ void tile_products(
    AT (&acc)[4][4], AT (*q_s)[kDC + 1], AT (*s_s)[kDC + 1],
    const int* qrow_s, const QT* __restrict__ qc,
    const ST* __restrict__ slabs, long long slab_row0, int m0, int d,
    int maxc, int t) {
  const int lane = t & 31;
  const int warp = t >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = AT(0);

  for (int d0 = 0; d0 < d; d0 += kDC) {
    __syncthreads();  // previous chunk consumed (and qrow_s written)
    // gathered query rows, zero for pad slots and past d
#pragma unroll
    for (int p = 0; p < (kRows * kDC) / kThreads; ++p) {
      const int el = t + p * kThreads;
      const int row = el / kDC, col = el % kDC;
      const int qi = qrow_s[row];
      AT v = AT(0);
      if (qi >= 0 && d0 + col < d)
        v = as_acc<AT>(qc[static_cast<long long>(qi) * d + d0 + col]);
      q_s[row][col] = v;
    }
    // slab tile rows m0.., zero past maxc and past d
#pragma unroll
    for (int p = 0; p < (kTileM * kDC) / kThreads; ++p) {
      const int el = t + p * kThreads;
      const int row = el / kDC, col = el % kDC;
      const int m = m0 + row;
      AT v = AT(0);
      if (m < maxc && d0 + col < d)
        v = as_acc<AT>(slabs[(slab_row0 + m) * d + d0 + col]);
      s_s[row][col] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kDC; ++j) {
      AT qv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[warp * 4 + i][j];  // broadcast
#pragma unroll
      for (int e = 0; e < 4; ++e) sv[e] = s_s[lane + 32 * e][j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += qv[i] * sv[e];
    }
  }
}

template <typename QT, typename ST, typename AT>
__global__ void __launch_bounds__(kThreads)
grouped_scan_kernel(const QT* __restrict__ qc, const int* __restrict__ qidx,
                    const ST* __restrict__ slabs,
                    const float* __restrict__ bias, float* __restrict__ vals,
                    int* __restrict__ idx, int cap, int qn, int d, int maxc,
                    int k, float scale) {
  __shared__ AT q_s[kRows][kDC + 1];
  __shared__ AT s_s[kTileM][kDC + 1];
  __shared__ int qrow_s[kRows];

  const int c = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long slab_row0 = static_cast<long long>(c) * maxc;

  if (t < kRows) {
    const int r = r0 + t;
    int qi = -1;
    if (r < cap) qi = qidx[static_cast<long long>(c) * cap + r];
    qrow_s[t] = (qi >= 0 && qi < qn) ? qi : -1;
  }

  // running sorted k-list of each of the warp's 4 rows: lane j holds entry j
  float lv[4];
  int li[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lv[i] = INFINITY;
    li[i] = INT_MAX;
  }

  for (int m0 = 0; m0 < maxc; m0 += kTileM) {
    AT acc[4][4];
    tile_products(acc, q_s, s_s, qrow_s, qc, slabs, slab_row0, m0, d, maxc,
                  t);

    // distances of this lane's 4 slots; past maxc they never win
    float bv4[4];
    int slot4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + lane + 32 * e;
      slot4[e] = m < maxc ? m : INT_MAX;
      bv4[e] = m < maxc ? bias[slab_row0 + m] : INFINITY;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float cv[4];
      int ci[4];
      bool any = false;
      const float kth = __shfl_sync(kFull, lv[i], k - 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        cv[e] = slot4[e] == INT_MAX
                    ? INFINITY
                    : bv4[e] - scale * static_cast<float>(acc[i][e]);
        ci[e] = slot4[e];
        any |= cv[e] < kth;  // a tie with the k-th loses: it has a later slot
      }
      if (!__any_sync(kFull, any)) continue;
      // k passes over (running list entry of this lane) + (4 tile slots)
      float mv = lv[i];
      int mi = li[i];
      float nv = INFINITY;
      int ni = INT_MAX;
      for (int j = 0; j < k; ++j) {
        float bv = mv;
        int bi = mi;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (before(cv[e], ci[e], bv, bi)) {
            bv = cv[e];
            bi = ci[e];
          }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(kFull, bv, off);
          const int oi = __shfl_xor_sync(kFull, bi, off);
          if (before(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (lane == j) {
          nv = bv;
          ni = bi;
        }
        // slots are unique, so the winner is removed from exactly one place
        if (mi == bi) {
          mv = INFINITY;
          mi = INT_MAX;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ci[e] == bi) {
            cv[e] = INFINITY;
            ci[e] = INT_MAX;
          }
      }
      lv[i] = nv;
      li[i] = ni;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + warp * 4 + i;
    if (r < cap && lane < k) {
      const long long o = (static_cast<long long>(c) * cap + r) * k + lane;
      vals[o] = lv[i];
      idx[o] = li[i] == INT_MAX ? 0 : li[i];  // only when maxc < k
    }
  }
}

template <typename QT, typename ST, typename AT>
void launch(const void* qc, const void* qidx, const void* slabs,
            const void* bias, void* vals, void* idx, int n_clusters, int cap,
            int qn, int d, int maxc, int k, float scale, cudaStream_t st) {
  const dim3 grid(n_clusters, (cap + kRows - 1) / kRows);
  grouped_scan_kernel<QT, ST, AT><<<grid, kThreads, 0, st>>>(
      static_cast<const QT*>(qc), static_cast<const int*>(qidx),
      static_cast<const ST*>(slabs), static_cast<const float*>(bias),
      static_cast<float*>(vals), static_cast<int*>(idx), cap, qn, d, maxc, k,
      scale);
}


// ---- bf16 query x bf16 or int8 slab: mma.sync tensor cores ------------------

constexpr int kPT = 128;         // 4 product warps: 16 slab rows of a tile each
constexpr int kHT = 32;          // 1 heap warp: one thread a query row
constexpr int kTN = 64;          // slab rows per ring stage
constexpr int kTD = 128;         // d elements per ring stage
constexpr int kMaxChunks = 15;   // d <= 1920: the query tile must fit

// A ring stage: the [kTN x kTD] slab tile, rows padded so that a warp's
// shared loads hit distinct banks (bf16: ldmatrix's 8 rows of 16 bytes;
// int8: a quarter warp's 16-byte loads from two rows), then the tile's f32
// bias.
template <typename ST>
__host__ __device__ constexpr int stage_row_bytes() {
  return sizeof(ST) == 2 ? (kTD + 8) * 2 : kTD + 16;
}
template <typename ST>
__host__ __device__ constexpr int stage_bytes() {
  return kTN * stage_row_bytes<ST>() + kTN * 4;
}

// Ring stages and blocks an SM of the k <= 32 kernel. d <= 128: 2 stages
// and a small query tile leave room for 3 blocks, whose phases (wait,
// products, staging) overlap one another; that measured faster than 2
// blocks of 4 stages. Above, the query tile fills the SM's shared memory
// and the ring is all the overlap there is. The general kernel is alone on
// its SM (its rows' buffers fill it) and takes 3 stages where d <= 128.
__host__ __device__ constexpr int ring_stages(bool a_reg) { return a_reg ? 2 : 4; }
__host__ __device__ constexpr int blocks_per_sm(bool a_reg) { return a_reg ? 3 : 1; }
__host__ __device__ constexpr int general_ring_stages(bool a_reg) {
  return a_reg ? 3 : 2;
}

// Copy 16 bytes of a row (8 bf16 or 16 int8) into shared memory; elements
// at n_valid and past it (n_valid may be <= 0 or past the piece) become
// zero. kAsync: 16-byte cp.async, which every row start must allow; else
// plain element loads and stores.
template <bool kAsync, typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, int n_valid,
                                       const T* safe) {
  constexpr int kN = 16 / sizeof(T);
  if constexpr (kAsync) {
    const int nv = min(max(n_valid, 0), kN);
    cp_async16(smem_addr(dst), nv > 0 ? src : safe,
               nv * static_cast<int>(sizeof(T)));
  } else {
    using Bits = std::conditional_t<sizeof(T) == 2, uint16_t, uint8_t>;
    const Bits* s = reinterpret_cast<const Bits*>(src);
    Bits* o = reinterpret_cast<Bits*>(dst);
#pragma unroll
    for (int u = 0; u < kN; ++u) o[u] = u < n_valid ? s[u] : Bits(0);
  }
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

// The product warps' pipeline, shared by the two tensor-core kernels.
//   * The block's 32 query rows (qrow_s: the gathered row, -1 for a pad)
//     are copied into q_s, [rows][n_dc * kTD + 8] bf16, zero for pad
//     rows and past d. When d <= 128 (kAReg) they are kept as mma A
//     fragments in registers for the whole run.
//   * The slab (rows slab_row0 .. + maxc) streams through a cp.async ring
//     of kRing stages of [64 rows x 128 d], the tail of d zero-filled.
//   * Each of the 4 warps takes 16 slab rows of a tile: mma.sync m16n8k16
//     bf16 -> f32 against all the query rows, f32 sums of exact products,
//     the accumulators run over the d chunks of a tile (d = 960: 8).
//     A bf16 slab's B fragments come by ldmatrix. An int8 slab's tile is
//     copied as it is (half the bytes) and each thread reads its B
//     fragments as words and upcasts them (i8x4_to_bf16x2), which needs
//     no second pass over the stage: the thread's 32 bytes of a row's d
//     chunk hold its 4 values of each of the chunk's 8 k-steps, and the
//     query's A fragments are read in the same order, so the k order
//     within a chunk is permuted alike on both sides.
//   * At the end of tile t, epi(t, dist) takes its distances:
//     dist[mi][hr][ni][h] is query row mi * 16 + hr * 8 + lane / 4 against
//     tile slot wn * 16 + ni * 8 + (lane % 4) * 2 + h, rounded as the plain
//     version rounds bias - scale * dot; +inf past maxc.
template <typename ST, bool kAsync, bool kAReg, int kRing, typename Epi>
__device__ __forceinline__ void scan_products(
    __nv_bfloat16* q_s, unsigned char* ring, const int* qrow_s,
    const __nv_bfloat16* __restrict__ qc, const ST* __restrict__ slabs,
    const float* __restrict__ bias, long long slab_row0, int d, int maxc,
    float scale, int tid, Epi&& epi) {
  constexpr bool kI8 = sizeof(ST) == 1;
  constexpr int kRB = stage_row_bytes<ST>();
  constexpr int kSB = stage_bytes<ST>();
  constexpr int kEl = 16 / sizeof(ST);        // elements a 16-byte piece
  constexpr int kPieces = kTD / kEl;          // pieces a row of a d chunk
  constexpr int kRowsPass = kPT / kPieces;    // rows a pass of the threads
  const int lane = tid & 31;
  const int wn = tid >> 5;   // slab rows wn * 16 .. + 15 of the tile
  const int n_dc = (d + kTD - 1) / kTD;
  const int ldq = n_dc * kTD + 8;
  const int n_tiles = (maxc + kTN - 1) / kTN;
  const int steps = n_tiles * n_dc;

  // the query tile: row r, 8 elements from column 8 * piece
  const int q_pieces = n_dc * (kTD / 8);
  for (int i = tid; i < kRows * q_pieces; i += kPT) {
    const int row = i / q_pieces, col = (i - row * q_pieces) * 8;
    const int qi = qrow_s[row];
    copy16<kAsync>(q_s + row * ldq + col,
                   qc + static_cast<long long>(qi < 0 ? 0 : qi) * d + col,
                   qi < 0 ? 0 : d - col, qc);
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
                       ok ? d - col : 0, slabs);
      }
      if (l_dc == n_dc - 1 && tid < kTN) {   // the tile's bias, 0 past maxc
        const bool ok = m0 + tid < maxc;
        cp_async4(smem_addr(st + kTN * kRB) + tid * 4,
                  ok ? bias + slab_row0 + m0 + tid : bias, ok ? 4 : 0);
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

  float acc[2][2][4];
  uint32_t af[kAReg ? 8 : 1][2][4];   // the resident query
  // bf16: ldmatrix lane offsets: A rows lane % 16, columns (lane / 16) * 8;
  // B rows (lane / 16) * 8 + lane % 8, columns ((lane / 8) % 2) * 8
  const uint32_t a_base = smem_addr(q_s + (lane & 15) * ldq
                                    + (lane >> 4) * 8);
  const int b_off = kI8 ? (wn * 16 + (lane >> 2)) * kRB + (lane & 3) * 32
                        : (wn * 16 + ((lane >> 4) << 3) + (lane & 7)) * kRB
                              + ((lane >> 3) & 1) * 16;
  // int8: the A pairs of k-step kk of a chunk for this thread, row
  // mi * 16 + lane / 4 (+ 8): columns (lane % 4) * 32 + kk * 4 .. + 3
  const __nv_bfloat16* a8 = q_s + (lane >> 2) * ldq + (lane & 3) * 32;
  auto load_a8 = [&](uint32_t (&a)[4], int mi, int col) {
    const uint2 lo = *reinterpret_cast<const uint2*>(a8 + mi * 16 * ldq
                                                     + col);
    const uint2 hi = *reinterpret_cast<const uint2*>(a8 + (mi * 16 + 8) * ldq
                                                     + col);
    a[0] = lo.x;
    a[1] = hi.x;
    a[2] = lo.y;
    a[3] = hi.y;
  };
  const int d16 = (d + 15) / 16;   // k-steps in all of d

  int t = 0, dc = 0, stage = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kRing - 2>();
    product_warps_sync();
    issue();

    const unsigned char* st = ring + stage * kSB;
    if (dc == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
    }
    if constexpr (kI8) {
      // every k-step of a chunk: the permuted order mixes the tail of d
      // (zero on both sides) into all of them
      const unsigned char* bp = st + b_off;
      if constexpr (kAReg) {
        if (s == 0) {   // the query tile landed with the first stage
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) load_a8(af[kk][mi], mi, kk * 4);
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
              load_a8(a, mi, dc * kTD + kk * 4);
            }
            mma_bf16(acc[mi][0], a, b[0][0], b[0][1]);
            mma_bf16(acc[mi][1], a, b[1][0], b[1][1]);
          }
        }
      }
    } else {
      const uint32_t b_base = smem_addr(st + b_off);
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
            ldmatrix_x4(a[mi], a_base + (mi * 16 * ldq + dc * kTD + kk * 16)
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
                  fb[ni][h], __fmul_rn(scale, acc[mi][ni][hr * 2 + h]));
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

// ---- k <= 32: scan_mma_kernel -----------------------------------------------

template <typename ST>
size_t scan_mma_smem_bytes(int n_dc, int k, int stages) {
  return static_cast<size_t>(kRows) * (n_dc * kTD + 8) * 2   // query tile
         + static_cast<size_t>(stages) * stage_bytes<ST>()   // the ring
         + static_cast<size_t>(kRows) * k * 8                // the heaps
         + 2 * kTN * kRows * 5          // two candidate buffers: f32 + u8
         + kRows * 12;                  // query rows, 2 x candidate counts
}

// kAReg: d <= 128, the query tile lives in registers as A fragments
template <typename ST, bool kAsync, bool kAReg>
__global__ void __launch_bounds__(kPT + kHT, blocks_per_sm(kAReg))
scan_mma_kernel(const __nv_bfloat16* __restrict__ qc,
                const int* __restrict__ qidx, const ST* __restrict__ slabs,
                const float* __restrict__ bias, float* __restrict__ vals,
                int* __restrict__ idx, int cap, int qn, int d, int maxc,
                int k, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRing = ring_stages(kAReg);
  const int n_dc = (d + kTD - 1) / kTD;
  const int ldq = n_dc * kTD + 8;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + kRows * ldq * 2;
  Key* heap = reinterpret_cast<Key*>(ring + kRing * stage_bytes<ST>());
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
    scan_products<ST, kAsync, kAReg, kRing>(
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

// ---- k > 32: scan_general_mma_kernel ----------------------------------------
//
// The products of scan_mma_kernel (scan_products: a block takes one
// cluster and 32 query rows, so at cap <= 32 a slab is read once), and in
// place of its per-row heaps, sized for k <= 32, select_topk.cuh's running
// buffers: a row keeps its candidates below its bar in a buffer of 2k + 32
// (value, slot) keys, in shared memory while the block's 32 buffers fit
// beside the kernel's own bytes and in global scratch above, and selects
// its k smallest when more than 2k are held. At the end of each tile the
// product warps stage the tile's survivors, the distances below their
// row's bar, as a value in a [32 rows][64 slots] buffer and a 64-bit mask a
// row; 8 top-k warps, 4 rows each, append them in slot order (so that
// equal values keep the lower slot) and select. The buffers form a queue
// of kNB tiles, passed back and forth by named barriers, so the product
// warps go on with the next tiles while the top-k warps work through a
// burst of selections (a block's rows reach theirs at about the same
// tile). The bar is the row's k-th key since its last selection,
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

// the kernel's own shared memory, beside the rows' buffers
template <typename ST>
size_t general_mma_own_bytes(int n_dc, int stages) {
  return static_cast<size_t>(kRows) * (n_dc * kTD + 8) * 2   // query tile
         + static_cast<size_t>(stages) * stage_bytes<ST>()   // the ring
         + kNB * kRows * kTN * 4   // the survivor buffers' values
         + kNB * kRows * 8         // and masks
         + kRows * 16;             // bars, sizes, query rows
}

template <typename ST, bool kAsync, bool kAReg>
__global__ void __launch_bounds__(kGThreads, 1)
scan_general_mma_kernel(const __nv_bfloat16* __restrict__ qc,
                        const int* __restrict__ qidx,
                        const ST* __restrict__ slabs,
                        const float* __restrict__ bias,
                        float* __restrict__ vals, int* __restrict__ idx,
                        Key* scratch, int cap, int qn, int d, int maxc, int k,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRing = general_ring_stages(kAReg);
  constexpr int kR = kRows;
  constexpr int kNT = kGThreads;
  constexpr int kRTW = kR / kGT;                   // rows of a top-k warp
  const int n_dc = (d + kTD - 1) / kTD;
  const int ldq = n_dc * kTD + 8;
  const int c = blockIdx.x;
  const int r0 = blockIdx.y * kR;
  const long long blk = static_cast<long long>(c) * gridDim.y + blockIdx.y;
  Key* bufs = scratch != nullptr ? scratch + blk * kR * topk_buf(k)
                                 : reinterpret_cast<Key*>(smem);
  unsigned char* own = smem + (scratch != nullptr ? 0
                                                  : topk_bufs_bytes(kR, k));
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(own);
  unsigned char* ring = own + kR * ldq * 2;
  // survivors of a tile, kNB buffers: values [kNB][kR][kTN] and masks
  // [kNB][kR] (bit s: slot s of the tile), the mask as 4 u16, one a
  // product warp. Tile t goes to buffer t % kNB; named barriers 2 + b
  // (full) and 2 + kNB + b (empty) pass buffer b back and forth.
  float* cand_v = reinterpret_cast<float*>(ring + kRing * stage_bytes<ST>());
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
    scan_products<ST, kAsync, kAReg, kRing>(
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

// 16-byte copies where every row start of qc and slabs allows them
template <typename ST>
bool rows_allow_async(const void* qc, const void* slabs, int d) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(qc) |
                       reinterpret_cast<uintptr_t>(slabs) |
                       static_cast<uintptr_t>(d) * 2 |
                       static_cast<uintptr_t>(d) * sizeof(ST);
  return at % 16 == 0;
}

template <typename ST, bool kAsync, bool kAReg>
int launch_mma(const void* qc, const void* qidx, const void* slabs,
               const void* bias, void* vals, void* idx, int n_clusters,
               int cap, int qn, int d, int maxc, int k, float scale,
               cudaStream_t st) {
  const size_t smem = scan_mma_smem_bytes<ST>((d + kTD - 1) / kTD, k,
                                              ring_stages(kAReg));
  const cudaError_t err = cudaFuncSetAttribute(
      scan_mma_kernel<ST, kAsync, kAReg>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_clusters, (cap + kRows - 1) / kRows);
  scan_mma_kernel<ST, kAsync, kAReg><<<grid, kPT + kHT, smem, st>>>(
      static_cast<const __nv_bfloat16*>(qc), static_cast<const int*>(qidx),
      static_cast<const ST*>(slabs), static_cast<const float*>(bias),
      static_cast<float*>(vals), static_cast<int*>(idx), cap, qn, d, maxc, k,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename ST>
int launch_mma_any(const void* qc, const void* qidx, const void* slabs,
                   const void* bias, void* vals, void* idx, int n_clusters,
                   int cap, int qn, int d, int maxc, int k, float scale,
                   cudaStream_t st) {
  const bool async = rows_allow_async<ST>(qc, slabs, d);
  auto go = [&](auto kernel_launch) {
    return kernel_launch(qc, qidx, slabs, bias, vals, idx, n_clusters, cap,
                         qn, d, maxc, k, scale, st);
  };
  if (d <= kTD)
    return async ? go(launch_mma<ST, true, true>)
                 : go(launch_mma<ST, false, true>);
  return async ? go(launch_mma<ST, true, false>)
               : go(launch_mma<ST, false, false>);
}

template <typename ST>
size_t general_mma_own(int d) {
  const int n_dc = (d + kTD - 1) / kTD;
  return general_mma_own_bytes<ST>(n_dc, general_ring_stages(n_dc == 1));
}

template <typename ST, bool kAsync, bool kAReg>
int launch_general_mma(const void* qc, const void* qidx, const void* slabs,
                       const void* bias, void* vals, void* idx, void* scratch,
                       int n_clusters, int cap, int qn, int d, int maxc,
                       int k, float scale, cudaStream_t st) {
  const size_t own = general_mma_own<ST>(d);
  if (topk_needs_scratch(kRows, k, own) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = topk_smem_bytes(kRows, k, own);
  auto kernel = scan_general_mma_kernel<ST, kAsync, kAReg>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_clusters, (cap + kRows - 1) / kRows);
  kernel<<<grid, kGThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(qc), static_cast<const int*>(qidx),
      static_cast<const ST*>(slabs), static_cast<const float*>(bias),
      static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<Key*>(scratch), cap, qn, d, maxc, k, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename ST>
int launch_general_mma_any(const void* qc, const void* qidx,
                           const void* slabs, const void* bias, void* vals,
                           void* idx, void* scratch, int n_clusters, int cap,
                           int qn, int d, int maxc, int k, float scale,
                           cudaStream_t st) {
  const bool async = rows_allow_async<ST>(qc, slabs, d);
  auto go = [&](auto kernel_launch) {
    return kernel_launch(qc, qidx, slabs, bias, vals, idx, scratch,
                         n_clusters, cap, qn, d, maxc, k, scale, st);
  };
  if (d <= kTD)
    return async ? go(launch_general_mma<ST, true, true>)
                 : go(launch_general_mma<ST, false, true>);
  return async ? go(launch_general_mma<ST, true, false>)
               : go(launch_general_mma<ST, false, false>);
}

// ---- any k on CUDA cores: scan_general_kernel ------------------------------
//
// For k > 32 with the pairs that scan_general_mma_kernel does not take (f32
// x f32, int8 x int8, and a bf16 query past d = 1920), any 1 <= k <= maxc.
// Its products are grouped_scan_kernel's (tile_products: a block takes one
// cluster and 32 query rows, streams the slab through shared memory in
// [128 x 32] tiles, and each thread forms a 4 x 4 register tile on CUDA
// cores, with the arithmetic of _dots); each distance is rounded as the
// plain version rounds bias - scale * dot. The top-k is select_topk.cuh's
// running one: a warp keeps its 4 rows' candidates below their bar in
// buffers of 2k + 32 (value, slot) keys, shared memory up to k = 396 and
// global scratch above, and sorts each row's k smallest at the end.

// the kernel's own shared memory: the query and slab tiles, the row ids
constexpr size_t kGeneralSmem = (kRows + kTileM) * (kDC + 1) * 4 + kRows * 4;

// two blocks an SM (at most 128 registers a thread; shared memory allows
// two up to k = 168): with one, 8 warps could not hide the shared-memory
// and load latency of the products
template <typename QT, typename ST, typename AT>
__global__ void __launch_bounds__(kThreads, 2)
scan_general_kernel(const QT* __restrict__ qc, const int* __restrict__ qidx,
                    const ST* __restrict__ slabs,
                    const float* __restrict__ bias, float* __restrict__ vals,
                    int* __restrict__ idx, Key* scratch, int cap, int qn,
                    int d, int maxc, int k, float scale) {
  extern __shared__ __align__(16) unsigned char smem_g[];
  const int n_tiles = (cap + kRows - 1) / kRows;
  const int c = blockIdx.x / n_tiles;
  const int r0 = (blockIdx.x - c * n_tiles) * kRows;
  Key* bufs = topk_block_bufs(smem_g, scratch, kRows, k);
  unsigned char* rest = smem_g + topk_own_offset(scratch, kRows, k);
  AT (*q_s)[kDC + 1] = reinterpret_cast<AT (*)[kDC + 1]>(rest);
  AT (*s_s)[kDC + 1] =
      reinterpret_cast<AT (*)[kDC + 1]>(rest + kRows * (kDC + 1) * 4);
  int* qrow_s = reinterpret_cast<int*>(rest + (kRows + kTileM) * (kDC + 1)
                                       * 4);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long slab_row0 = static_cast<long long>(c) * maxc;

  if (t < kRows) {
    const int r = r0 + t;
    const int qi = r < cap ? qidx[static_cast<long long>(c) * cap + r] : -1;
    qrow_s[t] = (qi >= 0 && qi < qn) ? qi : -1;
  }

  // the warp's 4 rows: buffers, their sizes and bars (warp-uniform)
  Key* buf[4];
  int size[4];
  Key bar[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    buf[i] = bufs + static_cast<long long>(warp * 4 + i) * topk_buf(k);
    size[i] = 0;
    bar[i] = kNoKey;
  }

  for (int m0 = 0; m0 < maxc; m0 += kTileM) {
    AT acc[4][4];
    tile_products(acc, q_s, s_s, qrow_s, qc, slabs, slab_row0, m0, d, maxc,
                  t);

    // this lane's 4 slots, pushed in slot order (e outer, lane inner)
    float bv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + lane + 32 * e;
      bv[e] = m < maxc ? bias[slab_row0 + m] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + lane + 32 * e;
        const float dist =
            __fsub_rn(bv[e], __fmul_rn(scale, static_cast<float>(acc[i][e])));
        warp_push(buf[i], size[i], bar[i], k, make_key(dist, m), m < maxc,
                  lane);
      }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + warp * 4 + i;
    if (r >= cap) continue;   // warp-uniform
    const long long o = (static_cast<long long>(c) * cap + r) * k;
    warp_sort_smallest(buf[i], size[i], k, lane);
    for (int j = lane; j < k; j += 32) {
      vals[o + j] = key_value(buf[i][j]);
      idx[o + j] = static_cast<int>(buf[i][j] & 0xffffffffu);
    }
  }
}

template <typename QT, typename ST, typename AT>
int launch_general(const void* qc, const void* qidx, const void* slabs,
                   const void* bias, void* vals, void* idx, void* scratch,
                   int n_clusters, int cap, int qn, int d, int maxc, int k,
                   float scale, cudaStream_t st) {
  if (topk_needs_scratch(kRows, k, kGeneralSmem) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = topk_smem_bytes(kRows, k, kGeneralSmem);
  const cudaError_t err = cudaFuncSetAttribute(
      scan_general_kernel<QT, ST, AT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(n_clusters) * ((cap + kRows - 1) / kRows);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  scan_general_kernel<QT, ST, AT>
      <<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
          static_cast<const QT*>(qc), static_cast<const int*>(qidx),
          static_cast<const ST*>(slabs), static_cast<const float*>(bias),
          static_cast<float*>(vals), static_cast<int*>(idx),
          static_cast<Key*>(scratch), cap, qn, d, maxc, k, scale);
  return static_cast<int>(cudaGetLastError());
}

// the dtype pairs on tensor cores: a bf16 query with a bf16 or an int8 slab
bool on_tensor_cores(int q_dtype, int s_dtype, int d) {
  return q_dtype == kBF16 && (s_dtype == kBF16 || s_dtype == kI8) &&
         (d + kTD - 1) / kTD <= kMaxChunks;
}

}  // namespace

// Plain C entry point (loaded with ctypes), k <= 32. Pointers are device
// pointers; outputs vals [C, cap, k] f32 and idx [C, cap, k] int32 are
// allocated by the caller. Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success). The kernel goes by the dtype
// pair and d alone: scan_mma_kernel for a bf16 query with a bf16 or int8
// slab up to d = 1920, grouped_scan_kernel for the rest.
extern "C" int grouped_scan(const void* qc, const void* qidx,
                            const void* slabs, const void* bias, void* vals,
                            void* idx, int n_clusters, int cap, int qn, int d,
                            int maxc, int k, float scale, int q_dtype,
                            int s_dtype, void* stream) {
  if (n_clusters < 1 || cap < 1 || (cap + kRows - 1) / kRows > 65535 ||
      qn < 1 || d < 1 || maxc < 1 || k < 1 || k > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (on_tensor_cores(q_dtype, s_dtype, d))
    return s_dtype == kBF16
               ? launch_mma_any<__nv_bfloat16>(qc, qidx, slabs, bias, vals,
                                               idx, n_clusters, cap, qn, d,
                                               maxc, k, scale, st)
               : launch_mma_any<int8_t>(qc, qidx, slabs, bias, vals, idx,
                                        n_clusters, cap, qn, d, maxc, k,
                                        scale, st);
  if (q_dtype == kF32 && s_dtype == kF32)
    launch<float, float, float>(qc, qidx, slabs, bias, vals, idx, n_clusters,
                                cap, qn, d, maxc, k, scale, st);
  else if (q_dtype == kBF16 && s_dtype == kBF16)
    // past d = 1920 the tensor-core kernel's query tile does not fit: the
    // CUDA-core kernel takes any d (f32 sums of exact bf16 products)
    launch<__nv_bfloat16, __nv_bfloat16, float>(
        qc, qidx, slabs, bias, vals, idx, n_clusters, cap, qn, d, maxc, k,
        scale, st);
  else if (q_dtype == kI8 && s_dtype == kI8)
    launch<int8_t, int8_t, int>(qc, qidx, slabs, bias, vals, idx, n_clusters,
                                cap, qn, d, maxc, k, scale, st);
  else if (q_dtype == kBF16 && s_dtype == kI8)   // d > 1920, as bf16
    launch<__nv_bfloat16, int8_t, float>(qc, qidx, slabs, bias, vals, idx,
                                         n_clusters, cap, qn, d, maxc, k,
                                         scale, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The entry point for any 1 <= k <= maxc: the arguments of grouped_scan,
// and `scratch`, global memory for the rows' buffers of
// grouped_scan_general_scratch(...) bytes when that is not 0, else null.
// scan_general_mma_kernel takes the pairs and d of scan_mma_kernel,
// scan_general_kernel the rest.
extern "C" int grouped_scan_general(const void* qc, const void* qidx,
                                    const void* slabs, const void* bias,
                                    void* vals, void* idx, void* scratch,
                                    int n_clusters, int cap, int qn, int d,
                                    int maxc, int k, float scale, int q_dtype,
                                    int s_dtype, void* stream) {
  if (n_clusters < 1 || cap < 1 || qn < 1 || d < 1 || maxc < 1 || k < 1 ||
      k > maxc)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (on_tensor_cores(q_dtype, s_dtype, d)) {
    if ((cap + kRows - 1) / kRows > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    return s_dtype == kBF16
               ? launch_general_mma_any<__nv_bfloat16>(
                     qc, qidx, slabs, bias, vals, idx, scratch, n_clusters,
                     cap, qn, d, maxc, k, scale, st)
               : launch_general_mma_any<int8_t>(
                     qc, qidx, slabs, bias, vals, idx, scratch, n_clusters,
                     cap, qn, d, maxc, k, scale, st);
  }
  if (q_dtype == kF32 && s_dtype == kF32)
    return launch_general<float, float, float>(
        qc, qidx, slabs, bias, vals, idx, scratch, n_clusters, cap, qn, d,
        maxc, k, scale, st);
  if (q_dtype == kBF16 && s_dtype == kBF16)
    return launch_general<__nv_bfloat16, __nv_bfloat16, float>(
        qc, qidx, slabs, bias, vals, idx, scratch, n_clusters, cap, qn, d,
        maxc, k, scale, st);
  if (q_dtype == kI8 && s_dtype == kI8)
    return launch_general<int8_t, int8_t, int>(
        qc, qidx, slabs, bias, vals, idx, scratch, n_clusters, cap, qn, d,
        maxc, k, scale, st);
  if (q_dtype == kBF16 && s_dtype == kI8)
    return launch_general<__nv_bfloat16, int8_t, float>(
        qc, qidx, slabs, bias, vals, idx, scratch, n_clusters, cap, qn, d,
        maxc, k, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of global scratch grouped_scan_general needs for this shape: 0 when
// the rows' buffers fit shared memory.
extern "C" long long grouped_scan_general_scratch(int n_clusters, int cap,
                                                  int d, int k, int q_dtype,
                                                  int s_dtype) {
  size_t own = kGeneralSmem;
  if (on_tensor_cores(q_dtype, s_dtype, d))
    own = s_dtype == kBF16 ? general_mma_own<__nv_bfloat16>(d)
                           : general_mma_own<int8_t>(d);
  return topk_scratch_bytes(
      static_cast<long long>(n_clusters) * ((cap + kRows - 1) / kRows),
      kRows, k, own);
}
