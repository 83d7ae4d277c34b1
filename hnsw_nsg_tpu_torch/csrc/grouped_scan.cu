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
// Two kernels for k <= 32, by operand type, and a general kernel for any
// k <= maxc (at the end of this file, with its own notes).
//
// bf16 x bf16 (the CNNS path) up to d = 1920, scan_mma_kernel (above that
// the query tile does not fit and the pair runs on grouped_scan_kernel
// below). A block takes one cluster
// and up to 32 of its query rows, so at cap <= 32 a slab is read once.
//   * The query rows are gathered by pointer into shared memory (zero for
//     pad slots and past d) and, when d <= 128, kept as mma A fragments in
//     registers for the whole run.
//   * The slab streams through a cp.async ring of [64 rows x 128 d] tiles
//     (rows padded by 16 bytes so that ldmatrix reads hit distinct banks;
//     16-byte copies when every row starts on 16 bytes, d % 8 == 0, else
//     plain loads and stores; the tail of d is zero-filled). When d <= 128 the ring
//     has 2 stages and three blocks share an SM (~70 KB each), so ~52 KB
//     of slab are in flight an SM and one block's products and staging
//     run under the others' loads; above, 4 stages and one block.
//   * Four product warps take 16 slab rows each: mma.sync m16n8k16 bf16
//     -> f32 over the 32 query rows, f32 sums of exact products. For
//     d > 128 the accumulators run over the d chunks of a tile (d = 960:
//     8 chunks) with the query read from shared memory.
//   * Top-k follows the survivors, not the tiles. The first tile has no
//     bar yet, so the product warps sort its 64 keys a row themselves (a
//     bitonic network in shared memory) and the k smallest become the
//     row's 4-ary max-heap of (value, slot) keys. From then on, when a
//     tile's distances are ready, only those below their row's current
//     k-th, the heap's root (strict <: a tie with the k-th has a later
//     slot and loses), are staged, and a fifth warp, one thread a query
//     row, pushes them into the heap while the product warps go on with
//     the next tile, which they stage into a second buffer: the two
//     roles meet at one barrier a tile. The keys order by value, then
//     slot, so neither the order in which a tile's survivors arrive nor
//     a bar that is one tile old matters. A row sees ~k ln(maxc / 64)
//     survivors after the first tile. At the end each heap is sorted
//     into the output.
//
// The other three pairs (f32 x f32, which must stay exact FMAs; int8 x
// int8; an int8 slab with a bf16 query), grouped_scan_kernel: one block of
// 256 threads takes one cluster and up to 32 of its query rows, streams
// the slab through shared memory in [128 x 32] tiles, and each thread
// forms a 4 x 4 register tile of dot products with CUDA-core FMAs. A warp
// owns 4 query rows and merges each 128-slot tile into the row's sorted
// k-list by k warp-wide (min, lowest-slot argmin) passes, skipping a tile
// when no value beats the current k-th. int8 x int8 on s8 tensor cores
// and the int8-slab pair (upcast to bf16) on the kernel above are the
// next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

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

// ---- bf16 x bf16: mma.sync tensor cores -------------------------------------

constexpr int kPT = 128;         // 4 product warps: 16 slab rows of a tile each
constexpr int kHT = 32;          // 1 heap warp: one thread a query row
constexpr int kTN = 64;          // slab rows per ring stage
constexpr int kTD = 128;         // d elements per ring stage
constexpr int kLdS = kTD + 8;    // padded shared-memory row (bf16)
// Ring stages and blocks an SM. d <= 128: 2 stages and a small query tile
// leave room for 3 blocks, whose phases (wait, products, staging) overlap
// one another; that measured faster than 2 blocks of 4 stages. Above,
// the query tile fills the SM's shared memory and the ring is all the
// overlap there is.
__host__ __device__ constexpr int ring_stages(bool a_reg) { return a_reg ? 2 : 4; }
__host__ __device__ constexpr int blocks_per_sm(bool a_reg) { return a_reg ? 3 : 1; }
// a stage: the slab tile and its f32 bias (in bf16 units)
constexpr int kStageElems = kTN * kLdS + 2 * kTN;
constexpr int kMaxChunks = 15;   // d <= 1920: the query tile must fit

// Copy 8 bf16 of a row into shared memory; elements at n_valid and past
// it (n_valid may be <= 0 or >= 8) become zero. kCB is the copy width in
// bytes that the row starts allow: 16 (cp.async) or 2 (plain loads).
template <int kCB>
__device__ __forceinline__ void copy8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int n_valid,
                                      const __nv_bfloat16* safe) {
  if constexpr (kCB == 2) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      dst[u] = u < n_valid ? src[u] : __float2bfloat16(0.f);
  } else {
    static_assert(kCB == 16, "copy widths: 16 or 2 bytes");
    const int nv = min(max(n_valid, 0), 8);
    cp_async16(smem_addr(dst), nv > 0 ? src : safe, nv * 2);
  }
}

__device__ __forceinline__ void product_warps_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kPT) : "memory");
}
__device__ __forceinline__ void scan_hand_over_sync() {
  asm volatile("bar.sync 2, %0;\n" :: "n"(kPT + kHT) : "memory");
}

size_t scan_mma_smem_bytes(int n_dc, int k, int stages) {
  return static_cast<size_t>(kRows) * (n_dc * kTD + 8) * 2   // query tile
         + static_cast<size_t>(stages) * kStageElems * 2     // the ring
         + static_cast<size_t>(kRows) * k * 8                // the heaps
         + 2 * kTN * kRows * 5          // two candidate buffers: f32 + u8
         + kRows * 12;                  // query rows, 2 x candidate counts
}

// kAReg: d <= 128, the query tile lives in registers as A fragments
template <int kCB, bool kAReg>
__global__ void __launch_bounds__(kPT + kHT, blocks_per_sm(kAReg))
scan_mma_kernel(const __nv_bfloat16* __restrict__ qc,
                const int* __restrict__ qidx,
                const __nv_bfloat16* __restrict__ slabs,
                const float* __restrict__ bias, float* __restrict__ vals,
                int* __restrict__ idx, int cap, int qn, int d, int maxc,
                int k, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRing = ring_stages(kAReg);
  const int n_dc = (d + kTD - 1) / kTD;
  const int ldq = n_dc * kTD + 8;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = q_s + kRows * ldq;
  Key* heap = reinterpret_cast<Key*>(ring + kRing * kStageElems);
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
    scan_hand_over_sync();   // tile 0 is in the heaps
    for (int t = 1; t < n_tiles; ++t) {
      scan_hand_over_sync();
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
    const int wn = warp;   // slab rows wn * 16 .. + 15 of the tile
    const int steps = n_tiles * n_dc;

    // the query tile: row r, 8 elements from column 8 * piece
    const int q_pieces = n_dc * (kTD / 8);
    for (int i = tid; i < kRows * q_pieces; i += kPT) {
      const int row = i / q_pieces, col = (i - row * q_pieces) * 8;
      const int qi = qrow_s[row];
      copy8<kCB>(q_s + row * ldq + col,
                 qc + static_cast<long long>(qi < 0 ? 0 : qi) * d + col,
                 qi < 0 ? 0 : d - col, qc);
    }

    // this thread's pieces of a slab tile: rows c_row + 8 p, columns c_col
    // .. + 7 of the stage's d chunk
    const int c_row = tid >> 4, c_col = (tid & 15) * 8;
    int l_t = 0, l_dc = 0, l_stage = 0;   // the next step to load
    auto issue = [&]() {
      if (l_t < n_tiles) {
        __nv_bfloat16* st = ring + l_stage * kStageElems;
        const int m0 = l_t * kTN;
        const int col = l_dc * kTD + c_col;
#pragma unroll
        for (int p = 0; p < kTN / 8; ++p) {
          const int row = c_row + 8 * p;
          const bool ok = m0 + row < maxc;
          copy8<kCB>(st + row * kLdS + c_col,
                     slabs + (slab_row0 + (ok ? m0 + row : 0)) * d + col,
                     ok ? d - col : 0, slabs);
        }
        if (l_dc == n_dc - 1 && tid < kTN) {   // the tile's bias, 0 past maxc
          const bool ok = m0 + tid < maxc;
          cp_async4(smem_addr(st + kTN * kLdS) + tid * 4,
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
    // ldmatrix lane offsets: A rows lane % 16, columns (lane / 16) * 8;
    // B rows (lane / 16) * 8 + lane % 8, columns ((lane / 8) % 2) * 8
    const uint32_t a_base = smem_addr(q_s + (lane & 15) * ldq
                                      + (lane >> 4) * 8);
    const int b_off = (wn * 16 + ((lane >> 4) << 3) + (lane & 7)) * kLdS
                      + ((lane >> 3) & 1) * 8;
    const int d16 = (d + 15) / 16;   // k-steps in all of d

    int t = 0, dc = 0, stage = 0;
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kRing - 2>();
      product_warps_sync();
      issue();

      const __nv_bfloat16* st = ring + stage * kStageElems;
      const uint32_t b_base = smem_addr(st + b_off);
      if (dc == 0) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
      }
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

      if (dc == n_dc - 1) {
        // The tile's distances. Accumulator entry j of tile (mi, ni) is
        // query row mi * 16 + (j / 2) * 8 + lane / 4 and slab row ni * 8 +
        // (lane % 4) * 2 + j % 2 of the warp's 16. One fma: the plain
        // version's bias - scale * dot whenever scale is a power of two
        // (l2: 2, ip: 1), where the product is exact.
        const float* bias_s = reinterpret_cast<const float*>(st + kTN * kLdS);
        const int m0 = t * kTN;
        float fb[2][2];
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int bt = wn * 16 + ni * 8 + (lane & 3) * 2 + h;
            fb[ni][h] = m0 + bt < maxc ? bias_s[bt] : INFINITY;
          }
        if (t == 0) {
          // The first tile has no bar yet and every slot would be a
          // survivor: sort each row's 64 keys here, in parallel (a bitonic
          // network in shared memory, cand as [kRows][kTN]), and make the k
          // smallest the row's heap. In descending order they are a heap.
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
                  cand[row * kTN + bt] = make_key(
                      fmaf(-scale, acc[mi][ni][hr * 2 + h], fb[ni][h]), bt);
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
          scan_hand_over_sync();   // tile 0 is in the heaps
        } else {
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
              float dist[2][2];
              unsigned take = 0;
#pragma unroll
              for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  dist[ni][h] = fmaf(-scale, acc[mi][ni][hr * 2 + h],
                                     fb[ni][h]);
                  take |= static_cast<unsigned>(dist[ni][h] < kth)
                          << (ni * 2 + h);
                }
              int slot = take ? atomicAdd(&cn[row], __popc(take)) : 0;
#pragma unroll
              for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  if (take >> (ni * 2 + h) & 1) {
                    cv[slot * kRows + row] = dist[ni][h];
                    cs[slot * kRows + row] = static_cast<uint8_t>(
                        wn * 16 + ni * 8 + (lane & 3) * 2 + h);
                    ++slot;
                  }
            }
          scan_hand_over_sync();
        }
      }
      if (++dc == n_dc) {
        dc = 0;
        ++t;
      }
      stage = stage == kRing - 1 ? 0 : stage + 1;
    }
    cp_async_wait<0>();
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

template <int kCB, bool kAReg>
int launch_mma(const void* qc, const void* qidx, const void* slabs,
               const void* bias, void* vals, void* idx, int n_clusters,
               int cap, int qn, int d, int maxc, int k, float scale,
               cudaStream_t st) {
  const size_t smem = scan_mma_smem_bytes((d + kTD - 1) / kTD, k,
                                          ring_stages(kAReg));
  const cudaError_t err = cudaFuncSetAttribute(
      scan_mma_kernel<kCB, kAReg>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_clusters, (cap + kRows - 1) / kRows);
  scan_mma_kernel<kCB, kAReg><<<grid, kPT + kHT, smem, st>>>(
      static_cast<const __nv_bfloat16*>(qc), static_cast<const int*>(qidx),
      static_cast<const __nv_bfloat16*>(slabs),
      static_cast<const float*>(bias), static_cast<float*>(vals),
      static_cast<int*>(idx), cap, qn, d, maxc, k, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kCB>
int launch_mma_d(const void* qc, const void* qidx, const void* slabs,
                 const void* bias, void* vals, void* idx, int n_clusters,
                 int cap, int qn, int d, int maxc, int k, float scale,
                 cudaStream_t st) {
  return d <= kTD ? launch_mma<kCB, true>(qc, qidx, slabs, bias, vals, idx,
                                          n_clusters, cap, qn, d, maxc, k,
                                          scale, st)
                  : launch_mma<kCB, false>(qc, qidx, slabs, bias, vals, idx,
                                           n_clusters, cap, qn, d, maxc, k,
                                           scale, st);
}

// ---- any k: the general kernel ---------------------------------------------
//
// The two kernels above keep each row's running k best in a warp's lanes or
// in heaps sized for k <= 32. For k > 32 (CNNSIndex.search's own default is
// k = 100) this kernel takes any 1 <= k <= maxc, every dtype pair, any d.
// Its products are grouped_scan_kernel's (tile_products: a block takes one
// cluster and 32 query rows, streams the slab through shared memory in
// [128 x 32] tiles, and each thread forms a 4 x 4 register tile on CUDA
// cores, with the arithmetic of _dots); each distance is rounded as the
// plain version rounds bias - scale * dot. The top-k is select_topk.cuh's
// running one: a warp keeps its 4 rows' candidates below their bar in
// buffers of 2k + 32 (value, slot) keys, shared memory up to k = 396 and
// global scratch above, and sorts each row's k smallest at the end. Simple
// and not tuned: the products run on CUDA cores.

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
    warp_emit_smallest(buf[i], size[i], k, lane, [&](int rank, Key key) {
      vals[o + rank] = key_value(key);
      idx[o + rank] = static_cast<int>(key & 0xffffffffu);
    });
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

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers;
// outputs vals [C, cap, k] f32 and idx [C, cap, k] int32 are allocated by
// the caller. Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int grouped_scan(const void* qc, const void* qidx,
                            const void* slabs, const void* bias, void* vals,
                            void* idx, int n_clusters, int cap, int qn, int d,
                            int maxc, int k, float scale, int q_dtype,
                            int s_dtype, void* stream) {
  if (n_clusters < 1 || cap < 1 || (cap + kRows - 1) / kRows > 65535 ||
      qn < 1 || d < 1 || maxc < 1 || k < 1 || k > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && s_dtype == kF32)
    launch<float, float, float>(qc, qidx, slabs, bias, vals, idx, n_clusters,
                                cap, qn, d, maxc, k, scale, st);
  else if (q_dtype == kBF16 && s_dtype == kBF16) {
    if ((d + kTD - 1) / kTD > kMaxChunks) {
      // the query tile of the tensor-core kernel no longer fits: the
      // CUDA-core kernel takes any d (f32 sums of exact bf16 products)
      launch<__nv_bfloat16, __nv_bfloat16, float>(
          qc, qidx, slabs, bias, vals, idx, n_clusters, cap, qn, d, maxc, k,
          scale, st);
      return static_cast<int>(cudaGetLastError());
    }
    // 16-byte copies where every row start of qc and slabs allows them
    const uintptr_t at = reinterpret_cast<uintptr_t>(qc) |
                         reinterpret_cast<uintptr_t>(slabs) |
                         static_cast<uintptr_t>(d) * 2;
    if (at % 16 == 0)
      return launch_mma_d<16>(qc, qidx, slabs, bias, vals, idx, n_clusters,
                              cap, qn, d, maxc, k, scale, st);
    return launch_mma_d<2>(qc, qidx, slabs, bias, vals, idx, n_clusters, cap,
                           qn, d, maxc, k, scale, st);
  }
  else if (q_dtype == kI8 && s_dtype == kI8)
    launch<int8_t, int8_t, int>(qc, qidx, slabs, bias, vals, idx, n_clusters,
                                cap, qn, d, maxc, k, scale, st);
  else if (q_dtype == kBF16 && s_dtype == kI8)
    launch<__nv_bfloat16, int8_t, float>(qc, qidx, slabs, bias, vals, idx,
                                         n_clusters, cap, qn, d, maxc, k,
                                         scale, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The general kernel's entry point (any 1 <= k <= maxc): the arguments of
// grouped_scan, and `scratch`, global memory for the rows' buffers of
// grouped_scan_general_scratch(n_clusters, cap, k) bytes when that is not
// 0, else null.
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
                                                  int k) {
  return topk_scratch_bytes(
      static_cast<long long>(n_clusters) * ((cap + kRows - 1) / kRows), kRows,
      k, kGeneralSmem);
}
