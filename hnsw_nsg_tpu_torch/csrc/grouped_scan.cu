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
// bandwidth.
//
// What this first design does about it: nothing yet. One block of 256
// threads takes one cluster and up to 32 of its query rows. It streams the
// slab through shared memory in [128 x 32] tiles (coalesced rows), and
// each thread forms a 4 x 4 register tile of dot products with CUDA-core
// FMAs. A warp owns 4 query rows and the 4 x 4 distances its lanes hold,
// and merges each 128-slot tile into the row's running sorted k-list by k
// warp-wide (min, lowest-slot argmin) passes, skipping a tile outright when
// no value beats the current k-th. The slab is read once per 32 query rows.
// Later work: wgmma products (bf16 and s8) fed by a TMA ring of slab tiles,
// with the top-k epilogue overlapping the next tile's loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

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
  else if (q_dtype == kBF16 && s_dtype == kBF16)
    launch<__nv_bfloat16, __nv_bfloat16, float>(qc, qidx, slabs, bias, vals,
                                                idx, n_clusters, cap, qn, d,
                                                maxc, k, scale, st);
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
