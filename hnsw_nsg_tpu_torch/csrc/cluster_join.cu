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
// Operand types: bf16 x bf16 or f32 x f32, exact products summed in f32
// with FMAs (no TF32).
//
// Design. The TPU materialized a [rows, mm] distance tile in VMEM and
// folded its `group` contiguous column slices. Here a block takes one
// cluster and 32 member rows (8 warps x 4 rows) and walks the buckets in
// tiles of 128: for each bucket tile it streams the `group` stack row
// ranges {e * g + b0 .. + 128} through shared memory in [128 x 32] chunks
// of d, forms a 4 x 4 register tile of dot products per thread, and
// folds each e into per-bucket running minima in registers. No [rows, g]
// bucket state ever exists, so shared memory holds only the two operand
// tiles. The finished bucket minima of a tile are merged into each row's
// running sorted k-list (k <= 64; lane j holds entries j and j + 32) by k
// warp-wide (min, lowest bucket) passes, skipped when no bucket of the
// tile beats the current k-th. Buckets arrive in increasing b, so a tie
// with the k-th always loses, as it must.
//
// What bounds it on the H100: the FMAs on CUDA cores. At the 1M build
// shape (maxc = 2112, M = 8, mm = 16,896, d = 128) a cluster costs
// 2 * maxc * mm * d = 9.1 GFLOP, ~9 TFLOP for the ~1000 clusters, while
// each block reads its cluster's stack (4.3 MB in bf16) once from L2, so
// the tensor cores (wgmma on bf16 tiles) are the way to a faster version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRows = 32;       // member rows per block: 4 per warp
constexpr int kTileB = 128;     // buckets per tile: 4 per lane
constexpr int kDC = 32;         // d elements per shared-memory chunk
constexpr int kMaxK = 64;       // running list: 2 entries per lane
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// (value, bucket) order: the lower bucket wins a tie
__device__ __forceinline__ bool before(float av, int ab, float bv, int bb) {
  return av < bv || (av == bv && ab < bb);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cluster_join_kernel(const T* __restrict__ qv, const T* __restrict__ stacks,
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
            v = to_f32(qv[(q_row0 + r) * d + d0 + col]);
          q_s[row][col] = v;
        }
#pragma unroll
        for (int p = 0; p < (kTileB * kDC) / kThreads; ++p) {
          const int el = t + p * kThreads;
          const int row = el / kDC, col = el % kDC;
          const int b = b0 + row;
          float v = 0.f;
          if (b < g && d0 + col < d)
            v = to_f32(stacks[(s_row0 + static_cast<long long>(e) * g + b)
                              * d + d0 + col]);
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

template <typename T>
void launch(const void* qv, const void* stacks, const void* bias, void* vals,
            void* idx, int n_clusters, int maxc, int d, int mm, int k,
            int group, float scale, cudaStream_t st) {
  const dim3 grid((maxc + kRows - 1) / kRows, n_clusters);
  cluster_join_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(qv), static_cast<const T*>(stacks),
      static_cast<const float*>(bias), static_cast<float*>(vals),
      static_cast<int*>(idx), maxc, d, mm, k, group, scale);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers:
// qv [C, maxc, d] and stacks [C, mm, d] of one dtype (0 f32, 1 bf16),
// bias [C, mm] f32; outputs vals [C, maxc, k] f32 and idx [C, maxc, k]
// int32, allocated by the caller. Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" int cluster_join(const void* qv, const void* stacks,
                            const void* bias, void* vals, void* idx,
                            int n_clusters, int maxc, int d, int mm, int k,
                            int group, float scale, int dtype, void* stream) {
  if (n_clusters < 1 || n_clusters > 65535 || maxc < 1 || d < 1 || mm < 1 ||
      k < 1 || k > kMaxK || group < 1 || mm % group != 0 || k > mm / group)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    launch<float>(qv, stacks, bias, vals, idx, n_clusters, maxc, d, mm, k,
                  group, scale, st);
  else if (dtype == kBF16)
    launch<__nv_bfloat16>(qv, stacks, bias, vals, idx, n_clusters, maxc, d,
                          mm, k, group, scale, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
