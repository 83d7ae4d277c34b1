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
// and do the products and the top-k in the shadow of the loads. In f32
// the slab bytes double and the products run on the FP32 pipes, whose
// 67 TFLOP/s make them a second bound of the same size.
//
// Eight kernels, each pair one for k <= 32 and one for any k <= maxc.
// Which runs goes by the dtype pair, d and k alone (the entry points at the
// end):
//   * a bf16 query with a bf16 or an int8 slab (the CNNS path, and SQ8:
//     int8 slabs of non-integral data) up to d = 1920, on mma.sync bf16
//     tensor cores: scan_mma_kernel and scan_general_mma_kernel
//     (grouped_scan_bf16.cu, grouped_scan_sq8.cu);
//   * int8 x int8 (uint8 data stored shift-by-128) up to d = 3840, on
//     mma.sync s8 tensor cores, exact s32 sums: scan_i8_kernel and
//     scan_general_i8_kernel (grouped_scan_i8.cu);
//   * f32 x f32 up to d = 960, in exact FMAs on CUDA cores:
//     scan_f32_kernel and scan_general_f32_kernel (grouped_scan_f32.cu);
//   * the pairs past those widths, on CUDA cores: grouped_scan_kernel and
//     scan_general_kernel, here.
// The first three share scan_pipeline.cuh: the query tile resident in
// shared memory, the slab streamed through a cp.async ring, four product
// warps, and the top-k in warps of its own beside them. Each pair's
// instantiations compile in a file of their own, in parallel.
// k <= 32 (scan_heap_body): top-k follows the survivors, not the tiles.
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
// each heap is sorted into the output. When d <= 128 several blocks share
// an SM (bf16: 3, ~70 KB each; f32: 2), so their loads, products and
// staging overlap; above, one block and a deeper ring.
// Any k (scan_general_body): the same products, and in place of the heaps
// select_topk.cuh's running buffers, filled by 8 top-k warps (its notes
// are in scan_pipeline.cuh).
//
// The CUDA-core kernels, grouped_scan_kernel for k <= 32: one block of 256
// threads takes one cluster and up to 32 of its query rows, streams the
// slab through shared memory in [128 x 32] tiles, and each thread forms a
// 4 x 4 register tile of dot products with CUDA-core FMAs. A warp owns 4
// query rows and merges each 128-slot tile into the row's sorted k-list by
// k warp-wide (min, lowest-slot argmin) passes, skipping a tile when no
// value beats the current k-th. For any k, scan_general_kernel (at the end
// of this file, with its notes). They serve the pairs past the pipeline's
// widths (f32 past d = 960, a bf16 query past d = 1920, int8 x int8 past
// d = 3840).

#include "scan_pipeline.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kTileM = 128;     // slab rows per tile: 4 per lane
constexpr int kDC = 32;         // d elements per shared-memory chunk

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
void launch_cuda_cores(const void* qc, const void* qidx, const void* slabs,
                       const void* bias, void* vals, void* idx,
                       int n_clusters, int cap, int qn, int d, int maxc,
                       int k, float scale, cudaStream_t st) {
  const dim3 grid(n_clusters, (cap + kRows - 1) / kRows);
  grouped_scan_kernel<QT, ST, AT><<<grid, kThreads, 0, st>>>(
      static_cast<const QT*>(qc), static_cast<const int*>(qidx),
      static_cast<const ST*>(slabs), static_cast<const float*>(bias),
      static_cast<float*>(vals), static_cast<int*>(idx), cap, qn, d, maxc, k,
      scale);
}

// ---- any k on CUDA cores: scan_general_kernel ------------------------------
//
// For k > 32 with the pairs that the pipeline's kernels do not take (int8
// x int8 past d = 3840, a bf16 query past d = 1920, f32 past d = 960), any
// 1 <= k <= maxc.
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
int launch_general_cuda_cores(const void* qc, const void* qidx,
                              const void* slabs, const void* bias,
                              void* vals, void* idx, void* scratch,
                              int n_clusters, int cap, int qn, int d,
                              int maxc, int k, float scale,
                              cudaStream_t st) {
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
         d <= max_d<__nv_bfloat16>();
}

// f32 x f32 on the pipeline (grouped_scan_f32.cu)
bool on_f32_pipeline(int q_dtype, int s_dtype, int d) {
  return q_dtype == kF32 && s_dtype == kF32 && d <= max_d<float>();
}

// int8 x int8 on s8 tensor cores (grouped_scan_i8.cu)
bool on_i8_pipeline(int q_dtype, int s_dtype, int d) {
  return q_dtype == kI8 && s_dtype == kI8 && d <= max_d<int8_t>();
}

}  // namespace

// Plain C entry point (loaded with ctypes), k <= 32. Pointers are device
// pointers; outputs vals [C, cap, k] f32 and idx [C, cap, k] int32 are
// allocated by the caller. Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success). The kernel goes by the dtype
// pair and d alone: scan_mma_kernel for a bf16 query with a bf16 or int8
// slab up to d = 1920, scan_i8_kernel for int8 x int8 up to d = 3840,
// scan_f32_kernel for f32 up to d = 960, grouped_scan_kernel for the rest.
extern "C" int grouped_scan(const void* qc, const void* qidx,
                            const void* slabs, const void* bias, void* vals,
                            void* idx, int n_clusters, int cap, int qn, int d,
                            int maxc, int k, float scale, int q_dtype,
                            int s_dtype, void* stream) {
  if (n_clusters < 1 || cap < 1 || (cap + kRows - 1) / kRows > 65535 ||
      qn < 1 || d < 1 || maxc < 1 || k < 1 || k > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ScanArgs a{qc,   qidx, slabs, bias, vals, idx, nullptr, n_clusters,
                   cap, qn,   d,     maxc, k,    scale};
  if (on_tensor_cores(q_dtype, s_dtype, d))
    return s_dtype == kBF16 ? launch_scan_bf16(false, a, st)
                            : launch_scan_sq8(false, a, st);
  if (on_i8_pipeline(q_dtype, s_dtype, d))
    return launch_scan_i8(false, a, st);
  if (on_f32_pipeline(q_dtype, s_dtype, d))
    return launch_scan_f32(false, a, st);
  if (q_dtype == kF32 && s_dtype == kF32)   // d > 960
    launch_cuda_cores<float, float, float>(qc, qidx, slabs, bias, vals, idx,
                                           n_clusters, cap, qn, d, maxc, k,
                                           scale, st);
  else if (q_dtype == kBF16 && s_dtype == kBF16)
    // past d = 1920 the tensor-core kernel's query tile does not fit: the
    // CUDA-core kernel takes any d (f32 sums of exact bf16 products)
    launch_cuda_cores<__nv_bfloat16, __nv_bfloat16, float>(
        qc, qidx, slabs, bias, vals, idx, n_clusters, cap, qn, d, maxc, k,
        scale, st);
  else if (q_dtype == kI8 && s_dtype == kI8)   // d > 3840
    launch_cuda_cores<int8_t, int8_t, int>(qc, qidx, slabs, bias, vals, idx,
                                           n_clusters, cap, qn, d, maxc, k,
                                           scale, st);
  else if (q_dtype == kBF16 && s_dtype == kI8)   // d > 1920, as bf16
    launch_cuda_cores<__nv_bfloat16, int8_t, float>(
        qc, qidx, slabs, bias, vals, idx, n_clusters, cap, qn, d, maxc, k,
        scale, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The entry point for any 1 <= k <= maxc: the arguments of grouped_scan,
// and `scratch`, global memory for the rows' buffers of
// grouped_scan_general_scratch(...) bytes when that is not 0, else null.
// scan_general_mma_kernel, scan_general_i8_kernel and
// scan_general_f32_kernel take the pairs and d of scan_mma_kernel,
// scan_i8_kernel and scan_f32_kernel, scan_general_kernel the rest.
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
  const ScanArgs a{qc,   qidx, slabs, bias, vals, idx, scratch, n_clusters,
                   cap, qn,   d,     maxc, k,    scale};
  const bool tensor_cores = on_tensor_cores(q_dtype, s_dtype, d);
  const bool i8_pipeline = on_i8_pipeline(q_dtype, s_dtype, d);
  const bool f32_pipeline = on_f32_pipeline(q_dtype, s_dtype, d);
  if (tensor_cores || i8_pipeline || f32_pipeline) {
    if ((cap + kRows - 1) / kRows > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    if (f32_pipeline) return launch_scan_f32(true, a, st);
    if (i8_pipeline) return launch_scan_i8(true, a, st);
    return s_dtype == kBF16 ? launch_scan_bf16(true, a, st)
                            : launch_scan_sq8(true, a, st);
  }
  if (q_dtype == kF32 && s_dtype == kF32)   // d > 960
    return launch_general_cuda_cores<float, float, float>(
        qc, qidx, slabs, bias, vals, idx, scratch, n_clusters, cap, qn, d,
        maxc, k, scale, st);
  if (q_dtype == kBF16 && s_dtype == kBF16)
    return launch_general_cuda_cores<__nv_bfloat16, __nv_bfloat16, float>(
        qc, qidx, slabs, bias, vals, idx, scratch, n_clusters, cap, qn, d,
        maxc, k, scale, st);
  if (q_dtype == kI8 && s_dtype == kI8)   // d > 3840
    return launch_general_cuda_cores<int8_t, int8_t, int>(
        qc, qidx, slabs, bias, vals, idx, scratch, n_clusters, cap, qn, d,
        maxc, k, scale, st);
  if (q_dtype == kBF16 && s_dtype == kI8)
    return launch_general_cuda_cores<__nv_bfloat16, int8_t, float>(
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
    own = s_dtype == kBF16 ? general_own_bytes<__nv_bfloat16, __nv_bfloat16>(d)
                           : general_own_bytes<__nv_bfloat16, int8_t>(d);
  else if (on_i8_pipeline(q_dtype, s_dtype, d))
    own = general_own_bytes<int8_t, int8_t>(d);
  else if (on_f32_pipeline(q_dtype, s_dtype, d))
    own = general_own_bytes<float, float>(d);
  return topk_scratch_bytes(
      static_cast<long long>(n_clusters) * ((cap + kRows - 1) / kRows),
      kRows, k, own);
}
