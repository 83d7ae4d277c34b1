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
// by pointer, and the pipeline's d loop serves every d.
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
// Six kernels, each dtype pair one for k <= 32 and one for any k <= maxc,
// all on the ring pipeline of scan_pipeline.cuh (the slab streamed through
// a cp.async ring, four product warps, the top-k in warps of its own
// beside them):
//   * a bf16 query with a bf16 or an int8 slab (the CNNS path, and SQ8:
//     int8 slabs of non-integral data) on mma.sync bf16 tensor cores:
//     scan_mma_kernel and scan_general_mma_kernel (grouped_scan_bf16.cu,
//     grouped_scan_sq8.cu);
//   * int8 x int8 (uint8 data stored shift-by-128) on mma.sync s8 tensor
//     cores, exact s32 sums: scan_i8_kernel and scan_general_i8_kernel
//     (grouped_scan_i8.cu);
//   * f32 x f32 in exact FMAs on CUDA cores: scan_f32_kernel and
//     scan_general_f32_kernel (grouped_scan_f32.cu).
// Each pair's instantiations compile in a file of their own, in parallel,
// and those of its streamed mode in another (grouped_scan_*_wide.cu).
// The mode of the query rows goes by d alone: resident in shared memory
// up to max_d (f32 960, a bf16 query 1920, int8 x int8 3840), streamed
// through the ring beside the slab past it (the "wide" kernels of
// cluster_scan.scan_kernel, in the place of the CUDA-core kernels that
// served those widths before). Past max_d the query chunk of every stage
// comes from L2 (a block's 32 rows are read again each slab tile): half
// the slab's bytes at bf16, as many at f32; the HBM stream, the bound,
// stays the slab's.
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
// staging overlap; up to max_d, one block and a deeper ring; streamed,
// two blocks of 3 stages.
// Any k (scan_general_body): the same products, and in place of the heaps
// select_topk.cuh's running buffers, filled by 8 top-k warps (its notes
// are in scan_pipeline.cuh).

#include "scan_pipeline.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

// the pair's launch (general: any k; else k <= 32), streamed past the
// query type's max_d, or an error for a pair that pallas_scan.py:_dots
// does not take
int launch_pair(bool general, const ScanArgs& a, int q_dtype, int s_dtype,
                cudaStream_t st) {
  if (q_dtype == kBF16 && s_dtype == kBF16)
    return a.d > max_d<__nv_bfloat16>() ? launch_scan_bf16_wide(general, a, st)
                                        : launch_scan_bf16(general, a, st);
  if (q_dtype == kBF16 && s_dtype == kI8)
    return a.d > max_d<__nv_bfloat16>() ? launch_scan_sq8_wide(general, a, st)
                                        : launch_scan_sq8(general, a, st);
  if (q_dtype == kI8 && s_dtype == kI8)
    return a.d > max_d<int8_t>() ? launch_scan_i8_wide(general, a, st)
                                 : launch_scan_i8(general, a, st);
  if (q_dtype == kF32 && s_dtype == kF32)
    return a.d > max_d<float>() ? launch_scan_f32_wide(general, a, st)
                                : launch_scan_f32(general, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (loaded with ctypes), k <= 32. Pointers are device
// pointers; outputs vals [C, cap, k] f32 and idx [C, cap, k] int32 are
// allocated by the caller. Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success). The kernel goes by the dtype
// pair: scan_mma_kernel for a bf16 query with a bf16 or int8 slab,
// scan_i8_kernel for int8 x int8, scan_f32_kernel for f32; its mode by d.
extern "C" int grouped_scan(const void* qc, const void* qidx,
                            const void* slabs, const void* bias, void* vals,
                            void* idx, int n_clusters, int cap, int qn, int d,
                            int maxc, int k, float scale, int q_dtype,
                            int s_dtype, void* stream) {
  if (n_clusters < 1 || cap < 1 || qn < 1 || d < 1 || maxc < 1 || k < 1 ||
      k > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs a{qc,   qidx, slabs, bias, vals, idx, nullptr, n_clusters,
                   cap, qn,   d,     maxc, k,    scale};
  return launch_pair(false, a, q_dtype, s_dtype,
                     static_cast<cudaStream_t>(stream));
}

// The entry point for any 1 <= k <= maxc: the arguments of grouped_scan,
// and `scratch`, global memory for the rows' buffers of
// grouped_scan_general_scratch(...) bytes when that is not 0, else null.
// scan_general_mma_kernel, scan_general_i8_kernel and
// scan_general_f32_kernel take the pairs of scan_mma_kernel,
// scan_i8_kernel and scan_f32_kernel.
extern "C" int grouped_scan_general(const void* qc, const void* qidx,
                                    const void* slabs, const void* bias,
                                    void* vals, void* idx, void* scratch,
                                    int n_clusters, int cap, int qn, int d,
                                    int maxc, int k, float scale, int q_dtype,
                                    int s_dtype, void* stream) {
  if (n_clusters < 1 || cap < 1 || qn < 1 || d < 1 || maxc < 1 || k < 1 ||
      k > maxc)
    return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs a{qc,   qidx, slabs, bias, vals, idx, scratch, n_clusters,
                   cap, qn,   d,     maxc, k,    scale};
  return launch_pair(true, a, q_dtype, s_dtype,
                     static_cast<cudaStream_t>(stream));
}

// Bytes of global scratch grouped_scan_general needs for this shape: 0 when
// the rows' buffers fit shared memory beside the kernel's own bytes (the
// query tile up to max_d, the larger ring stages past it).
extern "C" long long grouped_scan_general_scratch(int n_clusters, int cap,
                                                  int d, int k, int q_dtype,
                                                  int s_dtype) {
  size_t own;
  if (q_dtype == kBF16 && s_dtype == kBF16)
    own = general_own_bytes<__nv_bfloat16, __nv_bfloat16>(d);
  else if (q_dtype == kBF16 && s_dtype == kI8)
    own = general_own_bytes<__nv_bfloat16, int8_t>(d);
  else if (q_dtype == kI8 && s_dtype == kI8)
    own = general_own_bytes<int8_t, int8_t>(d);
  else if (q_dtype == kF32 && s_dtype == kF32)
    own = general_own_bytes<float, float>(d);
  else
    return 0;   // no kernel takes the pair: the launch refuses it
  return topk_scratch_bytes(
      static_cast<long long>(n_clusters) * ((cap + kRows - 1) / kRows),
      kRows, k, own);
}
