// Grouped cluster scan, f32 query x f32 slab, for Hopper (sm_90a): the
// ring pipeline of scan_pipeline.cuh with exact f32 FMAs on CUDA cores.
// Replaces the Pallas kernels of hnsw_nsg_tpu/ops/pallas_scan.py for this
// pair (_scan_kernel_gq :244, _scan_kernel_gq_dblk :354, _scan_kernel
// :81; notes in grouped_scan.cu): the query tile resident in shared
// memory up to d = max_d<float>() = 960, streamed through the ring beside
// the slab past it. Compiled apart from the other pairs so that they
// build in parallel.
//
// What bounds it on the H100: at the sift1m bench shape (C = 1152 probed
// slabs of maxc = 2056 rows, d = 128, 32 query rows a cluster) the slabs
// are 1.21 GB, 0.36 ms at 3.35 TB/s, and the products 19.4 GFLOP, 0.29 ms
// at the 67 TFLOP/s FP32 peak: two bounds of one size, to be overlapped.
// So the slab streams through the cp.async ring while the product warps
// run their FMAs: the query tile is read from shared memory, staged once
// per block, and each thread's 16 sums (4 query rows x 4 slab rows, the
// layout the epilogues take) read their operands as float4 along d, 8
// 16-byte shared loads for 64 FFMAs in place of the CUDA-core kernel's 8
// scalar loads for 16. The top-k runs beside the products in warps of its
// own: a heap warp for k <= 32 (scan_f32_kernel), 8 top-k warps on
// select_topk.cuh's running buffers for any k (scan_general_f32_kernel).
// Each sum runs in increasing d, one fmaf at a time from 0, and each
// distance is rounded as bias - scale * dot, so the values are those of
// the CUDA-core kernels this pipeline replaced, bit for bit.
//
// Measured there (H100 80GB HBM3 at 700 W, PERF.md): 0.86 ms at k = 10
// (the CUDA-core kernel: 1.61), 42% of the bound. clock64 counters in the
// product warps (scripts/scan_clocks.py): 53% of their cycles in the
// products (1,024 FFMAs a warp and d chunk in ~2,800 cycles, two product
// warps an SM sub-partition), 18% waiting on the ring and their barrier,
// 27% in the epilogue and its barrier with the heap warp. 4 x 16 sums a
// thread (20 operands for 64 FMAs in place of 8 for 16) left the product
// cycles as they were, so the shared loads are not what limits them.

#include "scan_pipeline.cuh"

int launch_scan_f32(bool general, const ScanArgs& a, cudaStream_t st) {
  return launch_pipeline<float, float, false>(general, a, st);
}
