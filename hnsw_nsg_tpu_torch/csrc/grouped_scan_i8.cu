// Grouped cluster scan, int8 query x int8 slab, for Hopper (sm_90a): the
// ring pipeline of scan_pipeline.cuh with mma.sync m16n8k32 s8 -> s32 on
// tensor cores. Replaces the Pallas kernels of
// hnsw_nsg_tpu/ops/pallas_scan.py for this pair (_scan_kernel_gq :244,
// _scan_kernel_gq_dblk :354, _scan_kernel :81; notes in grouped_scan.cu):
// uint8 vectors stored shift-by-128 as int8 slabs, whose products the
// reference sums exactly in s32 (pallas_scan.py:47-51). Up to d =
// max_d<int8_t>() = 3840 the query tile (123 KB) stays in shared memory;
// wider rows stream their d chunks through the ring beside the slab's
// (the streamed mode, scan_pipeline.cuh). Compiled apart from the other
// pairs so that they build in parallel.
//
// What bounds it on the H100: at the sift10m_u8 bench shape (C = 1152
// probed slabs of maxc = 2056 rows, d = 128, 32 query rows a cluster) the
// slabs are 303 MB, 0.09 ms at 3.35 TB/s, while the products (19.4 GOP)
// take 0.01 ms at the 1,979 TOP/s int8 peak: the bound is the bytes. So
// the slab streams through the cp.async ring in 16-byte copies ([64 rows
// x 128 d] int8 stages, half a bf16 stage's bytes), and each product
// warp reads its B fragments as words straight from the stage, with no
// upcast (SQ8's int8 slab with a bf16 query needs one), against A
// fragments that a query at d <= 128 keeps in registers: 16 mma.sync a
// warp and d chunk. At d <= 128, 3 blocks share an SM for k <= 32 (4
// fit, and measured 1-2% slower). The top-k runs beside the products in
// warps of its own: a heap warp
// for k <= 32 (scan_i8_kernel), 8 top-k warps on select_topk.cuh's
// running buffers for any k (scan_general_i8_kernel).
// The s32 sums are exact in any order, so a chunk's k order may be
// permuted alike on both sides; each distance is bias - scale * dot, the
// dot converted to f32 in one rounding (as the reference's
// .astype(jnp.float32) and the plain version's float64 sum), then the
// product and the difference each rounded once. The values, and with the
// (value, slot) keys the ids, are those of the CUDA-core kernels this
// pipeline replaced, bit for bit, exact ties going to the lowest slot.

#include "scan_pipeline.cuh"

int launch_scan_i8(bool general, const ScanArgs& a, cudaStream_t st) {
  return launch_pipeline<int8_t, int8_t, false>(general, a, st);
}
