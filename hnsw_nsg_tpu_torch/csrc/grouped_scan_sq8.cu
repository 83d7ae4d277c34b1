// Grouped cluster scan, a bf16 query with int8 slabs (SQ8): the
// tensor-core kernels of scan_pipeline.cuh (notes in grouped_scan.cu),
// compiled apart so that the pipeline's instantiations build in parallel.

#include "scan_pipeline.cuh"

int launch_scan_sq8(bool general, const ScanArgs& a, cudaStream_t st) {
  return launch_pipeline<__nv_bfloat16, int8_t, false>(general, a, st);
}
