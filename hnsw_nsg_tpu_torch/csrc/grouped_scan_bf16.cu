// Grouped cluster scan, a bf16 query with bf16 slabs: the tensor-core
// kernels of scan_pipeline.cuh (notes in grouped_scan.cu), compiled apart
// so that the pipeline's instantiations build in parallel.

#include "scan_pipeline.cuh"

int launch_scan_bf16(bool general, const ScanArgs& a, cudaStream_t st) {
  return launch_pipeline<__nv_bfloat16, __nv_bfloat16, false>(general, a, st);
}
