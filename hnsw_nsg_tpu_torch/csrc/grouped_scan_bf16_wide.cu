// Grouped cluster scan, a bf16 query with bf16 slabs, past
// d = 1920: the streamed mode of scan_pipeline.cuh (the query's d
// chunks through the ring beside the slab's; notes in grouped_scan.cu),
// compiled apart from grouped_scan_bf16.cu so that the two build in
// parallel.

#include "scan_pipeline.cuh"

int launch_scan_bf16_wide(bool general, const ScanArgs& a, cudaStream_t st) {
  return launch_pipeline<__nv_bfloat16, __nv_bfloat16, true>(general, a, st);
}
