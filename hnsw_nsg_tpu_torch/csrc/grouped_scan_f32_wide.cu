// Grouped cluster scan, f32 query x f32 slab, past
// d = 960: the streamed mode of scan_pipeline.cuh (the query's d
// chunks through the ring beside the slab's; notes in grouped_scan.cu),
// compiled apart from grouped_scan_f32.cu so that the two build in
// parallel.

#include "scan_pipeline.cuh"

int launch_scan_f32_wide(bool general, const ScanArgs& a, cudaStream_t st) {
  return launch_pipeline<float, float, true>(general, a, st);
}
