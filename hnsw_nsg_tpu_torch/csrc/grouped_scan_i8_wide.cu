// Grouped cluster scan, int8 query x int8 slab, past
// d = 3840: the streamed mode of scan_pipeline.cuh (the query's d
// chunks through the ring beside the slab's; notes in grouped_scan.cu),
// compiled apart from grouped_scan_i8.cu so that the two build in
// parallel.

#include "scan_pipeline.cuh"

int launch_scan_i8_wide(bool general, const ScanArgs& a, cudaStream_t st) {
  return launch_pipeline<int8_t, int8_t, true>(general, a, st);
}
