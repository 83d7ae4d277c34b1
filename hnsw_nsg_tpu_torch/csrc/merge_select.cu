// Fused retset merge + frontier select, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _merge_select_kernel behind
// fused_merge_select (hnsw_nsg_tpu/ops/merge_select.py:92, pallas_call
// :228). Per query, with the retset r_d/r_i/r_e [L] sorted ascending by
// distance and a candidate block c_d/c_i [C]:
//   1. drop candidates whose id is PAD (< 0), already in the retset, or a
//      repeat of an earlier candidate (the first occurrence is kept);
//      dropped slots become (PAD_DIST, PAD_ID);
//   2. order retset ++ candidates by (dist, concatenation position) and
//      keep the first L: the new retset; a slot is expanded if it was an
//      expanded retset slot or holds PAD_ID;
//   3. pick the first `expand` unexpanded slots as the next frontier
//      (sel_ids, sel_valid; PAD_ID and false past the last one) and mark
//      them expanded.
// The result is a permutation of the inputs (no arithmetic), bit-identical
// to merge_into_retset followed by _select_frontier.
//
// Design. The TPU sorted the whole concatenation with a bitonic network
// because its vector unit has no cheap data-dependent addressing. Here the
// retset is already sorted, so one warp per query only orders the C
// candidates and merges:
//   * dedup: each lane takes candidates j = lane, lane+32, ... and
//     compares against the retset ids (shared-memory broadcasts) and the
//     earlier candidates;
//   * sort: each candidate's rank by (dist, j) is counted against the
//     other candidates (C^2 / 32 compares per lane; C is R * expand);
//   * merge path: retset slot i lands at i + #{candidates with dist <
//     r_d[i]}, sorted candidate s at s + #{retset slots with dist <=
//     its dist} (binary searches; the retset wins ties, being earlier);
//   * select: a warp ballot + prefix popcount over the unexpanded slots,
//     32 slots at a time, stopping after `expand` picks.
// The retset must be ascending in distance, as every caller keeps it.
//
// What bounds it on the H100: it is a memory-light, latency-bound pass.
// A query reads and writes ~(L + C) * 9 bytes (~5 KB at L = 500, C = 50)
// per hop, with a few thousand shared-memory operations of dependent
// work per warp; there is no arithmetic to speak of. Several warps (one
// query each) share a block so that each SM keeps enough queries in
// flight to hide the shared-memory and global latencies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kPadDist = 3.4e37f;  // ops/distance.py PAD_DIST
constexpr int kPadId = -1;           // ops/distance.py PAD_ID
constexpr int kMaxWarps = 8;
constexpr int kSmallSmem = 48 * 1024;

// bytes of shared memory one warp (one query) uses, 16-byte aligned
__host__ __device__ inline int warp_bytes(int l, int c) {
  return ((17 * l + 16 * c) + 15) & ~15;
}

// #{i : a[i] < v} and #{i : a[i] <= v} over an ascending array
__device__ __forceinline__ int count_less(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}
__device__ __forceinline__ int count_le(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void merge_select_kernel(
    const float* __restrict__ r_d, const int* __restrict__ r_i,
    const uint8_t* __restrict__ r_e, const float* __restrict__ c_d,
    const int* __restrict__ c_i, float* __restrict__ o_d,
    int* __restrict__ o_i, uint8_t* __restrict__ o_e,
    int* __restrict__ sel_i, uint8_t* __restrict__ sel_v, int nq, int l,
    int c, int expand) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5)
                      + warp;
  if (q >= nq) return;  // the whole warp leaves; only __syncwarp below

  unsigned char* base = smem + static_cast<size_t>(warp) * warp_bytes(l, c);
  float* rd = reinterpret_cast<float*>(base);  // [l] retset dists
  int* ri = reinterpret_cast<int*>(rd + l);    // [l] retset ids
  float* od = reinterpret_cast<float*>(ri + l);  // [l] new retset
  int* oi = reinterpret_cast<int*>(od + l);
  float* md = reinterpret_cast<float*>(oi + l);  // [c] masked candidates
  int* mi = reinterpret_cast<int*>(md + c);
  float* sd = reinterpret_cast<float*>(mi + c);  // [c] sorted candidates
  int* si = reinterpret_cast<int*>(sd + c);
  uint8_t* oe = reinterpret_cast<uint8_t*>(si + c);  // [l] new flags

  const long long rq = q * l, cq = q * c;
  for (int i = lane; i < l; i += 32) {
    rd[i] = r_d[rq + i];
    ri[i] = r_i[rq + i];
  }
  for (int j = lane; j < c; j += 32) mi[j] = c_i[cq + j];
  __syncwarp();

  // 1. dedup against the retset and the earlier candidates
  for (int j = lane; j < c; j += 32) {
    const int id = mi[j];
    bool drop = id < 0;
    for (int i = 0; i < l && !drop; ++i) drop = ri[i] == id;
    for (int t = 0; t < j && !drop; ++t) drop = mi[t] == id;
    sd[j] = drop ? kPadDist : c_d[cq + j];
    si[j] = drop ? kPadId : id;
  }
  __syncwarp();
  for (int j = lane; j < c; j += 32) {
    md[j] = sd[j];
    mi[j] = si[j];
  }
  __syncwarp();

  // 2a. stable order of the candidates by (dist, position)
  for (int j = lane; j < c; j += 32) {
    const float v = md[j];
    int rank = 0;
    for (int t = 0; t < c; ++t) {
      const float w = md[t];
      rank += (w < v) || (w == v && t < j);
    }
    sd[rank] = v;
    si[rank] = mi[j];
  }
  __syncwarp();

  // 2b. merge path: each element's slot in the merged order; keep < l
  for (int i = lane; i < l; i += 32) {
    const float v = rd[i];
    const int p = i + count_less(sd, c, v);
    if (p < l) {
      od[p] = v;
      oi[p] = ri[i];
      oe[p] = (r_e[rq + i] != 0) || ri[i] < 0;
    }
  }
  for (int s = lane; s < c; s += 32) {
    const float v = sd[s];
    const int p = s + count_le(rd, l, v);
    if (p < l) {
      od[p] = v;
      oi[p] = si[s];
      oe[p] = si[s] < 0;
    }
  }
  __syncwarp();

  // 3. frontier: the first `expand` unexpanded slots, in slot order
  int taken = 0;
  for (int s0 = 0; s0 < l && taken < expand; s0 += 32) {
    const int slot = s0 + lane;
    const bool un = slot < l && oe[slot] == 0;
    const unsigned ball = __ballot_sync(kFull, un);
    const int rank = taken + __popc(ball & ((1u << lane) - 1u));
    if (un && rank < expand) {
      sel_i[q * expand + rank] = oi[slot];
      sel_v[q * expand + rank] = 1;
      oe[slot] = 1;
    }
    taken += __popc(ball);
  }
  for (int e = (taken < expand ? taken : expand) + lane; e < expand; e += 32) {
    sel_i[q * expand + e] = kPadId;
    sel_v[q * expand + e] = 0;
  }
  __syncwarp();
  for (int i = lane; i < l; i += 32) {
    o_d[rq + i] = od[i];
    o_i[rq + i] = oi[i];
    o_e[rq + i] = oe[i];
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers:
// r_d f32, r_i i32, r_e bool (1 byte) [Q, L]; c_d f32, c_i i32 [Q, C];
// outputs o_d/o_i/o_e [Q, L] and sel_i i32 / sel_v bool [Q, expand],
// allocated by the caller. Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
extern "C" int merge_select(const void* r_d, const void* r_i, const void* r_e,
                            const void* c_d, const void* c_i, void* o_d,
                            void* o_i, void* o_e, void* sel_i, void* sel_v,
                            int nq, int l, int c, int expand, void* stream) {
  if (nq < 1 || l < 1 || c < 0 || expand < 1 || expand > l)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_warp = warp_bytes(l, c);
  int warps = kSmallSmem / per_warp;
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const int bytes = warps * per_warp;
  if (bytes > kSmallSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (nq + warps - 1) / warps;
  merge_select_kernel<<<blocks, warps * 32, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r_d), static_cast<const int*>(r_i),
      static_cast<const uint8_t*>(r_e), static_cast<const float*>(c_d),
      static_cast<const int*>(c_i), static_cast<float*>(o_d),
      static_cast<int*>(o_i), static_cast<uint8_t*>(o_e),
      static_cast<int*>(sel_i), static_cast<uint8_t*>(sel_v), nq, l, c,
      expand);
  return static_cast<int>(cudaGetLastError());
}
