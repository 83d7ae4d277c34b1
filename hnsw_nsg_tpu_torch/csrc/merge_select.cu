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
// What bounds it on the H100: nothing the card is short of. A query reads
// and writes ~(L + C) * 9 bytes (~5 KB at L = 500, C = 50), 5-12 us of
// memory traffic for a whole batch, and does no arithmetic. The time is
// the instructions a warp issues (an SM's four schedulers share them
// among its resident warps) and the chains of dependent shared-memory
// reads in them. So the design counts instructions, has no loop that
// ends early on the data, and keeps the batch resident in one or two
// waves.
//
// Design. The TPU sorted the whole concatenation with a bitonic network
// because its vector unit has no cheap data-dependent addressing. Here the
// retset is already sorted, so one warp per query orders only the
// candidates it keeps and merges:
//   * the lanes hold the retset ids in registers, slot lane + 32 k in
//     register k (the kernel is compiled for 2, 4, 8, 16 and 32 slots a
//     lane, so L <= 1024; wider retsets and C > 1024 go to the general
//     kernel at the end of this file),
//     and the expanded flags as one bit mask; only the dists go to
//     shared memory;
//   * membership, 32 candidates a round: each candidate id is read by
//     the whole warp (a broadcast) and compared with the lane's retset
//     ids, the hits of a round collected in a per-lane bit mask and
//     OR-reduced across the warp once a round. That is C * ceil(L / 32)
//     compares a lane with no dependent chain, against the first
//     design's walk over L ids with an exit on the data, and it is exact
//     whatever the ids are (a shared-memory hash table was tried first:
//     its atomicCAS inserts cost more than all these compares);
//   * repeats: within a round match_any gives the first lane of each id;
//     across rounds a candidate is compared with the kept list. So the
//     first occurrence wins, in position order;
//   * the kept candidates are packed in position order (ballot + prefix
//     popcount). Only they are ranked and merged: a dropped candidate is
//     (PAD_DIST, PAD_ID) and sorts behind every retset slot, so it never
//     reaches the first L. In a running search few candidates are kept;
//   * sort: each kept candidate's rank by (dist, position) is counted
//     against the other kept ones, two candidates a lane at a time;
//   * merge path: sorted candidate s lands at s + #{retset dists <= its
//     dist}, retset slot i at i + #{candidate dists < r_d[i]}: binary
//     searches of a fixed step count without branches, up to 8 of a
//     lane's slots in step. The retset wins ties, being earlier. Dists
//     go straight to the output row; ids and flags pass through shared
//     memory, in slot order, for the select and for vector stores;
//   * select: a warp ballot + prefix popcount over the unexpanded slots,
//     32 slots at a time, stopping after `expand` picks.
// The retset must be ascending in distance, as every caller keeps it.
//
// Shared memory per query is 9 L + 12 C bytes: 5.1 KB at L = 500, C = 50
// (the first design: 9.3 KB, under a 48 KB cap a block). A block is 8
// warps. Resident warps per SM, as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor reports them through
// merge_select_occupancy: 40 at L = 500 (48 registers; the first design
// held 20), so the collect pool's 4096 queries are one wave, and 48 at
// L = 100 and L = 40 (40 registers). nvcc -Xptxas -v shows at most 32
// bytes of spill in any instantiation. The 32-slot build (L = 513..1024,
// an HNSW search with ef up to 1024) keeps 32 ids a lane in registers
// under a cap of 128 (two blocks an SM; it takes 96, no spill): at
// L = 1024, C = 32 a block takes 77 KB of shared memory, so two blocks,
// 16 queries, are what an SM holds whatever the cap. Measured at
// Q = 8192, L = 1024, C = 32 (PERF.md): 0.080 ms, where the general
// kernel took 0.66.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kPadDist = 3.4e37f;  // ops/distance.py PAD_DIST
constexpr int kPadId = -1;           // ops/distance.py PAD_ID
constexpr int kWarps = 8;            // queries (warps) per block
constexpr int kMaxL = 1024;          // 32 retset slots a lane
constexpr int kMaxC = 1024;
constexpr int kSmallSmem = 48 * 1024;

__host__ __device__ inline int pad16(int bytes) { return (bytes + 15) & ~15; }

// bytes of shared memory one warp (one query) uses: rd [l] f32, md [c]
// f32, mi [c] i32, sd [c] f32, oi [l] i32, oe [l] u8
__host__ __device__ inline int warp_bytes(int l, int c) {
  return 2 * pad16(4 * l) + 3 * pad16(4 * c) + pad16(l);
}

// The binary searches below count #{i : a[i] < v} (or <=) over an
// ascending array of n entries in steps from `top`, the largest power of
// two <= n (0 when n is 0), down to 1: the step count does not depend on
// the data, so several searches run in step.
__device__ __forceinline__ int floor_pow2(int n) {
  return n > 0 ? 1 << (31 - __clz(n)) : 0;
}

// blocks an SM should hold, which sets the register cap: the lanes keep
// kNR retset ids each
constexpr int min_blocks(int nr) {
  return nr <= 8 ? 6 : nr <= 16 ? 5 : 2;
}

// kNR: retset slots a lane, >= ceil(l / 32). kVec: l % 4 == 0 and the
// output rows are 16-byte aligned.
template <int kNR, bool kVec>
__global__ void __launch_bounds__(kWarps * 32, min_blocks(kNR))
merge_select_kernel(
    const float* __restrict__ r_d, const int* __restrict__ r_i,
    const uint8_t* __restrict__ r_e, const float* __restrict__ c_d,
    const int* __restrict__ c_i, float* __restrict__ o_d,
    int* __restrict__ o_i, uint8_t* __restrict__ o_e,
    int* __restrict__ sel_i, uint8_t* __restrict__ sel_v, int nq, int l,
    int c, int expand) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (q >= nq) return;  // the whole warp leaves; only __syncwarp below

  unsigned char* base = smem + static_cast<size_t>(warp) * warp_bytes(l, c);
  float* rd = reinterpret_cast<float*>(base);              // [l] retset dists
  int* oi = reinterpret_cast<int*>(base + pad16(4 * l));   // [l] new ids
  float* md = reinterpret_cast<float*>(base + 2 * pad16(4 * l));  // [c]
  int* mi = reinterpret_cast<int*>(md) + pad16(4 * c) / 4;        // [c]
  float* sd = reinterpret_cast<float*>(mi) + pad16(4 * c) / 4;    // [c]
  uint8_t* oe = reinterpret_cast<uint8_t*>(sd) + pad16(4 * c);    // [l] flags

  const long long rq = q * l, cq = q * c;

  // 1. the candidates as they came; the retset: dists to shared memory,
  // slot i = lane + 32 k in register k (id) and in bit k of `expanded`
  for (int j = lane; j < c; j += 32) {
    mi[j] = c_i[cq + j];
    md[j] = c_d[cq + j];
  }
  int rid[kNR];
  // (64 bits, though kNR <= 32: with a 32-bit mask the 16-slot build
  // spills more and measured 38 us against 33 at Q = 4096, L = 500)
  unsigned long long expanded = 0;
#pragma unroll
  for (int k = 0; k < kNR; ++k) {
    const int i = lane + 32 * k;
    rid[k] = kPadId;
    if (i < l) {
      rd[i] = r_d[rq + i];
      rid[k] = r_i[rq + i];
      if (r_e[rq + i] != 0) expanded |= 1ull << k;
    }
  }
  __syncwarp();

  // 2. keep a candidate if its id is live, not in the retset and the
  // first of its id: 32 candidates a round, in position order. Each
  // candidate of the round is broadcast to the warp, whose lanes hold the
  // retset ids; a repeat within the round shows in match_any, a repeat of
  // an earlier round in the kept list (an earlier candidate that was not
  // kept was in the retset or a repeat itself). The kept ones are packed
  // to the front of md/mi, in position order: the n listed candidates. A
  // dropped candidate is (PAD_DIST, PAD_ID) behind every retset slot, so
  // it never reaches the first L and is not listed, unless a retset dist
  // exceeds PAD_DIST (no caller does that): then every candidate is
  // listed, the dropped ones masked.
  const bool all_listed = rd[l - 1] > kPadDist;
  int n = 0;
  for (int j0 = 0; j0 < c; j0 += 32) {
    const int j = j0 + lane;
    const int id = j < c ? mi[j] : kPadId;
    const float dist = j < c ? md[j] : kPadDist;
    const int t_end = c - j0 < 32 ? c - j0 : 32;
    // bit t of `mine`: one of this lane's retset ids is candidate j0 + t
    unsigned mine = 0;
#pragma unroll 4
    for (int t = 0; t < t_end; ++t) {
      const int x = mi[j0 + t];
      bool hit = false;
#pragma unroll
      for (int k = 0; k < kNR; ++k) hit |= rid[k] == x;
      mine |= static_cast<unsigned>(hit) << t;
    }
    const unsigned in_retset = __reduce_or_sync(kFull, mine);
    bool repeat = (__ffs(__match_any_sync(kFull, id)) - 1) != lane;
#pragma unroll 4
    for (int t = 0; t < n; ++t) repeat |= mi[t] == id;
    const bool keep = id >= 0 && !((in_retset >> lane) & 1u) && !repeat;
    const bool listed = keep || (all_listed && j < c);
    __syncwarp();  // the round and the list are read before it is packed
    const unsigned ball = __ballot_sync(kFull, listed);
    if (listed) {
      const int pos = n + __popc(ball & ((1u << lane) - 1u));
      md[pos] = keep ? dist : kPadDist;
      mi[pos] = keep ? id : kPadId;
    }
    n += __popc(ball);
    __syncwarp();
  }

  // 3. the listed candidates: rank by (dist, position), then the merged
  // slot. A lane takes candidates j and j + 32 together, so that their
  // reads overlap.
  const int l_top = floor_pow2(l), n_top = floor_pow2(n);
  for (int j = lane; j < n; j += 64) {
    const int j2 = j + 32;
    const bool two = j2 < n;
    const float v = md[j], v2 = two ? md[j2] : kPadDist;
    int rank = 0, rank2 = 0;
#pragma unroll 8
    for (int t = 0; t < n; ++t) {
      const float w = md[t];
      rank += (w < v) | ((w == v) & (t < j));
      rank2 += (w < v2) | ((w == v2) & (t < j2));
    }
    int pos = 0, pos2 = 0;   // count_le(rd, l, v) and (.., v2)
    for (int step = l_top; step > 0; step >>= 1) {
      const int t = pos + step, t2 = pos2 + step;
      // (no branch: the read is clamped into the array)
      const bool up = (t <= l) & (rd[min(t, l) - 1] <= v);
      const bool up2 = (t2 <= l) & (rd[min(t2, l) - 1] <= v2);
      pos = up ? t : pos;
      pos2 = up2 ? t2 : pos2;
    }
    sd[rank] = v;
    const int p = rank + pos;
    if (p < l) {
      const int id = mi[j];
      o_d[rq + p] = v;
      oi[p] = id;
      oe[p] = id < 0;
    }
    if (two) {
      sd[rank2] = v2;
      const int p2 = rank2 + pos2;
      if (p2 < l) {
        const int id = mi[j2];
        o_d[rq + p2] = v2;
        oi[p2] = id;
        oe[p2] = id < 0;
      }
    }
  }
  __syncwarp();

  // 4. the retset slots: slot i moves up by the candidates ahead of it,
  // #{sd < rd[i]}. The binary searches of up to 8 slots run in step.
  constexpr int kChunk = kNR < 8 ? kNR : 8;
#pragma unroll
  for (int k0 = 0; k0 < kNR; k0 += kChunk) {
    float v[kChunk];
    int ahead[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int i = lane + 32 * (k0 + u);
      v[u] = i < l ? rd[i] : kPadDist;
      ahead[u] = 0;
    }
    for (int step = n_top; step > 0; step >>= 1) {
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int t = ahead[u] + step;
        const bool up = (t <= n) & (sd[min(t, n) - 1] < v[u]);
        ahead[u] = up ? t : ahead[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int k = k0 + u;
      const int i = lane + 32 * k;
      const int p = i + ahead[u];
      if (i < l && p < l) {
        o_d[rq + p] = v[u];
        oi[p] = rid[k];
        oe[p] = ((expanded >> k) & 1ull) | (rid[k] < 0);
      }
    }
  }
  __syncwarp();

  // 5. frontier: the first `expand` unexpanded slots, in slot order
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
  if (kVec) {
    for (int i = lane * 4; i < l; i += 128) {
      *reinterpret_cast<int4*>(o_i + rq + i) =
          *reinterpret_cast<const int4*>(oi + i);
      *reinterpret_cast<uint32_t*>(o_e + rq + i) =
          *reinterpret_cast<const uint32_t*>(oe + i);
    }
  } else {
    for (int i = lane; i < l; i += 32) {
      o_i[rq + i] = oi[i];
      o_e[rq + i] = oe[i];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

using Kernel = void (*)(const float*, const int*, const uint8_t*,
                        const float*, const int*, float*, int*, uint8_t*,
                        int*, uint8_t*, int, int, int, int);

template <int kNR>
Kernel pick_vec(bool vec) {
  return vec ? merge_select_kernel<kNR, true>
             : merge_select_kernel<kNR, false>;
}

// the instantiation whose lanes hold ceil(l / 32) retset slots or more
Kernel pick(int l, bool vec) {
  const int nr = (l + 31) / 32;
  return nr <= 2   ? pick_vec<2>(vec)
         : nr <= 4 ? pick_vec<4>(vec)
         : nr <= 8 ? pick_vec<8>(vec)
         : nr <= 16 ? pick_vec<16>(vec)
                    : pick_vec<32>(vec);
}

cudaError_t allow(Kernel kernel, int bytes) {
  if (bytes <= kSmallSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}


// ---- the general kernel: any L and C that fit shared memory ----------------
//
// The kernel above holds the retset ids in a lane's registers, so it is
// compiled per width and stops at L = 1024. This one takes L and C at run
// time (an HNSW search with ef above 1024, a beam whose expand * R passes
// 1024): a block per query, the retset and the candidates in shared
// memory, the same three steps with nothing clever in them. It is the
// simple one and is not tuned:
//   * dedup: thread j walks the retset ids and the earlier candidates for
//     candidate j (an exit on the first hit), C * (L + C / 2) compares a
//     block at worst;
//   * rank: every candidate, dropped ones included, is counted against
//     all others by (dist, position), C^2 compares a block;
//   * merge path: one binary search a retset slot and a candidate; the
//     retset wins ties, being earlier. Results go straight to the output
//     rows;
//   * select: the first warp reads the new flags back (ballot + prefix
//     popcount, 32 slots a step).
// It needs 8 L + 16 C bytes a query: 64 KB at L = 4096, C = 2048. Up to
// the 227 KB a block may have they are shared memory; past that (L ~ 29,000
// at C = 50) the same arrays lie in global scratch that the wrapper
// allocates, Q x (8 L + 16 C) bytes, so any L and C are taken, the JAX
// function's contract. The two homes are two instantiations, so that the
// shared-memory one compiles to shared-memory loads and stores, not to
// generic ones (0.67 -> 0.50 ms at Q = 8192, L = 1025, C = 32).

constexpr int kGenThreads = 256;
constexpr int kGenSmemMax = 232448;

__host__ __device__ inline int general_bytes(int l, int c) {
  return 8 * l + 16 * c;
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

template <bool kScratch>
__global__ void __launch_bounds__(kGenThreads)
merge_select_general_kernel(
    const float* __restrict__ r_d, const int* __restrict__ r_i,
    const uint8_t* __restrict__ r_e, const float* __restrict__ c_d,
    const int* __restrict__ c_i, float* __restrict__ o_d,
    int* __restrict__ o_i, uint8_t* o_e, int* __restrict__ sel_i,
    uint8_t* __restrict__ sel_v, unsigned char* scratch, int l, int c,
    int expand) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const long long q = blockIdx.x;
  unsigned char* base = kScratch ? scratch + q * general_bytes(l, c) : smem;
  float* rd = reinterpret_cast<float*>(base);   // [l] retset dists
  int* ri = reinterpret_cast<int*>(rd + l);     // [l] retset ids
  float* md = reinterpret_cast<float*>(ri + l); // [c] masked candidates
  int* mi = reinterpret_cast<int*>(md + c);
  float* sd = reinterpret_cast<float*>(mi + c); // [c] sorted candidates
  int* si = reinterpret_cast<int*>(sd + c);
  const long long rq = q * l, cq = q * c;

  for (int i = tid; i < l; i += kGenThreads) {
    rd[i] = r_d[rq + i];
    ri[i] = r_i[rq + i];
  }
  for (int j = tid; j < c; j += kGenThreads) si[j] = c_i[cq + j];
  __syncthreads();

  // 1. drop PADs, retset members and repeats of an earlier candidate
  for (int j = tid; j < c; j += kGenThreads) {
    const int id = si[j];
    bool drop = id < 0;
    for (int i = 0; i < l && !drop; ++i) drop = ri[i] == id;
    for (int t = 0; t < j && !drop; ++t) drop = si[t] == id;
    md[j] = drop ? kPadDist : c_d[cq + j];
    mi[j] = drop ? kPadId : id;
  }
  __syncthreads();

  // 2a. stable order of the candidates by (dist, position)
  for (int j = tid; j < c; j += kGenThreads) {
    const float v = md[j];
    int rank = 0;
    for (int t = 0; t < c; ++t) {
      const float w = md[t];
      rank += (w < v) || (w == v && t < j);
    }
    sd[rank] = v;
    si[rank] = mi[j];
  }
  __syncthreads();

  // 2b. merge path: each element's slot in the merged order; keep < l
  for (int i = tid; i < l; i += kGenThreads) {
    const float v = rd[i];
    const int p = i + count_less(sd, c, v);
    if (p < l) {
      o_d[rq + p] = v;
      o_i[rq + p] = ri[i];
      o_e[rq + p] = (r_e[rq + i] != 0) || ri[i] < 0;
    }
  }
  for (int s = tid; s < c; s += kGenThreads) {
    const float v = sd[s];
    const int p = s + count_le(rd, l, v);
    if (p < l) {
      o_d[rq + p] = v;
      o_i[rq + p] = si[s];
      o_e[rq + p] = si[s] < 0;
    }
  }
  __syncthreads();   // the block's writes to o_i / o_e are visible to it

  // 3. frontier: the first `expand` unexpanded slots, in slot order
  if (tid >= 32) return;
  const int lane = tid;
  int taken = 0;
  for (int s0 = 0; s0 < l && taken < expand; s0 += 32) {
    const int slot = s0 + lane;
    const bool un = slot < l && o_e[rq + slot] == 0;
    const unsigned ball = __ballot_sync(kFull, un);
    const int rank = taken + __popc(ball & ((1u << lane) - 1u));
    if (un && rank < expand) {
      sel_i[q * expand + rank] = o_i[rq + slot];
      sel_v[q * expand + rank] = 1;
      o_e[rq + slot] = 1;
    }
    taken += __popc(ball);
  }
  for (int e = (taken < expand ? taken : expand) + lane; e < expand; e += 32) {
    sel_i[q * expand + e] = kPadId;
    sel_v[q * expand + e] = 0;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers:
// r_d f32, r_i i32, r_e bool (1 byte) [Q, L]; c_d f32, c_i i32 [Q, C];
// outputs o_d/o_i/o_e [Q, L] and sel_i i32 / sel_v bool [Q, expand],
// allocated by the caller. L <= 1024, C <= 1024. Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
extern "C" int merge_select(const void* r_d, const void* r_i, const void* r_e,
                            const void* c_d, const void* c_i, void* o_d,
                            void* o_i, void* o_e, void* sel_i, void* sel_v,
                            int nq, int l, int c, int expand, void* stream) {
  if (nq < 1 || l < 1 || l > kMaxL || c < 0 || c > kMaxC || expand < 1 ||
      expand > l)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = kWarps * warp_bytes(l, c);
  const bool vec = l % 4 == 0 && aligned16(o_i) && aligned16(o_e);
  const Kernel kernel = pick(l, vec);
  const cudaError_t err = allow(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (nq + kWarps - 1) / kWarps;
  kernel<<<blocks, kWarps * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r_d), static_cast<const int*>(r_i),
      static_cast<const uint8_t*>(r_e), static_cast<const float*>(c_d),
      static_cast<const int*>(c_i), static_cast<float*>(o_d),
      static_cast<int*>(o_i), static_cast<uint8_t*>(o_e),
      static_cast<int*>(sel_i), static_cast<uint8_t*>(sel_v), nq, l, c,
      expand);
  return static_cast<int>(cudaGetLastError());
}

// Resident warps (queries) per SM that the launch for (l, c) gets, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; < 0: the negated CUDA
// error, or the shape is not taken.
extern "C" int merge_select_occupancy(int l, int c) {
  if (l < 1 || l > kMaxL || c < 0 || c > kMaxC) return -1;
  const int bytes = kWarps * warp_bytes(l, c);
  const Kernel kernel = pick(l, l % 4 == 0);
  cudaError_t err = allow(kernel, bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kWarps * 32, bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks * kWarps;
}

// Bytes of global scratch a query of the general kernel needs: 0 when its
// arrays fit shared memory.
extern "C" long long merge_select_general_scratch(int l, int c) {
  const long long bytes = 8ll * l + 16ll * c;
  return bytes > kGenSmemMax ? bytes : 0;
}

// The general kernel's entry point: the arguments of merge_select, any L
// and C, and `scratch`, Q x merge_select_general_scratch(l, c) bytes of
// global memory when that is not 0, else null (one instantiation; a block
// a query).
extern "C" int merge_select_general(const void* r_d, const void* r_i,
                                    const void* r_e, const void* c_d,
                                    const void* c_i, void* o_d, void* o_i,
                                    void* o_e, void* sel_i, void* sel_v,
                                    void* scratch, int nq, int l, int c,
                                    int expand, void* stream) {
  if (nq < 1 || l < 1 || c < 0 || expand < 1 || expand > l ||
      8ll * l + 16ll * c > INT_MAX ||
      (merge_select_general_scratch(l, c) > 0) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool in_scratch = scratch != nullptr;
  const int bytes = in_scratch ? 0 : general_bytes(l, c);
  using General = void (*)(const float*, const int*, const uint8_t*,
                           const float*, const int*, float*, int*, uint8_t*,
                           int*, uint8_t*, unsigned char*, int, int, int);
  const General kernel = in_scratch ? merge_select_general_kernel<true>
                                    : merge_select_general_kernel<false>;
  if (bytes > kSmallSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<nq, kGenThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r_d), static_cast<const int*>(r_i),
      static_cast<const uint8_t*>(r_e), static_cast<const float*>(c_d),
      static_cast<const int*>(c_i), static_cast<float*>(o_d),
      static_cast<int*>(o_i), static_cast<uint8_t*>(o_e),
      static_cast<int*>(sel_i), static_cast<uint8_t*>(sel_v),
      static_cast<unsigned char*>(scratch), l, c, expand);
  return static_cast<int>(cudaGetLastError());
}
