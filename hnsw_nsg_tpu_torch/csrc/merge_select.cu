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


// ---- the general kernel: any L and C -----------------------------------------
//
// The kernel above holds the retset ids in a lane's registers, so it is
// compiled per width and stops at L = 1024. This one takes L and C at run
// time (an HNSW search with ef above 1024, a beam whose expand * R passes
// 1024): a block a query, of ceil(max(L, C) / 8) threads rounded up to a
// warp (32 to 1024), so that every thread has work on every step and the
// block is as small as the query allows (L = 2048: 256 threads, L = 1025:
// 160). What bounds it on the H100 is again the instructions a query
// issues and the barriers between its steps, not its bytes; the design
// carries the warp kernel's ideas to a block:
//   * membership: each thread holds a strided share of the retset ids, 8
//     slots i = base + tid + threads * u in registers (retsets past
//     8 x 1024 slots take several such passes), and every candidate id,
//     read four at a time as a shared-memory broadcast, is compared with
//     all 8: C * 8 compares a thread a pass, no exit on the data. A
//     thread's hits of a round of 32 candidates form a bit mask,
//     OR-reduced across the warp and put into a shared C-bit mask with
//     one atomicOr a warp;
//   * repeats: candidate j against the candidates before it; then the
//     kept candidates (live, not in the retset, first of their id) are
//     packed in position order (ballot + per-warp counts + prefix). Only
//     they are ranked and merged, as in the warp kernel, unless a retset
//     dist exceeds PAD_DIST, when all are listed, the dropped masked;
//   * rank by (dist, position) among the kept ones, their slot by a
//     binary search of the retset dists, and the retset slots' by
//     fixed-step binary searches of the sorted kept dists, 8 in step a
//     thread. Dists go straight out; ids and flags to shared memory;
//   * frontier: a block-wide ballot and prefix over the unexpanded
//     slots, read from shared memory, a block of slots a round, stopping
//     after `expand` picks; then ids and flags leave in 16-byte stores.
// Per query 9 L + 20 C bytes of arrays (19 KB at L = 2048, C = 32): in
// shared memory up to the 227 KB a block may have; past that (L ~ 25,000
// at C = 50) the same arrays lie in global scratch that the wrapper
// allocates, Q x merge_select_general_scratch(L, C) bytes, so any L and C
// are taken, the JAX function's contract. The two homes are two
// instantiations, so that the shared-memory one compiles to shared-memory
// loads and stores. Measured at Q = 8192, C = 32 (H100 80GB HBM3 at
// 700 W, PERF.md): 0.112 / 0.177 / 0.356 ms at L = 1025 / 2048 / 4096,
// about half its bytes bound at L >= 2048, where the kernel it replaced
// (a thread a candidate walking the retset) took 0.50 / 0.92 / 1.78.

constexpr int kGenNR = 8;           // retset slots a thread holds at once
constexpr int kGenMaxThreads = 1024;
constexpr int kGenMisc = 64;        // ints: two sets of per-warp counts
constexpr int kGenSmemMax = 232448;

// threads of the block for (l, c)
__host__ __device__ inline int general_threads(int l, int c) {
  const int need = ((l > c ? l : c) + kGenNR - 1) / kGenNR;
  const int t = (need + 31) & ~31;
  return t < 32 ? 32 : t > kGenMaxThreads ? kGenMaxThreads : t;
}

__host__ __device__ inline long long pad16ll(long long bytes) {
  return (bytes + 15) & ~15ll;
}

// bytes of one query's arrays: rd [l] f32, oi [l] i32, oe [l] u8, md,
// mi [c] (as given), kd, ki [c] (the listed ones, packed), sd [c] (their
// dists sorted), hit [ceil(c / 32)] u32
__host__ __device__ inline long long general_bytes(int l, int c) {
  return 2 * pad16ll(4ll * l) + pad16ll(l) + 5 * pad16ll(4ll * c)
         + pad16ll(4ll * ((c + 31) / 32));
}

// (32 registers a thread: a full SM of 2048 threads, 8 queries at
// L = 2048; 0.176 ms at Q = 8192, C = 32, where 49 registers gave 5
// blocks an SM and 0.182)
template <bool kScratch>
__global__ void __launch_bounds__(kGenMaxThreads, 2)
merge_select_general_kernel(
    const float* __restrict__ r_d, const int* __restrict__ r_i,
    const uint8_t* __restrict__ r_e, const float* __restrict__ c_d,
    const int* __restrict__ c_i, float* __restrict__ o_d,
    int* __restrict__ o_i, uint8_t* __restrict__ o_e,
    int* __restrict__ sel_i, uint8_t* __restrict__ sel_v,
    unsigned char* scratch, int l, int c, int expand, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const long long q = blockIdx.x;
  int* misc = reinterpret_cast<int*>(smem);   // [2][32] per-warp counts
  unsigned char* base =
      kScratch ? scratch + q * general_bytes(l, c) : smem + 4 * kGenMisc;
  float* rd = reinterpret_cast<float*>(base);
  int* oi = reinterpret_cast<int*>(base + pad16ll(4ll * l));
  uint8_t* oe = base + 2 * pad16ll(4ll * l);
  float* md = reinterpret_cast<float*>(oe + pad16ll(l));
  int* mi = reinterpret_cast<int*>(md) + pad16ll(4ll * c) / 4;
  float* kd = reinterpret_cast<float*>(mi) + pad16ll(4ll * c) / 4;
  int* ki = reinterpret_cast<int*>(kd) + pad16ll(4ll * c) / 4;
  float* sd = reinterpret_cast<float*>(ki) + pad16ll(4ll * c) / 4;
  unsigned* hit = reinterpret_cast<unsigned*>(sd) + pad16ll(4ll * c) / 4;
  const long long rq = q * l, cq = q * c;
  const int n_words = (c + 31) / 32;
  const int span = kGenNR * nt;   // retset slots a membership pass

  for (int i = tid; i < l; i += nt) rd[i] = r_d[rq + i];
  for (int j = tid; j < c; j += nt) {
    md[j] = c_d[cq + j];
    mi[j] = c_i[cq + j];
  }
  for (int w = tid; w < n_words; w += nt) hit[w] = 0;
  __syncthreads();

  // 1. membership: bit j of hit[] is set when candidate j's id is in the
  // retset (a PAD id may match a PAD slot; it is dropped either way). The
  // last pass's ids and flags stay in registers for step 4 (all of them
  // when one pass covers the retset, L <= 8 x threads).
  int rid[kGenNR];
  unsigned rfl = 0;   // bit u: slot i0 + tid + nt * u was expanded
  for (int i0 = 0; i0 < l; i0 += span) {
    rfl = 0;
#pragma unroll
    for (int u = 0; u < kGenNR; ++u) {
      const int i = i0 + tid + nt * u;
      rid[u] = i < l ? r_i[rq + i] : kPadId;
      rfl |= static_cast<unsigned>(i < l && r_e[rq + i] != 0) << u;
    }
    for (int j0 = 0; j0 < c; j0 += 32) {
      const int t_end = c - j0 < 32 ? c - j0 : 32;
      unsigned mine = 0;   // (the last round's loads may pass c: masked)
#pragma unroll 4
      for (int t = 0; t < t_end; t += 4) {
        const int4 x = *reinterpret_cast<const int4*>(mi + j0 + t);
        bool h0 = false, h1 = false, h2 = false, h3 = false;
#pragma unroll
        for (int u = 0; u < kGenNR; ++u) {
          h0 |= rid[u] == x.x;
          h1 |= rid[u] == x.y;
          h2 |= rid[u] == x.z;
          h3 |= rid[u] == x.w;
        }
        mine |= (static_cast<unsigned>(h0) | static_cast<unsigned>(h1) << 1 |
                 static_cast<unsigned>(h2) << 2 |
                 static_cast<unsigned>(h3) << 3) << t;
      }
      if (t_end < 32) mine &= (1u << t_end) - 1u;
      mine = __reduce_or_sync(kFull, mine);
      if (lane == 0 && mine) atomicOr(&hit[j0 >> 5], mine);
    }
  }
  __syncthreads();

  // 2. keep a candidate if its id is live, not in the retset and the
  // first of its id; list the kept ones (all, the dropped masked, when a
  // retset dist exceeds PAD_DIST: see the warp kernel) in position order
  const bool all_listed = rd[l - 1] > kPadDist;
  int n = 0;   // listed so far, the same on every thread
  for (int j0 = 0; j0 < c; j0 += nt) {
    const int j = j0 + tid;
    bool keep = false, listed = false;
    int id = kPadId;
    float dist = kPadDist;
    if (j < c) {
      id = mi[j];
      dist = md[j];
      keep = id >= 0 && !((hit[j >> 5] >> (j & 31)) & 1u);
      if (keep)
        for (int t = 0; t < j; ++t) keep &= mi[t] != id;
      listed = keep || all_listed;
    }
    const unsigned ball = __ballot_sync(kFull, listed);
    if (lane == 0) misc[warp] = __popc(ball);
    __syncthreads();
    int pos = n + __popc(ball & lower), total = 0;
    for (int w = 0; w < nw; ++w) {
      const int cw = misc[w];
      pos += w < warp ? cw : 0;
      total += cw;
    }
    if (listed) {
      kd[pos] = keep ? dist : kPadDist;
      ki[pos] = keep ? id : kPadId;
    }
    n += total;
    __syncthreads();   // misc is read before the next round writes it
  }

  // 3. the listed candidates: rank by (dist, position), then the merged
  // slot (the retset wins ties, being earlier)
  const int l_top = floor_pow2(l), n_top = floor_pow2(n);
  for (int j = tid; j < n; j += nt) {
    const float v = kd[j];
    int rank = 0;
    for (int t = 0; t < n; ++t) {
      const float w = kd[t];
      rank += (w < v) | ((w == v) & (t < j));
    }
    sd[rank] = v;
    int pos = 0;   // #{i : rd[i] <= v}
    for (int step = l_top; step > 0; step >>= 1) {
      const int t = pos + step;
      pos = (t <= l) & (rd[min(t, l) - 1] <= v) ? t : pos;
    }
    const int p = rank + pos;
    if (p < l) {
      const int id = ki[j];
      o_d[rq + p] = v;
      oi[p] = id;
      oe[p] = id < 0;
    }
  }
  __syncthreads();

  // 4. the retset slots: slot i moves up by #{sd < rd[i]}, the binary
  // searches of a thread's 8 slots in step
  for (int i0 = 0; i0 < l; i0 += span) {
    float v[kGenNR];
    int ahead[kGenNR];
#pragma unroll
    for (int u = 0; u < kGenNR; ++u) {
      const int i = i0 + tid + nt * u;
      v[u] = i < l ? rd[i] : kPadDist;
      ahead[u] = 0;
    }
    for (int step = n_top; step > 0; step >>= 1) {
#pragma unroll
      for (int u = 0; u < kGenNR; ++u) {
        const int t = ahead[u] + step;
        ahead[u] = (t <= n) & (sd[min(t, n) - 1] < v[u]) ? t : ahead[u];
      }
    }
    const bool held = i0 + span >= l;   // the pass whose ids are held
#pragma unroll
    for (int u = 0; u < kGenNR; ++u) {
      const int i = i0 + tid + nt * u;
      const int p = i + ahead[u];
      if (i < l && p < l) {
        const int id = held ? rid[u] : r_i[rq + i];
        const bool ex = held ? (rfl >> u & 1u) : r_e[rq + i] != 0;
        o_d[rq + p] = v[u];
        oi[p] = id;
        oe[p] = ex | (id < 0);
      }
    }
  }
  __syncthreads();

  // 5. frontier: the first `expand` unexpanded slots, in slot order, a
  // block of slots a round (two sets of counts, so one barrier a round)
  int taken = 0;
  for (int s0 = 0, r = 0; s0 < l && taken < expand; s0 += nt, ++r) {
    const int slot = s0 + tid;
    const bool un = slot < l && oe[slot] == 0;
    const unsigned ball = __ballot_sync(kFull, un);
    int* wc = misc + (r & 1) * 32;
    if (lane == 0) wc[warp] = __popc(ball);
    __syncthreads();
    int rank = taken + __popc(ball & lower), total = 0;
    for (int w = 0; w < nw; ++w) {
      const int cw = wc[w];
      rank += w < warp ? cw : 0;
      total += cw;
    }
    if (un && rank < expand) {
      sel_i[q * expand + rank] = oi[slot];
      sel_v[q * expand + rank] = 1;
      oe[slot] = 1;
    }
    taken += total;
  }
  for (int e = (taken < expand ? taken : expand) + tid; e < expand; e += nt) {
    sel_i[q * expand + e] = kPadId;
    sel_v[q * expand + e] = 0;
  }
  __syncthreads();
  if (vec) {
    for (int i = tid * 4; i < l; i += nt * 4) {
      *reinterpret_cast<int4*>(o_i + rq + i) =
          *reinterpret_cast<const int4*>(oi + i);
      *reinterpret_cast<uint32_t*>(o_e + rq + i) =
          *reinterpret_cast<const uint32_t*>(oe + i);
    }
  } else {
    for (int i = tid; i < l; i += nt) {
      o_i[rq + i] = oi[i];
      o_e[rq + i] = oe[i];
    }
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
  const long long bytes = general_bytes(l, c);
  return bytes + 4 * kGenMisc > kGenSmemMax ? bytes : 0;
}

// The general kernel's entry point: the arguments of merge_select, any L
// and C, and `scratch`, Q x merge_select_general_scratch(l, c) bytes of
// global memory when that is not 0, else null (a block a query, of
// general_threads(l, c) threads).
extern "C" int merge_select_general(const void* r_d, const void* r_i,
                                    const void* r_e, const void* c_d,
                                    const void* c_i, void* o_d, void* o_i,
                                    void* o_e, void* sel_i, void* sel_v,
                                    void* scratch, int nq, int l, int c,
                                    int expand, void* stream) {
  if (nq < 1 || l < 1 || c < 0 || expand < 1 || expand > l ||
      general_bytes(l, c) > INT_MAX ||
      (merge_select_general_scratch(l, c) > 0) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool in_scratch = scratch != nullptr;
  const int bytes =
      4 * kGenMisc + (in_scratch ? 0 : static_cast<int>(general_bytes(l, c)));
  using General = void (*)(const float*, const int*, const uint8_t*,
                           const float*, const int*, float*, int*, uint8_t*,
                           int*, uint8_t*, unsigned char*, int, int, int, int);
  const General kernel = in_scratch ? merge_select_general_kernel<true>
                                    : merge_select_general_kernel<false>;
  if (bytes > kSmallSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = l % 4 == 0 && aligned16(o_i) && aligned16(o_e);
  kernel<<<nq, general_threads(l, c), bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r_d), static_cast<const int*>(r_i),
      static_cast<const uint8_t*>(r_e), static_cast<const float*>(c_d),
      static_cast<const int*>(c_i), static_cast<float*>(o_d),
      static_cast<int*>(o_i), static_cast<uint8_t*>(o_e),
      static_cast<int*>(sel_i), static_cast<uint8_t*>(sel_v),
      static_cast<unsigned char*>(scratch), l, c, expand, vec);
  return static_cast<int>(cudaGetLastError());
}
