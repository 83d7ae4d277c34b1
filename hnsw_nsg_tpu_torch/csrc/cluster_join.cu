// Cluster join with bucketed top-k, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _join_kernel behind cluster_join_topk
// (hnsw_nsg_tpu/ops/pallas_scan.py:98, pallas_call :203), the kernel of
// the cluster-join kNN-graph builder (models/knn_ivf.py). For cluster c
// and each member row r of qv[c] ([maxc, d]), against the stacked
// candidate slabs stacks[c] ([mm, d]):
//   dist[m] = bias[c, m] - scale * <qv[c, r], stacks[c, m]>
// The mm slots fall into g = mm / group comb buckets, bucket b holding the
// slots {b + e * g : e < group}. Each bucket keeps its minimum, the lowest
// e winning a tie (strict < in increasing e). The k smallest buckets,
// ordered by (value, b) (the first minimum wins, as jnp.argmin), are
// returned as vals [C, maxc, k] and idx = e * g + b. Slots of a bucket
// after its minimum are never returned: this is the TPU kernel's bucket
// rule (pallas_scan.py:129-142), kept because it decides which slots can
// come back. Entries past the finite buckets are (+inf, b) over the
// buckets whose every slot has an infinite bias, lowest b first, as the
// plain version's stable sort returns them; the caller masks them.
//
// One kernel a dtype, each for any 1 <= k <= g, exact products summed in
// f32 as pallas_scan.py:_dots specifies:
//
// bf16 x bf16 (the build path), join_mma_kernel: tensor cores.
//   A block takes one cluster and 128 member rows (64 when k is large, see
//   below) and walks the buckets in tiles of 64. Eight product warps, each
//   a 32-row x (64 / warps across) bucket tile, compute for each bucket
//   tile and each e the products with the stack rows e * g + b0 .. + 63,
//   which stream through a 3-stage cp.async ring (rows padded by 16 bytes,
//   so ldmatrix reads hit distinct banks). When d <= 128 a ring step is
//   the whole of d and each product warp keeps its 32 query rows as mma
//   fragments in registers for the whole run (at 128 rows setmaxnreg
//   moves registers from the heap warps to the product warps); above
//   that (d = 960, gist) the query streams beside the stack in 64-wide d
//   chunks. Products are mma.sync m16n8k16 bf16 -> f32, B (and a streamed
//   A) from ldmatrix, into one of two accumulator sets. The other set,
//   the previous e, is folded meanwhile into per-(row, bucket) running
//   minima and their e, in registers and in the accumulator's own layout
//   (C fragment: row lane / 4 (+ 8), columns 2 (lane % 4) + {0, 1}), so no
//   [rows, g] state exists and the fold runs while the tensor cores work.
//   When a bucket tile is done, only the minima that beat their row's
//   current k-th are staged, and the heap warps, one thread a row, push
//   them into per-row 4-ary max-heaps of packed (value, b, e) keys while
//   the product warps go on with the next tile. A row takes
//   ~k (1 + ln(g / k)) pushes in all (~240 at k = 52, ~410 at k = 102,
//   ~680 at k = 202 at the build shape, for data in random order), not k
//   per tile: a larger k costs pushes, not products. Buckets arrive in
//   increasing b, so a candidate tying the k-th loses, as it must.
//
//   Only the heaps grow with k: 128 rows x k x 8 bytes beside the ring
//   (53 KB) and the candidate buffer (64 KB), which takes the place of the
//   resident query tile once its fragments are in registers (the first
//   candidates are staged after every product warp has passed the first
//   step). So a block takes 128 rows while that fits a block's 227 KB
//   (k <= 110 at d <= 128, k <= 80 above, where the query streams), and 64
//   rows above (the 8 product warps as 2 x 4 of 32 rows x 16 buckets: the
//   same ldmatrix reads for each mma, but each stack tile read for 64
//   rows instead of 128, so twice the ring steps for the same products;
//   heaps of 64 rows up to k = 285 at d <= 128, 279 above). Past that
//   the heaps of 64 rows lie in global scratch that the wrapper
//   allocates, the same code reading and writing them there. Measured at
//   the 1M build shape (PERF.md): k = 102 in 84 ms at 128 rows against
//   136 at 64; k = 202 in 241 ms at 64 rows against 280 at 128 rows with
//   the heaps in global memory. A deeper ring (4 or 5 stages) changed
//   nothing, and queues that let the heap threads run behind the product
//   warps without a barrier a tile were slower at k <= 102.
//
//   What bounds it on the H100: the tensor-core products. Only slots with
//   a finite bias need one: a +inf slot scores +inf whatever its dot. At
//   the 1M build shape (C = 1091, maxc = 2112, M = 8, mm = 16,896,
//   d = 128) every slot is 2 * C * maxc * mm * d = 9.97 TFLOP;
//   chip_smoke.py leaves about 3/4 of the slots finite, so the join needs
//   ~7.5 TFLOP, ~7.6 ms at the 989 TFLOP/s bf16 peak (its input and
//   output take ~1.9 ms at 3.35 TB/s). Measured there (H100 80GB HBM3 at
//   700 W): ~57 ms at k = 52, ~13% of the bound, against ~860 ms for the
//   plain version; without the heap pushes ~47 ms (k = 52), ~56 (k = 102)
//   and ~106 (k = 202, 64 rows): the top-k's serial pushes hold up the
//   tiles as k grows. The kernel makes every product, pad slots included,
//   at ~170 TFLOP/s: mma.sync from 8 warps of 32-row tiles, fed by
//   ldmatrix, stays far below the peak. What is left for a later step,
//   largest first on the real build path: in a 1M build the slabs are
//   ~43% full (1M rows in 1091 slabs of 2112), so skipping the bucket
//   tiles past a stack's fullest slab, and the all-pad row tiles (which
//   needs each cluster's member count), would cut most of the products;
//   then warpgroup wgmma fed by TMA; a top-k whose pushes do not wait on
//   the slowest row of a tile; larger row tiles to cut the L2 traffic
//   (each block reads its cluster's stack once per 128 or 64 rows, ~80 or
//   ~160 GB at that shape).
//
// f32 x f32, join_f32_kernel: exact f32 FMAs on CUDA cores (no TF32, no
//   3xTF32: F-H1), an SGEMM-style register-tiled kernel with the fold and
//   the top-k in its epilogue, at the end of this file with its own notes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_helpers.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemMax = 232448;   // dynamic shared memory a block

enum DType { kF32 = 0, kBF16 = 1 };

// ---- bf16 x bf16: mma.sync tensor cores -------------------------------------

constexpr int kMT = 256;          // 8 product warps
constexpr int kMTB = 64;          // buckets per tile
constexpr int kStages = 3;
constexpr int kBiasVals = kMTB * 2;     // the tile's f32 bias, in bf16 units
constexpr int kMisc = 16;         // ints of block reductions

// One instantiation's shapes. kDC: d values a chunk, 128 when d <= 128
// (one chunk, the query tile resident), else 64 (the query chunk streams
// with the stack). kRowsB: member rows a block, 128 or 64. The 8 product
// warps tile the rows and a bucket tile kWM x kWN, each warp 32 rows x
// kNI * 8 buckets; one heap thread a row.
template <int kDC, int kRowsB>
struct Shape {
  static constexpr int kLd = kDC + 8;          // padded smem row (bf16)
  static constexpr int kSegs = kDC / 8;        // 16-byte copies a row
  static constexpr int kQ = kRowsB * kLd;      // bf16 in a query chunk
  static constexpr int kS = kMTB * kLd;        // bf16 in a stack chunk
  static constexpr bool kResident = kDC == 128;
  static constexpr int kStage = kS + (kResident ? 0 : kQ) + kBiasVals;
  static constexpr int kWM = kRowsB / 32;
  static constexpr int kWN = kMT / 32 / kWM;
  static constexpr int kNI = kMTB / kWN / 8;   // 4 at 128 rows, 2 at 64
  static constexpr int kThreads = kMT + kRowsB;
  // bytes ahead of the ring: the candidate buffer, which shares them with
  // the resident query tile (dead once its fragments are in registers,
  // before the first candidate is staged)
  static constexpr int kCand = kRowsB * kMTB * 8;
  static constexpr int kFront = kResident && kQ * 2 > kCand ? kQ * 2 : kCand;
};

// acc (+)= the product of one d chunk: the warp's 32 rows x kNI * 8
// buckets as 2 x kNI m16n8k16 tiles, kDC / 16 k-steps
template <int kDC, int kNI>
__device__ __forceinline__ void mma_chunk(float (&acc)[2][kNI][4],
                                          uint32_t a_base, uint32_t b_base,
                                          bool first) {
  constexpr int kLd = kDC + 8;
#pragma unroll
  for (int kk = 0; kk < kDC / 16; ++kk) {
    uint32_t a[2][4], b[kNI / 2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], a_base + (mi * 16 * kLd + kk * 16) * 2);
#pragma unroll
    for (int nj = 0; nj < kNI / 2; ++nj)
      ldmatrix_x4(b[nj], b_base + (nj * 16 * kLd + kk * 16) * 2);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const uint32_t b0 = b[ni >> 1][(ni & 1) * 2];
        const uint32_t b1 = b[ni >> 1][(ni & 1) * 2 + 1];
        if (kk == 0 && first) mma_bf16_first(acc[mi][ni], a[mi], b0, b1);
        else mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
  }
}

// acc = the product over the whole of d <= 128, with the A fragments (the
// resident query) in registers
template <int kNI>
__device__ __forceinline__ void mma_chunk_areg(float (&acc)[2][kNI][4],
                                               const uint32_t (&af)[8][2][4],
                                               uint32_t b_base) {
  constexpr int kLd = 128 + 8;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t b[kNI / 2][4];
#pragma unroll
    for (int nj = 0; nj < kNI / 2; ++nj)
      ldmatrix_x4(b[nj], b_base + (nj * 16 * kLd + kk * 16) * 2);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const uint32_t b0 = b[ni >> 1][(ni & 1) * 2];
        const uint32_t b1 = b[ni >> 1][(ni & 1) * 2 + 1];
        if (kk == 0) mma_bf16_first(acc[mi][ni], af[kk][mi], b0, b1);
        else mma_bf16(acc[mi][ni], af[kk][mi], b0, b1);
      }
  }
}

// Fold slot e * g + b into bucket b: strict <, so the lowest e wins. One
// fma: the same value as the plain version's bias - scale * dot whenever
// scale is a power of two (l2: 2, ip: 1), where the product is exact.
// Accumulator entry j of tile (mi, ni) is row mi * 16 + (j / 2) * 8 +
// lane / 4 and bucket ni * 8 + (lane % 4) * 2 + j % 2 of the warp's tile.
// Entry q = (mi * kNI + ni) * 4 + j keeps the e of its minimum in byte j
// of be[mi * kNI + ni]; erep is e in all four bytes.
template <int kNI>
__device__ __forceinline__ void fold(const float (&acc)[2][kNI][4],
                                     float (&bmin)[2][kNI][4],
                                     uint32_t (&be)[2 * kNI],
                                     const float (&bs)[kNI][2], uint32_t erep,
                                     float scale) {
  constexpr uint32_t kSetByte[4] = {0x3214u, 0x3240u, 0x3410u, 0x4210u};
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dist = fmaf(-scale, acc[mi][ni][j], bs[ni][j & 1]);
        if (dist < bmin[mi][ni][j]) {
          bmin[mi][ni][j] = dist;
          be[mi * kNI + ni] = __byte_perm(be[mi * kNI + ni], erep,
                                          kSetByte[j]);
        }
      }
}

// A finished bucket tile (starting at b0): append the minima that beat
// their row's k-th (the heap root, +inf until the heap is full) to the
// row's candidates, one shared atomic per thread and row; reset them.
template <int kNI, int kRowsB>
__device__ __forceinline__ void stage_tile(
    float (&bmin)[2][kNI][4], uint32_t (&be)[2 * kNI], const Key* heap,
    const int* heap_n, Key* cand, int* cand_n, int k, int q_valid, int b0,
    int wm, int wn, int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = wm * 32 + mi * 16 + hr * 8 + (lane >> 2);
      // the bar: the k-th (the root), or any finite value while the heap
      // is not full; rows past maxc take nothing
      const float kth = row >= q_valid ? -INFINITY
                        : heap_n[row] < k ? INFINITY
                                          : key_value(heap[row]);
      unsigned take = 0;
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          take |= static_cast<unsigned>(bmin[mi][ni][hr * 2 + h] < kth)
                  << (ni * 2 + h);
      int slot = take ? atomicAdd(&cand_n[row], __popc(take)) : 0;
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = hr * 2 + h;
          if (take >> (ni * 2 + h) & 1) {
            const int b = b0 + wn * kNI * 8 + ni * 8 + (lane & 3) * 2 + h;
            const int e = (be[mi * kNI + ni] >> (8 * j)) & 0xff;
            cand[slot * kRowsB + row] = make_key(bmin[mi][ni][j], b * 8 + e);
            ++slot;
          }
          bmin[mi][ni][j] = INFINITY;
        }
    }
#pragma unroll
  for (int w = 0; w < 2 * kNI; ++w) be[w] = 0;
}

// the product warps' own barrier (named barrier 1), apart from the heap
// warps; and the hand-over barrier of both roles (named barrier 2)
__device__ __forceinline__ void mma_warps_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kMT) : "memory");
}
template <int kThreads>
__device__ __forceinline__ void hand_over_sync() {
  asm volatile("bar.sync 2, %0;\n" :: "n"(kThreads) : "memory");
}

// the dynamic shared memory of a block; `heaps`: the heaps are in it
template <int kDC, int kRowsB>
size_t mma_smem_bytes(int k, bool heaps) {
  using S = Shape<kDC, kRowsB>;
  return S::kFront + kStages * S::kStage * 2
         + (heaps ? static_cast<size_t>(kRowsB) * k * 8 : 0)
         + kRowsB * 8                            // candidate, heap counts
         + kMisc * 4;
}

// Heaps of kRowsB rows in shared memory, or (kHeapsGlobal) in the
// block's part of `scratch`, kRowsB * k keys.
template <int kDC, int kRowsB, bool kHeapsGlobal>
__global__ void __launch_bounds__(Shape<kDC, kRowsB>::kThreads, 1)
join_mma_kernel(const __nv_bfloat16* __restrict__ qv,
                const __nv_bfloat16* __restrict__ stacks,
                const float* __restrict__ bias, float* __restrict__ vals,
                int* __restrict__ idx, Key* scratch, int maxc, int d, int mm,
                int k, int group, float scale) {
  using S = Shape<kDC, kRowsB>;
  constexpr int kLd = S::kLd;
  constexpr int kNI = S::kNI;
  constexpr int kThreads = S::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  // [the resident query tile, later the candidates][the ring][the heaps]
  // [counts]. A ring stage: the stack chunk, the query chunk when it
  // streams, and the bias of the stage's (tile, e).
  __nv_bfloat16* q_res = reinterpret_cast<__nv_bfloat16*>(smem);
  Key* cand = reinterpret_cast<Key*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + S::kFront);
  Key* after_ring = reinterpret_cast<Key*>(ring + kStages * S::kStage);
  const long long n_keys = static_cast<long long>(kRowsB) * k;
  Key* heap = kHeapsGlobal ? scratch + blockIdx.x * n_keys : after_ring;
  int* cand_n = reinterpret_cast<int*>(kHeapsGlobal ? after_ring
                                                    : after_ring + n_keys);
  int* heap_n = cand_n + kRowsB;   // entries in each row's heap
  int* misc = heap_n + kRowsB;     // [0] the least heap_n; [1..] a warp's

  // a 1-d grid, the row tiles of a cluster next to each other, so that
  // the blocks that read one stack run together
  const int n_row_tiles = (maxc + kRowsB - 1) / kRowsB;
  const int c = blockIdx.x / n_row_tiles;
  const int r0 = (blockIdx.x - c * n_row_tiles) * kRowsB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = mm / group;
  const int n_tiles = (g + kMTB - 1) / kMTB;
  const long long q_row0 = static_cast<long long>(c) * maxc + r0;
  const long long s_row0 = static_cast<long long>(c) * mm;
  const int q_valid = maxc - r0;

  // each row's heap (see heap_push) starts empty
  for (long long i = tid; i < n_keys; i += kThreads) heap[i] = kNoKey;
  for (int i = tid; i < kRowsB; i += kThreads) cand_n[i] = heap_n[i] = 0;
  if (tid == 0) misc[0] = k;
  __syncthreads();

  // Two roles, which meet at two block barriers a bucket tile: (A) the
  // heaps hold every earlier tile, (B) the product warps have staged the
  // tile's candidates. The heap warps then push them while the product
  // warps go on with the next tile.
  if (warp >= kMT / 32) {
    // at 128 rows the heap warpgroup gives registers to the two product
    // warpgroups: 128 x 80 + 256 x 208 <= 384 x 168, the launch's
    // allocation (at 64 rows the product warps need fewer, and the two
    // heap warps are not a warpgroup)
    if constexpr (kRowsB == 128)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n" ::: "memory");
    // heap warps: one thread a row; each push costs O(log k), and only
    // candidates ahead of the root get in. A candidate tying the root
    // loses, as buckets arrive in increasing b (within a tile, (value, p)
    // order decides).
    const int row = tid - kMT;
    Key* h = heap + row;
    int size = 0;
    for (int t = 0; t < n_tiles; ++t) {
      hand_over_sync<kThreads>();   // A
      hand_over_sync<kThreads>();   // B
      const int n = cand_n[row];
      for (int q = 0; q < n; ++q) {
        const Key x = cand[q * kRowsB + row];
        if (size < k) heap_push<kRowsB>(h, size++, x);
        else if (x < h[0]) heap_sift<kRowsB>(h, size, k, x);
      }
      cand_n[row] = 0;
      heap_n[row] = size;
    }
  } else {
    if constexpr (kRowsB == 128)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n" ::: "memory");
    const int wm = warp / S::kWN;   // rows wm * 32 .. + 31
    const int wn = warp % S::kWN;   // buckets wn * kNI * 8 .. of the tile
    const int n_dc = S::kResident ? 1 : (d + kDC - 1) / kDC;
    const int steps = n_tiles * group * n_dc;

    // this thread's 16-byte copies of a chunk: rows c_row + p * kRowStep,
    // columns c_col .. + 7
    constexpr int kRowStep = kMT / S::kSegs;
    constexpr int kSCopies = kMTB / kRowStep;
    constexpr int kQCopies = kRowsB / kRowStep;
    const int c_row = tid / S::kSegs, c_col = (tid % S::kSegs) * 8;
    auto load_query = [&](__nv_bfloat16* dst, int d0) {
#pragma unroll
      for (int p = 0; p < kQCopies; ++p) {
        const int row = c_row + p * kRowStep;
        const bool ok = row < q_valid && d0 + c_col < d;
        cp_async16(smem_addr(dst + row * kLd + c_col),
                   ok ? qv + (q_row0 + row) * d + d0 + c_col : qv,
                   ok ? 16 : 0);
      }
    };

    // the next step to load: chunk l_dc of slot range e * g + l_b0 ..
    int l_dc = 0, l_e = 0, l_b0 = 0, l_stage = 0;
    auto issue = [&]() {
      if (l_b0 < g) {
        __nv_bfloat16* st = ring + l_stage * S::kStage;
        const long long e_row0 = s_row0 + static_cast<long long>(l_e) * g
                                 + l_b0;
        const __nv_bfloat16* src = stacks + (e_row0 + c_row) * d
                                   + l_dc * kDC + c_col;
        const int valid = g - l_b0;
        const bool col_ok = l_dc * kDC + c_col < d;
#pragma unroll
        for (int p = 0; p < kSCopies; ++p) {
          const bool ok = col_ok && c_row + p * kRowStep < valid;
          cp_async16(smem_addr(st + (c_row + p * kRowStep) * kLd + c_col),
                     ok ? src + p * kRowStep * d : stacks, ok ? 16 : 0);
        }
        if (!S::kResident) load_query(st + S::kS, l_dc * kDC);
        if (l_dc == n_dc - 1 && tid < kMTB) {   // the fold's bias, 0 past g
          const bool ok = tid < valid;
          cp_async4(smem_addr(st + S::kS + (S::kResident ? 0 : S::kQ))
                        + tid * 4,
                    ok ? bias + e_row0 + tid : bias, ok ? 4 : 0);
        }
        if (++l_dc == n_dc) {
          l_dc = 0;
          if (++l_e == group) {
            l_e = 0;
            l_b0 += kMTB;
          }
        }
        l_stage = l_stage == kStages - 1 ? 0 : l_stage + 1;
      }
      cp_async_commit();
    };

    if (S::kResident) load_query(q_res, 0);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) issue();

    float acc0[2][kNI][4], acc1[2][kNI][4];   // one set fills, one folds
    uint32_t af[S::kResident ? 8 : 1][2][4];  // the resident query
    float bmin[2][kNI][4];
    uint32_t be[2 * kNI];
    float fb[kNI][2];   // the bias of the e-group waiting for its fold
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        be[mi * kNI + ni] = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) bmin[mi][ni][j] = INFINITY;
      }

    // ldmatrix lane offsets: A rows lane % 16, columns (lane / 16) * 8;
    // B rows (lane / 16) * 8 + lane % 8, columns ((lane / 8) % 2) * 8
    const int a_off = (wm * 32 + (lane & 15)) * kLd + (lane >> 4) * 8;
    const int b_off = (wn * kNI * 8 + ((lane >> 4) << 3) + (lane & 7)) * kLd
                      + ((lane >> 3) & 1) * 8;
    auto hand_over = [&](int tb0) {
      hand_over_sync<kThreads>();   // A
      stage_tile<kNI, kRowsB>(bmin, be, heap, heap_n, cand, cand_n, k,
                              q_valid, tb0, wm, wn, lane);
      hand_over_sync<kThreads>();   // B
    };

    // An e-group's fold waits one step, so that it runs while the next
    // group's products are in the tensor cores.
    int dc = 0, e = 0, b0 = 0, par = 0, stage = 0, fe = 0;
    bool fold_due = false;
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kStages - 2>();
      mma_warps_sync();
      issue();

      const __nv_bfloat16* st = ring + stage * S::kStage;
      const uint32_t a_base = smem_addr(
          (S::kResident ? q_res : st + S::kS) + a_off);
      const uint32_t b_base = smem_addr(st + b_off);
      if constexpr (S::kResident) {
        if (s == 0) {   // the query tile landed with the first stage
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              ldmatrix_x4(af[kk][mi],
                          a_base + (mi * 16 * kLd + kk * 16) * 2);
        }
        if (par) mma_chunk_areg<kNI>(acc1, af, b_base);
        else mma_chunk_areg<kNI>(acc0, af, b_base);
      } else {
        if (par) mma_chunk<kDC, kNI>(acc1, a_base, b_base, dc == 0);
        else mma_chunk<kDC, kNI>(acc0, a_base, b_base, dc == 0);
      }

      if (fold_due) {   // the previous e-group
        if (par) fold<kNI>(acc0, bmin, be, fb, fe * 0x01010101u, scale);
        else fold<kNI>(acc1, bmin, be, fb, fe * 0x01010101u, scale);
        fold_due = false;
        if (fe == group - 1) hand_over(b0 - kMTB);   // a new tile began
      }
      if (dc == n_dc - 1) {   // this e-group's products are all issued
        const float* bias_s = reinterpret_cast<const float*>(
            st + S::kS + (S::kResident ? 0 : S::kQ));
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int bt = wn * kNI * 8 + ni * 8 + (lane & 3) * 2 + h;
            fb[ni][h] = b0 + bt < g ? bias_s[bt] : INFINITY;
          }
        fe = e;
        fold_due = true;
        par ^= 1;
      }
      if (++dc == n_dc) {
        dc = 0;
        if (++e == group) {
          e = 0;
          b0 += kMTB;
        }
      }
      stage = stage == kStages - 1 ? 0 : stage + 1;
    }
    cp_async_wait<0>();
    if (par) fold<kNI>(acc0, bmin, be, fb, fe * 0x01010101u, scale);
    else fold<kNI>(acc1, bmin, be, fb, fe * 0x01010101u, scale);
    hand_over(b0 - kMTB);
  }
  __syncthreads();   // the last tile is in the heaps

  // heap sort each row into ascending (value, b) order; entries past the
  // finite buckets stay empty for now
  if (tid >= kMT) {
    const int row = tid - kMT;
    Key* h = heap + row;
    const int n = heap_n[row];
    for (int size = n; size > 1; --size) {
      const Key top = h[0];
      heap_sift<kRowsB>(h, size - 1, k, h[(size - 1) * kRowsB]);
      h[(size - 1) * kRowsB] = top;
    }
    if (row < q_valid) atomicMin(&misc[0], n);
  }
  __syncthreads();

  // A row with fewer finite buckets than k holds every one of them (its
  // bar was +inf while its heap was not full). Its tail gets the buckets
  // whose every slot has an infinite bias, lowest b first, as (+inf, b):
  // where the plain version's stable sort puts them. Block-uniform.
  const int need = k - misc[0];
  int* warp_n = misc + 1;
  for (int f0 = 0, found = 0; f0 < g && found < need; f0 += kThreads) {
    const int b = f0 + tid;
    bool all_inf = b < g;
    for (int e = 0; e < group && all_inf; ++e)
      all_inf = bias[s_row0 + static_cast<long long>(e) * g + b] == INFINITY;
    const unsigned ball = __ballot_sync(kFull, all_inf);
    if (lane == 0) warp_n[warp] = __popc(ball);
    __syncthreads();
    int rank = found + __popc(ball & ((1u << lane) - 1u));
    for (int w = 0; w < kThreads / 32; ++w) {
      rank += w < warp ? warp_n[w] : 0;
      found += warp_n[w];
    }
    if (all_inf && rank < need) {
      const Key key = make_key(INFINITY, b * 8);
      for (int r = 0; r < kRowsB && r < q_valid; ++r) {
        const int pos = heap_n[r] + rank;
        if (pos < k) heap[static_cast<long long>(pos) * kRowsB + r] = key;
      }
    }
    __syncthreads();   // warp_n is read before the next round writes it
  }

  for (long long i = tid; i < n_keys; i += kThreads) {
    const int row = static_cast<int>(i / k);
    const int j = static_cast<int>(i - static_cast<long long>(row) * k);
    if (row >= q_valid) continue;
    const Key key = heap[static_cast<long long>(j) * kRowsB + row];
    const int p = static_cast<int>(key & 0xffffffffu);
    const long long o = (q_row0 + row) * k + j;
    vals[o] = key == kNoKey ? INFINITY : key_value(key);
    idx[o] = key == kNoKey ? 0 : (p & 7) * g + (p >> 3);
  }
}

template <int kDC, int kRowsB, bool kHeapsGlobal>
int launch_mma(const void* qv, const void* stacks, const void* bias,
               void* vals, void* idx, void* scratch, int n_clusters,
               int maxc, int d, int mm, int k, int group, float scale,
               cudaStream_t st) {
  const auto kernel = join_mma_kernel<kDC, kRowsB, kHeapsGlobal>;
  const size_t smem = mma_smem_bytes<kDC, kRowsB>(k, !kHeapsGlobal);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(n_clusters) * ((maxc + kRowsB - 1) / kRowsB);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), Shape<kDC, kRowsB>::kThreads, smem,
           st>>>(
      static_cast<const __nv_bfloat16*>(qv),
      static_cast<const __nv_bfloat16*>(stacks),
      static_cast<const float*>(bias), static_cast<float*>(vals),
      static_cast<int*>(idx), static_cast<Key*>(scratch), maxc, d, mm, k,
      group, scale);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for (d, k): 128 rows a block while their heaps fit
// shared memory beside the rest, else 64, with the heaps in shared memory
// while they fit, else in global scratch.
struct MmaRoute {
  int rows;
  bool heaps_in_smem;
};
template <int kDC>
MmaRoute mma_route(int k) {
  if (mma_smem_bytes<kDC, 128>(k, true) <= kSmemMax)
    return {128, true};
  return {64, mma_smem_bytes<kDC, 64>(k, true) <= kSmemMax};
}
MmaRoute mma_route(int d, int k) {
  return d <= 128 ? mma_route<128>(k) : mma_route<64>(k);
}

template <int kDC>
int launch_bf16(const void* qv, const void* stacks, const void* bias,
                void* vals, void* idx, void* scratch, int n_clusters,
                int maxc, int d, int mm, int k, int group, float scale,
                cudaStream_t st) {
  const MmaRoute r = mma_route<kDC>(k);
  if (r.heaps_in_smem == (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (r.rows == 128)
    return launch_mma<kDC, 128, false>(qv, stacks, bias, vals, idx, scratch,
                                       n_clusters, maxc, d, mm, k, group,
                                       scale, st);
  if (r.heaps_in_smem)
    return launch_mma<kDC, 64, false>(qv, stacks, bias, vals, idx, scratch,
                                      n_clusters, maxc, d, mm, k, group,
                                      scale, st);
  return launch_mma<kDC, 64, true>(qv, stacks, bias, vals, idx, scratch,
                                   n_clusters, maxc, d, mm, k, group, scale,
                                   st);
}

// ---- f32 x f32: CUDA-core FMAs ---------------------------------------------
//
// join_f32_kernel takes any 1 <= k <= g and any d. A block takes one
// cluster and 128 member rows and walks the buckets in tiles of 128; for
// each tile and each e it forms the 128 x 128 products of the rows with
// the stack rows e * g + b0 .. + 127 the way an SGEMM does: each of the
// 256 threads owns an 8 x 8 register tile (rows ty * 4 + {0..3} and
// 64 + ty * 4 + {0..3}, buckets likewise from tx; a warp is 4 ty x 8 tx,
// so that each of its loads reads at most 128 distinct bytes), whose
// operands it reads as four 16-byte loads a d step from transposed tiles
// ([d][row]) in shared memory: 64 FMAs for 4 loads. The stack streams
// through a 4-stage ring of 16-wide d chunks; cp.async 4-byte copies
// transpose it on the way in (2 stack rows x 64 bytes a warp). When
// d <= 128 the query tile is copied once and stays resident for the
// whole walk; above (d = 960, gist) a query chunk rides in each stage.
// Each sum runs in increasing d, one fmaf at a time from 0 (exact f32
// products, no TF32, no 3xTF32: F-H1), and each distance is rounded as
// bias - scale * dot, so the values are those of the kernel this one
// replaced, bit for bit.
//
// Before the walk a block marks each (tile, e) slice whose 128 bias
// values are not all +inf (one warp a slice, a byte of e bits a tile, up
// to g = 131,072 buckets; past that every slice counts as live). Dead
// slices are skipped: their distances are +inf and can never lower a
// bucket's minimum (strict <, from +inf). Every tile still hands its
// minima on, so an all-+inf bucket comes out as (+inf, b), as it does
// from the plain version.
//
// After a tile's last e, the minima that beat their row's bar (the root
// key of the row's heap, or any key while it holds fewer than k) are
// staged, 16 a row and round, and threads 0..127, one a row, push them
// into per-row 4-ary max-heaps of (value, b * 8 + e) keys. A full key
// compare decides, so the arrival order does not matter: the k smallest
// (value, b) win, ties to the lower b, as the plain version's stable sort
// has them. A row sees about k (1 + ln(g / k)) pushes in all. At the end
// each row is heap sorted in place and the block writes the rows out.
//
// Shared memory: the resident query (66 KB) and the stack ring (35 KB),
// or a ring of both (68 KB); the staged keys (16 KB); bars, counts and
// slice marks (2.5 KB); and the heaps, 128 rows x k keys, while all of it
// fits a block's 227 KB (k <= 107 at d <= 128, k <= 140 above); past
// that the heaps lie in global scratch that the wrapper allocates, the
// same code reading them there. One block an SM: the accumulators, the
// minima and their e take ~140 of a thread's ~235 registers.
//
// What bounds it on the H100: the FP32 pipes, 67 TFLOP/s. At the 1M
// build shape (C = 1091, maxc = 2112, mm = 16,896, d = 128) the finite
// slots need 7.55 TFLOP, 112.6 ms; the kernel also makes the products of
// the padded rows and buckets of partly live slices. Measured there (H100
// 80GB HBM3 at 700 W, PERF.md): 210 / 229 / 264 ms at k = 10 / 52 / 102,
// where the kernel it replaced took 572 / 609 / 639; the products run at
// ~36 TFLOP/s of the finite slots, and the heap pushes, which do not
// overlap them (every thread waits for them at the end of a tile), add
// ~20 ms at k = 52 and ~55 at k = 102.

constexpr int kFThreads = 256;   // 8 warps
constexpr int kFRows = 128;      // member rows a block
constexpr int kFTile = 128;      // buckets a tile
constexpr int kFBK = 16;         // d values a ring stage
constexpr int kFStages = 4;
constexpr int kFLd = 132;        // a transposed tile's padded row (floats)
constexpr int kFResD = 128;      // the query stays resident up to this d
constexpr int kFCap = 16;        // staged keys a row and round
constexpr int kFMaskWords = 256; // slice marks: 4 tiles a word, 8 e bits each

template <bool kResident>
struct F32Shape {
  // a ring stage (floats): the query chunk [kFBK][kFLd] unless resident,
  // the stack chunk [kFBK][kFLd], and the bias of the stage's (tile, e)
  // (written with its last chunk)
  static constexpr int kStage = (kResident ? 1 : 2) * kFBK * kFLd + kFTile;
  static constexpr int kQuery = kResident ? kFResD * kFLd : 0;   // floats
  static constexpr size_t kFixed =
      static_cast<size_t>(kQuery) * 4 + static_cast<size_t>(kFStages) *
      kStage * 4 + static_cast<size_t>(kFCap) * kFRows * 8
      + kFRows * 8 + kFRows * 4 + kFMaskWords * 4;
};

bool f32_heaps_in_smem(int d, int k) {
  const size_t fixed = d <= kFResD ? F32Shape<true>::kFixed
                                   : F32Shape<false>::kFixed;
  return fixed + static_cast<size_t>(kFRows) * k * 8 <= kSmemMax;
}

long long f32_blocks(int n_clusters, int maxc) {
  return static_cast<long long>(n_clusters) * ((maxc + kFRows - 1) / kFRows);
}

// the row (bucket) of register-tile entry [i][.] ([.][i]) of thread ty (tx)
__device__ __forceinline__ int f32_off(int i, int t) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

template <bool kResident, bool kHeapsGlobal>
__global__ void __launch_bounds__(kFThreads, 1)
join_f32_kernel(const float* __restrict__ qv,
                const float* __restrict__ stacks,
                const float* __restrict__ bias, float* __restrict__ vals,
                int* __restrict__ idx, Key* scratch, int maxc, int d, int mm,
                int k, int group, float scale) {
  using S = F32Shape<kResident>;
  extern __shared__ __align__(16) unsigned char smem[];
  // [the resident query][the ring][staged keys][bars][staged counts]
  // [slice marks][the heaps]
  float* q_res = reinterpret_cast<float*>(smem);
  float* ring = q_res + S::kQuery;
  Key* cand = reinterpret_cast<Key*>(ring + kFStages * S::kStage);
  Key* bar = cand + kFCap * kFRows;
  int* cand_n = reinterpret_cast<int*>(bar + kFRows);
  unsigned* live = reinterpret_cast<unsigned*>(cand_n + kFRows);
  Key* heap = kHeapsGlobal
                  ? scratch + static_cast<long long>(blockIdx.x) * kFRows * k
                  : reinterpret_cast<Key*>(live + kFMaskWords);

  // a 1-d grid, the row tiles of a cluster next to each other, so that
  // the blocks that read one stack run together
  const int n_row_tiles = (maxc + kFRows - 1) / kFRows;
  const int c = blockIdx.x / n_row_tiles;
  const int r0 = (blockIdx.x - c * n_row_tiles) * kFRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int g = mm / group;
  const int n_tiles = (g + kFTile - 1) / kFTile;
  const long long q_row0 = static_cast<long long>(c) * maxc + r0;
  const long long s_row0 = static_cast<long long>(c) * mm;
  const int q_valid = min(maxc - r0, kFRows);
  const bool marked = n_tiles <= 4 * kFMaskWords;

  for (int w = tid; w < kFMaskWords; w += kFThreads) live[w] = 0;
  for (int r = tid; r < kFRows; r += kFThreads) {
    bar[r] = kNoKey;
    cand_n[r] = 0;
  }
  if (kResident) {   // the query tile, transposed, zero past d and maxc
    for (int i = tid; i < kFRows * kFResD; i += kFThreads) {
      const int r = i / kFResD, dd = i % kFResD;
      const bool ok = r < q_valid && dd < d;
      cp_async4(smem_addr(q_res + dd * kFLd + r),
                ok ? qv + (q_row0 + r) * d + dd : qv, ok ? 4 : 0);
    }
    cp_async_commit();
  }
  __syncthreads();
  if (marked) {   // a warp a slice: is any of its 128 bias values not +inf
    for (int s = warp; s < n_tiles * group; s += kFThreads / 32) {
      const int t = s / group, e = s - t * group;
      const float* bs = bias + s_row0 + static_cast<long long>(e) * g;
      bool fin = false;
#pragma unroll
      for (int u = 0; u < kFTile / 32; ++u) {
        const int b = t * kFTile + u * 32 + lane;
        fin |= b < g && bs[b] != INFINITY;
      }
      if (__any_sync(kFull, fin) && lane == 0)
        atomicOr(&live[t >> 2], 1u << ((t & 3) * 8 + e));
    }
    __syncthreads();
  }
  // the first live e >= e0 of tile t, or group
  auto live_from = [&](int t, int e0) -> int {
    if (!marked) return e0 < group ? e0 : group;
    const unsigned bits = (live[t >> 2] >> ((t & 3) * 8)) & 0xffu;
    const unsigned rest = bits >> e0;
    const int e = rest ? e0 + __ffs(rest) - 1 : group;
    return e < group ? e : group;
  };

  // The copies run kFStages - 1 chunks ahead of the products, over the
  // same sequence: each tile, its live e, the d chunks of each. This
  // thread copies rows cr + kStep p (member or stack rows) of column cd.
  constexpr int kStep = kFThreads / kFBK;
  const int nd = (d + kFBK - 1) / kFBK;
  const int cr = tid / kFBK, cd = tid % kFBK;
  const long long row_step = static_cast<long long>(kStep) * d;
  const float* q_src = qv + (q_row0 + cr) * d + cd;
  unsigned q_ok = 0;   // bit p: member row cr + kStep p is live
#pragma unroll
  for (int p = 0; p < kFRows / kStep; ++p)
    q_ok |= static_cast<unsigned>(cr + kStep * p < q_valid) << p;
  const uint32_t ring_dst = smem_addr(ring) + (cd * kFLd + cr) * 4;
  constexpr int kSOff = kResident ? 0 : kFBK * kFLd;   // the stack chunk
  constexpr int kBOff = kSOff + kFBK * kFLd;           // the bias
  int p_t = 0, p_e = live_from(0, 0), p_dc = 0, p_stage = 0;
  while (p_e == group && ++p_t < n_tiles) p_e = live_from(p_t, 0);
  auto issue = [&]() {
    if (p_t < n_tiles) {
      const uint32_t dst = ring_dst + p_stage * S::kStage * 4;
      const int d0 = p_dc * kFBK;
      const bool d_ok = d0 + cd < d;
      if (!kResident) {
        const float* src = q_src + d0;
#pragma unroll
        for (int p = 0; p < kFRows / kStep; ++p) {
          const bool ok = d_ok && (q_ok >> p & 1u);
          cp_async4(dst + p * kStep * 4, ok ? src + p * row_step : qv,
                    ok ? 4 : 0);
        }
      }
      const int b0 = p_t * kFTile;
      const long long e_row0 = s_row0 + static_cast<long long>(p_e) * g + b0;
      const float* src = stacks + (e_row0 + cr) * d + d0 + cd;
      const int rows_left = g - b0 - cr;
#pragma unroll
      for (int p = 0; p < kFTile / kStep; ++p) {
        const bool ok = d_ok && kStep * p < rows_left;
        cp_async4(dst + (kSOff + p * kStep) * 4,
                  ok ? src + p * row_step : stacks, ok ? 4 : 0);
      }
      if (p_dc == nd - 1 && tid < kFTile) {   // the fold's bias, 0 past g
        const bool ok = b0 + tid < g;
        cp_async4(smem_addr(ring + p_stage * S::kStage + kBOff + tid),
                  ok ? bias + e_row0 + tid : bias, ok ? 4 : 0);
      }
      if (++p_dc == nd) {
        p_dc = 0;
        p_e = live_from(p_t, p_e + 1);
        while (p_e == group && ++p_t < n_tiles) p_e = live_from(p_t, 0);
      }
      p_stage = p_stage == kFStages - 1 ? 0 : p_stage + 1;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) issue();

  int size = 0;   // threads 0..127: the heap size of row tid
  int c_stage = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int b0 = t * kFTile;
    float bmin[8][8];
    uint32_t be[8];   // the e of bmin[i][j] in bits 4 j .. 4 j + 3
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      be[i] = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) bmin[i][j] = INFINITY;
    }
    for (int e = live_from(t, 0); e < group; e = live_from(t, e + 1)) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      const float* st = ring;
      for (int dc = 0; dc < nd; ++dc) {
        cp_async_wait<kFStages - 2>();
        __syncthreads();   // the stage landed; the one before is free
        issue();
        st = ring + c_stage * S::kStage;
        c_stage = c_stage == kFStages - 1 ? 0 : c_stage + 1;
        const float* as =
            (kResident ? q_res + dc * kFBK * kFLd : st) + ty * 4;
        const float* bs = st + kSOff + tx * 4;
#pragma unroll
        for (int kk = 0; kk < kFBK; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kFLd);
          const float4 a1 =
              *reinterpret_cast<const float4*>(as + kk * kFLd + 64);
          const float4 s0 = *reinterpret_cast<const float4*>(bs + kk * kFLd);
          const float4 s1 =
              *reinterpret_cast<const float4*>(bs + kk * kFLd + 64);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float b[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
      // fold slot e * g + b into bucket b: strict <, so the lowest e
      // wins; no bucket past g
      const float* bias_s = st + kBOff;
      float fb[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int bt = f32_off(j, tx);
        fb[j] = b0 + bt < g ? bias_s[bt] : INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float dist = __fsub_rn(fb[j], __fmul_rn(scale, acc[i][j]));
          if (dist < bmin[i][j]) {
            bmin[i][j] = dist;
            be[i] = (be[i] & ~(0xfu << (4 * j))) |
                    (static_cast<uint32_t>(e) << (4 * j));
          }
        }
    }

    // The tile's minima into the heaps: every bucket (b < g) of every
    // live row, while it beats the row's bar, in rounds of kFCap keys a
    // row.
    uint64_t pend = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (f32_off(i, ty) < q_valid && b0 + f32_off(j, tx) < g)
          pend |= 1ull << (i * 8 + j);
    while (true) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned bits = static_cast<unsigned>(pend >> (i * 8)) & 0xffu;
        if (!bits) continue;
        const int row = f32_off(i, ty);
        const Key b_row = bar[row];
        // no key of a larger value can beat the bar (+inf: any does)
        const float b_val = b_row == kNoKey ? INFINITY : key_value(b_row);
        pend &= ~(static_cast<uint64_t>(bits) << (i * 8));
        Key key[8];
        unsigned take = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          key[j] = 0;
          if ((bits >> j & 1u) && bmin[i][j] <= b_val) {
            key[j] = make_key(bmin[i][j], (b0 + f32_off(j, tx)) * 8 +
                                              ((be[i] >> (4 * j)) & 0xfu));
            take |= static_cast<unsigned>(key[j] < b_row) << j;
          }
        }
        if (!take) continue;
        int slot = atomicAdd(&cand_n[row], __popc(take));
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (take >> j & 1u) {
            if (slot < kFCap) cand[slot * kFRows + row] = key[j];
            else pend |= 1ull << (i * 8 + j);   // the next round
            ++slot;
          }
      }
      const bool more = __syncthreads_or(pend != 0);
      if (tid < kFRows) {
        Key* h = heap + tid;
        const int n = min(cand_n[tid], kFCap);
        for (int s = 0; s < n; ++s) {
          const Key x = cand[s * kFRows + tid];
          if (size < k) heap_push<kFRows>(h, size++, x);
          else if (x < h[0]) heap_sift<kFRows>(h, size, k, x);
        }
        cand_n[tid] = 0;
        bar[tid] = size < k ? kNoKey : h[0];
      }
      __syncthreads();
      if (!more) break;
    }
  }
  cp_async_wait<0>();

  // heap sort each row into ascending (value, b) order; every live row
  // has pushed all g >= k buckets while its heap was not full, so it
  // holds k keys
  if (tid < q_valid) {
    Key* h = heap + tid;
    for (int n = size; n > 1; --n) {
      const Key top = h[0];
      heap_sift<kFRows>(h, n - 1, k, h[(n - 1) * kFRows]);
      h[(n - 1) * kFRows] = top;
    }
  }
  __syncthreads();
  for (int i = tid; i < q_valid * k; i += kFThreads) {
    const int row = i / k;
    const int j = i - row * k;
    const Key key = heap[static_cast<long long>(j) * kFRows + row];
    const int p = static_cast<int>(key & 0xffffffffu);
    const long long o = (q_row0 + row) * k + j;
    vals[o] = key_value(key);
    idx[o] = (p & 7) * g + (p >> 3);
  }
}

template <bool kResident, bool kHeapsGlobal>
int launch_f32_as(const void* qv, const void* stacks, const void* bias,
                  void* vals, void* idx, void* scratch, int n_clusters,
                  int maxc, int d, int mm, int k, int group, float scale,
                  cudaStream_t st) {
  const auto kernel = join_f32_kernel<kResident, kHeapsGlobal>;
  const size_t smem = F32Shape<kResident>::kFixed
                      + (kHeapsGlobal ? 0 : static_cast<size_t>(kFRows) * k * 8);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(f32_blocks(n_clusters, maxc)), kFThreads,
           smem, st>>>(
      static_cast<const float*>(qv), static_cast<const float*>(stacks),
      static_cast<const float*>(bias), static_cast<float*>(vals),
      static_cast<int*>(idx), static_cast<Key*>(scratch), maxc, d, mm, k,
      group, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* qv, const void* stacks, const void* bias,
               void* vals, void* idx, void* scratch, int n_clusters,
               int maxc, int d, int mm, int k, int group, float scale,
               cudaStream_t st) {
  const bool in_smem = f32_heaps_in_smem(d, k);
  if (in_smem == (scratch != nullptr) ||
      f32_blocks(n_clusters, maxc) > INT_MAX ||
      static_cast<long long>(kFRows) * k > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = d <= kFResD
                          ? (in_smem ? launch_f32_as<true, false>
                                     : launch_f32_as<true, true>)
                          : (in_smem ? launch_f32_as<false, false>
                                     : launch_f32_as<false, true>);
  return launch(qv, stacks, bias, vals, idx, scratch, n_clusters, maxc, d,
                mm, k, group, scale, st);
}

}  // namespace

// Plain C entry point (loaded with ctypes), any 1 <= k <= mm / group.
// Pointers are device pointers: qv [C, maxc, d] and stacks [C, mm, d] of
// one dtype (0 f32, 1 bf16), bias [C, mm] f32; outputs vals [C, maxc, k]
// f32 and idx [C, maxc, k] int32, allocated by the caller; `scratch`,
// global memory of cluster_join_scratch(...) bytes when that is not 0,
// else null. bf16 needs d % 8 == 0 and 16-byte aligned qv and stacks
// (the wrapper pads d). Launches on `stream` without
// synchronising and returns the CUDA error of the launch (0 on success).
extern "C" int cluster_join(const void* qv, const void* stacks,
                            const void* bias, void* vals, void* idx,
                            void* scratch, int n_clusters, int maxc, int d,
                            int mm, int k, int group, float scale, int dtype,
                            void* stream) {
  if (n_clusters < 1 || maxc < 1 || d < 1 || mm < 1 || k < 1 || group < 1 ||
      group > 8 || mm % group != 0 || k > mm / group ||
      static_cast<long long>(mm / group) * 8 + 7 > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_f32(qv, stacks, bias, vals, idx, scratch, n_clusters, maxc,
                      d, mm, k, group, scale, st);
  if (dtype != kBF16 || d % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(qv) & 15) ||
      (reinterpret_cast<uintptr_t>(stacks) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  return d <= 128 ? launch_bf16<128>(qv, stacks, bias, vals, idx, scratch,
                                     n_clusters, maxc, d, mm, k, group,
                                     scale, st)
                  : launch_bf16<64>(qv, stacks, bias, vals, idx, scratch,
                                    n_clusters, maxc, d, mm, k, group, scale,
                                    st);
}

// Bytes of global scratch cluster_join needs for this shape: 0 when the
// rows' heaps fit shared memory.
extern "C" long long cluster_join_scratch(int n_clusters, int maxc, int d,
                                          int k, int dtype) {
  if (dtype == kF32)
    return f32_heaps_in_smem(d, k) ? 0
                                : f32_blocks(n_clusters, maxc) * kFRows
                                      * static_cast<long long>(k)
                                      * sizeof(Key);
  const MmaRoute r = mma_route(d, k);
  if (r.heaps_in_smem) return 0;
  return static_cast<long long>(n_clusters) * ((maxc + r.rows - 1) / r.rows)
         * r.rows * static_cast<long long>(k) * sizeof(Key);
}

// Member rows a block of the kernel that cluster_join launches for (d, k,
// dtype): 128 or 64 (bf16), 128 (f32).
extern "C" int cluster_join_rows(int d, int k, int dtype) {
  return dtype == kF32 ? kFRows : mma_route(d, k).rows;
}
