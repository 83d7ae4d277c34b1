// The flat router of the CNNS search (models/cnns.py _route_clusters) in
// one kernel, for Hopper (sm_90a): for each query row q of a bf16 batch
// [qn, d] and the flat bf16 representatives r_j [n, d], the n_rep smallest
//   dist_j = bias[j] - scale * <q, r_j>
// as column indices j, in the order of a stable sort of the row: ascending,
// equal values by the lower column, NaN after every number. l2: bias = the
// reps' f32 squared norms, scale = 2; ip and cosine: bias = 1, scale = 1.
// Columns at or past n_real (the reps of slab-count padding clusters) read
// PAD_DIST, 3.4e37, without a product. It replaces no TPU kernel: the JAX
// package routes with an XLA product and approx_max_k; on the card the
// plain chain (an f32 GEMM of the bf16 values, a stable sort of all n
// columns) wrote and sorted a [qn, n] f32 block for every batch.
//
// What bounds it: the product, 2 qn n_real d operations (0.25 ms of bf16
// tensor cores at 8,192 x 4,880 x 3,072). It is the grouped scan's product
// with one slab that every query meets (scan_pipeline.cuh), tiled for
// that: a block takes 128 query rows and a run of 256-column tiles of the
// reps (its split); d streams through a 3-stage cp.async ring of 64-wide
// chunks of both operands, the tail of d and the rows past qn or n
// zero-filled, so any d is taken; 8 warps, 2 x 4, each 64 query rows by 64
// columns on mma.sync m16n8k16 bf16 -> f32 (a product of two bf16 values
// is exact in f32, so only the order of the f32 sum differs from the
// plain version's), one rounding in fmaf(-scale, dot, bias). The reps are
// read at most qn / 128 times, from L2.
//
// Selection in the epilogue, so that the [qn, n] block never leaves the
// chip: a tile's distances go to shared memory a quarter (64 columns) at
// a time, and each query row folds them into its running n_rep best
// (value, column) keys (make_key, mma_helpers.cuh), a warp a row:
//   * n_rep <= 32: a sorted list a row, lane i its i-th key (fold_lists);
//   * n_rep > 32: select_topk.cuh's running buffers (2 n_rep + 32 keys a
//     row, in global scratch), as the scan's general kernels keep them.
// Columns come in increasing order, so equal values keep the lower column.
// With one split the block writes the rows' columns; with several it
// writes each split's sorted keys and a second launch merges them a query
// at a time by the same order. The split count fills the card
// (route_topk_splits).

#include "scan_pipeline.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kQM = 128;          // query rows a block
constexpr int kRN = 256;          // representative columns a tile
constexpr int kQuarter = kRN / 4; // columns a selection pass reads
constexpr int kDK = 64;           // d a ring stage
constexpr int kRStages = 3;
constexpr int kRT = 256;          // 8 warps, 2 x 4 of 64 rows x 64 columns
constexpr int kWarps = kRT / 32;
constexpr int kRowsW = kQM / kWarps;   // rows a warp selects for
constexpr int kGroup = 4;         // rows whose chunks a warp tests at once
// a shared row of a stage, in bf16: 144 bytes, so that ldmatrix's 8 rows
// of 16 bytes and a quarter warp's 16-byte copies lie on distinct banks
constexpr int kLd = kDK + 8;
constexpr int kStageB = (kQM + kRN) * kLd * 2;
constexpr int kDLd = kQuarter + 1;   // f32 a row of the distance quarter
constexpr int kMaxListK = 32;     // the lists' n_rep; the buffers take any
constexpr int kMaxSplits = 64;
constexpr float kPadDist = 3.4e37f;

size_t route_smem_bytes(bool general, int k) {
  return static_cast<size_t>(kRStages) * kStageB        // the ring
         + static_cast<size_t>(kQM) * kDLd * 4           // the distances
         + (general ? static_cast<size_t>(kQM) * 12      // bars and sizes
                    : static_cast<size_t>(kQM) * k * 8);  // the lists
}

struct RouteArgs {
  const bf16* q;
  const bf16* reps;
  const float* bias;
  long long* out;   // [qn, k] columns, with one split
  Key* keys;        // [splits, k, qn] sorted keys, with several; else null
  Key* bufs;        // n_rep > 32: the rows' buffers; else null
  int qn, d, n_real, n_cols, k, tiles_per_split;
  float scale;
};

__device__ __forceinline__ long long key_column(Key key) {
  return key == kNoKey ? -1 : static_cast<long long>(key & 0xffffffffu);
}

// n_rep <= 32: fold a quarter's live columns (nq, the first c0) into the
// sorted lists of the warp's rows r = warp + 8 i, kept in lists[r * k ..]
// (ascending keys, kNoKey while a row has fewer than k). The rows go
// kGroup at a time: first each chunk of 32 columns of the group is tested
// against its row's k-th key, together; then, a row at a time, the keys
// below it enter the row's list in registers (lane i its i-th key) at
// their rank, the keys after it moving up a lane and the k-th leaving. The
// next key is read while one enters.
__device__ __forceinline__ void fold_lists(Key* lists, const float* dist,
                                           int warp, int lane, int n_rows,
                                           int c0, int nq, int k) {
  for (int g = 0; g < kRowsW; g += kGroup) {
    unsigned long long mask[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int r = warp + kWarps * (g + i);
      // no key is below 0: rows past the batch take nothing
      const Key bar = r < n_rows ? lists[r * k + k - 1] : 0;
      mask[i] = 0;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = c * 32 + lane;
        const Key key = j < nq ? make_key(dist[r * kDLd + j], c0 + j) : kNoKey;
        mask[i] |= static_cast<unsigned long long>(
                       __ballot_sync(kFull, key < bar)) << (32 * c);
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      unsigned long long m = mask[i];
      if (m == 0) continue;
      const int r = warp + kWarps * (g + i);
      const float* dr = dist + r * kDLd;
      Key lst = lane < k ? lists[r * k + lane] : kNoKey;
      int j = __ffsll(static_cast<long long>(m)) - 1;
      m &= m - 1;
      Key x = make_key(dr[j], c0 + j);
      while (true) {
        const int jn = __ffsll(static_cast<long long>(m)) - 1;
        m &= m - 1;
        const Key xn = make_key(dr[jn & (kQuarter - 1)],
                                c0 + (jn & (kQuarter - 1)));
        const int p = __popc(__ballot_sync(kFull, lane < k && lst < x));
        const Key up = __shfl_up_sync(kFull, lst, 1);
        if (p < k) lst = lane == p ? x : lane > p ? up : lst;
        if (jn < 0) break;
        x = xn;
      }
      if (lane < k) lists[r * k + lane] = lst;
    }
  }
}

template <bool kAsync, bool kGeneral>
__global__ void __launch_bounds__(kRT, 1) route_topk_kernel(const RouteArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* dist_s = reinterpret_cast<float*>(smem + kRStages * kStageB);
  // lists: key i of row r at sel_s[r * k + i]; buffers: the row's bar
  Key* sel_s = reinterpret_cast<Key*>(dist_s + kQM * kDLd);
  int* size_s = reinterpret_cast<int*>(sel_s + kQM);   // buffers: sizes
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int row0 = blockIdx.y * kQM;
  const int n_rows = min(kQM, a.qn - row0);
  const int k = a.k;
  const int n_tiles = (a.n_cols + kRN - 1) / kRN;
  const int t_begin = blockIdx.x * a.tiles_per_split;
  const int t_end = min(t_begin + a.tiles_per_split, n_tiles);
  const int n_dc = (a.d + kDK - 1) / kDK;
  const int gran = kAsync ? 16 : row_granule<bf16, bf16>(a.q, a.reps, a.d);
  Key* bufs = nullptr;
  if constexpr (kGeneral)
    bufs = a.bufs + (static_cast<long long>(blockIdx.y) * gridDim.x
                     + blockIdx.x) * kQM * topk_buf(k);
  // the ring steps of tile t: its d chunks, or one step without loads or
  // products for a tile of padding columns only (all PAD_DIST)
  const auto chunks = [&](int t) { return t * kRN < a.n_real ? n_dc : 1; };

  if constexpr (kGeneral) {
    if (tid < kQM) {
      sel_s[tid] = kNoKey;
      size_s[tid] = 0;
    }
  } else {
    for (int i = tid; i < kQM * k; i += kRT) sel_s[i] = kNoKey;
  }

  // this thread's 16-byte pieces of a stage: rows c_row + kPass i of the
  // queries and of the reps, elements c_el .. + 7 of the d chunk
  constexpr int kPass = kRT / (kDK / 8);   // rows a pass of the threads
  const int c_row = tid / (kDK / 8), c_el = (tid % (kDK / 8)) * 8;
  int l_t = t_begin, l_dc = 0, l_stage = 0;   // the next step to load
  const auto issue = [&]() {
    if (l_t < t_end) {
      if (l_t * kRN < a.n_real) {
        bf16* as = reinterpret_cast<bf16*>(smem + l_stage * kStageB);
        bf16* bs = as + kQM * kLd;
        const int col = l_dc * kDK + c_el;
#pragma unroll
        for (int i = 0; i < kQM / kPass; ++i) {
          const int r = c_row + kPass * i;
          const bool ok = r < n_rows;
          copy16<kAsync>(as + r * kLd + c_el,
                         a.q + static_cast<long long>(ok ? row0 + r : 0) * a.d
                             + col,
                         ok ? a.d - col : 0, a.q, gran);
        }
#pragma unroll
        for (int i = 0; i < kRN / kPass; ++i) {
          const int r = c_row + kPass * i;
          const int j = l_t * kRN + r;
          const bool ok = j < a.n_cols;
          copy16<kAsync>(bs + r * kLd + c_el,
                         a.reps + static_cast<long long>(ok ? j : 0) * a.d
                             + col,
                         ok ? a.d - col : 0, a.reps, gran);
        }
      }
      if (++l_dc == chunks(l_t)) {
        l_dc = 0;
        ++l_t;
      }
      l_stage = l_stage == kRStages - 1 ? 0 : l_stage + 1;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kRStages - 1; ++s) issue();

  // ldmatrix lane offsets: A rows lane % 16, d (lane / 16) * 8; B rows
  // (lane / 16) * 8 + lane % 8, d ((lane / 8) % 2) * 8
  const int a_off = (wm * 64 + (lane & 15)) * kLd + (lane >> 4) * 8;
  const int b_off = kQM * kLd
                    + (wn * 64 + ((lane >> 4) << 3) + (lane & 7)) * kLd
                    + ((lane >> 3) & 1) * 8;
  float acc[4][8][4];
  int t = t_begin, dc = 0, stage = 0;
  while (t < t_end) {
    cp_async_wait<kRStages - 2>();
    __syncthreads();
    issue();
    if (dc == 0) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
    }
    if (t * kRN < a.n_real) {
      const bf16* st = reinterpret_cast<const bf16*>(smem + stage * kStageB);
      const uint32_t a_base = smem_addr(st + a_off);
      const uint32_t b_base = smem_addr(st + b_off);
#pragma unroll
      for (int kk = 0; kk < kDK / 16; ++kk) {
        uint32_t af[4][4], bq[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldmatrix_x4(af[mi], a_base + (mi * 16 * kLd + kk * 16) * 2);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          ldmatrix_x4(bq[nj], b_base + (nj * 16 * kLd + kk * 16) * 2);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) {
            mma_bf16(acc[mi][2 * nj], af[mi], bq[nj][0], bq[nj][1]);
            mma_bf16(acc[mi][2 * nj + 1], af[mi], bq[nj][2], bq[nj][3]);
          }
      }
    }

    if (++dc == chunks(t)) {
      // acc[mi][ni][hr * 2 + h]: query row wm * 64 + mi * 16 + hr * 8 +
      // lane / 4, column wn * 64 + ni * 8 + (lane % 4) * 2 + h of the
      // tile: the warps of wn == quarter hold the quarter's 64 columns
      const int c0 = t * kRN;
      const int n = min(kRN, a.n_cols - c0);
      for (int quarter = 0; quarter < 4; ++quarter) {
        const int q0 = c0 + quarter * kQuarter;
        if (wn == quarter) {
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int cl = ni * 8 + (lane & 3) * 2 + h;
              const bool real = q0 + cl < a.n_real;
              const float b = real ? __ldg(a.bias + q0 + cl) : 0.f;
#pragma unroll
              for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                  const int r = wm * 64 + mi * 16 + hr * 8 + (lane >> 2);
                  dist_s[r * kDLd + cl] =
                      real ? __fmaf_rn(-a.scale, acc[mi][ni][hr * 2 + h], b)
                           : kPadDist;
                }
            }
        }
        __syncthreads();
        // each warp folds the quarter's live columns into its rows' best
        const int nq = min(kQuarter, n - quarter * kQuarter);
        if (nq > 0) {
          if constexpr (kGeneral) {
            for (int r = warp; r < n_rows; r += kWarps) {
              const float* dr = dist_s + r * kDLd;
              Key* buf = bufs + static_cast<long long>(r) * topk_buf(k);
              int size = size_s[r];
              Key bar = sel_s[r];
              for (int j0 = 0; j0 < nq; j0 += 32) {
                const int j = j0 + lane;
                warp_push(buf, size, bar, k,
                          make_key(j < nq ? dr[j] : 0.f, q0 + j), j < nq,
                          lane);
              }
              if (lane == 0) {
                size_s[r] = size;
                sel_s[r] = bar;
              }
            }
          } else {
            fold_lists(sel_s, dist_s, warp, lane, n_rows, q0, nq, k);
          }
        }
        // the next quarter's writes wait for these reads; the next
        // tile's ring barrier orders its first quarter after the last
        if (quarter < 3) __syncthreads();
      }
      dc = 0;
      ++t;
    }
    stage = stage == kRStages - 1 ? 0 : stage + 1;
  }
  cp_async_wait<0>();
  __syncthreads();

  // each row's n_rep best, ascending: to the output (one split) or to
  // this split's keys; a split with fewer live columns than n_rep pads
  // with kNoKey (never taken by the merge, which has n_rep real ones)
  const auto emit = [&](int r, int j, Key key) {
    if (a.keys != nullptr)
      a.keys[(static_cast<long long>(blockIdx.x) * k + j) * a.qn + row0 + r] =
          key;
    else
      a.out[static_cast<long long>(row0 + r) * k + j] = key_column(key);
  };
  if constexpr (kGeneral) {
    for (int r = warp; r < n_rows; r += kWarps) {
      Key* buf = bufs + static_cast<long long>(r) * topk_buf(k);
      const int size = size_s[r];
      for (int i = size + lane; i < k; i += 32) buf[i] = kNoKey;
      warp_sort_smallest(buf, max(size, k), k, lane);
      for (int i = lane; i < k; i += 32) emit(r, i, buf[i]);
    }
  } else {
    for (int i = tid; i < k * kQM; i += kRT) {
      const int j = i / kQM, r = i - j * kQM;
      if (r < n_rows) emit(r, j, sel_s[r * k + j]);
    }
  }
}

// The splits' sorted keys [splits, k, qn] of each query merged into its k
// smallest columns, ascending: a thread a query, the lists' heads in
// registers.
__global__ void __launch_bounds__(128)
route_merge_kernel(const Key* __restrict__ keys, long long* __restrict__ out,
                   int qn, int k, int splits) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= qn) return;
  int pos[kMaxSplits];
  Key head[kMaxSplits];
  for (int s = 0; s < splits; ++s) {
    pos[s] = 0;
    head[s] = keys[static_cast<long long>(s) * k * qn + q];
  }
  for (int j = 0; j < k; ++j) {
    int best = 0;
    for (int s = 1; s < splits; ++s)
      if (head[s] < head[best]) best = s;
    out[static_cast<long long>(q) * k + j] = key_column(head[best]);
    const int p = ++pos[best];
    head[best] = p < k ? keys[(static_cast<long long>(best) * k + p) * qn + q]
                       : kNoKey;
  }
}

int col_tiles(int n_cols) { return (n_cols + kRN - 1) / kRN; }

}  // namespace

// The split count of a launch over qn queries and n_cols columns on a card
// of `sms` SMs (one block an SM): of 1 to min(tiles, 64) splits that each
// get a tile, the one whose waves of blocks times the tiles of a split,
// plus one for a block's own start and end, is least; the fewest on a tie.
extern "C" int route_topk_splits(int qn, int n_cols, int sms) {
  const long long row_tiles = (qn + kQM - 1) / kQM;
  const int tiles = col_tiles(n_cols);
  sms = max(sms, 1);
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= tiles && s <= kMaxSplits; ++s) {
    const int tps = (tiles + s - 1) / s;
    if ((tiles + tps - 1) / tps != s) continue;   // a split without a tile
    const long long cost = (row_tiles * s + sms - 1) / sms * (tps + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  return best;
}

// Bytes of global scratch route_topk needs: the splits' keys (more than
// one split) and the rows' buffers (n_rep > 32).
extern "C" long long route_topk_scratch(int qn, int n_cols, int k,
                                        int splits) {
  const long long row_tiles = (qn + kQM - 1) / kQM;
  return (splits > 1 ? static_cast<long long>(splits) * k * qn * 8 : 0)
         + (k > kMaxListK
                ? row_tiles * splits * kQM * static_cast<long long>(topk_buf(k))
                      * 8
                : 0);
}

// Plain C entry point (loaded with ctypes). q [qn, d] and reps [>= n_cols,
// d] bf16, bias [>= n_cols] f32, out [qn, k] int64 (the columns); columns
// n_real .. n_cols - 1 read PAD_DIST and those past n_cols are not taken,
// so the caller passes n_cols = min(n, n_real + k). scratch:
// route_topk_scratch(...) bytes, or null when that is 0. Launches on
// `stream` without synchronising; returns cudaGetLastError() (0 on
// success).
extern "C" int route_topk(const void* q, const void* reps, const void* bias,
                          void* out, void* scratch, int qn, int d, int n_real,
                          int n_cols, int k, int splits, float scale,
                          void* stream) {
  const int tiles = col_tiles(n_cols);
  if (qn < 1 || d < 1 || n_cols < 1 || k < 1 || k > n_cols || n_real < 0 ||
      n_real > n_cols || splits < 1 || splits > kMaxSplits || splits > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tps = (tiles + splits - 1) / splits;
  if ((tiles + tps - 1) / tps != splits ||
      (scratch == nullptr) != (route_topk_scratch(qn, n_cols, k, splits) == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool general = k > kMaxListK;
  Key* keys = splits > 1 ? static_cast<Key*>(scratch) : nullptr;
  Key* bufs = general ? static_cast<Key*>(scratch)
                            + (splits > 1 ? static_cast<long long>(splits) * k
                                                * qn
                                          : 0)
                      : nullptr;
  const RouteArgs args{static_cast<const bf16*>(q),
                       static_cast<const bf16*>(reps),
                       static_cast<const float*>(bias),
                       static_cast<long long*>(out),
                       keys,
                       bufs,
                       qn,
                       d,
                       n_real,
                       n_cols,
                       k,
                       tps,
                       scale};
  const bool async = row_granule<bf16, bf16>(q, reps, d) == 16;
  const auto kern = general ? (async ? route_topk_kernel<true, true>
                                     : route_topk_kernel<false, true>)
                            : (async ? route_topk_kernel<true, false>
                                     : route_topk_kernel<false, false>);
  const size_t smem = route_smem_bytes(general, k);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(splits, (qn + kQM - 1) / kQM), kRT, smem, st>>>(args);
  if (splits > 1)
    route_merge_kernel<<<(qn + 127) / 128, 128, 0, st>>>(
        keys, static_cast<long long*>(out), qn, k, splits);
  return static_cast<int>(cudaGetLastError());
}
