// The per-query probe path of the CNNS search (models/cnns.py
// _flat_probe_search) on bf16 slabs, in two kernels, for Hopper (sm_90a).
// For each (query q, probe slot j) pair whose cluster c = visit[q, j] is
// live, the distance of the bf16 query row to every live row x of slab c,
//   l2: (cnorms[c, r] - 2 <q, x>) + |q|^2,    ip and cosine: 1 - <q, x>,
// and each query's k smallest over its probed slabs: ascending, equal
// values in the order of (probe slot, row), PAD_DIST / PAD_ID past the
// live rows. It replaces no TPU kernel: the JAX package runs the per-query
// path as XLA gathers and einsums; on the card the plain chain gathered
// every probe slot's slabs ([Q, maxc, d] bf16), upcast them to f32, ran a
// batched f32 product and sorted k + maxc columns a slot.
//
// What bounds it: bytes. A probed slab is maxc x d bf16 (12.6 MB at maxc =
// 2056, d = 3072), one FMA for every 2 bytes of a pair: far below the
// card's ridge, so the design moves only those bytes, once a cluster for
// up to kRunQ of its pairs.
//   * probe_scan_kernel: the pairs sorted by cluster (`order`, one small
//     argsort on the card), so that the pairs of one cluster form a run; a
//     block a (pair, row split), split by split, and the block of a run's
//     1st, (kRunQ + 1)-th, ... pair takes that pair and the next kRunQ - 1
//     of the run, the others returning at once. It streams its rows
//     [r0, r1) of the slab where they lie, once for its pairs, through a
//     3-stage cp.async ring of 16 KB stages ([tr rows x dc] bf16, d taken
//     in chunks of dc <= 1024; the queries' chunks ride in the first stage
//     of each chunk and go to shared memory as f32): no gathered copy and
//     no f32 copy is made. A row is summed by a group of lanes, 16-byte
//     shared loads of the slab against the queries' values, in f32 FMAs
//     of exact bf16 products on the CUDA cores (so a distance differs from
//     the plain one only by the order of its sum, and is the same
//     whichever pairs share the block), the group's sums joined by
//     shuffles; each row's sum stays in shared memory across the d
//     chunks. Then, a pair at a time, each warp keeps the k best of a
//     contiguous run of the rows (k <= 32: the 32 smallest keys across its
//     lanes, each chunk of 32 sorted and merged in by bitonic shuffle
//     networks, the warps' lists then merged pairwise; above,
//     select_topk.cuh's buffers, warp 0 taking the others' lists in warp
//     order), and the item's list goes to scratch.
//   * probe_merge_kernel: a warp a query folds the sorted lists of its
//     pairs' items, in (slot, split) order, into its k best and writes
//     their distances and global ids.
// Keys are (value, slot * maxc + row) (make_key), so equal values keep the
// order of (slot, row), as the plain path's stable running merge does:
// select_topk.cuh keeps ties in buffer order, and every list is appended
// in increasing position. Rows with a PAD id (< 0), PAD slots and
// distances not below PAD_DIST (inf, NaN: the plain merge's k PAD entries
// come first) take no part.

#include "scan_pipeline.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kProbeThreads = 256;
constexpr int kProbeWarps = kProbeThreads / 32;
constexpr int kProbeStages = 3;
constexpr int kStageSlab = 16384;     // slab bytes a ring stage
constexpr int kMaxDc = 1024;          // d a chunk
constexpr int kMaxItemRows = 1024;    // slab rows a work item
constexpr int kItemBytes = 1 << 20;   // slab bytes a work item, at most
constexpr int kListK = 32;            // the lists' k; the buffers take any
constexpr int kMergeWarps = 4;        // queries a merge block
constexpr int kRunQ = 4;              // a run's pairs a block takes
constexpr float kProbePad = 3.4e37f;

// How a block reads the slab at width d: d chunks of dc (a multiple of 8)
// elements, nch 16-byte pieces each; a row's pieces spread over `lanes`
// lanes (a power of two, at most 32; at most 4 pieces a lane), `groups`
// rows a warp at once; tr rows a ring stage, a multiple of the rows the
// block's warps take at once.
struct ProbeLayout {
  int dc, n_dc, nch, lanes, groups, tr;
};

__host__ __device__ ProbeLayout probe_layout(int d) {
  ProbeLayout p;
  const int ld8 = (d + 7) / 8 * 8;
  p.dc = ld8 < kMaxDc ? ld8 : kMaxDc;
  p.n_dc = (d + p.dc - 1) / p.dc;
  p.nch = p.dc / 8;
  p.lanes = 1;
  while (p.lanes < p.nch && p.lanes < 32) p.lanes *= 2;
  p.groups = 32 / p.lanes;
  const int unit = kProbeWarps * p.groups;
  const int fit = kStageSlab / (p.dc * 2) / unit * unit;
  p.tr = fit > unit ? fit : unit;
  return p;
}

// a stage: tr slab rows of the chunk, then kRunQ queries' chunks
__host__ __device__ int probe_stage_bytes(const ProbeLayout& p) {
  return (p.tr + kRunQ) * p.dc * 2;
}

__host__ __device__ int align16(int n) { return (n + 15) / 16 * 16; }

// the rows a warp selects from, in an item of `rows` rows
__host__ __device__ int warp_rows(int rows) {
  return ((rows + kProbeWarps - 1) / kProbeWarps + 31) / 32 * 32;
}

// keys a select_topk buffer of k holds at most, fed `cands` candidates
__host__ __device__ int buf_cap(int k, int cands) {
  return (2 * k < cands ? 2 * k : cands) + 32;
}

size_t probe_smem_bytes(const ProbeLayout& p, int rows, int k) {
  size_t b = static_cast<size_t>(kProbeStages) * probe_stage_bytes(p)
             + static_cast<size_t>(kRunQ) * p.dc * 4
             + align16(kRunQ * rows * 4);
  if (k <= kListK)
    return b + static_cast<size_t>(kProbeWarps) * 32 * 8;
  return b + static_cast<size_t>(buf_cap(k, rows)
                                 + (kProbeWarps - 1) * buf_cap(k, warp_rows(rows)))
                 * 8
         + kProbeWarps * 4;
}

struct ProbeArgs {
  const bf16* q;            // [qn, d]
  const float* qnorm;       // [qn] (l2) or null
  const long long* visit;   // [qn, npr] cluster ids, PAD_ID padded
  const long long* order;   // [qn * npr] the pairs sorted by cluster
  const bf16* slabs;        // [c, maxc, d]
  const int* ids;           // [c, maxc] global ids, PAD_ID padded
  const float* cnorms;      // [c, maxc] (l2) or null: bias 1
  Key* keys;                // [qn * npr * splits, kl] the items' lists
  Key* bufs;                // the merge's buffers in scratch, or null
  float* out_d;             // [qn, k]
  int* out_i;               // [qn, k]
  int qn, npr, c, maxc, d, k, rows, splits, kl;
  float scale;
};

__device__ __forceinline__ void unpack8(uint4 w, float (&v)[8]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __uint_as_float(u[e] << 16);
    v[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
  }
}

// acc + <x, (lo, hi)>, one FMA at a time in element order: x the 8 f32
// values of 8 bf16, lo and hi the query's; a product of two bf16 values is
// exact in f32, so each step is one rounded add, as in the plain product
__device__ __forceinline__ float dot8(const float (&x)[8], float4 lo,
                                      float4 hi, float acc) {
  acc = __fmaf_rn(x[0], lo.x, acc);
  acc = __fmaf_rn(x[1], lo.y, acc);
  acc = __fmaf_rn(x[2], lo.z, acc);
  acc = __fmaf_rn(x[3], lo.w, acc);
  acc = __fmaf_rn(x[4], hi.x, acc);
  acc = __fmaf_rn(x[5], hi.y, acc);
  acc = __fmaf_rn(x[6], hi.z, acc);
  acc = __fmaf_rn(x[7], hi.w, acc);
  return acc;
}

// The warp's 32 keys, one a lane, sorted ascending across the lanes: a
// bitonic network of shuffles.
__device__ __forceinline__ Key sort32(Key x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const Key o = __shfl_xor_sync(kFull, x, stride);
      const bool keep_min = ((lane & size) == 0) == ((lane & stride) == 0);
      x = keep_min == (o < x) ? o : x;
    }
  }
  return x;
}

// The 32 smallest of two ascending lists of 32 keys across the lanes
// (lane i its i-th), ascending: the lane-wise minimum of a and b reversed
// is bitonic, and five shuffle steps sort it.
__device__ __forceinline__ Key merge32(Key a, Key b, int lane) {
  const Key r = __shfl_sync(kFull, b, 31 - lane);
  Key x = r < a ? r : a;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const Key o = __shfl_xor_sync(kFull, x, stride);
    x = ((lane & stride) == 0) == (o < x) ? o : x;
  }
  return x;
}

// Fold one key a lane (kNoKey: none; sorted across the lanes when
// kSorted) into a warp's list of the 32 smallest keys seen (lane i its
// i-th, kNoKey while fewer); bar is the list's k-th key on every lane. A
// chunk with no key below the bar changes nothing.
template <bool kSorted>
__device__ __forceinline__ void fold32(Key& lst, Key& bar, Key key, int k,
                                       int lane) {
  if (!__any_sync(kFull, key < bar)) return;
  lst = merge32(lst, kSorted ? key : sort32(key, lane), lane);
  bar = __shfl_sync(kFull, lst, k - 1);
}

// kJ: the 16-byte pieces of a row chunk a lane takes at most (1 up to
// d = 256, else 4).
template <bool kAsync, bool kGeneral, int kJ>
__global__ void __launch_bounds__(kProbeThreads, kJ == 1 ? 3 : 2)
probe_scan_kernel(const ProbeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // split-major over the pairs sorted by cluster: a run of one cluster's
  // pairs is taken kRunQ pairs a block, by the blocks of its 1st, (kRunQ +
  // 1)-th, ... pair; the others return
  const int n_pairs = a.qn * a.npr;
  const int p0 = blockIdx.x % n_pairs;
  const int split = blockIdx.x / n_pairs;
  const long long pair0 = a.order[p0];
  const long long cid = a.visit[pair0];
  if (cid < 0 || cid >= a.c) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const auto same = [&](int i, long long& pr) {
    pr = i >= 0 && i < n_pairs ? a.order[i] : -1;
    return pr >= 0 && a.visit[pr] == cid;
  };
  // the pairs after p0 in its group, lane g - 1 the (g + 1)-th: the first
  // kRunQ - 1 lanes look ahead
  long long ahead;
  const bool fwd = same(lane < kRunQ - 1 ? p0 + 1 + lane : -1, ahead);
  // where the run starts: 32 pairs back at a time
  int start = p0;
  for (;;) {
    long long unused;
    const unsigned back = __ballot_sync(kFull, same(start - 1 - lane, unused));
    const int n = __ffs(~back) - 1;      // pairs of the run just before
    if (n >= 0) {
      start -= n;
      break;
    }
    start -= 32;
  }
  if ((p0 - start) % kRunQ != 0) return;
  const int m = __ffs(~__ballot_sync(kFull, fwd));   // 1 + pairs ahead
  long long pr[kRunQ];
#pragma unroll
  for (int g = 0; g < kRunQ; ++g)
    pr[g] = g == 0 ? pair0 : __shfl_sync(kFull, ahead, g - 1);

  const ProbeLayout p = probe_layout(a.d);
  const int r0 = split * a.rows;
  const int n_rows = min(a.rows, a.maxc - r0);
  const long long base = cid * a.maxc + r0;       // the item's first row
  const bf16* slab = a.slabs + base * a.d;
  const int stage_b = probe_stage_bytes(p);
  float* qf = reinterpret_cast<float*>(smem + kProbeStages * stage_b);
  float* partial = qf + kRunQ * p.dc;
  Key* lists = reinterpret_cast<Key*>(
      reinterpret_cast<unsigned char*>(partial) + align16(kRunQ * a.rows * 4));
  const int n_tiles = (n_rows + p.tr - 1) / p.tr;
  const int n_steps = n_tiles * p.n_dc;
  const int gran = kAsync ? 16 : row_granule<bf16, bf16>(a.q, a.slabs, a.d);
  const int sub = lane % p.lanes, grp = lane / p.lanes;
  const int units = p.tr / (kProbeWarps * p.groups);
  const int qf_half = p.nch * 4;   // a query's f32 chunk: elements 0-3 of
                                   // each piece, then elements 4-7

  // step s of the ring: d chunk s / n_tiles of row tile s % n_tiles;
  // the first tile of a chunk brings the m queries' chunks too
  int l_step = 0;
  const auto issue = [&]() {
    if (l_step < n_steps) {
      const int c = l_step / n_tiles, t = l_step - c * n_tiles;
      bf16* st = reinterpret_cast<bf16*>(smem + (l_step % kProbeStages)
                                         * stage_b);
      const int col0 = c * p.dc, row0 = t * p.tr;
      const int nr = min(p.tr, n_rows - row0);
      for (int i = tid; i < p.tr * p.nch; i += kProbeThreads) {
        const int r = i / p.nch, col = col0 + (i - r * p.nch) * 8;
        const bool ok = r < nr;
        copy16<kAsync>(st + r * p.dc + (col - col0),
                       slab + static_cast<long long>(ok ? row0 + r : 0)
                                  * a.d + col,
                       ok ? a.d - col : 0, a.slabs, gran);
      }
      if (t == 0)
        for (int i = tid; i < m * p.nch; i += kProbeThreads) {
          const int g = i / p.nch, col = col0 + (i - g * p.nch) * 8;
          long long pg = pr[0];
#pragma unroll
          for (int h = 1; h < kRunQ; ++h) pg = g == h ? pr[h] : pg;
          copy16<kAsync>(st + (p.tr + g) * p.dc + (col - col0),
                         a.q + (pg / a.npr) * a.d + col, a.d - col, a.q,
                         gran);
        }
    }
    cp_async_commit();
    ++l_step;
  };
#pragma unroll
  for (int s = 0; s < kProbeStages - 1; ++s) issue();

  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kProbeStages - 2>();
    __syncthreads();
    issue();
    const int c = s / n_tiles, t = s - c * n_tiles;
    const bf16* st = reinterpret_cast<const bf16*>(
        smem + (s % kProbeStages) * stage_b);
    if (t == 0) {
      // the queries' chunk in f32, de-interleaved so that a quarter
      // warp's 16-byte loads are contiguous
      for (int i = tid; i < m * p.dc; i += kProbeThreads) {
        const int g = i / p.dc, e = i - g * p.dc;
        qf[g * 2 * qf_half + ((e & 7) >> 2) * qf_half + (e >> 3) * 4
           + (e & 3)] = __bfloat162float(st[(p.tr + g) * p.dc + e]);
      }
      __syncthreads();
    }
    for (int u = 0; u < units; ++u) {
      const int r = (u * kProbeWarps + warp) * p.groups + grp;
      const bf16* xr = st + r * p.dc;
      float acc[kRunQ];
#pragma unroll
      for (int g = 0; g < kRunQ; ++g) acc[g] = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int ch = sub + p.lanes * j;
        if (ch < p.nch) {
          float x[8];
          unpack8(*reinterpret_cast<const uint4*>(xr + ch * 8), x);
#pragma unroll
          for (int g = 0; g < kRunQ; ++g) {
            if (g < m) {
              const float* qg = qf + g * 2 * qf_half + ch * 4;
              const float4 lo = *reinterpret_cast<const float4*>(qg);
              const float4 hi =
                  *reinterpret_cast<const float4*>(qg + qf_half);
              acc[g] = dot8(x, lo, hi, acc[g]);
            }
          }
        }
      }
      const int i = t * p.tr + r;
#pragma unroll
      for (int g = 0; g < kRunQ; ++g) {
        if (g < m) {
          for (int off = p.lanes / 2; off > 0; off >>= 1)
            acc[g] += __shfl_xor_sync(kFull, acc[g], off);
          float* pg = partial + g * a.rows;
          if (sub == 0 && i < n_rows)
            pg[i] = c == 0 ? acc[g] : pg[i] + acc[g];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // selection, a pair at a time: warp w takes the rows [b0, b1) in
  // increasing order
  const int rw = warp_rows(n_rows);
  const int b0 = warp * rw, b1 = min(b0 + rw, n_rows);
#pragma unroll 1
  for (int g = 0; g < m; ++g) {
    long long pair = pr[0];
#pragma unroll
    for (int h = 1; h < kRunQ; ++h) pair = g == h ? pr[h] : pair;
    const int q = static_cast<int>(pair / a.npr);
    const int slot = static_cast<int>(pair - static_cast<long long>(q)
                                                 * a.npr);
    const unsigned pos0 = static_cast<unsigned>(slot) * a.maxc + r0;
    const float qn = a.qnorm != nullptr ? a.qnorm[q] : 0.f;
    const float* pg = partial + g * a.rows;
    const auto row_key = [&](int i) -> Key {
      if (i >= b1) return kNoKey;
      const int id = a.ids[base + i];
      const float bias = a.cnorms != nullptr ? a.cnorms[base + i] : 1.f;
      float dist = __fmaf_rn(-a.scale, pg[i], bias);
      if (a.qnorm != nullptr) dist = __fadd_rn(dist, qn);
      return id >= 0 && dist < kProbePad ? make_key(dist, pos0 + i)
                                         : kNoKey;
    };
    Key* out = a.keys + (pair * a.splits + split) * a.kl;
    if constexpr (!kGeneral) {
      Key lst = kNoKey, bar = kNoKey;
      for (int i0 = b0; i0 < b1; i0 += 32)
        fold32<false>(lst, bar, row_key(i0 + lane), a.k, lane);
      // the warps' lists merged pairwise, in three rounds
      lists[warp * 32 + lane] = lst;
      for (int half = 1; half < kProbeWarps; half *= 2) {
        __syncthreads();
        if (warp % (2 * half) == 0) {
          lst = merge32(lst, lists[(warp + half) * 32 + lane], lane);
          lists[warp * 32 + lane] = lst;
        }
      }
      if (warp == 0 && lane < a.kl) out[lane] = lst;
    } else {
      // warp 0's buffer takes every candidate of the item in the end,
      // the others' only their own rows'
      const int cap0 = buf_cap(a.k, a.rows);
      const int capw = buf_cap(a.k, warp_rows(a.rows));
      int* lens = reinterpret_cast<int*>(lists + cap0
                                         + (kProbeWarps - 1) * capw);
      Key* buf = warp == 0 ? lists : lists + cap0 + (warp - 1) * capw;
      int size = 0;
      Key bar = kNoKey;
      for (int i0 = b0; i0 < b1; i0 += 32) {
        const Key key = row_key(i0 + lane);
        warp_push(buf, size, bar, a.k, key, key != kNoKey, lane);
      }
      const int len = min(size, a.k);
      warp_sort_smallest(buf, size, len, lane);
      if (lane == 0) lens[warp] = len;
      __syncthreads();
      if (warp == 0) {
        size = len;
        bar = len == a.k ? buf[a.k - 1] : kNoKey;
        for (int w = 1; w < kProbeWarps; ++w) {
          const Key* bw = lists + cap0 + (w - 1) * capw;
          const int lw = lens[w];
          for (int j0 = 0; j0 < lw; j0 += 32) {
            const int j = j0 + lane;
            warp_push(buf, size, bar, a.k, j < lw ? bw[j] : kNoKey,
                      j < lw, lane);
          }
        }
        const int n = min(size, a.k);
        warp_sort_smallest(buf, size, n, lane);
        for (int j = lane; j < a.kl; j += 32)
          out[j] = j < n ? buf[j] : kNoKey;
      }
    }
    // the next pair's lists wait for these
    __syncthreads();
  }
}

// A warp a query: its items' lists, in (slot, split) order (increasing
// positions), folded into its k best, then their distances and global ids
// (PAD_DIST, PAD_ID past them).
template <bool kGeneral>
__global__ void __launch_bounds__(kMergeWarps * 32)
probe_merge_kernel(const ProbeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kMergeWarps + warp;
  if (q >= a.qn) return;
  const long long* vq = a.visit + static_cast<long long>(q) * a.npr;
  Key lst = kNoKey, bar = kNoKey;
  int size = 0;
  Key* buf = nullptr;
  if constexpr (kGeneral)
    buf = topk_block_bufs(smem, a.bufs, kMergeWarps, a.k)
          + warp * topk_buf(a.k);
  for (int j = 0; j < a.npr; ++j) {
    const long long cid = vq[j];
    if (cid < 0 || cid >= a.c) continue;
    const Key* lists = a.keys + (static_cast<long long>(q) * a.npr + j)
                                    * a.splits * a.kl;
    for (int s = 0; s < a.splits; ++s) {
      const Key* l = lists + static_cast<long long>(s) * a.kl;
      for (int j0 = 0; j0 < a.kl; j0 += 32) {
        const Key key = j0 + lane < a.kl ? l[j0 + lane] : kNoKey;
        // a list is sorted: once no key of a chunk is below the bar, none
        // after it is
        if (!__any_sync(kFull, key < bar)) break;
        if constexpr (kGeneral)
          warp_push(buf, size, bar, a.k, key, key != kNoKey, lane);
        else
          fold32<true>(lst, bar, key, a.k, lane);
      }
    }
  }
  int n = a.k;
  if constexpr (kGeneral) {
    n = min(size, a.k);
    warp_sort_smallest(buf, size, n, lane);
  }
  for (int i = lane; i < a.k; i += 32) {
    Key key = kNoKey;
    if constexpr (kGeneral) key = i < n ? buf[i] : kNoKey;
    else key = lst;
    float dist = kProbePad;
    int id = -1;
    if (key != kNoKey) {
      const unsigned pos = static_cast<unsigned>(key & 0xffffffffu);
      const int slot = static_cast<int>(pos / a.maxc);
      const int row = static_cast<int>(pos - static_cast<unsigned>(slot) * a.maxc);
      dist = key_value(key);
      id = a.ids[vq[slot] * a.maxc + row];
    }
    a.out_d[static_cast<long long>(q) * a.k + i] = dist;
    a.out_i[static_cast<long long>(q) * a.k + i] = id;
  }
}

}  // namespace

// The slab rows of a work item, for `pairs` pairs of slabs of maxc rows of
// width d on a card of `sms` SMs: at most 1024 rows and 1 MiB of slab
// (each item's fixed cost, the ring's start and the selection, stays small
// beside its stream), fewer while there are under 8 items an SM and an
// item keeps 32 rows or more; then evened out over the splits.
extern "C" int probe_scan_rows(int pairs, int maxc, int d, int sms) {
  int rows = kItemBytes / (2 * max(d, 1));
  rows = max(1, min(min(rows, kMaxItemRows), maxc));
  long long splits = (maxc + rows - 1) / rows;
  while (static_cast<long long>(pairs) * splits < 8LL * sms && rows > 32) {
    rows = max(32, rows / 2);
    splits = (maxc + rows - 1) / rows;
  }
  return static_cast<int>((maxc + splits - 1) / splits);
}

// Bytes of global scratch probe_scan needs: the items' lists, and past
// select_topk.cuh's shared memory the merge's buffers (k > 32).
extern "C" long long probe_scan_scratch(int qn, int npr, int maxc, int k,
                                        int rows) {
  const long long splits = (maxc + rows - 1) / rows;
  const long long kl = min(k, rows);
  long long b = static_cast<long long>(qn) * npr * splits * kl * 8;
  if (k > kListK)
    b += topk_scratch_bytes((qn + kMergeWarps - 1) / kMergeWarps,
                            kMergeWarps, k, 0);
  return b;
}

// Plain C entry point (loaded with ctypes). q [qn, d] bf16, qnorm [qn] f32
// or null, visit [qn, npr] int64, order [qn * npr] int64 (a permutation of
// the pairs: the scan's block order), slabs [c, maxc, d] bf16, ids
// [c, maxc] int32, cnorms [c, maxc] f32 or null, out_d [qn, k] f32, out_i
// [qn, k] int32; rows from probe_scan_rows, scratch probe_scan_scratch(...)
// bytes; scale 2 (l2) or 1. Launches both kernels on `stream` without
// synchronising; returns cudaGetLastError() (0 on success).
extern "C" int probe_scan(const void* q, const void* qnorm, const void* visit,
                          const void* order, const void* slabs,
                          const void* ids, const void* cnorms, void* out_d,
                          void* out_i, void* scratch, int qn, int npr, int c,
                          int maxc, int d, int k, int rows, float scale,
                          void* stream) {
  if (qn < 1 || npr < 1 || c < 1 || maxc < 1 || d < 1 || k < 1 || rows < 1 ||
      rows > kMaxItemRows || rows > maxc || scratch == nullptr ||
      static_cast<long long>(npr) * maxc >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (maxc + rows - 1) / rows;
  const long long items = static_cast<long long>(qn) * npr * splits;
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const bool general = k > kListK;
  const long long n_keys = items * min(k, rows);
  const ProbeArgs args{static_cast<const bf16*>(q),
                       static_cast<const float*>(qnorm),
                       static_cast<const long long*>(visit),
                       static_cast<const long long*>(order),
                       static_cast<const bf16*>(slabs),
                       static_cast<const int*>(ids),
                       static_cast<const float*>(cnorms),
                       static_cast<Key*>(scratch),
                       general && topk_needs_scratch(kMergeWarps, k, 0)
                           ? static_cast<Key*>(scratch) + n_keys
                           : nullptr,
                       static_cast<float*>(out_d),
                       static_cast<int*>(out_i),
                       qn,
                       npr,
                       c,
                       maxc,
                       d,
                       k,
                       rows,
                       splits,
                       min(k, rows),
                       scale};
  const auto st = static_cast<cudaStream_t>(stream);
  const bool async = row_granule<bf16, bf16>(q, slabs, d) == 16;
  const ProbeLayout layout = probe_layout(d);
  const bool wide = layout.nch > 32;
  const auto pick = [&](auto j) {
    constexpr int kJ = decltype(j)::value;
    return general ? (async ? probe_scan_kernel<true, true, kJ>
                            : probe_scan_kernel<false, true, kJ>)
                   : (async ? probe_scan_kernel<true, false, kJ>
                            : probe_scan_kernel<false, false, kJ>);
  };
  const auto scan = wide ? pick(std::integral_constant<int, 4>())
                         : pick(std::integral_constant<int, 1>());
  const size_t smem = probe_smem_bytes(layout, rows, k);
  cudaError_t err = cudaFuncSetAttribute(
      scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scan<<<static_cast<unsigned>(items), kProbeThreads, smem, st>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto merge = general ? probe_merge_kernel<true>
                             : probe_merge_kernel<false>;
  const size_t m_smem = general ? topk_smem_bytes(kMergeWarps, k, 0) : 0;
  if (m_smem > 0) {
    err = cudaFuncSetAttribute(merge,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(m_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  merge<<<(qn + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, m_smem,
          st>>>(args);
  return static_cast<int>(cudaGetLastError());
}
