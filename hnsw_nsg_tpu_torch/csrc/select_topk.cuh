// The running top-k of grouped_scan.cu's general kernel (k > 32): one
// warp keeps a row's k smallest (value, position) keys (make_key in
// mma_helpers.cuh) and at the end writes them ascending, ties to the
// lower position, as a stable sort of the values would.
//
// The row's candidates arrive 32 at a time, one a lane, in increasing
// position (warp_push). Those below the row's bar are appended to a buffer
// of 2k + 32 keys, in shared memory or, for a large k, in global scratch.
// When more than 2k are held, the k smallest are kept, sorted
// (warp_keep_smallest), and the largest of them becomes the bar, so a row
// sees about k ln(n / k) appends and a few selections, not n. A selection
// is a radix select over the value bits, with the values in registers up
// to 1024 keys (warp_radix_keep). At the end the
// row's k smallest are sorted (warp_sort_smallest): a bitonic network in
// registers up to 1024 keys, else a ranking of each key against the
// others.

// Where the buffers live: a block of `rows` rows puts its rows' buffers in
// dynamic shared memory, ahead of the kernel's own `fixed` bytes, while
// both fit a block's 227 KB; past that they go to global scratch,
// topk_scratch_bytes of it, allocated by the caller, and the kernel's
// shared memory holds only its own bytes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_helpers.cuh"

namespace {

constexpr unsigned kWarpAll = 0xffffffffu;
constexpr size_t kTopkSmemMax = 232448;   // dynamic shared memory a block

// keys in one row's buffer
__host__ __device__ constexpr int topk_buf(int k) { return 2 * k + 32; }

__host__ __device__ constexpr size_t topk_bufs_bytes(int rows, int k) {
  return static_cast<size_t>(rows) * topk_buf(k) * sizeof(Key);
}

inline bool topk_needs_scratch(int rows, int k, size_t fixed) {
  return topk_bufs_bytes(rows, k) + fixed > kTopkSmemMax;
}

// the dynamic shared memory of a block
inline size_t topk_smem_bytes(int rows, int k, size_t fixed) {
  return (topk_needs_scratch(rows, k, fixed) ? 0 : topk_bufs_bytes(rows, k))
         + fixed;
}

// the global scratch of `blocks` blocks: 0 when the buffers fit shared memory
inline long long topk_scratch_bytes(long long blocks, int rows, int k,
                                    size_t fixed) {
  return topk_needs_scratch(rows, k, fixed)
             ? blocks * static_cast<long long>(topk_bufs_bytes(rows, k))
             : 0;
}

// The block's row buffers (row i at bufs + i * topk_buf(k)): in scratch
// when it is given, else at the front of smem.
__device__ __forceinline__ Key* topk_block_bufs(unsigned char* smem,
                                                Key* scratch, int rows,
                                                int k) {
  return scratch != nullptr
             ? scratch + static_cast<long long>(blockIdx.x) * rows
                             * topk_buf(k)
             : reinterpret_cast<Key*>(smem);
}

// Where the kernel's own shared memory starts, as an offset from smem.
__device__ __forceinline__ size_t topk_own_offset(const Key* scratch,
                                                  int rows, int k) {
  return scratch != nullptr ? 0 : topk_bufs_bytes(rows, k);
}

// Sort the warp's 32 kPer keys ascending, key i = v[i % kPer] of lane
// i / kPer: a bitonic network, in registers where a pair lies in one lane
// and by shuffles where it spans two.
template <int kPer>
__device__ __forceinline__ void warp_bitonic_sort(Key (&v)[kPer], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * kPer; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= kPer) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int i = lane * kPer + u;
          const Key o = __shfl_xor_sync(kWarpAll, v[u], stride / kPer);
          // the lower index of a pair keeps the smaller key in an
          // ascending run, the larger in a descending one
          const bool keep_min = ((i & size) == 0) == ((i & stride) == 0);
          v[u] = keep_min == (o < v[u]) ? o : v[u];
        }
      } else {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          if ((u & stride) == 0) {
            const int p = u | stride;
            const bool up = ((lane * kPer + u) & size) == 0;
            const Key a = v[u], b = v[p];
            const bool swap = up == (a > b);
            v[u] = swap ? b : a;
            v[p] = swap ? a : b;
          }
        }
      }
    }
  }
}

// buf[0..n) (k <= n <= 32 kPer) sorted in registers; its k smallest
// written back to buf[0..k).
template <int kPer>
__device__ __noinline__ void warp_sort_keep(Key* buf, int n, int k,
                                            int lane) {
  Key v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = lane * kPer + u;
    v[u] = i < n ? buf[i] : kNoKey;
  }
  warp_bitonic_sort<kPer>(v, lane);
  __syncwarp();
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = lane * kPer + u;
    if (i < k) buf[i] = v[u];
  }
  __syncwarp();
}

// The k smallest of buf[0..n) (n >= k) to buf[0..k), in buffer order;
// returns the largest of them, on every lane. A radix select over the
// value's 32 bits, one bit a pass, finds the k-th smallest value T and how
// many keys of value T belong to the k smallest: the first ones in buffer
// order, which is position order (keys are appended in position order, and
// every step here and in warp_sort_keep keeps equal values so). kPer > 0:
// the values a lane reads (buf[lane + 32 u], u < kPer; n <= 32 kPer) stay
// in registers over the passes; kPer = 0: any n, each pass reads the
// buffer. The k are packed to the front in buffer order (a key only moves
// to a lower index, one that the warp has already read).
template <int kPer>
__device__ __noinline__ Key warp_radix_keep(Key* buf, int n, int k,
                                            int lane) {
  unsigned hv[kPer > 0 ? kPer : 1];
  unsigned t_hi = 0;
  int bit0 = 31;
  if constexpr (kPer > 0) {
    // all ones past n: never counted, since a pass's prefix has a 0 at
    // its bit
    unsigned lo = ~0u, hi = 0u;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = lane + 32 * u;
      hv[u] = j < n ? static_cast<unsigned>(buf[j] >> 32) : ~0u;
      if (j < n) {
        lo = min(lo, hv[u]);
        hi = max(hi, hv[u]);
      }
    }
    // the bits above the highest one where the values differ are every
    // key's: the passes start below them
    lo = __reduce_min_sync(kWarpAll, lo);
    hi = __reduce_max_sync(kWarpAll, hi);
    bit0 = lo == hi ? -1 : 31 - __clz(lo ^ hi);
    t_hi = bit0 < 0 ? lo : bit0 == 31 ? 0u : lo & (~0u << (bit0 + 1));
  }
  int kk = k;
  for (int bit = bit0; bit >= 0; --bit) {
    // keys with the prefix t_hi above `bit` and a 0 at it
    const unsigned sel = (bit == 31 ? 0u : ~0u << (bit + 1)) | (1u << bit);
    int cnt = 0;
    if constexpr (kPer > 0) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) cnt += (hv[u] & sel) == t_hi;
    } else {
      for (int j = lane; j < n; j += 32)
        cnt += (static_cast<unsigned>(buf[j] >> 32) & sel) == t_hi;
    }
    cnt = static_cast<int>(
        __reduce_add_sync(kWarpAll, static_cast<unsigned>(cnt)));
    if (kk > cnt) {
      t_hi |= 1u << bit;
      kk -= cnt;
    }
  }
  int taken = 0, ties = 0;
  Key mx = 0;
  const unsigned lower = (1u << lane) - 1u;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const Key key = j < n ? buf[j] : kNoKey;
    const unsigned hi = static_cast<unsigned>(key >> 32);
    const bool tie = j < n && hi == t_hi;
    const unsigned tie_ball = __ballot_sync(kWarpAll, tie);
    const bool take = (j < n && hi < t_hi) ||
                      (tie && ties + __popc(tie_ball & lower) < kk);
    const unsigned ball = __ballot_sync(kWarpAll, take);
    if (take) {
      buf[taken + __popc(ball & lower)] = key;
      mx = key > mx ? key : mx;
    }
    taken += __popc(ball);
    ties += __popc(tie_ball);
    __syncwarp();
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Key o = __shfl_xor_sync(kWarpAll, mx, off);
    mx = o > mx ? o : mx;
  }
  return mx;
}

// A row's selection: its k smallest of buf[0..n) (n >= k) at buf[0..k),
// the largest of them returned. The radix select; a sort in registers
// measured slower (a 512-key network's shuffles cost more than the passes
// over 16 values a lane).
__device__ __forceinline__ Key warp_keep_smallest(Key* buf, int n, int k,
                                                  int lane) {
  __syncwarp();
  Key kth;
  if (n <= 32 * 8) kth = warp_radix_keep<8>(buf, n, k, lane);
  else if (n <= 32 * 16) kth = warp_radix_keep<16>(buf, n, k, lane);
  else if (n <= 32 * 32) kth = warp_radix_keep<32>(buf, n, k, lane);
  else kth = warp_radix_keep<0>(buf, n, k, lane);
  __syncwarp();
  return kth;
}

// Finish a row: its k smallest of buf[0..n) (n >= k), ascending, at
// buf[0..k). Up to n = 1024 one sort in registers; above, the radix select,
// then each key ranked against the others (k^2 / 32 compares a lane) into
// buf[k..2k) and copied back.
__device__ __forceinline__ void warp_sort_smallest(Key* buf, int n, int k,
                                                   int lane) {
  __syncwarp();
  if (n <= 32 * 8) {
    warp_sort_keep<8>(buf, n, k, lane);
  } else if (n <= 32 * 16) {
    warp_sort_keep<16>(buf, n, k, lane);
  } else if (n <= 32 * 32) {
    warp_sort_keep<32>(buf, n, k, lane);
  } else {
    warp_radix_keep<0>(buf, n, k, lane);
    __syncwarp();
    for (int i = lane; i < k; i += 32) {
      const Key key = buf[i];
      int rank = 0;
      for (int j = 0; j < k; ++j) rank += buf[j] < key;
      buf[k + rank] = key;
    }
    __syncwarp();
    for (int i = lane; i < k; i += 32) buf[i] = buf[k + i];
  }
  __syncwarp();
}

// One candidate a lane, positions increasing with the lane: append those
// below the bar (all valid ones while the buffer holds fewer than k; bar
// starts at kNoKey) and shrink the buffer back to k when it passes 2k.
// size and bar are the same on every lane.
__device__ __forceinline__ void warp_push(Key* buf, int& size, Key& bar,
                                          int k, Key key, bool valid,
                                          int lane) {
  const bool take = valid && key < bar;
  const unsigned ball = __ballot_sync(kWarpAll, take);
  if (take) buf[size + __popc(ball & ((1u << lane) - 1u))] = key;
  size += __popc(ball);
  if (size > 2 * k) {
    bar = warp_keep_smallest(buf, size, k, lane);
    size = k;
  }
}

}  // namespace
