// The running top-k of grouped_scan.cu's general kernel (k > 32): one
// warp keeps a row's k smallest (value, position) keys (make_key in
// mma_helpers.cuh) and at the end writes them ascending, ties to the
// lower position, as a stable sort of the values would.
//
// The row's candidates arrive 32 at a time, one a lane, in increasing
// position (warp_push). Those below the row's bar are appended to a buffer
// of 2k + 32 keys, in shared memory or, for a large k, in global scratch.
// When more than 2k are held, the k smallest are kept (warp_keep_smallest)
// and the largest of them becomes the bar, so a row sees about k ln(n / k)
// appends and a few selections, not n. A selection:
//   1. a radix select over the value's 32 bits, one bit a pass, finds the
//      k-th smallest value T and how many keys of value T belong to the
//      k smallest: the first ones in buffer order, which is position
//      order, since appends come in position order and step 2 keeps it;
//   2. those k keys are packed to the front of the buffer, in buffer
//      order (a ballot and a prefix count a 32-key step; a key only moves
//      to a lower index, one that the warp has already read).
// At the end each of the k keys is ranked against the others (the keys are
// unique) and handed to emit(rank, key): k^2 / 32 compares a lane.
//
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

// keep the k smallest of buf[0..n) (n >= k) at buf[0..k), in buffer order
__device__ __forceinline__ void warp_keep_smallest(Key* buf, int n, int k,
                                                   int lane) {
  // 1. T: the k-th smallest value's ordered bits; kk: keys of value T
  // among the k smallest
  unsigned t_hi = 0;
  int kk = k;
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned above = bit == 31 ? 0u : ~0u << (bit + 1);
    int cnt = 0;
    for (int j = lane; j < n; j += 32) {
      const unsigned hi = static_cast<unsigned>(buf[j] >> 32);
      cnt += ((hi & above) == t_hi) & !((hi >> bit) & 1u);
    }
    cnt = static_cast<int>(
        __reduce_add_sync(kWarpAll, static_cast<unsigned>(cnt)));
    if (kk > cnt) {
      t_hi |= 1u << bit;
      kk -= cnt;
    }
  }
  // 2. pack them to the front, in buffer order
  int taken = 0, ties = 0;
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
    if (take) buf[taken + __popc(ball & lower)] = key;
    taken += __popc(ball);
    ties += __popc(tie_ball);
    __syncwarp();
  }
}

// The largest of buf[0..k), on every lane.
__device__ __forceinline__ Key warp_max_key(const Key* buf, int k, int lane) {
  Key m = 0;
  for (int j = lane; j < k; j += 32) m = buf[j] > m ? buf[j] : m;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Key o = __shfl_xor_sync(kWarpAll, m, off);
    m = o > m ? o : m;
  }
  return m;
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
    __syncwarp();
    warp_keep_smallest(buf, size, k, lane);
    size = k;
    bar = warp_max_key(buf, k, lane);
    __syncwarp();
  }
}

// Finish a row: its k smallest, ascending, to emit(rank, key).
template <typename Emit>
__device__ __forceinline__ void warp_emit_smallest(Key* buf, int size, int k,
                                                   int lane, Emit emit) {
  __syncwarp();
  if (size > k) warp_keep_smallest(buf, size, k, lane);
  __syncwarp();
  for (int i = lane; i < k; i += 32) {
    const Key key = buf[i];
    int rank = 0;
    for (int j = 0; j < k; ++j) rank += buf[j] < key;
    emit(rank, key);
  }
  __syncwarp();
}

}  // namespace
