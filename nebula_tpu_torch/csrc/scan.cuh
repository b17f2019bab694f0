// Single-pass chained scan of many rows (decoupled look-back), shared by
// `expand` (the masked degrees → slot starts) and `compact_capture` (the
// keep mask → each kept slot's position).
//
// The reference computes both with one `jnp.cumsum` per part row that XLA
// lowers for the TPU.  On Hopper a row of up to a few million elements is
// scanned by many blocks at once, and a block cannot carry a sum to the
// next one, so each tile publishes its sum for the tiles after it:
//   * A flat grid of tiles of kTile elements over every row (a lane stack's
//     L * P rows included).  A block takes its tile from an atomic ticket,
//     not from blockIdx, so tiles run in ticket order: a tile waits only on
//     tiles that hold earlier tickets, which are resident or done, and the
//     look-back cannot deadlock.
//   * The block loads its tile striped (element k * kThreads + t to thread
//     t: every warp-wide load is coalesced), scans it in registers and
//     shared memory (warp shuffles, then the 128 warp sums), and publishes
//     the tile's sum in an 8-byte status word: flag in the high half,
//     value in the low half, so one load reads both.  The first warp then
//     walks back over its predecessors 32 at a time, adding their sums
//     until it meets one that has published its inclusive prefix, and
//     publishes its own.
//   * The status words and the ticket live in scratch the caller's entry
//     point clears on the stream before every launch
//     (`status_words(rows, n)` of them).
// Positions come from the scan alone, never from atomics on positions, so
// the result is deterministic and order-stable.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nt {
namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;   // elements a tile scans
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

// status word: the flag in the high 32 bits, the value in the low 32
constexpr unsigned long long kAggregate = 1ull << 32;  // the tile's sum
constexpr unsigned long long kInclusive = 2ull << 32;  // the prefix through it

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

struct TileScan {
  int warp_sums[kItems * kWarps];   // (item, warp) order: the tile's order
  int total;
  int prefix;
  int ticket;
};

// Tiles a row of n elements takes: at least one, so that every row's
// tile 0 runs and can write the row's total even when the row is empty.
inline int tiles_per_row(int n) {
  return n > kTile ? (n + kTile - 1) / kTile : 1;
}

// Status words a launch needs for `rows` rows of n elements, the ticket
// last.
inline size_t status_words(long long rows, int n) {
  return (size_t)rows * tiles_per_row(n) + 1;
}

// The block's ticket: the index of its tile in launch order.
__device__ __forceinline__ int take_ticket(unsigned long long* ticket,
                                           TileScan& s) {
  if (threadIdx.x == 0)
    s.ticket = (int)atomicAdd(ticket, 1ull);
  __syncthreads();
  return s.ticket;
}

// v[k] holds the value of tile element k * kThreads + threadIdx.x.  On
// return it holds that element's exclusive prefix within the tile, and
// the tile's sum is returned to every thread.
__device__ __forceinline__ int scan_tile(int (&v)[kItems], TileScan& s) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    int x = v[k];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFullMask, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) s.warp_sums[k * kWarps + w] = x;
    v[k] = x - v[k];
  }
  __syncthreads();
  if (w == 0) {                       // 128 sums, four a lane, in order
    int* a = s.warp_sums + 4 * lane;
    const int x0 = a[0], x1 = a[1], x2 = a[2], x3 = a[3];
    const int sum = x0 + x1 + x2 + x3;
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFullMask, incl, d);
      if (lane >= d) incl += y;
    }
    const int excl = incl - sum;
    a[0] = excl;
    a[1] = excl + x0;
    a[2] = excl + x0 + x1;
    a[3] = excl + x0 + x1 + x2;
    if (lane == 31) s.total = incl;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) v[k] += s.warp_sums[k * kWarps + w];
  return s.total;
}

// The exclusive prefix of tile c of a row, given the tile's sum; `st` is
// the row's status words, one a tile.  Returned to every thread (the call
// ends in a barrier).
__device__ __forceinline__ int tile_prefix(unsigned long long* st, int c,
                                           int sum, TileScan& s) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int excl = 0;
    if (c == 0) {
      if (lane == 0) store_release(st, kInclusive | (unsigned)sum);
    } else {
      if (lane == 0) store_release(st + c, kAggregate | (unsigned)sum);
      for (int end = c - 1;; end -= 32) {
        const int i = end - lane;        // lane 0 the nearest predecessor
        unsigned long long word;
        unsigned ready, incl;
        for (;;) {
          word = i >= 0 ? load_acquire(st + i) : kInclusive;
          ready = __ballot_sync(kFullMask, (word >> 32) != 0);
          incl = __ballot_sync(kFullMask, (word >> 32) == 2);
          // the lanes up to the nearest inclusive prefix must be ready
          const unsigned need =
              incl ? (incl & (0u - incl)) * 2u - 1u : kFullMask;
          if ((ready & need) == need) break;
          __nanosleep(32);
        }
        const int stop = incl ? __ffs(incl) - 1 : 31;
        int x = lane <= stop ? (int)(unsigned)word : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          x += __shfl_xor_sync(kFullMask, x, d);
        excl += x;
        if (incl) break;
      }
      if (lane == 0)
        store_release(st + c, kInclusive | (unsigned)(excl + sum));
    }
    if (lane == 0) s.prefix = excl;
  }
  __syncthreads();
  return s.prefix;
}

// Fill p[0, nbytes) with the byte `pattern` (0x00 or 0xff: the padding
// values 0 and -1 of any word width) using the whole block: 16-byte
// stores over the aligned middle, single bytes at the ragged ends.
__device__ __forceinline__ void block_fill(void* p, size_t nbytes,
                                           int pattern) {
  char* b = static_cast<char*>(p);
  const size_t lead = (16 - ((uintptr_t)b & 15)) & 15;
  const size_t head = lead < nbytes ? lead : nbytes;
  const size_t body = (nbytes - head) / 16;
  const unsigned u = pattern ? 0xffffffffu : 0u;
  const uint4 w = make_uint4(u, u, u, u);
  uint4* v = reinterpret_cast<uint4*>(b + head);
  for (size_t i = threadIdx.x; i < body; i += kThreads) v[i] = w;
  const size_t tail = head + body * 16;
  if (threadIdx.x < head) b[threadIdx.x] = (char)pattern;
  if (threadIdx.x < nbytes - tail) b[tail + threadIdx.x] = (char)pattern;
}

}  // namespace
}  // namespace nt
