// Per-part exclusive scan in three launches, shared by `expand` (scan of
// the masked degrees) and `compact_capture` (scan of the keep mask).
//
// The reference computes both with one `jnp.cumsum` per part row that XLA
// lowers for the TPU.  On Hopper a row of up to a few million elements is
// scanned by many blocks at once, and blocks cannot carry a sum from one
// to the next, so the scan is split the usual way:
//   1. chunk_sums:    grid (chunks, P) — each block sums one chunk of
//                     kChunk elements of one part (striped loads,
//                     coalesced);
//   2. chunk_offsets: grid (P) — one block per part turns its chunk sums
//                     into exclusive offsets in place and writes the
//                     part's total;
//   3. chunk_apply:   grid (chunks, P) — each block scans its chunk
//                     (cub::BlockScan over a blocked arrangement, so
//                     element order is kept) and hands every element its
//                     exclusive prefix to the caller's `Op`.
// The value of element i of part p is `F(p, i)`, evaluated in phases 1 and
// 3; no per-element scratch array is written.  No atomics: positions come
// from the scan alone, so the result is deterministic and order-stable.
//
// `compact_apply` is the variant for a 0/1 keep mask (compact_capture):
// a row's elements at and past its `extent` are known to be 0 and are
// never read, phase 3 scans only the chunks that hold a kept element and
// hands each kept element its position (`op.kept`), and every position at
// and past the row's total gets the padding (`op.pad`) in striped,
// coalesced order — a chunk with nothing kept costs only that fill.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace nt {
namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kChunk = kThreads * kItems;   // elements one block scans
constexpr int kScanThreads = 1024;
constexpr unsigned kFullMask = 0xffffffffu;

// extent: per row, the elements at and past it are 0 (nullptr: none).
template <class F>
__global__ void __launch_bounds__(kThreads)
chunk_sums_kernel(F f, int n, int nchunks, const int* __restrict__ extent,
                  int* __restrict__ sums) {
  const int c = blockIdx.x, p = blockIdx.y;
  const int base = c * kChunk;
  const int lim = extent ? min(n, extent[p]) : n;
  if (base >= lim) {                  // uniform over the block
    if (threadIdx.x == 0) sums[(size_t)p * nchunks + c] = 0;
    return;
  }
  int acc = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k * kThreads + threadIdx.x;
    if (i < lim) acc += f(p, i);
  }
  using Reduce = cub::BlockReduce<int, kThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  const int s = Reduce(tmp).Sum(acc);
  if (threadIdx.x == 0) sums[(size_t)p * nchunks + c] = s;
}

// The block-prefix callback of cub::BlockScan: called by the first warp
// with the tile's aggregate, returns the prefix of everything before it.
struct RunningPrefix {
  int total;
  __device__ int operator()(int tile_aggregate) {
    const int before = total;
    total += tile_aggregate;
    return before;
  }
};

__global__ void __launch_bounds__(kScanThreads)
chunk_offsets_kernel(int nchunks, int* __restrict__ sums,
                     int* __restrict__ total) {
  const int p = blockIdx.x;
  int* row = sums + (size_t)p * nchunks;
  using Scan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  RunningPrefix prefix{0};
  for (int base = 0; base < nchunks; base += kScanThreads) {
    const int i = base + threadIdx.x;
    int v = i < nchunks ? row[i] : 0;
    Scan(tmp).ExclusiveSum(v, v, prefix);
    __syncthreads();   // tmp is reused by the next tile
    if (i < nchunks) row[i] = v;
  }
  // the callback's state lives in the first warp; thread 0 holds the sum
  if (threadIdx.x == 0) total[p] = prefix.total;
}

template <class F, class Op>
__global__ void __launch_bounds__(kThreads)
chunk_apply_kernel(F f, Op op, int n, int nchunks,
                   const int* __restrict__ offsets) {
  const int c = blockIdx.x, p = blockIdx.y;
  const int base = c * kChunk + threadIdx.x * kItems;
  int val[kItems], pre[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k;
    val[k] = i < n ? f(p, i) : 0;
  }
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  Scan(tmp).ExclusiveSum(val, pre);
  const int off = offsets[(size_t)p * nchunks + c];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k;
    if (i < n) op(p, i, off + pre[k], val[k]);
  }
}

// Phase 3 of compact_apply: offsets are the exclusive chunk offsets of
// phase 2, total each row's kept count.
template <class F, class Op>
__global__ void __launch_bounds__(kThreads)
chunk_compact_kernel(F f, Op op, int n, int nchunks,
                     const int* __restrict__ extent,
                     const int* __restrict__ offsets,
                     const int* __restrict__ total) {
  const int c = blockIdx.x, p = blockIdx.y;
  const int start = c * kChunk, end = min(n, start + kChunk);
  const int kc = total[p];
  const int off = offsets[(size_t)p * nchunks + c];
  const int next = c + 1 < nchunks ? offsets[(size_t)p * nchunks + c + 1]
                                   : kc;
  if (next > off) {                   // uniform: the chunk keeps something
    const int lim = extent ? min(n, extent[p]) : n;
    const int base = start + threadIdx.x * kItems;
    int val[kItems], pre[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = base + k;
      val[k] = i < lim ? f(p, i) : 0;
    }
    using Scan = cub::BlockScan<int, kThreads>;
    __shared__ typename Scan::TempStorage tmp;
    Scan(tmp).ExclusiveSum(val, pre);
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (val[k]) op.kept(p, base + k, off + pre[k]);
  }
  for (int i = max(start, kc) + threadIdx.x; i < end; i += kThreads)
    op.pad(p, i);
}

template <class F>
void scan_sums(F f, int P, int n, int nchunks, const int* extent,
               int* chunk_sums, int* total, cudaStream_t stream) {
  if (nchunks > 0)
    chunk_sums_kernel<<<dim3(nchunks, P), kThreads, 0, stream>>>(
        f, n, nchunks, extent, chunk_sums);
  chunk_offsets_kernel<<<P, kScanThreads, 0, stream>>>(nchunks, chunk_sums,
                                                       total);
}

// The compaction variant (see the top of the file) over P rows of n
// 0/1 elements; extent: P ints or nullptr.
template <class F, class Op>
void compact_apply(F f, Op op, int P, int n, const int* extent,
                   int* chunk_sums, int* total, cudaStream_t stream) {
  if (P <= 0) return;
  const int nchunks = (n + kChunk - 1) / kChunk;
  scan_sums(f, P, n, nchunks, extent, chunk_sums, total, stream);
  if (nchunks > 0)
    chunk_compact_kernel<<<dim3(nchunks, P), kThreads, 0, stream>>>(
        f, op, n, nchunks, extent, chunk_sums, total);
}

// Runs the three phases over P rows of n elements on `stream`.
// chunk_sums: scratch of P * ceil(n / kChunk) ints; total: P ints.
template <class F, class Op>
void scan_apply(F f, Op op, int P, int n, int* chunk_sums, int* total,
                cudaStream_t stream) {
  if (P <= 0) return;
  const int nchunks = (n + kChunk - 1) / kChunk;
  scan_sums(f, P, n, nchunks, nullptr, chunk_sums, total, stream);
  if (nchunks > 0)
    chunk_apply_kernel<<<dim3(nchunks, P), kThreads, 0, stream>>>(
        f, op, n, nchunks, chunk_sums);
}

}  // namespace
}  // namespace nt

extern "C" int nt_scan_chunk();
