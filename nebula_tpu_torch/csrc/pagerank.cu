// pagerank_step — one PageRank iteration over destination-sorted edges
// (Queue B K12).
//
// Replaces nebula_tpu/algo/kernels.py:pagerank_step (:49), which computes
//     contrib = rank[esrc] * out_inv_e            (E edges, sorted by dst)
//     acc[v]  = sum of contrib over [starts[v], starts[v+1])
//     base    = (1 - d + d * sum(rank[dangling])) / n
//     new     = vmask ? base + d * acc : 0
//     delta   = sum |new - rank|,  active = count(|new - rank| > tol)
// in float64, the segment sums as differences of one inclusive cumsum.
//
// Two hazards shape the design.
//  * Determinism: the reference promises bit-identical ranks from run to
//    run, so no float atomics anywhere.  Every sum runs in an order fixed
//    by the shapes alone: block reductions and scans (cub, fixed trees),
//    partials combined in ascending tile or block order.
//  * Load balance: the destination Zipf tail gives one vertex about 2M
//    in-edges of 30M, so a warp or block per destination would be set by
//    that one row.  The work is partitioned by edges instead, in fixed
//    tiles of kTile edges, and each segment is summed directly (not as a
//    difference of two entries of an E-long float64 cumsum, which would
//    write and re-read 8 bytes per edge and carry the cumsum's rounding,
//    about 1e-16 per edge, into every vertex's sum).  Each tile reduces
//    the runs of equal destination it holds with one segmented block scan.
//    The run at the tile's first edge goes to part_first[tile] (its
//    segment may have started in an earlier tile); every other run starts
//    in this tile, and its in-tile sum goes to seg_first[v].  A vertex
//    pass then adds, for each v, its first piece and part_first of every
//    later tile its segment covers, in tile order.  No edge array beyond
//    the reference's inputs is needed: each tile marks its run heads from
//    `starts`, using tile_lo (the vertex owning each tile's first edge,
//    one binary search per tile).
//
// Launches, all on the caller's stream: tile_lo, tile sums, dangling
// partials, their sum, the vertex pass (new rank, moved partials), and
// the final sums of the moved partials.
//
// Bound: bytes — per edge esrc (4) and out_inv_e (8) streamed, plus the
// rank gather (8 bytes, scattered, mostly from L2 for 1M vertices), and
// per vertex starts, rank, the two masks and the new rank; the float64
// operations (two per edge) are far below the card's fp64 rate.
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kTileThreads = 256;
constexpr int kTileItems = 8;
constexpr int kTile = kTileThreads * kTileItems;  // edges a tile reduces
constexpr int kVThreads = 256;
constexpr int kVItems = 4;
constexpr int kVBlock = kVThreads * kVItems;      // vertices a block takes
constexpr int kSumThreads = 1024;

// tile_lo[t] = the vertex whose segment holds edge min(t * kTile, E): the
// largest v with starts[v] <= that edge (starts has n + 1 entries).  For
// t = ntiles it is n.
__global__ void __launch_bounds__(256)
tile_lo_kernel(const long long* __restrict__ starts, long long n,
               long long E, long long ntiles, long long* __restrict__ lo_out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > ntiles) return;
  const long long e0 = t * kTile < E ? t * kTile : E;
  long long lo = 0, hi = n + 1;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (starts[mid] <= e0) lo = mid + 1; else hi = mid;
  }
  lo_out[t] = lo - 1;
}

// A segmented-scan element: the sum since the run's head, and the head's
// position in the tile (-1 when the range holds no head).
struct Seg {
  double s;
  int head;
};

struct SegSum {
  __device__ Seg operator()(const Seg& a, const Seg& b) const {
    if (b.head >= 0) return b;
    Seg r;
    r.s = a.s + b.s;
    r.head = a.head;
    return r;
  }
};

__global__ void __launch_bounds__(kTileThreads)
tile_sums_kernel(const double* __restrict__ rank, const int* __restrict__ esrc,
                 const double* __restrict__ out_inv,
                 const long long* __restrict__ starts, long long n,
                 long long E, const long long* __restrict__ tile_lo,
                 double* __restrict__ part_first,
                 double* __restrict__ seg_first) {
  __shared__ int head_v[kTile];        // vertex whose run starts here
  using Scan = cub::BlockScan<Seg, kTileThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const long long t = blockIdx.x;
  const long long e0 = t * kTile;
  const int len = (int)(E - e0 < kTile ? E - e0 : kTile);
  for (int i = threadIdx.x; i < kTile; i += kTileThreads) head_v[i] = -1;
  __syncthreads();
  // vertices after tile_lo[t] whose non-empty segment starts in the tile;
  // position 0 belongs to tile_lo[t] and is never marked here
  const long long vlo = tile_lo[t];
  const long long vend = tile_lo[t + 1] < n - 1 ? tile_lo[t + 1] : n - 1;
  for (long long v = vlo + 1 + threadIdx.x; v <= vend; v += kTileThreads) {
    const long long s = starts[v];
    if (s < e0 + len && s < starts[v + 1]) head_v[s - e0] = (int)v;
  }
  __syncthreads();
  Seg items[kTileItems];
  const int base = threadIdx.x * kTileItems;   // blocked: order is kept
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const int i = base + k;
    items[k].s = 0.0;
    items[k].head = -1;
    if (i < len) {
      const int src = esrc[e0 + i];
      if (src >= 0 && src < n) items[k].s = rank[src] * out_inv[e0 + i];
      if (i == 0 || head_v[i] >= 0) items[k].head = i;
    }
  }
  Scan(tmp).InclusiveScan(items, items, SegSum());
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const int i = base + k;
    if (i < len && (i + 1 == len || head_v[i + 1] >= 0)) {   // a run's end
      const int h = items[k].head;
      if (h == 0) part_first[t] = items[k].s;
      else seg_first[head_v[h]] = items[k].s;
    }
  }
}

// dpart[b] = the sum of rank over the dangling vertices of block b
__global__ void __launch_bounds__(kVThreads)
dangling_kernel(const double* __restrict__ rank,
                const uint8_t* __restrict__ dmask, long long n,
                double* __restrict__ dpart) {
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < kVItems; ++k) {
    const long long v = (long long)blockIdx.x * kVBlock + k * kVThreads
                        + threadIdx.x;
    if (v < n && dmask[v]) acc += rank[v];
  }
  using Reduce = cub::BlockReduce<double, kVThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  const double s = Reduce(tmp).Sum(acc);
  if (threadIdx.x == 0) dpart[blockIdx.x] = s;
}

// One block: out_a = sum of a[0..m), out_b = sum of b[0..m) (b optional),
// each thread over a fixed stride, then a block reduction.
__global__ void __launch_bounds__(kSumThreads)
sum_kernel(const double* __restrict__ a, const long long* __restrict__ b,
           long long m, double* __restrict__ out_a,
           long long* __restrict__ out_b) {
  double sa = 0.0;
  long long sb = 0;
  for (long long i = threadIdx.x; i < m; i += kSumThreads) {
    sa += a[i];
    if (b != nullptr) sb += b[i];
  }
  using RD = cub::BlockReduce<double, kSumThreads>;
  using RL = cub::BlockReduce<long long, kSumThreads>;
  __shared__ typename RD::TempStorage td;
  __shared__ typename RL::TempStorage tl;
  const double ta = RD(td).Sum(sa);
  const long long tb = RL(tl).Sum(sb);
  if (threadIdx.x == 0) {
    *out_a = ta;
    if (out_b != nullptr) *out_b = tb;
  }
}

// The vertex pass.  seg_first may be new_rank itself: each thread reads
// seg_first[v] before it writes new_rank[v], and no other thread reads v.
__global__ void __launch_bounds__(kVThreads)
apply_kernel(const double* __restrict__ rank,
             const long long* __restrict__ starts,
             const uint8_t* __restrict__ vmask, long long n,
             const double* __restrict__ part_first,
             const double* seg_first, const double* __restrict__ dsum,
             double damping, double nverts, double tol, double* new_rank,
             double* __restrict__ mpart, long long* __restrict__ cpart) {
  // the same operations, in the same order, as the plain version
  const double base = __ddiv_rn(
      __dadd_rn(1.0 - damping, __dmul_rn(damping, *dsum)), nverts);
  double msum = 0.0;
  long long mcnt = 0;
#pragma unroll
  for (int k = 0; k < kVItems; ++k) {
    const long long v = (long long)blockIdx.x * kVBlock + k * kVThreads
                        + threadIdx.x;
    if (v >= n) continue;
    const long long s = starts[v], e = starts[v + 1];
    double acc = 0.0;
    if (s < e) {
      const long long ta = s / kTile, tb = (e - 1) / kTile;
      acc = (s % kTile == 0) ? part_first[ta] : seg_first[v];
#pragma unroll 8
      for (long long t = ta + 1; t <= tb; ++t) acc += part_first[t];
    }
    const double nw = vmask[v] ? __dadd_rn(base, __dmul_rn(damping, acc))
                               : 0.0;
    new_rank[v] = nw;
    const double moved = fabs(nw - rank[v]);
    msum += moved;
    mcnt += moved > tol ? 1 : 0;
  }
  using RD = cub::BlockReduce<double, kVThreads>;
  using RL = cub::BlockReduce<long long, kVThreads>;
  __shared__ typename RD::TempStorage td;
  __shared__ typename RL::TempStorage tl;
  const double bm = RD(td).Sum(msum);
  const long long bc = RL(tl).Sum(mcnt);
  if (threadIdx.x == 0) {
    mpart[blockIdx.x] = bm;
    cpart[blockIdx.x] = bc;
  }
}

}  // namespace

extern "C" int nt_pagerank_tile() { return kTile; }
extern "C" int nt_pagerank_vblock() { return kVBlock; }

// rank (n) f64, esrc (E) i32, starts (n + 1) i64, out_inv (E) f64,
// dmask / vmask (n) bool.  Scratch: tile_lo (ntiles + 1) i64, part_first
// (ntiles) f64, dpart and mpart (nvb) f64, cpart (nvb) i64, dsum (1) f64,
// with ntiles = ceil(E / nt_pagerank_tile()), nvb = ceil(n /
// nt_pagerank_vblock()).  Outputs new_rank (n) f64, delta and active one
// element each.
extern "C" int nt_pagerank_step(
    const double* rank, const int* esrc, const long long* starts,
    const double* out_inv, const uint8_t* dmask, const uint8_t* vmask,
    long long n, long long E, double nverts, double damping, double tol,
    long long* tile_lo, double* part_first, double* dpart, double* mpart,
    long long* cpart, double* dsum, double* new_rank, double* delta,
    long long* active, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n <= 0) {
    cudaMemsetAsync(delta, 0, sizeof(double), stream);
    cudaMemsetAsync(active, 0, sizeof(long long), stream);
    return (int)cudaGetLastError();
  }
  const long long ntiles = (E + kTile - 1) / kTile;
  const long long nvb = (n + kVBlock - 1) / kVBlock;
  if (ntiles > 0) {
    tile_lo_kernel<<<(unsigned)((ntiles + 1 + 255) / 256), 256, 0,
                     stream>>>(starts, n, E, ntiles, tile_lo);
    tile_sums_kernel<<<(unsigned)ntiles, kTileThreads, 0, stream>>>(
        rank, esrc, out_inv, starts, n, E, tile_lo, part_first, new_rank);
  }
  dangling_kernel<<<(unsigned)nvb, kVThreads, 0, stream>>>(rank, dmask, n,
                                                          dpart);
  sum_kernel<<<1, kSumThreads, 0, stream>>>(dpart, nullptr, nvb, dsum,
                                            nullptr);
  apply_kernel<<<(unsigned)nvb, kVThreads, 0, stream>>>(
      rank, starts, vmask, n, part_first, new_rank, dsum, damping, nverts,
      tol, new_rank, mpart, cpart);
  sum_kernel<<<1, kSumThreads, 0, stream>>>(mpart, cpart, nvb, delta,
                                            active);
  return (int)cudaGetLastError();
}
