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
// Edges sorted by destination make the segment sums a CSR SpMV: row
// pointers `starts`, column indices `esrc`, values rank[esrc] *
// out_inv_e.  The design is the merge-based CSR SpMV (Merrill & Garland,
// SC'16): the rows' ends and the edges form one merged list of n + E
// items, and each block owns a fixed kBlock of them, so a hub row (the
// dst Zipf tail gives one vertex about 2M in-edges of 30M) spreads over
// as many blocks as it has edges and a run of edgeless rows costs one
// item a row.  Two launches a step, both on the caller's stream:
//
//  1. sums: a warp-wide 32-ary search over `starts` finds the block's
//     first and last merge coordinates (rows ended, edges taken).  The
//     block stages its edges' values (coalesced loads of esrc and
//     out_inv_e, the rank gather) and its rows' end offsets in shared
//     memory; each thread finds its own coordinate there and walks its
//     kItems items serially, summing in registers.  One carry a thread
//     (the row open at its end, its partial) goes through a block-wide
//     segmented scan, whose exclusive prefix is added to the thread's
//     first row end.  Each row ending in the block gets its in-block sum
//     (written coalesced from shared memory); the row open at the block's
//     end gets the block's carry.  The block also sums rank over the
//     dangling rows that end in it.  The last block to finish (a
//     threadfence and an atomic ticket) sums the dangling partials in
//     block order.
//  2. apply: each block of kVBlock vertices adds the carries of its rows
//     (a contiguous run of block carries, found by a warp search) in
//     block order, with a block-wide segmented scan a chunk of 256 carries
//     at a time, so a hub row's thousand carries are summed in parallel;
//     then the new rank, the moved partials, and the last block's sums of
//     them in block order.
//
// Determinism: the reference promises bit-identical ranks from run to
// run, so no float atomics anywhere.  Every sum runs in an order fixed by
// the shapes alone: a thread's serial items, cub's block scans and
// reductions (fixed trees), partials combined in block order whatever
// block finishes last.  The wrapper allocates the scratch; the entry
// point clears the two tickets on the stream before the launches.
//
// Bound: bytes — per edge esrc (4) and out_inv_e (8) streamed, per vertex
// starts, rank, the two masks and the new rank.  The rank gather (8 bytes
// a sector from an 8 MB array) is served by L2, not HBM: its rate is
// measured beside the kernel in chip_smoke.py [5c] (the gather floor,
// one index_select at the same shape).  The float64 operations (two per
// edge) are far below the card's fp64 rate.  On an H100 the sums launch
// runs near that floor and the gather sets its time: through L1 it beats
// an L2-only load (.cg) by far, and the default L1 / shared-memory split
// beats both extremes; 10 items a thread beat 8 (more blocks) and 12 (a
// block per SM fewer); a launch of its own for the block boundaries
// gained nothing (PERF.md).
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 10;                         // merge items a thread
constexpr int kBlock = kThreads * kItems;          // merge items a block
constexpr int kVThreads = 256;
constexpr int kVItems = 4;
constexpr int kVBlock = kVThreads * kVItems;       // vertices a block

// A carry: the local row it belongs to, and its partial sum.
struct Carry {
  int row;
  double s;
};

// The segmented sum over carries in row order (rows never decrease): a
// carry of a later row starts a new segment.
struct CarrySum {
  __device__ Carry operator()(const Carry& a, const Carry& b) const {
    if (b.row != a.row) return b;
    Carry r;
    r.row = b.row;
    r.s = a.s + b.s;
    return r;
  }
};

// One warp: the count of p in [0, m) with pred(p), for a pred true on a
// prefix, by a 32-ary search (every lane returns it).
template <typename Pred>
__device__ long long warp_count(long long m, Pred pred) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = m;
  while (lo < hi) {
    const long long step = (hi - lo + 31) >> 5;
    const long long p = lo + lane * step;
    const unsigned hit = __ballot_sync(0xffffffffu, p < hi && pred(p));
    const int c = __popc(hit);
    if (c == 0) {
      hi = lo;
    } else {
      const long long nlo = lo + (c - 1) * step + 1;
      const long long nhi = lo + c * step;
      lo = nlo;
      if (nhi < hi) hi = nhi;
    }
  }
  return lo;
}

// The last block's share of a sum over m block partials: thread t adds
// a[t], a[t + T], ... in that order, kBatch loads in flight at a time
// (read past L1: other blocks wrote them).
template <int T, typename V>
__device__ V strided_sum(const V* a, long long m) {
  constexpr int kBatch = 8;
  V t = 0;
  for (long long b0 = threadIdx.x; b0 < m; b0 += (long long)T * kBatch) {
    V x[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const long long b = b0 + (long long)k * T;
      x[k] = b < m ? __ldcg(a + b) : V(0);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) t += x[k];
  }
  return t;
}

// Launch 1.  Merge coordinate of diagonal k: rows ended i = #{p in [0, n):
// starts[p + 1] + p + 1 <= k}, edges taken j = k - i.
__global__ void __launch_bounds__(kThreads)
sums_kernel(const double* __restrict__ rank, const int* __restrict__ esrc,
            const double* __restrict__ out_inv,
            const long long* __restrict__ starts,
            const uint8_t* __restrict__ dmask, long long n, long long E,
            double* __restrict__ acc, long long* __restrict__ crow,
            double* __restrict__ cval, double* __restrict__ dpart,
            unsigned* __restrict__ ticket, double* __restrict__ dsum) {
  __shared__ double s_val[kBlock];     // edge values, then the row sums
  __shared__ int s_end[kBlock];        // rows' end offsets in the block
  __shared__ long long s_coord[2];
  __shared__ int s_last;
  using Scan = cub::BlockScan<Carry, kThreads>;
  using Reduce = cub::BlockReduce<double, kThreads>;
  __shared__ union {
    typename Scan::TempStorage scan;
    typename Reduce::TempStorage reduce;
  } tmp;

  const long long k0 = (long long)blockIdx.x * kBlock;
  const long long k1 = k0 + kBlock < n + E ? k0 + kBlock : n + E;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long k = warp == 0 ? k0 : k1;
    const long long i = warp_count(n, [&](long long p) {
      return starts[p + 1] + p + 1 <= k;
    });
    if ((threadIdx.x & 31) == 0) s_coord[warp] = i;
  }
  __syncthreads();
  const long long i0 = s_coord[0], i1 = s_coord[1];
  const long long j0 = k0 - i0;
  const int nr = (int)(i1 - i0), ne = (int)(k1 - i1 - j0);

  // stage: the rows' ends, then the edges' values (loads first, then the
  // gathers, kItems of each in flight a thread)
  for (int r = threadIdx.x; r < nr; r += kThreads)
    s_end[r] = (int)(starts[i0 + r + 1] - j0);
  int src[kItems];
  double inv[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int e = q * kThreads + threadIdx.x;
    src[q] = e < ne ? esrc[j0 + e] : -1;
    inv[q] = e < ne ? out_inv[j0 + e] : 0.0;
  }
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int e = q * kThreads + threadIdx.x;
    if (e < ne)
      s_val[e] = src[q] >= 0 && src[q] < n ? rank[src[q]] * inv[q] : 0.0;
  }
  double dl = 0.0;               // rank over the dangling rows ending here
  for (long long v = i0 + threadIdx.x; v < i1; v += kThreads)
    if (dmask[v]) dl += rank[v];
  __syncthreads();

  // the thread's coordinate in the block, then its items
  const int kt = threadIdx.x * kItems < nr + ne ? threadIdx.x * kItems
                                                 : nr + ne;
  const int kend = kt + kItems < nr + ne ? kt + kItems : nr + ne;
  int lo = kt - ne > 0 ? kt - ne : 0;
  int hi = kt < nr ? kt : nr;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] + mid + 1 <= kt) lo = mid + 1; else hi = mid;
  }
  const int first_row = lo;
  int ri = lo, ej = kt - lo;
  double run = 0.0;
  double outv[kItems];
  unsigned ends = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    outv[q] = 0.0;
    if (kt + q < kend) {
      if (ri < nr && s_end[ri] <= ej) {          // row ri ends
        outv[q] = run;
        run = 0.0;
        ends |= 1u << q;
        ++ri;
      } else {
        run += s_val[ej];
        ++ej;
      }
    }
  }
  Carry mine{ri, run}, prefix, block;
  Scan(tmp.scan).ExclusiveScan(mine, prefix, CarrySum(), block);
  if (threadIdx.x > 0 && ends != 0) {
    // the exclusive prefix is the earlier threads' part of this thread's
    // first row (prefix.row == first_row)
#pragma unroll
    for (int q = 0; q < kItems; ++q)
      if (((ends >> q) & 1u) && (ends & ((1u << q) - 1)) == 0)
        outv[q] = prefix.s + outv[q];
  }
  __syncthreads();                   // every read of s_val is done
  int row = first_row;
#pragma unroll
  for (int q = 0; q < kItems; ++q)
    if ((ends >> q) & 1u) s_val[row++] = outv[q];
  __syncthreads();
  for (int r = threadIdx.x; r < nr; r += kThreads) acc[i0 + r] = s_val[r];
  const double bsum = Reduce(tmp.reduce).Sum(dl);
  if (threadIdx.x == 0) {
    crow[blockIdx.x] = i1;
    cval[blockIdx.x] = block.s;
    dpart[blockIdx.x] = bsum;
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const double total = Reduce(tmp.reduce).Sum(
      strided_sum<kThreads>(dpart, gridDim.x));
  if (threadIdx.x == 0) *dsum = total;
}

// Launch 2.  `acc` holds each row's sum within the block where it ends
// (it is new_rank itself: a thread reads acc[v] before it writes
// new_rank[v], and no other thread reads v).
__global__ void __launch_bounds__(kVThreads)
apply_kernel(const double* __restrict__ rank,
             const uint8_t* __restrict__ vmask, long long n,
             const double* acc, const long long* __restrict__ crow,
             const double* __restrict__ cval, long long nblocks,
             const double* __restrict__ dsum, double damping, double nverts,
             double tol, double* new_rank, double* __restrict__ mpart,
             long long* __restrict__ cpart, unsigned* __restrict__ ticket,
             double* __restrict__ delta, long long* __restrict__ active) {
  __shared__ double s_carry[kVBlock];
  __shared__ int s_row[kVThreads];
  __shared__ long long s_cb[2];
  __shared__ int s_last;
  using Scan = cub::BlockScan<Carry, kVThreads>;
  using RD = cub::BlockReduce<double, kVThreads>;
  using RL = cub::BlockReduce<long long, kVThreads>;
  __shared__ union {
    typename Scan::TempStorage scan;
    struct {
      typename RD::TempStorage d;
      typename RL::TempStorage l;
    } red;
  } tmp;

  const long long v0 = (long long)blockIdx.x * kVBlock;
  const long long v1 = v0 + kVBlock < n ? v0 + kVBlock : n;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long key = warp == 0 ? v0 : v1;
    const long long b = warp_count(nblocks, [&](long long p) {
      return crow[p] < key;
    });
    if ((threadIdx.x & 31) == 0) s_cb[warp] = b;
  }
  for (int i = threadIdx.x; i < kVBlock; i += kVThreads) s_carry[i] = 0.0;
  __syncthreads();
  // the carries of rows [v0, v1), in block order, a chunk at a time
  const long long cb0 = s_cb[0], cb1 = s_cb[1];
  for (long long c = cb0; c < cb1; c += kVThreads) {
    const long long b = c + threadIdx.x;
    Carry x{kVBlock, 0.0};
    if (b < cb1) {
      x.row = (int)(crow[b] - v0);
      x.s = cval[b];
    }
    Carry incl;
    Scan(tmp.scan).InclusiveScan(x, incl, CarrySum());
    s_row[threadIdx.x] = x.row;
    __syncthreads();
    if (b < cb1 && (threadIdx.x + 1 == kVThreads || b + 1 == cb1
                    || s_row[threadIdx.x + 1] != x.row))
      s_carry[x.row] += incl.s;       // one run end a row a chunk
    __syncthreads();
  }
  // the same operations, in the same order, as the plain version
  const double base = __ddiv_rn(
      __dadd_rn(1.0 - damping, __dmul_rn(damping, *dsum)), nverts);
  double msum = 0.0;
  long long mcnt = 0;
#pragma unroll
  for (int k = 0; k < kVItems; ++k) {
    const int i = k * kVThreads + threadIdx.x;
    const long long v = v0 + i;
    if (v >= v1) continue;
    const double a = s_carry[i] + acc[v];
    const double nw = vmask[v] ? __dadd_rn(base, __dmul_rn(damping, a))
                               : 0.0;
    new_rank[v] = nw;
    const double moved = fabs(nw - rank[v]);
    msum += moved;
    mcnt += moved > tol ? 1 : 0;
  }
  const double bm = RD(tmp.red.d).Sum(msum);
  const long long bc = RL(tmp.red.l).Sum(mcnt);
  if (threadIdx.x == 0) {
    mpart[blockIdx.x] = bm;
    cpart[blockIdx.x] = bc;
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const double sa = RD(tmp.red.d).Sum(
      strided_sum<kVThreads>(mpart, gridDim.x));
  const long long sb = RL(tmp.red.l).Sum(
      strided_sum<kVThreads>(cpart, gridDim.x));
  if (threadIdx.x == 0) {
    *delta = sa;
    *active = sb;
  }
}

}  // namespace

extern "C" int nt_pagerank_block() { return kBlock; }
extern "C" int nt_pagerank_vblock() { return kVBlock; }

// rank (n) f64, esrc (E) i32, starts (n + 1) i64, out_inv (E) f64,
// dmask / vmask (n) bool.  Scratch: crow (nb) i64, cval and dpart (nb)
// f64, mpart (nvb) f64, cpart (nvb) i64, dsum (1) f64, tickets (2)
// uint32, with nb = ceil((n + E) / nt_pagerank_block()), nvb = ceil(n /
// nt_pagerank_vblock()).  Outputs new_rank (n) f64, delta and active one
// element each.
extern "C" int nt_pagerank_step(
    const double* rank, const int* esrc, const long long* starts,
    const double* out_inv, const uint8_t* dmask, const uint8_t* vmask,
    long long n, long long E, double nverts, double damping, double tol,
    long long* crow, double* cval, double* dpart, double* mpart,
    long long* cpart, double* dsum, unsigned* tickets, double* new_rank,
    double* delta, long long* active, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n <= 0) {
    cudaMemsetAsync(delta, 0, sizeof(double), stream);
    cudaMemsetAsync(active, 0, sizeof(long long), stream);
    return (int)cudaGetLastError();
  }
  const long long nb = (n + E + kBlock - 1) / kBlock;
  const long long nvb = (n + kVBlock - 1) / kVBlock;
  if (nb >= (1ll << 31) || E >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(tickets, 0, 2 * sizeof(unsigned), stream);
  sums_kernel<<<(unsigned)nb, kThreads, 0, stream>>>(
      rank, esrc, out_inv, starts, dmask, n, E, new_rank, crow, cval, dpart,
      tickets, dsum);
  apply_kernel<<<(unsigned)nvb, kVThreads, 0, stream>>>(
      rank, vmask, n, new_rank, crow, cval, nb, dsum, damping, nverts, tol,
      new_rank, mpart, cpart, tickets + 1, delta, active);
  return (int)cudaGetLastError();
}
