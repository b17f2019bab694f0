// merge_delta — the delta plane merged into one block's expansion
// (Queue B K9).
//
// Replaces nebula_tpu/tpu/hop.py:_merge_delta (:118), which XLA compiled
// per part from a searchsorted membership test and four concatenations.
// The block's slot arrays come from expand (expand.cu) already
// W = EB + Dcap wide: columns [0, EB) hold the base slots (valid below
// total[p], padding after), columns [EB, W) are this kernel's to fill, so
// the base slots are never copied.  One launch covers all P parts:
//
//   blocks [0, P)   part p's delta rows, one thread per row k (strided):
//                   row k is active when d_valid[p, k] is set and the
//                   frontier bit fbm[p, clip(d_src[p, k], 0, vmax - 1)] is
//                   set; it lands at column EB + k as src = d_src*P + p,
//                   dst = d_dst, rank = d_rank, or as padding (-1, -1, 0)
//                   when not active, and eidx = emax + k either way (the
//                   virtual edge index the prop gathers split on).  The
//                   block then sums its active rows with a shared-memory
//                   reduction: total_out[p] = total[p] + active count.
//   blocks [P, ..)  the base slots in row tiles (rowtile.cuh), kTile slots
//                   of one part's row a block: slot j of part p is valid
//                   when j < total[p] and its eidx is not among the
//                   sorted, MAXI-padded tombstones d_tomb[p] — the
//                   semantics of jnp.searchsorted(side="left") with the
//                   position clipped to Tcap - 1 and an equality test,
//                   which for a sorted row is membership.  A tombstoned
//                   slot also gets dst = -1, so mark (mark.cu), which sets
//                   every id >= 0, drops it without a keep mask.
//
// Query lanes (Queue B K10; the reference merges per lane inside its
// vmapped hop, hop.py:478-497): the slots, total and fbm may carry a
// leading lane axis, (L, P, W), (L, P) and (L, P, vmax), while the delta
// plane's d_* tensors stay (P, ...) and are shared, never copied per
// lane.  One launch covers every lane: lane l is blockIdx.y, and its
// blocks run the solo body on its own slot, total and frontier rows (a
// delta row's activity depends on that lane's frontier) against the
// shared delta and tombstone rows.
//
// Shard slots (Queue B K17, the merge inside nebula_tpu/tpu/hop.py's
// shard program, :382-389): a slot holds only its own part's delta rows,
// so a delta row's source vertex is d_src * parts + pid + p, `parts` the
// mesh's part count and `pid` the slot's part (parts = P, pid = 0 when all
// P parts are given).
//
// valid (P, W) bool is the merged slot mask: it is no longer a prefix
// (tombstones punch holes, delta rows sit past EB), so predicate.cu and
// compact_capture.cu take it instead of total.  total_out counts what the
// reference's counter counts: base slots of frontier rows, tombstoned
// ones included, plus the active delta rows (hop.py:145-159).
//
// Bound: bytes.  Per base slot it reads eidx (4 bytes) and writes the
// valid byte; per delta row it reads 13 bytes of d_* leaves and a frontier
// byte and writes 17.  A binary search of the tombstones for every slot
// (13 dependent probes at Tcap = 8192) kept it far above that, though a
// few thousand tombstones a part hit almost no tile of millions of slots.
// So one search a tile, not a slot:
//   * a thread takes kV slots (one 16-byte eidx load, one word of valid
//     stored); a tile at or past total[p] stores zeros and reads nothing;
//   * the tile reduces the least and greatest eidx of its valid slots
//     (warp shuffles, then shared memory), and two warps find the
//     tombstones [lo, hi) in that closed range, each by a 32-way search
//     (a warp's lanes probe 32 positions at once, three rounds for 8,192);
//   * an empty range — nearly every tile — ends the tile: no slot
//     searches;
//   * a range of at most kStage tombstones is staged in shared memory and
//     each valid slot searches that slice; a wider one is searched in
//     place, each slot over [lo, hi) only.
// The range is right for any order of eidx; ascending eidx (a part's
// base slots) only keeps it small.  On an H100 (PERF.md) tiles of 1,024,
// 4,096 or 8,192 slots, 2 or 8 slots a thread, a search that starts from a
// sample of the tombstone row, and one wave of blocks that loads its next
// tile while it searches were each slower than this.
#include <cstdint>
#include <cuda_runtime.h>

#include "rowtile.cuh"

namespace {

using rowtile::kV;

constexpr int kThreads = 256;
constexpr int kTile = 2048;     // base slots of one row a block takes
constexpr int kStage = 1024;    // tombstones staged in shared memory
constexpr int kGroups = (kTile / kV + 1 + kThreads - 1) / kThreads;
constexpr int kMaxI = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// First index i in [0, n) of the sorted t with t[i] > key (upper) or
// t[i] >= key (lower), n if none; by a whole warp, 32 probes a round.
__device__ __forceinline__ int warp_bound(const int* __restrict__ t, int n,
                                          int key, bool upper) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int idx = lo + (lane + 1) * step - 1;
    bool below = false;
    if (idx < hi) {
      const int v = t[idx];
      below = upper ? v <= key : v < key;
    }
    const int c = __popc(__ballot_sync(kFull, below));
    const int nhi = lo + (c + 1) * step - 1;     // lane c's probe
    lo += c * step;
    if (nhi < hi) hi = nhi;
  }
  const int idx = lo + lane;
  bool below = false;
  if (idx < hi) {
    const int v = t[idx];
    below = upper ? v <= key : v < key;
  }
  return lo + __popc(__ballot_sync(kFull, below));
}

// Whether key is among the m sorted values t[0, m).
__device__ __forceinline__ bool member(const int* t, int m, int key) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo < m && t[lo] == key;
}

__global__ void __launch_bounds__(kThreads)
merge_delta_kernel(const int* __restrict__ total,
                   const uint8_t* __restrict__ fbm, long long fbm_ld,
                   int vmax, const int* __restrict__ d_src,
                   const int* __restrict__ d_dst,
                   const int* __restrict__ d_rank,
                   const uint8_t* __restrict__ d_valid, int Dcap,
                   const int* __restrict__ d_tomb, int Tcap, int P, int EB,
                   int emax, int parts, int pid, int tiles, int vec,
                   int* __restrict__ src, int* __restrict__ dst,
                   int* __restrict__ rk, int* __restrict__ eidx,
                   uint8_t* __restrict__ valid, int* __restrict__ total_out) {
  const long long W = (long long)EB + Dcap;
  {
    // query lanes: lane blockIdx.y merges its own slots against its own
    // frontier rows; the delta plane is shared.  The body is the solo
    // kernel's
    const size_t l = blockIdx.y;
    total += l * P;
    total_out += l * P;
    fbm += l * P * fbm_ld;
    const size_t lo = l * P * W;
    src += lo;
    dst += lo;
    rk += lo;
    eidx += lo;
    valid += lo;
  }
  __shared__ int part_sums[kThreads / 32];
  if ((int)blockIdx.x < P) {
    const int p = blockIdx.x;
    int count = 0;
    for (int k = threadIdx.x; k < Dcap; k += blockDim.x) {
      const size_t in = (size_t)p * Dcap + k;
      int s = d_src[in];
      const int sc = s < 0 ? 0 : (s > vmax - 1 ? vmax - 1 : s);
      const bool act = d_valid[in] && fbm[(size_t)p * fbm_ld + sc];
      const size_t o = (size_t)p * W + EB + k;
      src[o] = act ? s * parts + pid + p : -1;
      dst[o] = act ? d_dst[in] : -1;
      rk[o] = act ? d_rank[in] : 0;
      eidx[o] = emax + k;
      valid[o] = act ? 1 : 0;
      count += act ? 1 : 0;
    }
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_down_sync(kFull, count, off);
    if ((threadIdx.x & 31) == 0) part_sums[threadIdx.x >> 5] = count;
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int w = 0; w < kThreads / 32; ++w) sum += part_sums[w];
      total_out[p] = total[p] + sum;
    }
    return;
  }

  // the base slots: tile (blockIdx.x - P) of the P rows' tiles
  const int b = blockIdx.x - P;
  const int p = b / tiles;
  const int j0 = (b - p * tiles) * kTile;
  const int n = min(kTile, EB - j0);
  const long long a = (long long)p * W + j0;
  const int lim = total[p] - j0;              // valid below this offset
  uint8_t* vt = valid + a;
  if (lim <= 0) {
    rowtile::zero_bytes(vt, n);
    return;
  }
  // groups align to the flat index over every lane's rows
  const long long af = (long long)blockIdx.y * P * W + a;
  const int o0 = rowtile::first(af);
  const int ng = rowtile::groups(af, n);
  const int* et = eidx + a;
  int e[kGroups][kV];
  unsigned in[kGroups], live[kGroups];
  int lo_e = kMaxI, hi_e = -kMaxI - 1;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int g = threadIdx.x + i * kThreads;
    const int o = o0 + g * kV;
    in[i] = g < ng ? rowtile::between(o, 0, n) : 0u;
    live[i] = rowtile::between(o, 0, lim) & in[i];
    rowtile::load(et, o, in[i], live[i], vec, e[i]);
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if ((live[i] >> v) & 1u) {
        lo_e = min(lo_e, e[i][v]);
        hi_e = max(hi_e, e[i][v]);
      }
  }

  // the tombstones that can hit the tile: [lo, hi) of d_tomb[p]
  __shared__ int bounds[2];
  __shared__ int stage[kStage];
  int lo = 0, hi = 0;
  if (Tcap > 0) {
    __shared__ int mins[kThreads / 32], maxs[kThreads / 32];
    for (int off = 16; off > 0; off >>= 1) {
      lo_e = min(lo_e, __shfl_xor_sync(kFull, lo_e, off));
      hi_e = max(hi_e, __shfl_xor_sync(kFull, hi_e, off));
    }
    if ((threadIdx.x & 31) == 0) {
      mins[threadIdx.x >> 5] = lo_e;
      maxs[threadIdx.x >> 5] = hi_e;
    }
    __syncthreads();
    lo_e = mins[0];
    hi_e = maxs[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) {
      lo_e = min(lo_e, mins[w]);
      hi_e = max(hi_e, maxs[w]);
    }
    // warp 0 the first tombstone >= the least eidx, warp 1 the first
    // > the greatest
    const int* tp = d_tomb + (size_t)p * Tcap;
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const int r = warp_bound(tp, Tcap, warp == 0 ? lo_e : hi_e,
                               warp == 1);
      if ((threadIdx.x & 31) == 0) bounds[warp] = r;
    }
    __syncthreads();
    lo = bounds[0];
    hi = bounds[1];
    if (hi - lo > 0 && hi - lo <= kStage) {
      for (int i = threadIdx.x; i < hi - lo; i += kThreads)
        stage[i] = tp[lo + i];
      __syncthreads();
    }
  }
  const int m = hi - lo;
  const int* sl = m <= kStage ? stage : d_tomb + (size_t)p * Tcap + lo;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    if (!in[i]) continue;
    const int o = o0 + (threadIdx.x + i * kThreads) * kV;
    unsigned ok = live[i];
    if (m > 0) {
#pragma unroll
      for (int v = 0; v < kV; ++v)
        if (((live[i] >> v) & 1u) && member(sl, m, e[i][v])) {
          ok &= ~(1u << v);
          dst[a + o + v] = -1;
        }
    }
    rowtile::store_flags(vt, o, in[i], ok, vec);
  }
}

}  // namespace

extern "C" int nt_merge_delta_sizes(int* out) {
  out[0] = kTile;
  out[1] = kStage;
  return 0;
}

// src/dst/rk/eidx and valid are (L * P, EB + Dcap), row-contiguous; fbm
// is an (L * P, vmax) bitmap whose rows are fbm_ld bytes apart; total and
// total_out (L * P,); d_src/d_dst/d_rank/d_valid are (P, Dcap), d_tomb
// (P, Tcap) sorted, shared by the lanes.  total is read, total_out
// written; they may not alias.  L = 1 for a solo call.  parts, pid: see
// "Shard slots" above.
extern "C" int nt_merge_delta(const int* total, const uint8_t* fbm,
                              long long fbm_ld, int vmax, const int* d_src,
                              const int* d_dst, const int* d_rank,
                              const uint8_t* d_valid, int Dcap,
                              const int* d_tomb, int Tcap, int P, int L,
                              int EB, int emax, int parts, int pid,
                              int* src, int* dst, int* rk, int* eidx,
                              uint8_t* valid, int* total_out, void* stream) {
  if (P <= 0 || L <= 0 || vmax <= 0 || Dcap < 0 || Tcap < 0 || EB < 0 ||
      total == total_out)
    return (int)cudaErrorInvalidValue;
  if (L > 65535) return (int)cudaErrorInvalidValue;
  const int tiles = (EB + kTile - 1) / kTile;
  const long long nb = (long long)P * tiles;
  if (P + nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int iv = 4 * kV < 16 ? 4 * kV : 16;
  const int vec = rowtile::aligned(eidx, iv) && rowtile::aligned(valid, kV);
  merge_delta_kernel<<<dim3((unsigned)(P + nb), L), kThreads, 0,
                       (cudaStream_t)stream>>>(
      total, fbm, fbm_ld, vmax, d_src, d_dst, d_rank, d_valid, Dcap, d_tomb,
      Tcap, P, EB, emax, parts, pid, tiles, vec, src, dst, rk, eidx, valid,
      total_out);
  return (int)cudaGetLastError();
}
