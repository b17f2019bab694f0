// wcc_step and sssp_step — one min-relaxation iteration over the flat edge
// list (Queue B K13 and K14), two instantiations of one template.
//
// Replaces nebula_tpu/algo/kernels.py:wcc_step (:79) and sssp_step (:95):
//     send   = mask[esrc] ? val[esrc] + inc : SENTINEL
//     cand   = scatter-min of send by edst
//     new    = min(old, cand),  changed = new < old,  count(changed)
// WCC: val is the int64 label, inc 0, the sentinel INT64_MAX.  SSSP: val
// is the float64 distance, inc the edge weight (1.0 unweighted), the
// sentinel +inf.  A masked-off edge sends the sentinel, which never
// lowers anything, so here it sends nothing.
//
// The min is exact in any order, so atomics are allowed: each vertex's
// best value lives in the output buffer as an int64 key, lowered with
// atomicMin.  For WCC the key is the label.  For SSSP it is the float64's
// bits, with the magnitude bits flipped for negative values, so that the
// signed int64 order of keys is the numeric order of every non-NaN double
// (for the non-negative distances the engine allows, the key is the bits
// themselves).
//
// The step is Jacobi: `send` reads the OLD val and mask, never a value
// this launch has lowered.  Three launches:
//   1. prologue, one thread a vertex: new[v] = key(old[v]), and the mask
//      packed into ceil(n / 32) 32-bit words by a warp ballot (padded to
//      whole 16-byte vectors); it also clears the count;
//   2. relax, a persistent grid (as many blocks as are resident: 1,024
//      threads staged, 512 global), each warp walking one contiguous
//      range of edges, 128 edges a step (a 16-byte vector of esrc a
//      lane, two steps ahead; scalars where the arrays are not 16-byte
//      aligned or at the range's ragged end);
//   3. finish, one thread a vertex: new[v] = value(new[v]), changed =
//      new < old, the count through __syncthreads_count.
//
// Bound: bytes — esrc (4 bytes) of every edge; edst (4) and, weighted,
// the weight (8) of every edge whose source is in the mask; the old
// value and mask once per vertex; new value and changed flag once per
// vertex.  A kernel of one thread an edge stays far above it, at 17-18%
// on an H100, for two reasons this design takes away:
//   * each edge gathers its source's mask byte from device memory.
//     Here the mask is bits: on the "staged" route each block copies the
//     n bits into its shared memory first (125 KB at n = 1M; up to the
//     232,448 bytes a block may take on an H100, 1,859,584 vertices), and
//     an edge tests its source with one shared-memory load.  The
//     "global" route, for n past that, reads the same words through the
//     read-only cache (125 KB a million vertices, L2-resident).  Only an
//     edge whose bit is set reads its edst, its source's value and its
//     weight; a warp whose 128 edges are all off reads nothing more.
//   * each lowering edge issues its own 64-bit atomicMin, and with the
//     edges sorted by destination a warp's 32 lanes hit one or two
//     addresses.  Here a warp reduces its keys by destination run before
//     any atomic: lane-local over its 4 consecutive edges, then a
//     segmented scan over the lanes (5 shuffle rounds), and the run still
//     open at the warp's last edge is carried in registers into the
//     warp's next 128 edges.  One atomic a destination run a warp, a
//     reduction whose old value nobody waits for.  A lane with no edge
//     on is transparent to the runs, so a sparse frontier's edges into
//     one hub destination still meet in one atomic a warp (one atomic an
//     edge there, serialised on the hub's word, was the slower design).
// A run is a maximal stretch of equal destinations in the warp's edge
// order, so edges in any order give the same result: a destination seen
// in two runs gets two atomics.  An edge that is off or past the range
// carries the key INT64_MAX (no atomic); a lane with no edge on does not
// read its edst.
//
// Measured on an H100 (chip_smoke.py [5c]: `relax paths`, `whole run`;
// PERF.md): WCC's dense iterations run at the label gather's own time
// (label.index_select over esrc, the `gather floor` line); SSSP's late
// iterations at the time of streaming esrc with the two vertex passes.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kVThreads = 256;       // per-vertex passes
// relax block size a route: the staged route has one block an SM (its
// bitmap fills shared memory at the main path's n), so a wide one
template <bool kStaged>
struct Block {
  static constexpr int kT = kStaged ? 1024 : 512;
};
constexpr int kChunk = 128;          // edges a warp takes a step
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kNone = 0x7fffffffffffffffLL;   // no key: sends nothing

// key: the int64 whose signed order is the value order; bits: the stored
// int64 word of the value a key stands for; value: that value.
struct WccOps {
  using T = long long;
  static constexpr bool kWeighted = false;
  static __device__ long long key(long long v) { return v; }
  static __device__ long long bits(long long k) { return k; }
  static __device__ long long value(long long k) { return k; }
  static __device__ long long send(long long v, double) { return v; }
};

template <bool kW>
struct SsspOps {
  using T = double;
  static constexpr bool kWeighted = kW;
  static __device__ long long key(double v) {
    const long long b = __double_as_longlong(v);
    return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
  }
  static __device__ long long bits(long long k) {
    return k >= 0 ? k : k ^ 0x7fffffffffffffffLL;
  }
  static __device__ double value(long long k) {
    return __longlong_as_double(bits(k));
  }
  static __device__ double send(double v, double w) {
    return __dadd_rn(v, w);
  }
};

template <class Ops>
__global__ void __launch_bounds__(kVThreads)
prologue_kernel(const typename Ops::T* __restrict__ old,
                const uint8_t* __restrict__ mask, long long n,
                long long nwords, long long* __restrict__ best,
                unsigned* __restrict__ words,
                unsigned long long* __restrict__ count) {
  const long long v = (long long)blockIdx.x * kVThreads + threadIdx.x;
  bool on = false;
  if (v < n) {
    best[v] = Ops::key(old[v]);
    on = mask[v] != 0;
  }
  const unsigned b = __ballot_sync(kFull, on);
  if ((threadIdx.x & 31) == 0 && (v >> 5) < nwords) words[v >> 5] = b;
  if (v == 0) *count = 0ull;
}

// The 4 consecutive ints of p at e0.. (those past E read as -1), by one
// 16-byte load where p is aligned and all 4 lie below E.
__device__ __forceinline__ void load4(const int* __restrict__ p,
                                      long long e0, long long E, bool vec,
                                      int (&o)[4]) {
  if (vec && e0 + 4 <= E) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p + e0));
    o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = e0 + j < E ? __ldg(p + e0 + j) : -1;
  }
}

__device__ __forceinline__ long long kmin(long long a, long long b) {
  return a < b ? a : b;
}

// a reduction (its old value unused): the warp does not wait for it
__device__ __forceinline__ void lower(long long* best, int d, long long k) {
  atomicMin(best + d, k);
}

template <class Ops, bool kStaged>
__global__ void __launch_bounds__(Block<kStaged>::kT)
relax_kernel(const typename Ops::T* __restrict__ old,
             const unsigned* __restrict__ words, long long nvec,
             const int* __restrict__ esrc, const int* __restrict__ edst,
             const double* __restrict__ w, long long E, long long n, int vec,
             long long* best) {
  constexpr int kT = Block<kStaged>::kT;
  constexpr int kWarps = kT / 32;
  extern __shared__ uint4 stage[];
  const unsigned* sbits = reinterpret_cast<const unsigned*>(stage);
  if (kStaged) {
    const uint4* src = reinterpret_cast<const uint4*>(words);
#pragma unroll 8
    for (long long i = threadIdx.x; i < nvec; i += kT)
      stage[i] = __ldg(src + i);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * kWarps;
  const long long chunks = (E + kChunk - 1) / kChunk;
  const long long c0 = warp * chunks / nwarps;
  const long long c1 = (warp + 1) * chunks / nwarps;
  int carry_d = -1;                  // the run open at the last step's end
  long long carry_k = kNone;
  // esrc two steps ahead: 1 KB a warp in flight beside the step's reads
  int s[4], nx1[4], nx2[4];
  if (c0 < c1) load4(esrc, c0 * kChunk + 4 * lane, E, vec, nx1);
  if (c0 + 1 < c1) load4(esrc, (c0 + 1) * kChunk + 4 * lane, E, vec, nx2);
  for (long long c = c0; c < c1; ++c) {
    const long long e0 = c * kChunk + 4 * lane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = nx1[j];
      nx1[j] = nx2[j];
    }
    if (c + 2 < c1) load4(esrc, e0 + 2 * kChunk, E, vec, nx2);
    bool act[4];
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = s[j];
      act[j] = v >= 0 && v < n
               && ((kStaged ? sbits[v >> 5] : __ldg(words + (v >> 5)))
                   >> (v & 31) & 1u);
      any |= act[j];
    }
    // a step with no edge on sends nothing; the carried run stays open
    const unsigned lanes_on = __ballot_sync(kFull, any);
    if (lanes_on == 0u) continue;
    // edst, the sources' values and the weights in flight together
    int d[4] = {-1, -1, -1, -1};
    if (any) load4(edst, e0, E, vec, d);
    typename Ops::T val[4] = {};
    double wv[4] = {1.0, 1.0, 1.0, 1.0};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (act[j]) val[j] = old[s[j]];
      if (Ops::kWeighted && act[j]) wv[j] = __ldg(w + e0 + j);
    }
    long long k[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (d[j] < 0 || d[j] >= n) {
        d[j] = -1;
        act[j] = false;
      }
      k[j] = act[j] ? Ops::key(Ops::send(val[j], wv[j])) : kNone;
    }
    // run heads: an element whose destination differs from the one
    // before it in the warp's order.  A lane with no edge on is
    // transparent: the lanes on each side of it compare across it, and
    // the first lane on compares with the carry.
    const unsigned below = lanes_on & ((1u << lane) - 1u);
    const unsigned above = lane == 31 ? 0u : lanes_on & (~0u << (lane + 1));
    const int up = __shfl_sync(kFull, d[3], below ? 31 - __clz(below) : 0);
    const int dn = __shfl_sync(kFull, d[0], above ? __ffs(above) - 1 : 0);
    bool h[4];
    h[0] = any && d[0] != (below ? up : carry_d);
    h[1] = any && d[1] != d[0];
    h[2] = any && d[2] != d[1];
    h[3] = any && d[3] != d[2];
    // the lane's tail run: its min and whether it starts in this lane
    long long tv = k[3];
    if (!h[3]) {
      tv = kmin(tv, k[2]);
      if (!h[2]) {
        tv = kmin(tv, k[1]);
        if (!h[1]) tv = kmin(tv, k[0]);
      }
    }
    int F = h[0] | h[1] | h[2] | h[3];
    long long V = tv;
    // inclusive segmented scan over the lanes: V is the min of the run
    // open at this lane's end, over this lane and the lanes before it
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long ov = __shfl_up_sync(kFull, V, o);
      const int of = __shfl_up_sync(kFull, F, o);
      if (lane >= o) {
        if (!F) V = kmin(V, ov);
        F |= of;
      }
    }
    const long long pv = __shfl_up_sync(kFull, V, 1);
    const int pf = __shfl_up_sync(kFull, F, 1);
    const long long V31 = __shfl_sync(kFull, V, 31);
    const int F31 = __shfl_sync(kFull, F, 31);
    const int dlast = __shfl_sync(kFull, d[3], 31 - __clz(lanes_on));
    // the run open where this lane starts: from the lanes before it,
    // and from the carry where no run started since
    if (any) {
      long long r = lane == 0 ? carry_k : (pf ? pv : kmin(pv, carry_k));
      if (!below && h[0] && carry_d >= 0 && carry_k != kNone)
        lower(best, carry_d, carry_k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r = h[j] ? k[j] : kmin(r, k[j]);
        const bool ends = j < 3 ? h[j + 1] : (above && dn != d[3]);
        if (ends && d[j] >= 0 && r != kNone) lower(best, d[j], r);
      }
    }
    carry_k = F31 ? V31 : kmin(V31, carry_k);
    carry_d = dlast;
  }
  if (lane == 0 && carry_d >= 0 && carry_k != kNone)
    lower(best, carry_d, carry_k);
}

template <class Ops>
__global__ void __launch_bounds__(kVThreads)
finish_kernel(const typename Ops::T* __restrict__ old, long long n,
              long long* best, uint8_t* __restrict__ changed,
              unsigned long long* __restrict__ count) {
  const long long v = (long long)blockIdx.x * kVThreads + threadIdx.x;
  int lowered = 0;
  if (v < n) {
    const long long k = best[v];
    lowered = Ops::value(k) < old[v];
    best[v] = Ops::bits(k);       // the output buffer now holds the value
    changed[v] = (uint8_t)lowered;
  }
  const int c = __syncthreads_count(lowered);
  if (threadIdx.x == 0 && c > 0) atomicAdd(count, (unsigned long long)c);
}

template <class Ops, bool kStaged>
int relax_launch(const typename Ops::T* old, const unsigned* words,
                 long long nwords, const int* esrc, const int* edst,
                 const double* w, long long E, long long n, long long* best,
                 cudaStream_t stream) {
  static Resident res;
  auto kern = relax_kernel<Ops, kStaged>;
  const long long bytes = kStaged ? nwords * 4 : 0;
  constexpr int kT = Block<kStaged>::kT;
  long long grid = 0;
  const int rc = resident_grid(kern, kT, bytes, res, &grid);
  if (rc != 0) return rc;
  const long long need = cdiv(cdiv(E, kChunk), kT / 32);
  if (grid > need) grid = need;
  const int vec = (((uintptr_t)esrc | (uintptr_t)edst) & 15) == 0;
  kern<<<(unsigned)grid, kT, (size_t)bytes, stream>>>(
      old, words, nwords / 4, esrc, edst, w, E, n, vec, best);
  return 0;
}

template <class Ops>
int relax_step(const typename Ops::T* old, const uint8_t* mask,
               const int* esrc, const int* edst, const double* w,
               long long E, long long n, unsigned* words, int staged,
               typename Ops::T* out, uint8_t* changed, long long* count,
               cudaStream_t stream) {
  unsigned long long* cnt = reinterpret_cast<unsigned long long*>(count);
  if (n <= 0) {
    cudaMemsetAsync(count, 0, sizeof(long long), stream);
    return (int)cudaGetLastError();
  }
  long long* best = reinterpret_cast<long long*>(out);
  const long long nwords = cdiv(n, 128) * 4;     // whole 16-byte vectors
  prologue_kernel<Ops><<<(unsigned)cdiv(nwords * 32, kVThreads), kVThreads,
                         0, stream>>>(old, mask, n, nwords, best, words,
                                      cnt);
  if (E > 0) {
    const int rc = staged
        ? relax_launch<Ops, true>(old, words, nwords, esrc, edst, w, E, n,
                                  best, stream)
        : relax_launch<Ops, false>(old, words, nwords, esrc, edst, w, E, n,
                                   best, stream);
    if (rc != 0) return rc;
  }
  finish_kernel<Ops><<<(unsigned)cdiv(n, kVThreads), kVThreads, 0,
                       stream>>>(old, n, best, changed, cnt);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes the staged route takes for n vertices: ceil(n / 32)
// words, rounded up to 16 bytes (the size of the `words` scratch too).
extern "C" long long nt_relax_stage_bytes(long long n) {
  return cdiv(n, 128) * 16;
}

// label / new_label (n) int64, active / changed (n) bool, esrc / edst (E)
// int32, words nt_relax_stage_bytes(n) bytes of scratch, staged = 1 for
// the staged route (the wrapper checks that it fits), count one int64.
extern "C" int nt_wcc_step(const long long* label, const uint8_t* active,
                           const int* esrc, const int* edst, long long E,
                           long long n, unsigned* words, int staged,
                           long long* new_label, uint8_t* changed,
                           long long* count, void* stream) {
  return relax_step<WccOps>(label, active, esrc, edst, nullptr, E, n, words,
                            staged, new_label, changed, count,
                            (cudaStream_t)stream);
}

// dist / new_dist (n) float64, front / changed (n) bool, esrc / edst (E)
// int32, w (E) float64 or null (every edge weighs 1.0), the rest as
// nt_wcc_step.
extern "C" int nt_sssp_step(const double* dist, const uint8_t* front,
                            const int* esrc, const int* edst, const double* w,
                            long long E, long long n, unsigned* words,
                            int staged, double* new_dist, uint8_t* changed,
                            long long* count, void* stream) {
  if (w != nullptr)
    return relax_step<SsspOps<true>>(dist, front, esrc, edst, w, E, n, words,
                                     staged, new_dist, changed, count,
                                     (cudaStream_t)stream);
  return relax_step<SsspOps<false>>(dist, front, esrc, edst, nullptr, E, n,
                                    words, staged, new_dist, changed, count,
                                    (cudaStream_t)stream);
}
