// bfs_probe and bfs_level — the two device programs of the single-device
// direction-optimizing BFS that the GO kernels do not already cover
// (Queue B K11).  The BFS's expansion (hub bits read from their owners'
// rows, K8 folded in), WHERE mask and top-down marks reuse expand (K1),
// predicate_mask (K4) and mark (K2); gpu/bfs.py:run_bfs drives them level
// by level.
//
// bfs_probe replaces the bottom-up membership test of
// nebula_tpu/algo/frontier.py:bottom_up_step (:136-141):
//     member = fbm[nb % P, nb // P] & keep
//     cand  |= _mark(src, member)
// over the slots that expand made from the REVERSE block and the
// unvisited bitmap: slot j of part p is the in-edge nb -> src of an
// unvisited vertex src.  src is reached when its in-neighbour nb is on
// the frontier and the WHERE mask keeps the edge.  A degree-split hub
// row's src is the hub's dense id, owned by another part, so the mark
// routes by src (row src % P, column src / P), never by p.  The frontier
// comes as bits: the (P, W) 32-bit words of the (P, vmax) frontier
// bitmap, W = ceil(vmax / 32), bit i of word w = column 32w + i (the
// layout of pack_bits, and of the words bfs_level writes).  The mark
// writes the candidate bitmap through its row stride `old`.  Only ones
// are stored, so a vertex reached by several slots, kept or not, can
// never be cleared (mark.cu).  Slots past total[p], and negative or
// out-of-range ids, set nothing.
//
// bfs_level replaces the level update of nebula_tpu/tpu/bfs.py:
// build_bfs_fn_local (:170-172) and the two popcounts of its switch
// (:153-159):
//     new   = cand & (dist < 0)
//     dist  = where(new, level, dist)
//     fbm   = new;  unvis = dist < 0
//     counts += (|new|, |unvis|)
// one fused pass over (P, vmax); cand, fbm and unvis are the first vmax
// columns of their buffers, each with its own row stride.  It also
// clears cand, whose last reader it is in a level, and, given `fbits`,
// writes the new frontier as (P, W) words for the next level's probe.
// Phantom slots (local index >= num_vertices[p]) are never candidates:
// they stay -1 and count as unvisited, as in the reference, which
// subtracts their number on the host.
//
// Bounds: both are byte-bound.  bfs_probe reads 4 bytes of nbr a valid
// slot (1 more with keep), src where the slot's neighbour is on the
// frontier, and the frontier's words once; it writes one byte per
// reached vertex.  bfs_level streams cand, dist, fbm and unvis (7 bytes
// an element), writes 4 more for each vertex the level reaches, 1 for
// each candidate it clears and the words: about 8 MB at the north
// star's 1M slots, a few microseconds, so its launch is much of it.
//
// The parent design, one thread a slot gathering the neighbour's
// frontier BYTE from device memory, ran at the L2 gather rate: the 1 MB
// frontier misses L1, every slot took a 32-byte sector for one byte
// (15.4M gathers at the BFS's widest level, 5.5x the byte bound).  So:
//
//  * bfs_probe tests membership in bits.  On the "staged" route each
//    block of a persistent grid (one a resident slot, 1,024 threads)
//    copies the P * W words into its shared memory with 16-byte loads
//    (125,024 bytes at the north star; up to the 232,448 a block may
//    take on an H100), and a slot's test is one shared-memory load.  The
//    "global" route, for a frontier past that, reads the same words
//    through the read-only cache (125 KB a million vertices, L2- and
//    mostly L1-resident).
//  * The slots are walked as groups of 4, aligned in the flat (P, EB)
//    arrays: row p's valid prefix min(total[p], EB) covers whole groups
//    and a partial one at each end.  Each block takes one contiguous
//    share of all rows' groups, so short rows idle no block, and a
//    thread takes every 1,024th (512th) group of that share, kUnroll at
//    a time, whichever row each lies in: no thread walks a row's head,
//    body and tail in turn, row after row (the first version did, and a
//    level of a few hundred slots took longer than the parent's
//    kernel).  The row of a group comes from the rows' group counts,
//    which every warp reads 32 at a time and scans with shuffles (so no
//    shared memory is taken from the stage), carried from batch to
//    batch while a batch lies in one row.
//    A whole group loads nbr and src as 16-byte vectors and keep as 4
//    bytes; a partial group, or unaligned arrays, slot by slot.  src is
//    loaded with nbr, not after the test: at a bottom-up level the
//    frontier holds a large share of the vertices, so most of src's
//    sectors are needed anyway, and the eager load takes a dependent
//    round trip off every group.  nb % P and nb / P come from a
//    multiplier fixed for the launch (fastdiv.cuh).  A thread stores a
//    vertex once for a run of its slots with the same src (expand
//    groups a vertex's in-edges together).
//  * bfs_level is one launch: a warp takes 32 consecutive columns of a
//    row, a lane one column; __ballot_sync of "fresh" is the frontier's
//    word, stored by lane 0, and __popc of the "fresh" and "unvisited"
//    ballots gives the counts, summed over the block's warps and added
//    with one 64-bit atomicAdd each into the caller's zeroed counts (so
//    the sums are exact in any order, and no memset runs a level).
//
// Measured on an H100 (chip_smoke.py [6c], [6d]; PERF.md): beside
// variants that took src after the test, four groups a thread, 2-4
// words a warp step or 1,024-thread level blocks, this layout was the
// fastest on the whole BFS run; the level update takes the same time
// without its atomics, so they are not what holds it.
#include <cstdint>
#include <cuda_runtime.h>

#include "fastdiv.cuh"
#include "launch.cuh"

// The shared memory of the staged route, the (P, vmax) frontier as bits
// rounded up to 16 bytes: mark.cu's staged bitmap has the same size.
extern "C" long long nt_mark_stage_bytes(int P, int vmax);

namespace {

constexpr int kLevelThreads = 256;
constexpr int kUnroll = 2;            // groups a probe thread loads at once
constexpr unsigned kFull = 0xffffffffu;

// probe block size a route: the staged route has one block an SM (its
// words fill shared memory at the main path's frontier), so a wide one
template <bool kStaged>
struct Probe {
  static constexpr int kT = kStaged ? 1024 : 512;
};

struct ProbeArgs {
  const int* src;
  const int* nbr;
  const uint8_t* keep;    // null: every valid slot is kept
  const int* total;
  int P, EB, W;
  long long lim;          // P * vmax: ids at or past it set nothing
  FastDiv byP;
  const unsigned* words;  // (P, W) frontier bits
  uint8_t* out;
  long long old;
  int vec;                // nbr, src 16-byte and keep 4-byte aligned
};

template <bool kStaged>
__device__ __forceinline__ bool on_frontier(const ProbeArgs& a,
                                            const unsigned* bits, int nb) {
  const unsigned q = div_of((unsigned)nb, a.byP);
  const unsigned r = (unsigned)nb - q * a.byP.d;
  const size_t w = (size_t)r * a.W + (q >> 5);
  return ((kStaged ? bits[w] : __ldg(bits + w)) >> (q & 31)) & 1u;
}

__device__ __forceinline__ bool in_range(const ProbeArgs& a, int id) {
  return id >= 0 && id < a.lim;
}

__device__ __forceinline__ void reach(const ProbeArgs& a, int s, int& last) {
  if (s == last || !in_range(a, s)) return;
  last = s;
  const unsigned q = div_of((unsigned)s, a.byP);
  a.out[(size_t)(s - (int)(q * a.byP.d)) * a.old + q] = 1;
}

// Slots [i, i + 4) of the flat (P, EB) arrays that lie in [r0, r1): nbr,
// src and keep as one 16-byte, 16-byte and 4-byte load where all four
// lie inside and the arrays are aligned (`vec`), else slot by slot; a
// slot outside reads nbr -1 (sets nothing).
struct Group {
  int4 nb, s;
  unsigned k;
};

__device__ __forceinline__ Group load_group(const ProbeArgs& a,
                                            long long i, long long r0,
                                            long long r1) {
  Group g{make_int4(-1, -1, -1, -1), make_int4(-1, -1, -1, -1),
          0x01010101u};
  if (a.vec && i >= r0 && i + 4 <= r1) {
    g.nb = __ldg(reinterpret_cast<const int4*>(a.nbr + i));
    g.s = __ldg(reinterpret_cast<const int4*>(a.src + i));
    if (a.keep != nullptr)
      g.k = __ldg(reinterpret_cast<const unsigned*>(a.keep + i));
    return g;
  }
  int nb[4], s[4];
  unsigned k = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const bool in = i + t >= r0 && i + t < r1;
    nb[t] = in ? __ldg(a.nbr + i + t) : -1;
    s[t] = in ? __ldg(a.src + i + t) : -1;
    k |= (unsigned)(a.keep == nullptr || (in && a.keep[i + t])) << (8 * t);
  }
  g.nb = make_int4(nb[0], nb[1], nb[2], nb[3]);
  g.s = make_int4(s[0], s[1], s[2], s[3]);
  g.k = k;
  return g;
}

template <bool kStaged>
__device__ __forceinline__ void probe_group(const ProbeArgs& a,
                                            const unsigned* bits,
                                            const Group& g, int& last) {
  const int nb[4] = {g.nb.x, g.nb.y, g.nb.z, g.nb.w};
  const int s[4] = {g.s.x, g.s.y, g.s.z, g.s.w};
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (in_range(a, nb[t]) && (g.k >> (8 * t) & 0xffu)
        && on_frontier<kStaged>(a, bits, nb[t]))
      reach(a, s[t], last);
}

// Groups of 4 slots, aligned in the flat arrays, that hold row p's valid
// slots [p * EB, p * EB + n)
__device__ __forceinline__ long long groups_of(const ProbeArgs& a, int p,
                                               long long n) {
  const long long r0 = (long long)p * a.EB;
  return n > 0 ? (r0 + n - 1) / 4 - r0 / 4 + 1 : 0;
}

__device__ __forceinline__ long long valid_of(const ProbeArgs& a, int p) {
  return p < a.P ? min(max(__ldg(a.total + p), 0), a.EB) : 0;
}

template <bool kStaged>
__global__ void __launch_bounds__(Probe<kStaged>::kT)
bfs_probe_kernel(ProbeArgs a) {
  constexpr int kT = Probe<kStaged>::kT;
  extern __shared__ uint4 stage[];
  const int lane = threadIdx.x & 31;
  // every warp reads 32 rows' totals at once and scans them with
  // shuffles, so that all warps agree on the rows without shared memory
  long long G = 0;
  for (int c = 0; c < a.P; c += 32) {
    long long g = groups_of(a, c + lane, valid_of(a, c + lane));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) g += __shfl_xor_sync(kFull, g, o);
    G += g;
  }
  if (kStaged) {
    const long long nwords = (long long)a.P * a.W;
    unsigned* sw = reinterpret_cast<unsigned*>(stage);
    long long i = threadIdx.x;
    if (((uintptr_t)a.words & 15) == 0) {
      const uint4* gw = reinterpret_cast<const uint4*>(a.words);
#pragma unroll 4
      for (; i < nwords >> 2; i += kT) stage[i] = __ldg(gw + i);
      i = ((nwords >> 2) << 2) + threadIdx.x;
    }
    for (; i < nwords; i += kT) sw[i] = __ldg(a.words + i);
    __syncthreads();
  }
  const unsigned* bits =
      kStaged ? reinterpret_cast<const unsigned*>(stage) : a.words;
  // this block's share of all rows' groups; a thread takes every kT-th
  // group of it, kUnroll at a time, whichever rows they fall in
  const long long gb0 = G * blockIdx.x / gridDim.x;
  const long long gb1 = G * (blockIdx.x + 1) / gridDim.x;
  int last = -1;
  long long before = 0;               // groups of the rows before chunk c
  for (int c = 0; c < a.P && before < gb1; c += 32) {
    const long long n = valid_of(a, c + lane);
    const long long ng = groups_of(a, c + lane, n);
    long long incl = ng;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long x = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += x;
    }
    const long long first = before + incl - ng;   // row c + lane's first
    const long long end = before + __shfl_sync(kFull, incl, 31);
    const int m = min(32, a.P - c);
    const long long lo = max(gb0, before), hi = min(gb1, end);
    // the row of the batch's first group, carried from batch to batch:
    // a batch inside one row (nearly all, on wide rows) needs no search
    int jb = 0;
    long long eb = m > 1 ? __shfl_sync(kFull, first, 1) : end;
    for (long long g0 = lo; g0 < hi; g0 += (long long)kT * kUnroll) {
      while (g0 >= eb) {
        ++jb;
        eb = jb + 1 < m ? __shfl_sync(kFull, first, jb + 1) : end;
      }
      const bool one_row = g0 + (long long)kT * kUnroll <= eb;
      Group grp[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long g = g0 + (long long)u * kT + threadIdx.x;
        const long long gq = g < hi ? g : lo;
        // else the row holding group gq: the last of the chunk starting
        // at or before it (a row without groups starts where the next
        // does)
        int j = jb;
        if (!one_row) {
          j = 0;
#pragma unroll
          for (int step = 16; step > 0; step >>= 1) {
            const long long f = __shfl_sync(kFull, first, j + step);
            if (j + step < m && f <= gq) j += step;
          }
        }
        const long long fj = __shfl_sync(kFull, first, j);
        const long long nj = __shfl_sync(kFull, n, j);
        const long long r0 = (long long)(c + j) * a.EB;
        grp[u] = g < hi ? load_group(a, (r0 / 4 + gq - fj) * 4, r0, r0 + nj)
                        : Group{make_int4(-1, -1, -1, -1),
                                make_int4(-1, -1, -1, -1), 0u};
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        probe_group<kStaged>(a, bits, grp[u], last);
    }
    before = end;
  }
}

__global__ void __launch_bounds__(kLevelThreads)
bfs_level_kernel(uint8_t* __restrict__ cand, long long cld,
                 int* __restrict__ dist, int vmax, long long nwords,
                 FastDiv byW, int level, uint8_t* __restrict__ fbm,
                 long long fld, uint8_t* __restrict__ unvis, long long uld,
                 unsigned* __restrict__ fbits,
                 unsigned long long* __restrict__ counts) {
  constexpr int kWarps = kLevelThreads / 32;
  __shared__ unsigned long long part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned W = byW.d;
  unsigned long long acc = 0;         // (fresh << 32) | unvisited, lane 0
  for (long long w = (long long)blockIdx.x * kWarps + warp; w < nwords;
       w += (long long)gridDim.x * kWarps) {
    const unsigned p = div_of((unsigned)w, byW);
    const int v = (int)((unsigned)w - p * W) * 32 + lane;
    bool fresh = false, un = false;
    if (v < vmax) {
      const size_t i = (size_t)p * vmax + v;
      uint8_t* c = cand + (size_t)p * cld + v;
      const int d = dist[i];
      const bool hit = *c != 0;
      fresh = hit && d < 0;
      un = d < 0 && !fresh;
      if (fresh) dist[i] = level;
      if (hit) *c = 0;
      fbm[(size_t)p * fld + v] = fresh;
      unvis[(size_t)p * uld + v] = un;
    }
    const unsigned fb = __ballot_sync(kFull, fresh);
    const unsigned ub = __ballot_sync(kFull, un);
    if (lane == 0) {
      if (fbits != nullptr) fbits[w] = fb;
      acc += (unsigned long long)__popc(fb) << 32 | (unsigned)__popc(ub);
    }
  }
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) sum += part[i];
    if (sum >> 32) atomicAdd(&counts[0], sum >> 32);
    if (sum & 0xffffffffULL) atomicAdd(&counts[1], sum & 0xffffffffULL);
  }
}

template <bool kStaged>
int probe_launch(const ProbeArgs& a, int vmax, cudaStream_t stream) {
  static Resident res;
  auto kern = bfs_probe_kernel<kStaged>;
  const long long bytes = kStaged ? nt_mark_stage_bytes(a.P, vmax) : 0;
  constexpr int kT = Probe<kStaged>::kT;
  long long grid = 0;
  const int rc = resident_grid(kern, kT, bytes, res, &grid);
  if (rc != 0) return rc;
  const long long need = cdiv(cdiv((long long)a.P * a.EB, 4) + a.P,
                              (long long)kT * kUnroll);
  if (grid > need) grid = need;
  kern<<<(unsigned)grid, kT, (size_t)bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// src / nbr (P, EB) int32, keep (P, EB) bool or null, total (P,) int32,
// words the (P, ceil(vmax / 32)) frontier bits, staged = 1 for the
// staged route (the wrapper checks that it fits), out the candidate
// bitmap's first vmax columns, rows `old` bytes apart.
extern "C" int nt_bfs_probe(const int* src, const int* nbr,
                            const uint8_t* keep, const int* total, int P,
                            int EB, int vmax, const unsigned* words,
                            int staged, uint8_t* out, long long old,
                            void* stream) {
  if (P <= 0 || EB <= 0 || vmax <= 0) return 0;
  const int vec = (((uintptr_t)src | (uintptr_t)nbr) & 15) == 0
                  && ((uintptr_t)keep & 3) == 0;
  ProbeArgs a{src, nbr, keep, total, P, EB, (int)cdiv(vmax, 32),
              (long long)P * vmax, make_div((unsigned)P), words, out, old,
              vec};
  return staged ? probe_launch<true>(a, vmax, (cudaStream_t)stream)
                : probe_launch<false>(a, vmax, (cudaStream_t)stream);
}

// cand / fbm / unvis the first vmax columns of (P, *) bool buffers, rows
// cld / fld / uld bytes apart; dist (P, vmax) int32; fbits (P,
// ceil(vmax / 32)) words or null; counts two int64, zeroed by the
// caller, that the level's (|new|, |unvisited|) are added to.
extern "C" int nt_bfs_level(uint8_t* cand, long long cld, int* dist, int P,
                            int vmax, int level, uint8_t* fbm, long long fld,
                            uint8_t* unvis, long long uld, unsigned* fbits,
                            unsigned long long* counts, void* stream) {
  const long long W = cdiv(vmax, 32);
  const long long nwords = (long long)P * W;
  if (nwords <= 0) return 0;
  long long g = cdiv(nwords, kLevelThreads / 32);
  const long long cap = (long long)num_sms() * 8;
  if (g > cap) g = cap;
  bfs_level_kernel<<<(unsigned)g, kLevelThreads, 0, (cudaStream_t)stream>>>(
      cand, cld, dist, vmax, nwords, make_div((unsigned)W), level, fbm, fld,
      unvis, uld, fbits, counts);
  return (int)cudaGetLastError();
}
