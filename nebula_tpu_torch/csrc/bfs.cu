// bfs_probe and bfs_level — the two device programs of the single-device
// direction-optimizing BFS that the GO kernels do not already cover
// (Queue B K11).  The BFS's expansion, WHERE mask, top-down marks and hub
// bits reuse expand (K1), predicate_mask (K4), mark (K2) and extend_hubs
// (K8); gpu/bfs.py:run_bfs drives them level by level.
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
// routes by src (row src % P, column src / P), never by p.  The
// membership lookup reads the first vmax columns of the frontier buffer
// through its row stride `fld` (vmax, or vmax + H on a split snapshot);
// the mark writes the candidate bitmap through its stride `old`.  Only
// ones are stored, so a vertex reached by several slots, kept or not,
// can never be cleared (mark.cu).  Slots past total[p], and negative or
// out-of-range ids, set nothing.
//
// bfs_level replaces the level update of nebula_tpu/tpu/bfs.py:
// build_bfs_fn_local (:170-172) and the two popcounts of its switch
// (:153-159):
//     new   = cand & (dist < 0)
//     dist  = where(new, level, dist)
//     fbm   = new;  unvis = dist < 0
//     counts += (|new|, |unvis|)
// one fused elementwise pass over (P, vmax); cand, fbm and unvis are the
// first vmax columns of their buffers, each with its own row stride.
// Each block reduces its two counts (packed into one 64-bit word: a
// block's counts stay below 2^31) and adds them with one integer
// atomicAdd each, so the sums are exact in any order.  Phantom slots
// (local index >= num_vertices[p]) are never candidates: they stay -1
// and count as unvisited, as in the reference, which subtracts their
// number on the host.
//
// Bounds: both are byte-bound.  bfs_probe reads 8 bytes of every valid
// slot (nbr, and src where the frontier bit is set; 1 more with keep)
// and one frontier byte per slot at a scattered address, and writes one
// byte per reached vertex; its frontier reads are gathers, so it runs
// under the streaming rate.  bfs_level streams 7 bytes an element (cand 1,
// dist 4, fbm 1, unvis 1) and writes 4 more for each vertex the level
// reaches: 7-11 MB at the north star's 1M slots, a few microseconds, so it
// is launch-bound there.
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads)
bfs_probe_kernel(const int* __restrict__ src, const int* __restrict__ nbr,
                 const uint8_t* __restrict__ keep,
                 const int* __restrict__ total, int P, int EB, int vmax,
                 const uint8_t* __restrict__ fbm, long long fld,
                 uint8_t* __restrict__ out, long long old) {
  const int p = blockIdx.y;
  const int n = min(total[p], EB);
  const long long lim = (long long)P * vmax;
  const size_t row = (size_t)p * EB;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < n; j += (long long)gridDim.x * blockDim.x) {
    const int nb = nbr[row + j];
    if (nb < 0 || nb >= lim) continue;
    if (keep != nullptr && !keep[row + j]) continue;
    if (!fbm[(size_t)(nb % P) * fld + nb / P]) continue;
    const int s = src[row + j];
    if (s < 0 || s >= lim) continue;
    out[(size_t)(s % P) * old + s / P] = 1;
  }
}

__global__ void __launch_bounds__(kThreads)
bfs_level_kernel(const uint8_t* __restrict__ cand, long long cld,
                 int* __restrict__ dist, int P, int vmax, int level,
                 uint8_t* __restrict__ fbm, long long fld,
                 uint8_t* __restrict__ unvis, long long uld,
                 unsigned long long* __restrict__ counts) {
  using Reduce = cub::BlockReduce<unsigned long long, kThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  const long long n = (long long)P * vmax;
  unsigned long long n_new = 0, n_unvis = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / vmax, v = i - p * vmax;
    int d = dist[i];
    const bool fresh = cand[p * cld + v] && d < 0;
    if (fresh) {
      d = level;
      dist[i] = d;
    }
    fbm[p * fld + v] = fresh;
    unvis[p * uld + v] = d < 0;
    n_new += fresh;
    n_unvis += d < 0;
  }
  const unsigned long long sum = Reduce(tmp).Sum((n_new << 32) | n_unvis);
  if (threadIdx.x == 0 && sum != 0) {
    atomicAdd(&counts[0], sum >> 32);
    atomicAdd(&counts[1], sum & 0xffffffffULL);
  }
}

}  // namespace

extern "C" int nt_bfs_probe(const int* src, const int* nbr,
                            const uint8_t* keep, const int* total, int P,
                            int EB, int vmax, const uint8_t* fbm,
                            long long fld, uint8_t* out, long long old,
                            void* stream) {
  if (P > 0 && EB > 0) {
    long long gx = (EB + kThreads - 1) / kThreads;
    if (gx > kMaxBlocks) gx = kMaxBlocks;
    bfs_probe_kernel<<<dim3((unsigned)gx, (unsigned)P), kThreads, 0,
                       (cudaStream_t)stream>>>(src, nbr, keep, total, P, EB,
                                               vmax, fbm, fld, out, old);
  }
  return (int)cudaGetLastError();
}

extern "C" int nt_bfs_level(const uint8_t* cand, long long cld, int* dist,
                            int P, int vmax, int level, uint8_t* fbm,
                            long long fld, uint8_t* unvis, long long uld,
                            unsigned long long* counts, void* stream) {
  cudaError_t rc = cudaMemsetAsync(counts, 0, 2 * sizeof(unsigned long long),
                                   (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  const long long n = (long long)P * vmax;
  if (n > 0) {
    long long g = (n + kThreads - 1) / kThreads;
    if (g > kMaxBlocks) g = kMaxBlocks;
    bfs_level_kernel<<<(int)g, kThreads, 0, (cudaStream_t)stream>>>(
        cand, cld, dist, P, vmax, level, fbm, fld, unvis, uld, counts);
  }
  return (int)cudaGetLastError();
}
