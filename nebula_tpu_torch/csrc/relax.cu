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
// this launch has lowered.  So the three launches are
//   1. keys: new[v] = key(old[v]);
//   2. relax: per edge (grid-stride, so the 2M-in-edge destination costs
//      its edges, spread over the grid), atomicMin(new[dst], key(send))
//      after a plain read shows it would lower the value (values only
//      fall, so a stale read costs an atomic, never a wrong result);
//   3. finish: new[v] = value(new[v]), changed = new < old, count.
//
// Bound: bytes — esrc (4 bytes) of every edge; edst (4) and, weighted,
// the weight (8) of every edge whose source is in the mask; the old
// value and mask once per vertex, gathered per edge (mostly from L2);
// new value and changed flag once per vertex.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// key: the int64 whose signed order is the value order; bits: the stored
// int64 word of the value a key stands for; value: that value.
struct WccOps {
  using T = long long;
  static __device__ long long key(long long v) { return v; }
  static __device__ long long bits(long long k) { return k; }
  static __device__ long long value(long long k) { return k; }
  static __device__ long long send(long long v, const double*, long long) {
    return v;
  }
};

template <bool kWeighted>
struct SsspOps {
  using T = double;
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
  static __device__ double send(double v, const double* w, long long e) {
    return kWeighted ? __dadd_rn(v, w[e]) : __dadd_rn(v, 1.0);
  }
};

template <class Ops>
__global__ void __launch_bounds__(kThreads)
keys_kernel(const typename Ops::T* __restrict__ old, long long n,
            long long* __restrict__ best) {
  const long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (v < n) best[v] = Ops::key(old[v]);
}

template <class Ops>
__global__ void __launch_bounds__(kThreads)
relax_kernel(const typename Ops::T* __restrict__ old,
             const uint8_t* __restrict__ mask, const int* __restrict__ esrc,
             const int* __restrict__ edst, const double* __restrict__ w,
             long long E, long long n, long long* best) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < E;
       e += step) {
    const int s = esrc[e];
    if (s < 0 || s >= n || !mask[s]) continue;
    const int d = edst[e];
    if (d < 0 || d >= n) continue;
    const long long k = Ops::key(Ops::send(old[s], w, e));
    if (k < best[d]) atomicMin(best + d, k);
  }
}

template <class Ops>
__global__ void __launch_bounds__(kThreads)
finish_kernel(const typename Ops::T* __restrict__ old, long long n,
              long long* best, uint8_t* __restrict__ changed,
              unsigned long long* __restrict__ count) {
  const long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
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

template <class Ops>
int relax_step(const typename Ops::T* old, const uint8_t* mask,
               const int* esrc, const int* edst, const double* w,
               long long E, long long n, typename Ops::T* out,
               uint8_t* changed, long long* count, cudaStream_t stream) {
  cudaMemsetAsync(count, 0, sizeof(long long), stream);
  if (n <= 0) return (int)cudaGetLastError();
  long long* best = reinterpret_cast<long long*>(out);
  const unsigned vblocks = (unsigned)((n + kThreads - 1) / kThreads);
  keys_kernel<Ops><<<vblocks, kThreads, 0, stream>>>(old, n, best);
  long long g = (E + kThreads - 1) / kThreads;
  if (g > 132 * 16) g = 132 * 16;
  if (g > 0)
    relax_kernel<Ops><<<(unsigned)g, kThreads, 0, stream>>>(
        old, mask, esrc, edst, w, E, n, best);
  finish_kernel<Ops><<<vblocks, kThreads, 0, stream>>>(
      old, n, best, changed, reinterpret_cast<unsigned long long*>(count));
  return (int)cudaGetLastError();
}

}  // namespace

// label / new_label (n) int64, active / changed (n) bool, esrc / edst (E)
// int32, count one int64.
extern "C" int nt_wcc_step(const long long* label, const uint8_t* active,
                           const int* esrc, const int* edst, long long E,
                           long long n, long long* new_label,
                           uint8_t* changed, long long* count, void* stream) {
  return relax_step<WccOps>(label, active, esrc, edst, nullptr, E, n,
                            new_label, changed, count,
                            (cudaStream_t)stream);
}

// dist / new_dist (n) float64, front / changed (n) bool, esrc / edst (E)
// int32, w (E) float64 or null (every edge weighs 1.0), count one int64.
extern "C" int nt_sssp_step(const double* dist, const uint8_t* front,
                            const int* esrc, const int* edst, const double* w,
                            long long E, long long n, double* new_dist,
                            uint8_t* changed, long long* count,
                            void* stream) {
  if (w != nullptr)
    return relax_step<SsspOps<true>>(dist, front, esrc, edst, w, E, n,
                                     new_dist, changed, count,
                                     (cudaStream_t)stream);
  return relax_step<SsspOps<false>>(dist, front, esrc, edst, nullptr, E, n,
                                    new_dist, changed, count,
                                    (cudaStream_t)stream);
}
