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
//   blocks [P, ..)  the base slots, grid-stride: slot j of part p is valid
//                   when j < total[p] and its eidx is not among the sorted,
//                   MAXI-padded tombstones d_tomb[p] — a lower-bound binary
//                   search, the semantics of jnp.searchsorted(side="left")
//                   with the position clipped to Tcap - 1.  A tombstoned
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
// byte and writes 17.  The tombstone rows (4 * Tcap bytes a part) are read
// from cache by every search of that part: 13 probes for Tcap = 8192.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
merge_delta_kernel(const int* __restrict__ total,
                   const uint8_t* __restrict__ fbm, long long fbm_ld,
                   int vmax, const int* __restrict__ d_src,
                   const int* __restrict__ d_dst,
                   const int* __restrict__ d_rank,
                   const uint8_t* __restrict__ d_valid, int Dcap,
                   const int* __restrict__ d_tomb, int Tcap, int P, int EB,
                   int emax, int parts, int pid, int* __restrict__ src,
                   int* __restrict__ dst, int* __restrict__ rk,
                   int* __restrict__ eidx,
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
    __shared__ int part_sums[kThreads / 32];
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_down_sync(0xffffffffu, count, off);
    if ((threadIdx.x & 31) == 0) part_sums[threadIdx.x >> 5] = count;
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int w = 0; w < kThreads / 32; ++w) sum += part_sums[w];
      total_out[p] = total[p] + sum;
    }
    return;
  }
  const long long n = (long long)P * EB;
  const long long step = (long long)(gridDim.x - P) * blockDim.x;
  for (long long i = (long long)(blockIdx.x - P) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    const int p = (int)(i / EB);
    const int j = (int)(i % EB);
    const size_t o = (size_t)p * W + j;
    bool v = j < total[p];
    if (v && Tcap > 0) {
      const int e = eidx[o];
      const int* t = d_tomb + (size_t)p * Tcap;
      int lo = 0, hi = Tcap;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (t[mid] < e) lo = mid + 1; else hi = mid;
      }
      if (lo > Tcap - 1) lo = Tcap - 1;
      if (t[lo] == e) {
        v = false;
        dst[o] = -1;
      }
    }
    valid[o] = v ? 1 : 0;
  }
}

}  // namespace

// src/dst/rk/eidx and valid are (L * P, EB + Dcap), row-contiguous; fbm
// is an (L * P, vmax) bitmap whose rows are fbm_ld bytes apart; total and
// total_out (L * P,); d_src/d_dst/d_rank/d_valid are (P, Dcap), d_tomb
// (P, Tcap), shared by the lanes.  total is read, total_out written;
// they may not alias.  L = 1 for a solo call.  parts, pid: see "Shard
// slots" above.
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
  long long nb = ((long long)P * EB + kThreads - 1) / kThreads;
  if (nb > 132 * 16) nb = 132 * 16;
  merge_delta_kernel<<<dim3((unsigned)(P + nb), L), kThreads, 0,
                       (cudaStream_t)stream>>>(
      total, fbm, fbm_ld, vmax, d_src, d_dst, d_rank, d_valid, Dcap, d_tomb,
      Tcap, P, EB, emax, parts, pid, src, dst, rk, eidx, valid, total_out);
  return (int)cudaGetLastError();
}
