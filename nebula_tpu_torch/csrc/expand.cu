// expand — frontier-bitmap CSR expansion of one block (Queue B K1).
//
// Replaces nebula_tpu/tpu/hop.py:_expand_block (:58), which XLA compiled
// from jnp ops: degree mask, cumsum to slot starts, a cumsum-scatter map
// from slot to row, and gathers of nbr/rank.  For each part p of the
// (P, vmax) bitmap `fbm`, the expanded slots are the edges of the active
// rows in ascending row, then ascending eidx order — the (part, src)
// contiguous order the host materializers rely on (hop.py:39-43).
//
// Two C entry points, with one small device-to-host read between them:
//   nt_expand_scan  masked degree → exclusive scan → starts (P, vmax)
//                   and total (P,) — scan.cuh's three phases;
//   (host)          reads total and sizes the slot arrays exactly at
//                   EB = max(total), where the reference climbed a
//                   power-of-two ladder because XLA needs static shapes;
//   nt_expand_fill  writes src/dst/rank/eidx (P, EB) int32: one warp per
//                   32 consecutive rows ballots the active ones and copies
//                   each active row's edge range with its 32 lanes; slots
//                   at and past total[p] get the reference's padding
//                   (src = dst = -1, rank = eidx = 0).  The rows of the
//                   four arrays are `ld` >= EB slots apart: a block with a
//                   delta plane gets them EB + Dcap wide, the tail padded
//                   here and then filled by merge_delta (delta.cu), so its
//                   base slots are never copied.
//
// Query lanes (Queue B K10, nebula_tpu/tpu/hop.py:619
// build_traverse_fn_lanes, which vmaps the hop program over a leading
// lane axis with the CSR shared): fbm may be an (L, P, vmax) stack of L
// statements' frontiers.  Both entry points then run over its L * P rows
// in ONE launch each: row q = l * P + p reads the CSR of part p = q % P
// and frontier row q, and writes starts, total and slot row q, so lane l
// of the outputs is exactly the solo expansion of its frontier (the
// copy kernel takes the lane from blockIdx.y and runs the solo body on
// that lane's rows).  The host's one read is max(total) over every
// lane: the shared slot width.
// L = 1 is the solo call, bit for bit.
//
// Degree-split snapshots (nebula_tpu/tpu/hop.py:104-110): a block then has
// vmax_local + H rows per part, the last H being hub rows, and fbm is the
// (P, vmax_local + H) bitmap with the hub bits filled in (hubs.cu).  A
// local row r of part p is vertex r * P + p; hub row vmax_local + h is
// vertex hub_dense[h].  Nothing else changes: hub rows are scanned and
// copied like any other row, after the local rows, so slots stay in
// ascending row, then eidx, order.
//
// Shard slots (Queue B K17, nebula_tpu/tpu/hop.py:_expand_block's `pid`):
// on the sharded mesh a slot holds only its own part's CSR row, so the
// vertex of a local row is r * parts + pid (the mesh's part count and the
// slot's part), where the rows' own index would give r * 1 + 0.
//
// Bound: bytes.  It reads indptr and fbm once (5 bytes a row), nbr and
// rank of the expanded edges (8 bytes an edge) and writes 16 bytes a slot,
// at 3.35 TB/s; it does no arithmetic worth counting.  The design keeps
// every load and store of the copy coalesced along a row.  Its known
// weakness is load balance: a Zipf supernode's row of hundreds of
// thousands of edges is walked by one warp while the others finish, so
// the longest row, not the byte count, can set the time.
#include "scan.cuh"

namespace {

// q: a frontier row (lane * P + part); the CSR row is part q % P
struct MaskedDegree {
  const int* __restrict__ indptr;
  const uint8_t* __restrict__ fbm;
  int vmax, P;
  __device__ int operator()(int q, int i) const {
    if (!fbm[(size_t)q * vmax + i]) return 0;
    const int* ip = indptr + (size_t)(q % P) * (vmax + 1) + i;
    return ip[1] - ip[0];
  }
};

struct WriteStart {
  int* __restrict__ starts;
  int vmax;
  __device__ void operator()(int q, int i, int excl, int) const {
    starts[(size_t)q * vmax + i] = excl;
  }
};

__global__ void __launch_bounds__(256)
expand_rows_kernel(const int* __restrict__ indptr,
                   const int* __restrict__ nbr,
                   const int* __restrict__ rank,
                   const uint8_t* __restrict__ fbm,
                   const int* __restrict__ starts, int P, int vmax,
                   int vloc, const int* __restrict__ hub_dense, int parts,
                   int pid,
                   int emax, long long ld, int* __restrict__ src,
                   int* __restrict__ dst, int* __restrict__ rk,
                   int* __restrict__ eidx) {
  // query lanes: lane blockIdx.y reads its own frontier and starts and
  // writes its own slot rows; the CSR is shared.  The body is the solo
  // kernel's, so a 1-lane launch compiles and runs as the solo one did
  {
    const size_t l = blockIdx.y;
    fbm += l * P * vmax;
    starts += l * P * vmax;
    const size_t lo = l * P * ld;
    src += lo;
    dst += lo;
    rk += lo;
    eidx += lo;
  }
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const int groups = (vmax + 31) / 32;          // 32-row groups per part
  const long long ngroups = (long long)P * groups;
  for (long long g = warp; g < ngroups; g += nwarps) {
    const int p = (int)(g / groups);
    const int row0 = (int)(g % groups) * 32;
    const int r = row0 + lane;
    int beg = 0, deg = 0, st = 0;
    if (r < vmax && fbm[(size_t)p * vmax + r]) {
      const int* ip = indptr + (size_t)p * (vmax + 1) + r;
      beg = ip[0];
      deg = ip[1] - beg;
      st = starts[(size_t)p * vmax + r];
    }
    unsigned active = __ballot_sync(nt::kFullMask, deg > 0);
    const int* nb = nbr + (size_t)p * emax;
    const int* rkp = rank + (size_t)p * emax;
    const size_t orow = (size_t)p * ld;
    while (active) {                      // uniform across the warp
      const int b = __ffs(active) - 1;
      active &= active - 1;
      const int rb = __shfl_sync(nt::kFullMask, beg, b);
      const int rd = __shfl_sync(nt::kFullMask, deg, b);
      const size_t o = orow + __shfl_sync(nt::kFullMask, st, b);
      const int row = row0 + b;
      const int sid =
          row < vloc ? row * parts + pid + p : hub_dense[row - vloc];
#pragma unroll 4
      for (int j = lane; j < rd; j += 32) {
        const int e = rb + j;
        dst[o + j] = nb[e];
        rk[o + j] = rkp[e];
        eidx[o + j] = e;
        src[o + j] = sid;
      }
    }
  }
}

__global__ void __launch_bounds__(256)
expand_pad_kernel(const int* __restrict__ total, long long rows,
                  long long ld, int* __restrict__ src, int* __restrict__ dst,
                  int* __restrict__ rk, int* __restrict__ eidx) {
  const long long n = rows * ld;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += step) {
    const int q = (int)(i / ld);
    if (i % ld >= total[q]) {
      src[i] = -1;
      dst[i] = -1;
      rk[i] = 0;
      eidx[i] = 0;
    }
  }
}

int grid_for(long long work_items, int per_block) {
  long long g = (work_items + per_block - 1) / per_block;
  if (g > 132 * 16) g = 132 * 16;         // grid-stride beyond this
  return g < 1 ? 1 : (int)g;
}

}  // namespace

extern "C" int nt_scan_chunk() { return nt::kChunk; }

// fbm, starts (L * P, vmax), total (L * P,); indptr (P, vmax + 1)
extern "C" int nt_expand_scan(const int* indptr, const uint8_t* fbm, int P,
                              int L, int vmax, int* starts, int* total,
                              int* chunk_sums, void* stream) {
  if (L < 1 || (long long)L * P > 65535) return (int)cudaErrorInvalidValue;
  nt::scan_apply(MaskedDegree{indptr, fbm, vmax, P},
                 WriteStart{starts, vmax}, L * P, vmax, chunk_sums, total,
                 (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// vmax: rows per part (vmax_local + H); vloc: local rows (vmax when the
// snapshot is unsplit, and then hub_dense may be null); L: lanes (1 for
// a solo call); parts, pid: local row r of CSR row p is vertex
// r * parts + pid + p (parts = P and pid = 0 when every part's rows are
// given; a shard slot passes the mesh's P and its own part); ld: the
// output row stride, at least max(total); the outputs are (L * P, ld).
extern "C" int nt_expand_fill(const int* indptr, const int* nbr,
                              const int* rank, const uint8_t* fbm,
                              const int* starts, const int* total, int P,
                              int L, int vmax, int vloc, const int* hub_dense,
                              int parts, int pid, int emax, long long ld,
                              int* src, int* dst, int* rk, int* eidx,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vloc < vmax && hub_dense == nullptr) return (int)cudaErrorInvalidValue;
  if (L < 1) return (int)cudaErrorInvalidValue;
  if (L > 65535) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)L * P;
  const long long groups = (long long)P * ((vmax + 31) / 32);
  expand_rows_kernel<<<dim3(grid_for(groups, 8), L), 256, 0, s>>>(
      indptr, nbr, rank, fbm, starts, P, vmax, vloc, hub_dense, parts, pid,
      emax, ld, src, dst, rk, eidx);
  expand_pad_kernel<<<grid_for(rows * ld, 256), 256, 0, s>>>(
      total, rows, ld, src, dst, rk, eidx);
  return (int)cudaGetLastError();
}
