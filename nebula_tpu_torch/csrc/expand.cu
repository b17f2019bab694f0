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
//                   and total (P,), in one launch of scan.cuh's
//                   single-pass chained scan: a row of 125,000 vertices
//                   is 31 tiles that all run at once;
//   (host)          reads total and sizes the slot arrays exactly at
//                   EB = max(total), where the reference climbed a
//                   power-of-two ladder because XLA needs static shapes;
//   nt_expand_fill  writes src/dst/rank/eidx (P, EB) int32, balanced by
//                   edges, not rows (a load-balancing merge path): each
//                   row's work is its vmax frontier rows, its total[p]
//                   slots and its padding, vmax + ld items in all, and
//                   every block takes kSpan consecutive items of one row.
//                   A block finds where its span splits into rows and
//                   slots by a warp-wide search over starts (the merge
//                   path of starts against the slot indices 0, 1, ...),
//                   stages that window of starts in shared memory, and
//                   gives each thread eight slots j: each one's row is
//                   upper_bound(starts, j) - 1, which holds across
//                   zero-degree and inactive rows, whose start equals the
//                   next row's.  Stores and the nbr/rank loads go to
//                   consecutive slots and edges; a Zipf hub row of any
//                   length is spread over as many blocks as its slots
//                   need.  Items past vmax + total[p] are slots at and past
//                   total[p]: the reference's padding (src = dst = -1,
//                   rank = eidx = 0), written by the same blocks in 16-byte
//                   stores.  The rows of the four arrays are `ld` >= EB
//                   slots apart: a block with a delta plane gets them
//                   EB + Dcap wide, the tail padded here and then filled
//                   by merge_delta (delta.cu), so its base slots are never
//                   copied.
//
// Query lanes (Queue B K10, nebula_tpu/tpu/hop.py:619
// build_traverse_fn_lanes, which vmaps the hop program over a leading
// lane axis with the CSR shared): fbm may be an (L, P, vmax) stack of L
// statements' frontiers.  Both entry points then run over its L * P rows
// in ONE launch each: row q = l * P + p reads the CSR of part p = q % P
// and frontier row q, and writes starts, total and slot row q, so lane l
// of the outputs is exactly the solo expansion of its frontier.  The
// host's one read is max(total) over every lane: the shared slot width.
// L = 1 is the solo call, bit for bit.
//
// Degree-split snapshots (nebula_tpu/tpu/hop.py:104-110): a block then has
// vmax_local + H rows per part, the last H being hub rows.  A local row r
// of part p is vertex r * P + p; hub row vmax_local + h is vertex
// hub_dense[h].  Hub rows are scanned and copied like any other row,
// after the local rows, so slots stay in ascending row, then eidx, order.
// A hub's frontier bit lives in its owner part's row, and every part
// expands the hub's chunk, so the scan reads hub row vmax_local + h of
// row q from the same lane's owner row:
//     fbm[((q / P) * P + hub_owner[h]) * vmax + hub_local[h]]
// That is the reference's _extend_fbm_local (hop.py:303) gather, done
// where its one reader needs it: the hub-bits pass (Queue B K8,
// hop.py:_hub_consts :271) is folded into this scan and has no launch
// of its own, and the frontier buffer's H tail columns are never read.
// The non-hub rows keep their coalesced byte loads; only the tiles that
// hold hub rows (the last one or two of a row) make the H scattered
// loads.  Without the owner tables the scan reads the tail columns as
// any other row: the mesh fills them (exchange.cu's fill_hub_columns),
// since a shard slot holds no other part's row.
//
// Shard slots (Queue B K17, nebula_tpu/tpu/hop.py:_expand_block's `pid`):
// on the sharded mesh a slot holds only its own part's CSR row, so the
// vertex of a local row is r * parts + pid (the mesh's part count and the
// slot's part), where the rows' own index would give r * 1 + 0.
//
// Bound: bytes.  It reads indptr and fbm once (5 bytes a row), nbr and
// rank of the expanded edges (8 bytes an edge) and writes 16 bytes a slot,
// at 3.35 TB/s; it does no arithmetic worth counting.  The scan also
// writes and the fill reads starts (8 bytes a row), and each fill block
// reads a few hundred starts in its two searches (four rounds of 32
// probes at 125,000 rows); every other load and store is coalesced.  With
// the owner tables the scan reads the two (H,) int32 tables (8 * H bytes)
// and H scattered bytes a row in place of the H tail columns, and the
// hub-bits pass's P * H byte writes, and its launch, are gone.
#include "scan.cuh"

namespace {

constexpr int kFillItems = 8;
constexpr int kSpan = nt::kThreads * kFillItems;   // row, slot and padding
                                                   // items a fill block takes

// Exclusive scan of the masked degrees: tile c of row q covers frontier
// rows [c * kTile, (c + 1) * kTile) of q.  With hub_owner (and hub_local)
// a row i >= vloc reads its bit from its owner's row of q's lane.
__global__ void __launch_bounds__(nt::kThreads)
expand_scan_kernel(const int* __restrict__ indptr,
                   const uint8_t* __restrict__ fbm, int P, int vmax,
                   int vloc, const int* __restrict__ hub_owner,
                   const int* __restrict__ hub_local,
                   int* __restrict__ starts, int* __restrict__ total,
                   unsigned long long* __restrict__ status, int ntiles,
                   long long tiles) {
  __shared__ nt::TileScan s;
  const int t = nt::take_ticket(status + tiles, s);
  const int q = t / ntiles, c = t % ntiles;
  const int start = c * nt::kTile;
  if (start >= vmax) {                // only tile 0 of an empty row
    if (threadIdx.x == 0) total[q] = 0;
    return;
  }
  const int n = min(nt::kTile, vmax - start);
  const uint8_t* f = fbm + (size_t)q * vmax + start;
  const int* ip = indptr + (size_t)(q % P) * (vmax + 1) + start;
  // the tile's first hub row read through the tables (n: none)
  const int hub0 = hub_owner != nullptr ? max(vloc - start, 0) : n;
  int v[nt::kItems];
  if (hub0 >= n) {                    // uniform over the block
#pragma unroll
    for (int k = 0; k < nt::kItems; ++k) {
      const int i = k * nt::kThreads + threadIdx.x;
      v[k] = i < n && f[i] ? ip[i + 1] - ip[i] : 0;
    }
  } else {
    const uint8_t* lane = fbm + (size_t)(q / P) * P * vmax;
#pragma unroll
    for (int k = 0; k < nt::kItems; ++k) {
      const int i = k * nt::kThreads + threadIdx.x;
      bool on = false;
      if (i < hub0) {
        on = f[i];
      } else if (i < n) {
        const int h = start + i - vloc;
        on = lane[(size_t)hub_owner[h] * vmax + hub_local[h]];
      }
      v[k] = on ? ip[i + 1] - ip[i] : 0;
    }
  }
  const int sum = nt::scan_tile(v, s);
  const int off = nt::tile_prefix(status + (size_t)q * ntiles, c, sum, s);
  if (threadIdx.x == 0 && start + nt::kTile >= vmax) total[q] = off + sum;
  int* out = starts + (size_t)q * vmax + start;
#pragma unroll
  for (int k = 0; k < nt::kItems; ++k) {
    const int i = k * nt::kThreads + threadIdx.x;
    if (i < n) out[i] = off + v[k];
  }
}

// The merge path of a row's starts A (nA rows) against the slot indices
// B = 0, 1, ..., nB - 1, ties to A: how many of the first d items of the
// merge are rows, i.e. the first i with A[i] > d - 1 - i (the test turns
// false once and stays false).  Run by a whole warp, 32 probes a round:
// four rounds for 125,000 rows where a binary search takes 17 loads.
__device__ int merge_path(const int* __restrict__ A, int nA, int nB,
                          long long d) {
  const int lane = threadIdx.x & 31;
  int lo = (int)max(0ll, d - nB), hi = (int)min(d, (long long)nA);
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int mid = lo + lane * step;
    const bool below = mid < hi && (long long)A[mid] <= d - 1 - mid;
    const int c = __popc(__ballot_sync(nt::kFullMask, below));
    if (c == 0) break;                // A[lo] already past: i = lo
    if (step == 1) { lo += c; break; }
    lo += (c - 1) * step + 1;         // the answer is past probe c - 1 ...
    hi = min(hi, lo - 1 + step);      // ... and at or before probe c
  }
  return lo;
}

__global__ void __launch_bounds__(nt::kThreads)
expand_fill_kernel(const int* __restrict__ indptr,
                   const int* __restrict__ nbr,
                   const int* __restrict__ rank,
                   const int* __restrict__ starts,
                   const int* __restrict__ total, int P, int vmax, int vloc,
                   const int* __restrict__ hub_dense, int parts, int pid,
                   int emax, long long ld, int nblk, int* __restrict__ src,
                   int* __restrict__ dst, int* __restrict__ rk,
                   int* __restrict__ eidx) {
  __shared__ int win[kSpan + 1];
  __shared__ int split[2];
  const long long b = blockIdx.x;
  const int q = (int)(b / nblk);
  const long long d0 = (b % nblk) * (long long)kSpan;
  const long long d1 = min(d0 + kSpan, vmax + ld);
  const int tot = total[q];
  const long long nm = (long long)vmax + tot;   // row and slot items
  const size_t orow = (size_t)q * ld;
  if (d0 < nm) {                      // uniform over the block
    const int* A = starts + (size_t)q * vmax;
    const long long m1 = min(d1, nm);
    if (threadIdx.x < 64) {           // warp 0 splits at d0, warp 1 at m1
      const int a = merge_path(A, vmax, tot, threadIdx.x < 32 ? d0 : m1);
      if ((threadIdx.x & 31) == 0) split[threadIdx.x >> 5] = a;
    }
    __syncthreads();
    const int a0 = split[0], a1 = split[1];
    const int j0 = (int)(d0 - a0), j1 = (int)(m1 - a1);
    if (j0 < j1) {                    // uniform: the span holds slots
      // the window: starts of rows lo .. a1 - 1.  Row a0 - 1 is in it,
      // since slot j0 may still belong to it
      const int lo = max(a0 - 1, 0), nw = a1 - lo;
      for (int i = threadIdx.x; i < nw; i += nt::kThreads) win[i] = A[lo + i];
      __syncthreads();
      const int p = q % P;
      const int* ipp = indptr + (size_t)p * (vmax + 1);
      const int* nb = nbr + (size_t)p * emax;
      const int* rkp = rank + (size_t)p * emax;
      int row[kFillItems], e[kFillItems];
#pragma unroll
      for (int k = 0; k < kFillItems; ++k) {
        const int j = j0 + k * nt::kThreads + threadIdx.x;
        int l = 0, h = nw;              // upper_bound(win, j)
        while (l < h) {
          const int m = (l + h) >> 1;
          if (win[m] <= j) l = m + 1;
          else h = m;
        }
        row[k] = lo + l - 1;
        e[k] = j < j1 ? j - win[l - 1] : 0;
      }
#pragma unroll
      for (int k = 0; k < kFillItems; ++k) {
        const int j = j0 + k * nt::kThreads + threadIdx.x;
        if (j < j1) {
          const int r = row[k], x = ipp[r] + e[k];
          const size_t o = orow + j;
          dst[o] = nb[x];
          rk[o] = rkp[x];
          eidx[o] = x;
          src[o] = r < vloc ? r * parts + pid + p : hub_dense[r - vloc];
        }
      }
    }
  }
  // padding: the items past vmax + tot are slots tot .. ld - 1
  const long long plo = max(d0, nm) - vmax, phi = d1 - vmax;
  if (plo < phi) {
    const size_t o = orow + plo, n = (size_t)(phi - plo);
    nt::block_fill(src + o, 4 * n, 0xff);
    nt::block_fill(dst + o, 4 * n, 0xff);
    nt::block_fill(rk + o, 4 * n, 0);
    nt::block_fill(eidx + o, 4 * n, 0);
  }
}

}  // namespace

// fbm, starts (L * P, vmax), total (L * P,); indptr (P, vmax + 1);
// status: nt::status_words(L * P, vmax) 8-byte words of scratch, cleared
// here on the stream.  hub_owner, hub_local: (vmax - vloc,) owner part
// and owner row of each hub row, or both null (the hub rows' bits then
// come from fbm's tail columns); the owner rows are fbm's rows of the
// same lane, so every part of the snapshot must be given (P parts).
extern "C" int nt_expand_scan(const int* indptr, const uint8_t* fbm, int P,
                              int L, int vmax, int vloc,
                              const int* hub_owner, const int* hub_local,
                              int* starts, int* total,
                              unsigned long long* status, void* stream) {
  if (L < 1 || P < 1 || vmax < 0) return (int)cudaErrorInvalidValue;
  if ((hub_owner == nullptr) != (hub_local == nullptr)
      || (hub_owner != nullptr && (vloc < 0 || vloc > vmax)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)L * P;
  const int ntiles = nt::tiles_per_row(vmax);
  const long long tiles = rows * ntiles;
  if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaMemsetAsync(
      status, 0, nt::status_words(rows, vmax) * sizeof(*status), s);
  if (rc != cudaSuccess) return (int)rc;
  expand_scan_kernel<<<(unsigned)tiles, nt::kThreads, 0, s>>>(
      indptr, fbm, P, vmax, vloc, hub_owner, hub_local, starts, total,
      status, ntiles, tiles);
  return (int)cudaGetLastError();
}

// vmax: rows per part (vmax_local + H); vloc: local rows (vmax when the
// snapshot is unsplit, and then hub_dense may be null); L: lanes (1 for
// a solo call); parts, pid: local row r of CSR row p is vertex
// r * parts + pid + p (parts = P and pid = 0 when every part's rows are
// given; a shard slot passes the mesh's P and its own part); ld: the
// output row stride, at least max(total); the outputs are (L * P, ld).
extern "C" int nt_expand_fill(const int* indptr, const int* nbr,
                              const int* rank, const int* starts,
                              const int* total, int P, int L, int vmax,
                              int vloc, const int* hub_dense, int parts,
                              int pid, int emax, long long ld, int* src,
                              int* dst, int* rk, int* eidx, void* stream) {
  if (vloc < vmax && hub_dense == nullptr) return (int)cudaErrorInvalidValue;
  if (L < 1 || P < 1 || ld < 0 || ld > (1ll << 31) - 1 - vmax)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)L * P;
  const long long nblk = (vmax + ld + kSpan - 1) / kSpan;
  if (nblk == 0) return 0;
  if (rows * nblk >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  expand_fill_kernel<<<(unsigned)(rows * nblk), nt::kThreads, 0,
                       (cudaStream_t)stream>>>(
      indptr, nbr, rank, starts, total, P, vmax, vloc, hub_dense, parts, pid,
      emax, ld, (int)nblk, src, dst, rk, eidx);
  return (int)cudaGetLastError();
}
