// compact_capture — stable compaction of the final hop's kept slots plus
// the YIELD column gather (Queue B K3 with K5 fused in).
//
// Replaces nebula_tpu/tpu/hop.py:_compact_cap (:238) and the per-block
// yield gather of _build_local_fn (:543-550).  Per row, the exclusive scan
// of `keep` gives each kept slot its position; the slot's src/dst/rank/
// eidx go there, and so does the 8-byte word of each yield column at
// [p, eidx] — int64 and float64 share one code path.  On a block merged
// with its delta plane (delta.cu), a slot whose eidx is emax + k reads the
// column's (P, dcap) delta half at [p, k] instead, so no per-hop
// concatenation of a column (hop.py:547) is ever made.  kcount[q] is the
// row's kept count.  Positions at and past kcount[q] get the padding
// src = dst = -1, rank = eidx = 0, column words 0.
//
// Two launches:
//   compact_tiles_kernel  one pass over the keep mask in scan.cuh's
//       single-pass chained scan.  A tile of 4,096 slots loads its keep
//       bytes striped (coalesced), scans them, and lists its kept slots'
//       tile offsets in shared memory in order.  Once the look-back gives
//       the tile's first position `off`, consecutive threads copy
//       consecutive kept slots to positions off, off + 1, ...: every
//       store of the kept run is coalesced, the loads walk the tile's
//       slots in ascending order (a warp reads neighbouring slots, and the
//       yield columns at ascending eidx).  Only tiles below the row's
//       extent read anything: expand's total, past which no slot is
//       valid, so none is kept.  The row's last such tile writes kcount.
//   compact_pad_kernel    the padding [kcount[q], EB) of every row, one
//       block a span of 4,096 positions, in 16-byte stores; a span below
//       kcount returns at once.
// Positions come from the scan, never from atomics, so the order of the
// kept slots — the (part, src)-contiguous ascending-eidx order of expand —
// is kept, bit for bit, on every run.
//
// Query lanes (Queue B K10): the slot arrays and keep may be (L, P, EB),
// one lane a statement, with the yield columns (P, emax) shared: the
// tiles run over the L * P rows in one launch, slot row q = l * P + p
// reads column row p = q % P, and kcount is (L, P).
//
// Bound: bytes, at 3.35 TB/s: keep (1 byte a slot below the extent),
// src/dst/rank/eidx (16 bytes) read for each kept slot, the outputs
// written in full (16 bytes a slot plus 8 per yield column, padding
// included), and 8 bytes gathered per kept slot and column.  The padding
// is most of it at a filtered hop: kept slots are written once, the rest
// of the row is a streaming fill.
#include "scan.cuh"

namespace {

constexpr int kMaxCols = 4;
constexpr int kPadSpan = 4096;     // padding positions a block fills

struct Args {
  const int* src;
  const int* dst;
  const int* rank;
  const int* eidx;
  const uint8_t* keep;
  const int* extent;
  const long long* cols[kMaxCols];
  const long long* dcols[kMaxCols];
  long long* ocols[kMaxCols];
  int* osrc;
  int* odst;
  int* orank;
  int* oeidx;
  int* kcount;
  int ncols, emax, dcap, EB, P;
};

__global__ void __launch_bounds__(nt::kThreads)
compact_tiles_kernel(Args a, unsigned long long* __restrict__ status,
                     int ntiles, long long tiles) {
  __shared__ nt::TileScan s;
  __shared__ unsigned short idx[nt::kTile];
  const int t = nt::take_ticket(status + tiles, s);
  const int q = t / ntiles, c = t % ntiles;
  const int start = c * nt::kTile;
  const int lim = a.extent ? min(a.EB, max(a.extent[q], 0)) : a.EB;
  if (start >= lim) {                 // uniform: nothing here is kept
    if (c == 0 && threadIdx.x == 0) a.kcount[q] = 0;
    return;
  }
  const int n = min(nt::kTile, lim - start);
  const size_t base = (size_t)q * a.EB + start;
  const uint8_t* kp = a.keep + base;
  int v[nt::kItems];
  unsigned kept = 0;
#pragma unroll
  for (int k = 0; k < nt::kItems; ++k) {
    const int i = k * nt::kThreads + threadIdx.x;
    v[k] = i < n && kp[i] != 0;
    kept |= (unsigned)v[k] << k;
  }
  const int sum = nt::scan_tile(v, s);
#pragma unroll
  for (int k = 0; k < nt::kItems; ++k)
    if (kept >> k & 1)
      idx[v[k]] = (unsigned short)(k * nt::kThreads + threadIdx.x);
  // the look-back ends in a barrier, which also publishes idx
  const int off = nt::tile_prefix(status + (size_t)q * ntiles, c, sum, s);
  if (threadIdx.x == 0 && start + nt::kTile >= lim) a.kcount[q] = off + sum;
  const size_t obase = (size_t)q * a.EB + off;
  const int p = q % a.P;
  for (int r = threadIdx.x; r < sum; r += nt::kThreads) {
    const size_t in = base + idx[r], o = obase + r;
    const int e = a.eidx[in];
    a.osrc[o] = a.src[in];
    a.odst[o] = a.dst[in];
    a.orank[o] = a.rank[in];
    a.oeidx[o] = e;
    const bool ok = e >= 0 && e < a.emax;
    const bool dok = e >= a.emax && e - a.emax < a.dcap;
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k)   // static indices: no spills
      if (k < a.ncols)
        a.ocols[k][o] = ok    ? a.cols[k][(size_t)p * a.emax + e]
                        : dok ? a.dcols[k][(size_t)p * a.dcap + (e - a.emax)]
                              : 0;
  }
}

__global__ void __launch_bounds__(nt::kThreads)
compact_pad_kernel(Args a, int nspans) {
  const long long b = blockIdx.x;
  const int q = (int)(b / nspans), sp = (int)(b % nspans);
  const int lo = max(sp * kPadSpan, a.kcount[q]);
  const int hi = min((sp + 1) * kPadSpan, a.EB);
  if (lo >= hi) return;
  const size_t o = (size_t)q * a.EB + lo, n = hi - lo;
  nt::block_fill(a.osrc + o, 4 * n, 0xff);
  nt::block_fill(a.odst + o, 4 * n, 0xff);
  nt::block_fill(a.orank + o, 4 * n, 0);
  nt::block_fill(a.oeidx + o, 4 * n, 0);
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k)
    if (k < a.ncols) nt::block_fill(a.ocols[k] + o, 8 * n, 0);
}

}  // namespace

extern "C" int nt_scan_tile() { return nt::kTile; }

// The slot arrays, keep and the outputs are (L * P, EB), kcount and
// extent (L * P,); the columns (P, emax) and their delta halves (P, dcap).
// L = 1 for a solo call.  extent may be null: every slot may be kept.
// status: nt::status_words(L * P, EB) 8-byte words of scratch, cleared
// here on the stream.
extern "C" int nt_compact_capture(
    const int* src, const int* dst, const int* rank, const int* eidx,
    const uint8_t* keep, const int* extent, int P, int L, int EB, int ncols,
    int emax,
    const long long* col0, const long long* col1, const long long* col2,
    const long long* col3, int dcap, const long long* dcol0,
    const long long* dcol1, const long long* dcol2, const long long* dcol3,
    int* osrc, int* odst, int* orank, int* oeidx,
    long long* ocol0, long long* ocol1, long long* ocol2, long long* ocol3,
    int* kcount, unsigned long long* status, void* stream) {
  if (ncols < 0 || ncols > kMaxCols) return (int)cudaErrorInvalidValue;
  if (dcap < 0 || P < 1 || L < 1 || EB < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)L * P;
  const int ntiles = nt::tiles_per_row(EB);
  const long long tiles = rows * ntiles;
  const int nspans = (EB + kPadSpan - 1) / kPadSpan;
  if (tiles >= (1ll << 31) || rows * nspans >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  Args a{src, dst, rank, eidx, keep, extent,
         {col0, col1, col2, col3}, {dcol0, dcol1, dcol2, dcol3},
         {ocol0, ocol1, ocol2, ocol3},
         osrc, odst, orank, oeidx, kcount, ncols, emax, dcap, EB, P};
  cudaError_t rc = cudaMemsetAsync(
      status, 0, nt::status_words(rows, EB) * sizeof(*status), s);
  if (rc != cudaSuccess) return (int)rc;
  compact_tiles_kernel<<<(unsigned)tiles, nt::kThreads, 0, s>>>(
      a, status, ntiles, tiles);
  if (nspans > 0)
    compact_pad_kernel<<<(unsigned)(rows * nspans), nt::kThreads, 0, s>>>(
        a, nspans);
  return (int)cudaGetLastError();
}
