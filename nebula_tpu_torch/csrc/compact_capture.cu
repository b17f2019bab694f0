// compact_capture — stable compaction of the final hop's kept slots plus
// the YIELD column gather (Queue B K3 with K5 fused in).
//
// Replaces nebula_tpu/tpu/hop.py:_compact_cap (:238) and the per-block
// yield gather of _build_local_fn (:543-550).  Per part, the exclusive scan
// of `keep` gives each kept slot its position (scan.cuh's three phases);
// the slot's src/dst/rank/eidx go there, and so does the 8-byte word of
// each yield column at [p, eidx] — int64 and float64 share one code path.
// On a block merged with its delta plane (delta.cu), a slot whose eidx is
// emax + k reads the column's (P, dcap) delta half at [p, k] instead, so
// no per-hop concatenation of a column (hop.py:547) is ever made.
// kcount[p] is the scan's total.  Positions at and past kcount[p] get the
// padding src = dst = -1, rank = eidx = 0, column words 0.  Positions come
// from the scan, never from atomics, so the order of the kept slots — the
// (part, src)-contiguous ascending-eidx order of expand — is kept.  The
// scan is scan.cuh's compaction variant: given a row's extent (expand's
// total, past which no slot is valid, so none is kept), keep is read only
// below it, only chunks that keep a slot are scanned, and the padding is
// written in striped order.
//
// Query lanes (Queue B K10): the slot arrays and keep may be (L, P, EB),
// one lane a statement, with the yield columns (P, emax) shared: the
// scan runs over the L * P rows in one launch of each phase, slot row
// q = l * P + p reads column row p = q % P, and kcount is (L, P).
//
// Bound: bytes, at 3.35 TB/s: keep (1 byte a slot; counted in full),
// src/dst/rank/eidx (16 bytes) read for each valid slot — they are read
// only for kept slots, but the card reads whole 32-byte sectors (8 int32
// slots), and where the filter keeps about half the valid slots at
// random, as WHERE KNOWS.w > 50 does, a sector holds no kept slot with
// odds near 0.5^8 — the outputs written in full (16 bytes a slot plus 8
// per yield column, padding included), and 8 bytes gathered per kept slot
// and column.  The gather reads at eidx, which ascends within a row, so
// neighbouring kept slots mostly read neighbouring words.
#include "scan.cuh"

namespace {

constexpr int kMaxCols = 4;

struct Keep {
  const uint8_t* __restrict__ keep;
  int EB;
  __device__ int operator()(int p, int i) const {
    return keep[(size_t)p * EB + i] != 0;
  }
};

struct Scatter {
  const int* src;
  const int* dst;
  const int* rank;
  const int* eidx;
  const long long* cols[kMaxCols];
  const long long* dcols[kMaxCols];
  long long* ocols[kMaxCols];
  int* osrc;
  int* odst;
  int* orank;
  int* oeidx;
  int ncols, emax, dcap, EB, P;

  // q: a slot row (lane * P + part); the column row is part q % P
  __device__ void kept(int q, int i, int pos) const {
    const size_t in = (size_t)q * EB + i;
    const size_t o = (size_t)q * EB + pos;
    const int p = q % P;
    const int e = eidx[in];
    osrc[o] = src[in];
    odst[o] = dst[in];
    orank[o] = rank[in];
    oeidx[o] = e;
    const bool ok = e >= 0 && e < emax;
    const bool dok = e >= emax && e - emax < dcap;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)   // static indices: no spills
      if (c < ncols)
        ocols[c][o] = ok    ? cols[c][(size_t)p * emax + e]
                      : dok ? dcols[c][(size_t)p * dcap + (e - emax)]
                            : 0;
  }

  __device__ void pad(int q, int i) const {
    const size_t o = (size_t)q * EB + i;
    osrc[o] = -1;
    odst[o] = -1;
    orank[o] = 0;
    oeidx[o] = 0;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      if (c < ncols) ocols[c][o] = 0;
  }
};

}  // namespace

// The slot arrays, keep and the outputs are (L * P, EB), kcount and
// extent (L * P,); the columns (P, emax) and their delta halves (P, dcap).
// L = 1 for a solo call.  extent may be null: every slot may be kept.
extern "C" int nt_compact_capture(
    const int* src, const int* dst, const int* rank, const int* eidx,
    const uint8_t* keep, const int* extent, int P, int L, int EB, int ncols,
    int emax,
    const long long* col0, const long long* col1, const long long* col2,
    const long long* col3, int dcap, const long long* dcol0,
    const long long* dcol1, const long long* dcol2, const long long* dcol3,
    int* osrc, int* odst, int* orank, int* oeidx,
    long long* ocol0, long long* ocol1, long long* ocol2, long long* ocol3,
    int* kcount, int* chunk_sums, void* stream) {
  if (ncols < 0 || ncols > kMaxCols) return (int)cudaErrorInvalidValue;
  if (dcap < 0 || P < 1 || L < 1 || (long long)L * P > 65535)
    return (int)cudaErrorInvalidValue;
  Scatter op{src, dst, rank, eidx,
             {col0, col1, col2, col3}, {dcol0, dcol1, dcol2, dcol3},
             {ocol0, ocol1, ocol2, ocol3},
             osrc, odst, orank, oeidx, ncols, emax, dcap, EB, P};
  nt::compact_apply(Keep{keep, EB}, op, L * P, EB, extent, chunk_sums,
                    kcount, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
