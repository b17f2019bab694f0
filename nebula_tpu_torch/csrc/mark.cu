// mark — scatter kept destination ids into the (P, vmax) frontier bitmap
// (Queue B K2, and K6 for the seed bitmap).
//
// Replaces nebula_tpu/tpu/hop.py:_mark (:168) with the OR over blocks and
// source parts in _build_local_fn (:580), and the seed-bitmap `build` in
// nebula_tpu/tpu/runtime.py:_seed_builder (:969).  Dense id d lives at
// row d % P, column d / P: the one scatter does dedup (duplicates set the
// same byte) and routing (the row is the owning part).  Every block of
// every hop writes into the one next-frontier tensor, which is the OR.
//
// The bitmap's rows are `ld` bytes apart: ld = vmax for a plain (P, vmax)
// bitmap, vmax + H when it is the first vmax columns of a degree-split
// snapshot's (P, vmax + H) expansion bitmap (see hubs.cu).
//
// Query lanes (Queue B K10, nebula_tpu/tpu/hop.py:619; the lanes seed
// builder, nebula_tpu/tpu/runtime.py:976): `out` may be an (L, P, vmax)
// stack of bitmaps whose rows are all `ld` bytes apart (lane l's rows
// follow lane l - 1's), and the ids come lane-major, `per_lane` of them
// a lane: id i belongs to lane i / per_lane and lands in row
// (lane * P + d % P).  One launch marks every lane: a hop's (L, P, W) dst
// slots, or the (L, cap) seed ids.  A solo call passes per_lane = n.
//
// Only ones are ever stored, so duplicate writers agree and no atomics are
// needed; a slot that is not kept, or whose id lies outside [0, P*vmax),
// writes nothing (the reference's scatter dropped out-of-range ids; a
// scatter of `keep` values would let a False overwrite a True).  With no
// keep mask, a slot is kept when its id is >= 0: expand pads invalid slots
// with -1, and the seed list is exactly the ids to set.
//
// Bound: bytes — 4 bytes of id (and 1 of keep) read per slot, and the
// bitmap bytes written; the writes land at scattered addresses, one byte
// each, so the achieved rate sits well under the streaming rate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
mark_kernel(const int* __restrict__ ids, const uint8_t* __restrict__ keep,
            long long n, int P, int vmax, long long ld,
            long long per_lane, uint8_t* __restrict__ out) {
  const long long lim = (long long)P * vmax;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += step) {
    const int d = ids[i];
    if (d < 0 || d >= lim) continue;
    if (keep != nullptr && !keep[i]) continue;
    const long long row = (i / per_lane) * P + d % P;
    out[(size_t)row * ld + d / P] = 1;
  }
}

}  // namespace

extern "C" int nt_mark(const int* ids, const uint8_t* keep, long long n,
                       int P, int vmax, long long ld, long long per_lane,
                       uint8_t* out, void* stream) {
  if (per_lane < 1) return (int)cudaErrorInvalidValue;
  long long g = (n + 255) / 256;
  if (g > 132 * 32) g = 132 * 32;
  if (g > 0)
    mark_kernel<<<(int)g, 256, 0, (cudaStream_t)stream>>>(
        ids, keep, n, P, vmax, ld, per_lane, out);
  return (int)cudaGetLastError();
}
