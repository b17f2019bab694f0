// extend_hubs — hub-active bits appended to the expansion bitmap of a
// degree-split snapshot (Queue B K8).
//
// Replaces nebula_tpu/tpu/hop.py:_hub_consts (:271) and
// _extend_fbm_local (:303), the single-device hub extension:
//     bits[h] = fbm[hub_owner[h], hub_local[h]]
//     efbm    = concat(fbm, broadcast(bits, (P, H)), axis=1)
// A hub's frontier bit lives in its owner part's row; every part holds a
// chunk of the hub's edges as hub row vmax + h, so every part must see
// the bit.  The reference builds efbm as a new (P, vmax + H) array each
// hop.  Here the frontier itself lives in a (P, vmax + H) buffer whose
// first vmax columns are the ownership bitmap (mark writes there through
// a row stride), and this kernel fills the H tail columns in place: no
// (P, vmax) copy is made per hop.
//
// Query lanes (Queue B K10): fbm may be an (L, P, vmax + H) stack, one
// frontier buffer a lane; one launch fills every lane's hub columns from
// that lane's own bits.
//
// One thread per (lane, part, hub).  Bound: bytes — H bits read (scattered,
// one byte each), P * H bytes written, plus the two (H,) int32 tables; at
// the north star's H of about a hundred it is launch-bound, a few
// microseconds whatever its design.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
extend_hubs_kernel(uint8_t* __restrict__ fbm, const int* __restrict__ owner,
                   const int* __restrict__ local, int P, int vmax, int H,
                   long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const long long q = t / H;                 // lane * P + part
  const int h = (int)(t % H);
  const size_t ld = (size_t)vmax + H;
  uint8_t* lane = fbm + (size_t)(q / P) * P * ld;
  // reads touch columns < vmax only, writes columns >= vmax: no race
  lane[(size_t)(q % P) * ld + vmax + h] =
      lane[(size_t)owner[h] * ld + local[h]] ? 1 : 0;
}

}  // namespace

// fbm: (L, P, vmax + H) contiguous (L = 1 for a solo call)
extern "C" int nt_extend_hubs(uint8_t* fbm, const int* owner,
                              const int* local, int P, int L, int vmax,
                              int H, void* stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)L * P * H;
  if (n > 0)
    extend_hubs_kernel<<<(int)((n + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(fbm, owner, local, P, vmax,
                                                 H, n);
  return (int)cudaGetLastError();
}
