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
// One thread per (part, hub) pair.  Bound: bytes — H bits read (scattered,
// one byte each), P * H bytes written, plus the two (H,) int32 tables; at
// the north star's H of about a hundred it is launch-bound, a few
// microseconds whatever its design.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
extend_hubs_kernel(uint8_t* __restrict__ fbm, const int* __restrict__ owner,
                   const int* __restrict__ local, int P, int vmax, int H) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P * H) return;
  const int p = t / H, h = t % H;
  const int ld = vmax + H;
  // reads touch columns < vmax only, writes columns >= vmax: no race
  fbm[(size_t)p * ld + vmax + h] =
      fbm[(size_t)owner[h] * ld + local[h]] ? 1 : 0;
}

}  // namespace

extern "C" int nt_extend_hubs(uint8_t* fbm, const int* owner,
                              const int* local, int P, int vmax, int H,
                              void* stream) {
  const int n = P * H;
  if (n > 0)
    extend_hubs_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        fbm, owner, local, P, vmax, H);
  return (int)cudaGetLastError();
}
