// exchange — the sharded mesh's frontier exchange (Queue B K15) and hub
// bits (Queue B K16), each side of the transport's data movement.
//
// K15 replaces nebula_tpu/tpu/hop.py:_pack_bits (:179), _unpack_or (:193)
// and the packing/unpacking halves of _exchange_marks_lanes (:213).  Each
// shard slot marks its next-hop candidates into an (Ll, P, vmax) bool
// matrix, row d bound for slot d; it is packed to (Ll, P, W) 32-bit words,
// W = ceil(vmax / 32), bit i of word w = column 32w + i, padding bits past
// vmax 0 (the reference's shift-weighted sum over disjoint bits).  The
// transport ships row d to slot d (the all_to_all); the receiving slot ORs
// its P received rows on the packed words and unpacks once into the first
// vmax columns of its own next-frontier buffer.  The words are carried in
// an int32 tensor, bit for bit the reference's uint32.
//
//   nt_pack_bits   one warp per output word: lane i reads column 32w + i
//                  (one coalesced 32-byte read a warp) and __ballot_sync
//                  is the word; lane 0 stores it.
//   nt_unpack_or   one thread per output column: the OR of the P words
//                  holding it (the warp's 32 threads read the same word, a
//                  broadcast), then its bit, stored as one byte through
//                  the buffer's row stride.
//
// K16 replaces nebula_tpu/tpu/hop.py:_extend_fbm_sharded (:281) and
// _extend_fbm_sharded_lanes (:292): a hub's frontier bit lives in its
// owner slot, and every slot holds a chunk of each hub's edges as hub row
// vmax + h, so each slot takes the bits of the hubs it owns
// (hub_owner == pid, at hub_local), the transport sums them over the slots
// (the reference's psum), and each slot sets hub column vmax + h where the
// sum is > 0.
//
//   nt_owned_hub_bits   one thread per (lane, hub): (Ll, H) int32, 1 where
//                       the slot owns hub h and its bit is set;
//   nt_fill_hub_columns one thread per (lane, hub): column vmax + h of the
//                       lane's row = summed[l, h] > 0.
//
// Bounds: bytes.  pack reads each mark byte once and writes a bit of it
// (at the north star's hop-2 shapes, 8 slots x 8 x 125,000: 8 MB read,
// 1 MB written, 2.7 us at 3.35 TB/s); unpack reads P words and writes a
// byte per column; the hub pair moves a few hundred bytes.  All four are
// launch-bound at the shapes the mesh gives them, a few microseconds
// whatever their design; the design keeps every bitmap read and write
// coalesced along a row.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(256)
pack_bits_kernel(const uint8_t* __restrict__ marks, long long rows,
                 int vmax, long long ld, int W, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long words = rows * W;
  for (long long g = warp; g < words; g += nwarps) {
    const long long q = g / W;
    const int col = (int)(g % W) * 32 + lane;
    const bool bit = col < vmax && marks[(size_t)q * ld + col] != 0;
    const unsigned word = __ballot_sync(kFullMask, bit);
    if (lane == 0) out[g] = (int)word;
  }
}

__global__ void __launch_bounds__(256)
unpack_or_kernel(const int* __restrict__ recv, int L, int P, int W,
                 int vmax, long long ld, uint8_t* __restrict__ out) {
  const long long n = (long long)L * vmax;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += step) {
    const int l = (int)(i / vmax);
    const int c = (int)(i % vmax);
    const int* r = recv + (size_t)l * P * W + (c >> 5);
    unsigned ored = 0;
    for (int p = 0; p < P; ++p) ored |= (unsigned)r[(size_t)p * W];
    out[(size_t)l * ld + c] = (uint8_t)((ored >> (c & 31)) & 1u);
  }
}

__global__ void __launch_bounds__(256)
owned_hub_bits_kernel(const uint8_t* __restrict__ fbm, long long ld,
                      int pid, const int* __restrict__ owner,
                      const int* __restrict__ local, int H, long long n,
                      int* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const long long l = t / H;
  const int h = (int)(t % H);
  out[t] = (owner[h] == pid && fbm[(size_t)l * ld + local[h]]) ? 1 : 0;
}

__global__ void __launch_bounds__(256)
fill_hub_columns_kernel(uint8_t* __restrict__ fbm, long long ld, int vmax,
                        const int* __restrict__ summed, int H, long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const long long l = t / H;
  const int h = (int)(t % H);
  fbm[(size_t)l * ld + vmax + h] = summed[t] > 0 ? 1 : 0;
}

int blocks_for(long long threads, long long cap) {
  long long g = (threads + 255) / 256;
  if (g > cap) g = cap;                   // grid-stride beyond this
  return g < 1 ? 1 : (int)g;
}

}  // namespace

// marks: rows (Ll * P) of vmax bytes, `ld` bytes apart; out (rows, W)
// int32, contiguous
extern "C" int nt_pack_bits(const uint8_t* marks, long long rows, int vmax,
                            long long ld, int W, int* out, void* stream) {
  if (rows < 0 || vmax < 0 || W != (vmax + 31) / 32 || ld < vmax)
    return (int)cudaErrorInvalidValue;
  const long long words = rows * W;
  if (words > 0)
    pack_bits_kernel<<<blocks_for(words * 32, 132 * 32), 256, 0,
                       (cudaStream_t)stream>>>(marks, rows, vmax, ld, W,
                                               out);
  return (int)cudaGetLastError();
}

// recv: (L, P, W) int32 contiguous; out: L rows of vmax bytes, `ld` bytes
// apart (the first vmax columns of each lane's frontier buffer)
extern "C" int nt_unpack_or(const int* recv, int L, int P, int W, int vmax,
                            long long ld, uint8_t* out, void* stream) {
  if (L < 0 || P < 1 || W != (vmax + 31) / 32 || ld < vmax)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)L * vmax;
  if (n > 0)
    unpack_or_kernel<<<blocks_for(n, 132 * 32), 256, 0,
                       (cudaStream_t)stream>>>(recv, L, P, W, vmax, ld,
                                               out);
  return (int)cudaGetLastError();
}

// fbm: L rows (one a lane) `ld` bytes apart; out (L, H) int32
extern "C" int nt_owned_hub_bits(const uint8_t* fbm, int L, long long ld,
                                 int pid, const int* owner, const int* local,
                                 int H, int* out, void* stream) {
  if (L < 0 || H < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)L * H;
  if (n > 0)
    owned_hub_bits_kernel<<<(int)((n + 255) / 256), 256, 0,
                            (cudaStream_t)stream>>>(fbm, ld, pid, owner,
                                                    local, H, n, out);
  return (int)cudaGetLastError();
}

// fbm: L rows of vmax + H bytes, `ld` apart; summed (L, H) int32
extern "C" int nt_fill_hub_columns(uint8_t* fbm, int L, long long ld,
                                   int vmax, const int* summed, int H,
                                   void* stream) {
  if (L < 0 || H < 0 || ld < (long long)vmax + H)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)L * H;
  if (n > 0)
    fill_hub_columns_kernel<<<(int)((n + 255) / 256), 256, 0,
                              (cudaStream_t)stream>>>(fbm, ld, vmax, summed,
                                                      H, n);
  return (int)cudaGetLastError();
}
