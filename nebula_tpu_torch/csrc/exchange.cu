// exchange — the sharded mesh's frontier exchange (Queue B K15) and hub
// bits (Queue B K16), each side of the transport's data movement, over a
// slot group: the run of consecutive shard slots that share a device
// (gpu/mesh.py `Mesh.groups`; on one H100 all eight slots are one group).
// Each launch covers every slot of a group, so a hop costs one launch of
// each kernel a card, not one a slot.
//
// K15 replaces nebula_tpu/tpu/hop.py:_pack_bits (:179), _unpack_or (:195)
// and the packing/unpacking halves of _exchange_marks_lanes (:214).  Each
// shard slot marks its next-hop candidates into an (Ll, P, vmax) bool
// matrix, row d bound for slot d; a group's matrices are one (S, Ll, P,
// vmax) view (rows 32 * W bytes apart).  They are packed to (S, Ll, P, W)
// 32-bit words, W = ceil(vmax / 32), bit i of word w = column 32w + i,
// padding bits past vmax 0 (the reference's shift-weighted sum over
// disjoint bits).  The transport ships row d to slot d (the all_to_all; on
// one card a view, no copy); each receiving slot ORs its P received rows
// on the packed words and unpacks once into the first vmax columns of its
// own next-frontier buffer.  The words are carried in an int32 tensor, bit
// for bit the reference's uint32.
//
//   nt_pack_bits   one thread per output word, neighbouring threads on
//                  neighbouring words: the word's 32 mark bytes in two
//                  16-byte loads (8, 4 or 1-byte loads where the base or
//                  the row stride is not 16-byte aligned), turned into
//                  bits in registers 8 bytes at a time (a multiply that
//                  gathers the low bit of each byte into the top byte),
//                  one 4-byte store; a row's last word, past vmax, is read
//                  a byte at a time up to vmax.
//   nt_unpack_or   one thread per (destination slot, lane, word): the OR
//                  of the P source words (each read once, coalesced along
//                  w, through any strides the transport's view has), its
//                  32 bits spread to 32 bytes in registers and stored as
//                  wide as the destination row's alignment allows (16
//                  bytes down to 1); never past column vmax - 1, so the
//                  hub columns stay untouched.
//
// K16 replaces nebula_tpu/tpu/hop.py:_extend_fbm_sharded (:281) and
// _extend_fbm_sharded_lanes (:292): a hub's frontier bit lives in its
// owner slot, and every slot holds a chunk of each hub's edges as hub row
// vmax + h, so each group takes the bits of the hubs its slots own, the
// transport sums them over the groups (the reference's psum; on one card
// the group's partial is the sum), and every slot sets hub column vmax + h
// where the sum is > 0.
//
//   nt_owned_hub_bits   one thread per (lane, hub): (Ll, H) int32, 1 where
//                       hub h's owner is a slot of the group and that
//                       slot's bit at hub_local[h] is set (each hub has one
//                       owner, so nothing is summed inside the group);
//   nt_fill_hub_columns one thread per (slot, lane, hub): column vmax + h
//                       of the row = summed[l, h] > 0.
//
// Bounds: bytes, and all four are launch-bound at the mesh's shapes.  At
// the north star's hop 2 (8 slots x 8 x 125,000) pack reads 8,000,000
// bytes and writes 1,000,192 (2.7 us at 3.35 TB/s), unpack reads 1,000,192
// and writes 1,000,000 (0.6 us); the hub pair moves a few hundred bytes.
// What the design does about it: one launch a group, not one a slot (8x
// fewer launches on one card), no copy in the transport within a group,
// and each mark byte and each received word read once.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "fastdiv.cuh"

namespace {

constexpr unsigned long long kLow = 0x0101010101010101ull;

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + 255) / 256);
}

// bit i of the result = the low bit of byte i of x
__device__ __forceinline__ unsigned bits_of(unsigned long long x) {
  return (unsigned)(((x & kLow) * 0x0102040810204080ull) >> 56);
}

// byte i of the result = bit i of b (b < 256): b in every byte, each byte
// masked to its own bit, then each nonzero byte carried into its bit 7
__device__ __forceinline__ unsigned long long bytes_of(unsigned b) {
  const unsigned long long x =
      ((unsigned long long)b * kLow) & 0x8040201008040201ull;
  return ((x + 0x7f7f7f7f7f7f7f7full) >> 7) & kLow;
}

// the 32 bytes at p as four 8-byte values, in loads of V bytes (p is
// V-byte aligned)
template <int V>
__device__ __forceinline__ void load32(const uint8_t* __restrict__ p,
                                       unsigned long long x[4]) {
  if constexpr (V == 16) {
    const ulonglong2* v = reinterpret_cast<const ulonglong2*>(p);
    const ulonglong2 a = v[0], b = v[1];
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  } else if constexpr (V == 8) {
    const unsigned long long* v =
        reinterpret_cast<const unsigned long long*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = v[k];
  } else if constexpr (V == 4) {
    const unsigned* v = reinterpret_cast<const unsigned*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[k] = v[2 * k] | (unsigned long long)v[2 * k + 1] << 32;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[k] |= (unsigned long long)p[8 * k + i] << (8 * i);
    }
  }
}

// the four 8-byte values x at o, as wide as o's alignment allows
__device__ __forceinline__ void store32(uint8_t* __restrict__ o,
                                        const unsigned long long x[4]) {
  const unsigned a = (unsigned)((uintptr_t)o & 15);
  if (a == 0) {
    ulonglong2* v = reinterpret_cast<ulonglong2*>(o);
    v[0] = make_ulonglong2(x[0], x[1]);
    v[1] = make_ulonglong2(x[2], x[3]);
  } else if ((a & 7) == 0) {
    unsigned long long* v = reinterpret_cast<unsigned long long*>(o);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = x[k];
  } else if ((a & 3) == 0) {
    unsigned* v = reinterpret_cast<unsigned*>(o);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = (unsigned)x[k];
      v[2 * k + 1] = (unsigned)(x[k] >> 32);
    }
  } else if ((a & 1) == 0) {
    unsigned short* v = reinterpret_cast<unsigned short*>(o);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * k + j] = (unsigned short)(x[k] >> (16 * j));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 8; ++i) o[8 * k + i] = (uint8_t)(x[k] >> (8 * i));
  }
}

template <int V>
__global__ void __launch_bounds__(256)
pack_bits_kernel(const uint8_t* __restrict__ marks, unsigned words,
                 FastDiv W, int vmax, long long ld, int* __restrict__ out) {
  const unsigned g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= words) return;
  const unsigned q = div_of(g, W);                 // the row
  const int w = (int)(g - q * W.d);
  const uint8_t* p = marks + (long long)q * ld + 32LL * w;
  const int n = vmax - 32 * w;                     // columns in the word
  unsigned word = 0;
  if (n >= 32) {
    unsigned long long x[4];
    load32<V>(p, x);
    word = bits_of(x[0]) | bits_of(x[1]) << 8 | bits_of(x[2]) << 16 |
           bits_of(x[3]) << 24;
  } else {
    for (int i = 0; i < n; ++i) word |= (unsigned)(p[i] & 1u) << i;
  }
  out[g] = (int)word;
}

__global__ void __launch_bounds__(256)
unpack_or_kernel(const int* __restrict__ recv, unsigned n, FastDiv W,
                 FastDiv L, int P, long long rs, long long rl, long long rp,
                 int vmax, long long os, long long ol,
                 uint8_t* __restrict__ out) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const unsigned q = div_of(t, W);                 // the (slot, lane) row
  const int w = (int)(t - q * W.d);
  const unsigned s = div_of(q, L);
  const int l = (int)(q - s * L.d);
  const int* r = recv + (long long)s * rs + (long long)l * rl + w;
  unsigned v = 0;
  for (int p = 0; p < P; ++p) v |= (unsigned)__ldg(r + (long long)p * rp);
  uint8_t* o = out + (long long)s * os + (long long)l * ol + 32LL * w;
  const int ncol = vmax - 32 * w;
  if (ncol >= 32) {
    const unsigned long long x[4] = {bytes_of(v & 255u),
                                     bytes_of((v >> 8) & 255u),
                                     bytes_of((v >> 16) & 255u),
                                     bytes_of(v >> 24)};
    store32(o, x);
  } else {
    for (int i = 0; i < ncol; ++i) o[i] = (uint8_t)((v >> i) & 1u);
  }
}

__global__ void __launch_bounds__(256)
owned_hub_bits_kernel(const uint8_t* __restrict__ fbm, int S, long long ls,
                      long long ll, int p0, const int* __restrict__ owner,
                      const int* __restrict__ local, int H, long long n,
                      int* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const long long l = t / H;
  const int h = (int)(t % H);
  const int o = owner[h] - p0;                     // the owner's slot
  out[t] = (o >= 0 && o < S && fbm[o * ls + l * ll + local[h]]) ? 1 : 0;
}

__global__ void __launch_bounds__(256)
fill_hub_columns_kernel(uint8_t* __restrict__ fbm, int L, long long ld,
                        int vmax, const int* __restrict__ summed, int H,
                        long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const long long row = t / H;                     // (slot, lane)
  const int h = (int)(t % H);
  const long long l = row % L;
  fbm[row * ld + vmax + h] = summed[l * H + h] > 0 ? 1 : 0;
}

}  // namespace

// marks: `rows` rows (a group's S * Ll * P) of vmax bytes, `ld` bytes
// apart; out (rows, W) int32, contiguous
extern "C" int nt_pack_bits(const uint8_t* marks, long long rows, int vmax,
                            long long ld, int W, int* out, void* stream) {
  if (rows < 0 || vmax < 0 || W != (vmax + 31) / 32 || ld < vmax ||
      rows * W > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long words = rows * W;
  if (words == 0) return (int)cudaGetLastError();
  const unsigned grid = blocks_for(words);
  const FastDiv fw = make_div((unsigned)W);
  const unsigned a = (unsigned)(((uintptr_t)marks | (uintptr_t)ld) & 15);
  cudaStream_t st = (cudaStream_t)stream;
  if (a == 0)
    pack_bits_kernel<16><<<grid, 256, 0, st>>>(marks, (unsigned)words, fw,
                                               vmax, ld, out);
  else if ((a & 7) == 0)
    pack_bits_kernel<8><<<grid, 256, 0, st>>>(marks, (unsigned)words, fw,
                                              vmax, ld, out);
  else if ((a & 3) == 0)
    pack_bits_kernel<4><<<grid, 256, 0, st>>>(marks, (unsigned)words, fw,
                                              vmax, ld, out);
  else
    pack_bits_kernel<1><<<grid, 256, 0, st>>>(marks, (unsigned)words, fw,
                                              vmax, ld, out);
  return (int)cudaGetLastError();
}

// recv: (S, L, P, W) int32 words, element strides rs, rl, rp for the first
// three axes, W unit-stride; out: S x L rows of vmax bytes, row (s, l) at
// s * os + l * ol (the first vmax columns of each slot's lane buffer)
extern "C" int nt_unpack_or(const int* recv, int S, int L, int P, int W,
                            long long rs, long long rl, long long rp,
                            int vmax, long long os, long long ol,
                            uint8_t* out, void* stream) {
  if (S < 0 || L < 0 || P < 1 || W != (vmax + 31) / 32 ||
      (long long)S * L * W > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)S * L * W;
  if (n > 0)
    unpack_or_kernel<<<blocks_for(n), 256, 0,
                       (cudaStream_t)stream>>>(
        recv, (unsigned)n, make_div((unsigned)W), make_div((unsigned)L), P,
        rs, rl, rp, vmax, os, ol, out);
  return (int)cudaGetLastError();
}

// fbm: a group's S slots of L rows each, row (s, l) at s * ls + l * ll;
// p0 the first slot's part; out (L, H) int32
extern "C" int nt_owned_hub_bits(const uint8_t* fbm, int S, int L,
                                 long long ls, long long ll, int p0,
                                 const int* owner, const int* local, int H,
                                 int* out, void* stream) {
  if (S < 1 || L < 0 || H < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)L * H;
  if (n > 0)
    owned_hub_bits_kernel<<<blocks_for(n), 256, 0,
                            (cudaStream_t)stream>>>(fbm, S, ls, ll, p0, owner,
                                                    local, H, n, out);
  return (int)cudaGetLastError();
}

// fbm: `rows` rows (a group's S * L) of vmax + H bytes, `ld` apart, lane
// l = row % L; summed (L, H) int32
extern "C" int nt_fill_hub_columns(uint8_t* fbm, long long rows, int L,
                                   long long ld, int vmax, const int* summed,
                                   int H, void* stream) {
  if (rows < 0 || L < 1 || H < 0 || ld < (long long)vmax + H)
    return (int)cudaErrorInvalidValue;
  const long long n = rows * H;
  if (n > 0)
    fill_hub_columns_kernel<<<blocks_for(n), 256, 0,
                              (cudaStream_t)stream>>>(fbm, L, ld, vmax,
                                                      summed, H, n);
  return (int)cudaGetLastError();
}
