// Row tiles for the slot-parallel kernels, `predicate_mask` (predicate.cu)
// and `merge_delta` (delta.cu).
//
// Both walk an (R, W) array of slots row by row: a block takes a tile of
// one row, so the row, the part and every 64-bit base address are found
// once a tile, and offsets inside it are 32-bit.  A thread takes kV
// consecutive slots at once (a "group"), so it loads kV int32 slots with
// one vector load and stores kV byte flags as one word.  Groups are
// aligned to kV slots in the array's flat index, not in the row: a row
// whose width is not a multiple of kV starts off a 16-byte boundary, and
// its tiles' first and last groups are partial.  Those, and every group
// of a launch whose arrays are not aligned (`vec` false), load and store
// slot by slot.  A group's slots are bits 0..kV-1 of an unsigned mask.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace rowtile {
namespace {

constexpr int kV = 4;                      // slots a thread takes at once
constexpr unsigned kAll = (1u << kV) - 1;
static_assert(kV == 2 || kV == 4 || kV == 8, "kV is 2, 4 or 8");

// The groups of a tile whose first slot has flat index `a` and which
// holds n slots: group g covers tile offsets [first(a) + g kV, + kV).
__device__ __forceinline__ int first(long long a) {
  return -(int)(a & (kV - 1));
}
__device__ __forceinline__ int groups(long long a, int n) {
  return (n - first(a) + kV - 1) / kV;
}

// The bits of the group at offset o that lie in [lo, hi).
__device__ __forceinline__ unsigned between(int o, int lo, int hi) {
  unsigned m = 0;
#pragma unroll
  for (int v = 0; v < kV; ++v)
    m |= (unsigned)(o + v >= lo && o + v < hi) << v;
  return m;
}

// x[v] = t[o + v]: one vector load when the whole group is in range
// (`in`) and the launch is aligned, else only the slots of `want`
// (the rest read 0).
__device__ __forceinline__ void load(const int* __restrict__ t, int o,
                                     unsigned in, unsigned want, bool vec,
                                     int (&x)[kV]) {
  if (vec && in == kAll) {
    if constexpr (kV == 2) {
      const int2 w = *reinterpret_cast<const int2*>(t + o);
      x[0] = w.x;
      x[1] = w.y;
    } else {
#pragma unroll
      for (int c = 0; c < kV; c += 4) {
        const int4 w = *reinterpret_cast<const int4*>(t + o + c);
        x[c] = w.x;
        x[c + 1] = w.y;
        x[c + 2] = w.z;
        x[c + 3] = w.w;
      }
    }
  } else {
#pragma unroll
    for (int v = 0; v < kV; ++v) x[v] = (want >> v) & 1u ? t[o + v] : 0;
  }
}

// the word of kV bytes
using Word = typename std::conditional<
    kV == 2, unsigned short,
    typename std::conditional<kV == 4, unsigned,
                              unsigned long long>::type>::type;

// Byte flags t[o + v] != 0 of the in-range slots, as bits.
__device__ __forceinline__ unsigned load_flags(const uint8_t* __restrict__ t,
                                               int o, unsigned in,
                                               bool vec) {
  unsigned m = 0;
  if (vec && in == kAll) {
    const Word w = *reinterpret_cast<const Word*>(t + o);
#pragma unroll
    for (int v = 0; v < kV; ++v)
      m |= (unsigned)(((w >> (8 * v)) & 0xffu) != 0) << v;
  } else {
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if ((in >> v) & 1u) m |= (unsigned)(t[o + v] != 0) << v;
  }
  return m;
}

// t[o + v] = bit v of m, for the in-range slots: one word store when the
// whole group is in range and the launch aligned.
__device__ __forceinline__ void store_flags(uint8_t* __restrict__ t, int o,
                                            unsigned in, unsigned m,
                                            bool vec) {
  if (vec && in == kAll) {
    Word w = 0;
#pragma unroll
    for (int v = 0; v < kV; ++v) w |= (Word)((m >> v) & 1u) << (8 * v);
    *reinterpret_cast<Word*>(t + o) = w;
  } else {
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if ((in >> v) & 1u) t[o + v] = (uint8_t)((m >> v) & 1u);
  }
}

// Zero n bytes from t, by the whole block: 16-byte stores between a
// scalar head and tail.
__device__ __forceinline__ void zero_bytes(uint8_t* __restrict__ t, int n) {
  int head = (int)((16 - ((uintptr_t)t & 15)) & 15);
  if (head > n) head = n;
  const int nvec = (n - head) >> 4;
  for (int i = threadIdx.x; i < head; i += blockDim.x) t[i] = 0;
  uint4* tv = reinterpret_cast<uint4*>(t + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x)
    tv[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = head + (nvec << 4) + threadIdx.x; i < n; i += blockDim.x)
    t[i] = 0;
}

// Whether p is aligned for a group's vector access of `bytes`.
inline bool aligned(const void* p, int bytes) {
  return p == nullptr || ((uintptr_t)p & (uintptr_t)(bytes - 1)) == 0;
}

}  // namespace
}  // namespace rowtile
