// Division by a divisor fixed for a launch (the part count P, a row's
// word count), shared by mark.cu and bfs.cu: q = n / d for 0 <= n < 2^31
// by a multiply-high and a shift (the round-up method; d = 1 keeps n).
#pragma once

#include <cuda_runtime.h>

namespace {

struct FastDiv {
  unsigned d, mul, shr;
};

FastDiv make_div(unsigned d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    unsigned l = 0;
    while ((1u << l) < d) ++l;                  // ceil(log2 d)
    const unsigned p = 31 + l;
    f.mul = (unsigned)(((1ull << p) + d - 1) / d);
    f.shr = p - 32;
  }
  return f;
}

__device__ __forceinline__ unsigned div_of(unsigned n, const FastDiv& f) {
  return f.d == 1 ? n : __umulhi(n, f.mul) >> f.shr;
}

}  // namespace
