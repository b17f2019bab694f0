// predicate — the WHERE keep mask of a hop (Queue B K4).
//
// Replaces nebula_tpu/tpu/exprjit.py:compile_predicate (:201) with its
// term algebra `_term_alg` (:289), which XLA fused into the hop program,
// and the gather of each predicate column at the slot's eidx in
// nebula_tpu/tpu/hop.py:_build_local_fn (one_part_expand).  The predicate
// arrives as a small register program lowered by gpu/exprjit.py (the
// opcode numbers below mirror it): one interpreter, built once by nvcc,
// runs every predicate, so no compilation happens per query.
//
// For every slot (q, i) of the expanded (R, EB) arrays, R = L * P rows
// (one lane a statement, L = 1 solo; row q reads the columns' row
// p = q % P):
//   * keep = 0 where the slot is invalid: at and past total[q], or, on a
//     block merged with its delta plane (delta.cu), where its byte in the
//     (R, EB) valid mask is 0 — one of the two is given;
//   * otherwise keep = value & ~null of register 0 after the program ran
//     over a register file of (64-bit word, null bit) pairs, each
//     predicate column loaded straight from the pinned (P, emax) column at
//     [p, eidx] — no (P, EB) copy of any column is made; a delta slot's
//     eidx is emax + k, and it reads the column's (P, dcap) delta half at
//     [p, k] instead (the reference concatenated the halves per hop,
//     hop.py:494).
// The program, its constants and the column pointers travel by value as
// one __grid_constant__ kernel parameter; every thread of a warp runs the
// same instruction, so their loads from it are broadcast.
//
// Semantics, as the reference's: three-valued AND/OR/XOR; a null operand
// makes a comparison or arithmetic null; `/` and `%` by zero are null;
// int `/` truncates toward zero and int `%` takes the dividend's sign
// (computed as floor division on abs() operands, as the plain version
// does, so INT64_MIN behaves the same in both); float `%` is
// fmod(|a|, |b|) with a's sign; int arithmetic wraps (done in unsigned
// arithmetic); NaN is null in float columns, INT64_MIN in int, bool and
// string-code columns; IN compares int items as words and float items as
// doubles, and a NULL item makes a miss null.
//
// Bound: bytes.  Each valid slot reads its eidx (4 bytes; rank/src/dst
// only if the program loads them) and 8 bytes per predicate column at
// [p, eidx]; every slot writes one keep byte.  The gathers follow eidx,
// which ascends within a part's row, so neighbouring slots read
// neighbouring words.  The design keeps the instructions per slot few
// enough for the bytes to bound it:
//   * row tiles (rowtile.cuh): a block takes a tile of one row (2,048
//     slots for the compiled-in comparisons, 8,192 for the interpreter,
//     whose longer per-slot work gains from fewer tiles), so
//     the row, its part and the 64-bit bases are found once a tile and
//     offsets are 32-bit; a tile at or past total[q], or any tile of an
//     always-false program, stores zeros 16 bytes at a time and runs
//     nothing;
//   * kV slots a thread: eidx in one 16-byte load, keep stored as one
//     word, and each instruction decoded and dispatched once for kV
//     slots; a LOAD issues kV independent gathers;
//   * the register file in registers: kV words a register, addressed only
//     through compile-time indices (unrolled selects on the instruction's
//     d, a and b), null bits packed in one 64-bit mask; an instance for
//     programs of up to 2, 4 and 8 registers, so a short program carries
//     a short file;
//   * "compare": a program of the one-comparison form `LOAD col; CONST;
//     CMP` (int or float column, one of the six comparisons) runs a
//     kernel instance with that comparison compiled in — 12 instances,
//     built with the rest, chosen by the program's shape
//     (gpu/kernels.py:predicate_path); every other program goes to the
//     interpreter.  Both are bit for bit the plain version.  On an H100
//     (PERF.md) the interpreter alone took twice the bound at the main
//     path's w > 50, the compiled-in comparison about 1.1 times it.
#include <cstdint>
#include <cuda_runtime.h>

#include "rowtile.cuh"

namespace {

using rowtile::kAll;
using rowtile::kV;

constexpr int kRegs = 8;
constexpr int kMaxInsns = 64;
constexpr int kMaxConsts = 128;
constexpr int kMaxCols = 8;
constexpr long long kIntNull = (long long)(-9223372036854775807LL - 1);
constexpr int kThreads = 256;
static_assert(kRegs * kV <= 64, "the null bits fit one 64-bit mask");

enum Op {
  LOAD_I, LOAD_F, LOAD_B, LOAD_RANK, LOAD_SRC, LOAD_DST, CONST, NUL,
  IS_NULL, IS_NOT_NULL, NOT, NEG_I, NEG_F, I2F,
  EQ_I, NE_I, LT_I, LE_I, GT_I, GE_I,
  EQ_F, NE_F, LT_F, LE_F, GT_F, GE_F,
  ADD_I, SUB_I, MUL_I, DIV_I, MOD_I,
  ADD_F, SUB_F, MUL_F, DIV_F, MOD_F,
  BAND, BOR, BXOR, AND3, OR3, XOR3, IN
};

constexpr int kInHasNull = 1, kInNegate = 2, kInFloatOperand = 4;

struct Insn {
  int op, d, a, b, k, n, m, flags;
};

struct Program {
  int n_insns;
  int n_cols;
  int always_false;
  int n_regs;
  Insn code[kMaxInsns];
  long long consts[kMaxConsts];
  const long long* cols[kMaxCols];
  const long long* dcols[kMaxCols];   // delta halves, (P, dcap) each
};

// The slot arrays of one launch: (R, EB) each, row-contiguous.
struct Slots {
  const int* src;
  const int* dst;
  const int* rank;
  const int* eidx;
  const int* total;         // (R,), or null with `valid`
  const uint8_t* valid;     // (R, EB), or null with `total`
  uint8_t* keep;
  int P, EB, emax, dcap;
  int vec;                  // every array aligned for the groups' vectors
};

// One tile: its first slot's flat index, its width, the 64-bit offsets
// of its part's column rows.
struct Tile {
  long long a;
  int n;
  long long col0, dcol0;
};

__device__ __forceinline__ double f64(long long w) {
  return __longlong_as_double(w);
}
__device__ __forceinline__ long long w64(double x) {
  return __double_as_longlong(x);
}
__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ long long wrap_sub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}
__device__ __forceinline__ long long wrap_mul(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}
// torch.abs on int64: INT64_MIN stays INT64_MIN
__device__ __forceinline__ long long wrap_abs(long long a) {
  return a < 0 ? wrap_sub(0, a) : a;
}
// torch's floor division and floor remainder on int64 (b != 0, and b is
// never -1 here: it is abs() of a nonzero divisor)
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}
__device__ __forceinline__ long long floor_mod(long long a, long long b) {
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// x[v] = column k at the slot's eidx, for the live slots: the base half
// below emax, the delta half at eidx - emax.  kV independent gathers.
__device__ __forceinline__ void gather(const Program& prog, const Slots& s,
                                       const Tile& t, int k, unsigned live,
                                       const int (&e)[kV],
                                       long long (&x)[kV]) {
  const long long* __restrict__ c = prog.cols[k] + t.col0;
  if (s.dcap == 0) {
#pragma unroll
    for (int v = 0; v < kV; ++v) x[v] = (live >> v) & 1u ? c[e[v]] : 0;
    return;
  }
  const long long* __restrict__ d = prog.dcols[k] + t.dcol0;
#pragma unroll
  for (int v = 0; v < kV; ++v)
    x[v] = !((live >> v) & 1u) ? 0
           : e[v] >= s.emax ? d[e[v] - s.emax] : c[e[v]];
}

// The bits of the slots whose word is nonzero.
__device__ __forceinline__ unsigned truth(const long long (&x)[kV]) {
  unsigned m = 0;
#pragma unroll
  for (int v = 0; v < kV; ++v) m |= (unsigned)(x[v] != 0) << v;
  return m;
}

// x = register r (0 <= r < NR), through compile-time indices only.
template <int NR>
__device__ __forceinline__ void pick(const long long (&R)[NR][kV], int r,
                                     long long (&x)[kV]) {
#pragma unroll
  for (int v = 0; v < kV; ++v) x[v] = R[0][v];
#pragma unroll
  for (int i = 1; i < NR; ++i)
    if (r == i) {
#pragma unroll
      for (int v = 0; v < kV; ++v) x[v] = R[i][v];
    }
}

template <int NR>
__device__ __forceinline__ void put(long long (&R)[NR][kV], int r,
                                    const long long (&x)[kV]) {
#pragma unroll
  for (int i = 0; i < NR; ++i)
    if (r == i) {
#pragma unroll
      for (int v = 0; v < kV; ++v) R[i][v] = x[v];
    }
}

// The interpreter over a file of NR registers: the keep bits of one
// group's live slots.
template <int NR>
struct Interp {
  static constexpr int kTile = 8192;   // slots of one row a block takes
  static __device__ __forceinline__ unsigned eval(
      const Program& prog, const Slots& s, const Tile& t, int o,
      unsigned in, unsigned live, const int (&e)[kV]) {
    long long R[NR][kV];
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int v = 0; v < kV; ++v) R[i][v] = 0;
    unsigned long long nul = 0;     // bit r * kV + v: register r, slot v
    for (int pc = 0; pc < prog.n_insns; ++pc) {
      const Insn in_ = prog.code[pc];
      long long a[kV], b[kV], x[kV];
      pick<NR>(R, in_.a, a);
      pick<NR>(R, in_.b, b);
      const unsigned an = (unsigned)(nul >> (in_.a * kV)) & kAll;
      const unsigned bn = (unsigned)(nul >> (in_.b * kV)) & kAll;
      const unsigned abn = an | bn;
      unsigned z = 0;
#pragma unroll
      for (int v = 0; v < kV; ++v) x[v] = 0;
      switch (in_.op) {
        case LOAD_I:
          gather(prog, s, t, in_.k, live, e, x);
#pragma unroll
          for (int v = 0; v < kV; ++v) z |= (unsigned)(x[v] == kIntNull) << v;
          break;
        case LOAD_F:
          gather(prog, s, t, in_.k, live, e, x);
#pragma unroll
          for (int v = 0; v < kV; ++v) z |= (unsigned)isnan(f64(x[v])) << v;
          break;
        case LOAD_B:
          gather(prog, s, t, in_.k, live, e, x);
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            z |= (unsigned)(x[v] == kIntNull) << v;
            x[v] = x[v] != 0;
          }
          break;
        case LOAD_RANK:
        case LOAD_SRC:
        case LOAD_DST: {
          const int* base = in_.op == LOAD_RANK ? s.rank
                          : in_.op == LOAD_SRC ? s.src : s.dst;
          int w[kV];
          rowtile::load(base + t.a, o, in, live, s.vec, w);
#pragma unroll
          for (int v = 0; v < kV; ++v) x[v] = w[v];
          break;
        }
        case CONST: {
          const long long c = prog.consts[in_.k];
#pragma unroll
          for (int v = 0; v < kV; ++v) x[v] = c;
          break;
        }
        case NUL: z = kAll; break;
        case IS_NULL: {
#pragma unroll
          for (int v = 0; v < kV; ++v) x[v] = (an >> v) & 1u;
          break;
        }
        case IS_NOT_NULL: {
#pragma unroll
          for (int v = 0; v < kV; ++v) x[v] = !((an >> v) & 1u);
          break;
        }
        case NOT: {
#pragma unroll
          for (int v = 0; v < kV; ++v) x[v] = !a[v];
          z = an;
          break;
        }
        case NEG_I: {
#pragma unroll
          for (int v = 0; v < kV; ++v) x[v] = wrap_sub(0, a[v]);
          z = an;
          break;
        }
        case NEG_F: {
#pragma unroll
          for (int v = 0; v < kV; ++v) x[v] = w64(-f64(a[v]));
          z = an;
          break;
        }
        case I2F: {
#pragma unroll
          for (int v = 0; v < kV; ++v) x[v] = w64((double)a[v]);
          z = an;
          break;
        }
#define NT_CMP(OPC, EXPR)                                       \
  case OPC: {                                                   \
    _Pragma("unroll") for (int v = 0; v < kV; ++v) {            \
      const long long av = a[v], bv = b[v];                     \
      x[v] = (EXPR);                                            \
    }                                                           \
    z = abn;                                                    \
    break;                                                      \
  }
        NT_CMP(EQ_I, av == bv)
        NT_CMP(NE_I, av != bv)
        NT_CMP(LT_I, av < bv)
        NT_CMP(LE_I, av <= bv)
        NT_CMP(GT_I, av > bv)
        NT_CMP(GE_I, av >= bv)
        NT_CMP(EQ_F, f64(av) == f64(bv))
        NT_CMP(NE_F, f64(av) != f64(bv))
        NT_CMP(LT_F, f64(av) < f64(bv))
        NT_CMP(LE_F, f64(av) <= f64(bv))
        NT_CMP(GT_F, f64(av) > f64(bv))
        NT_CMP(GE_F, f64(av) >= f64(bv))
        NT_CMP(ADD_I, wrap_add(av, bv))
        NT_CMP(SUB_I, wrap_sub(av, bv))
        NT_CMP(MUL_I, wrap_mul(av, bv))
        NT_CMP(ADD_F, w64(f64(av) + f64(bv)))
        NT_CMP(SUB_F, w64(f64(av) - f64(bv)))
        NT_CMP(MUL_F, w64(f64(av) * f64(bv)))
        NT_CMP(BAND, av & bv)
        NT_CMP(BOR, av | bv)
        NT_CMP(BXOR, av ^ bv)
#undef NT_CMP
        case DIV_I: {
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            const long long bv = b[v] == 0 ? 1 : b[v];
            const long long q = floor_div(wrap_abs(a[v]), wrap_abs(bv));
            x[v] = ((a[v] >= 0) == (bv >= 0)) ? q : wrap_sub(0, q);
            z |= (unsigned)(b[v] == 0) << v;
          }
          z |= abn;
          break;
        }
        case MOD_I: {
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            const long long bv = b[v] == 0 ? 1 : b[v];
            const long long r = floor_mod(wrap_abs(a[v]), wrap_abs(bv));
            x[v] = a[v] >= 0 ? r : wrap_sub(0, r);
            z |= (unsigned)(b[v] == 0) << v;
          }
          z |= abn;
          break;
        }
        case DIV_F: {
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            const bool zero = f64(b[v]) == 0.0;
            x[v] = w64(f64(a[v]) / (zero ? 1.0 : f64(b[v])));
            z |= (unsigned)zero << v;
          }
          z |= abn;
          break;
        }
        case MOD_F: {
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            const bool zero = f64(b[v]) == 0.0;
            const double r = fmod(fabs(f64(a[v])),
                                  fabs(zero ? 1.0 : f64(b[v])));
            x[v] = w64(signbit(f64(a[v])) ? -r : r);
            z |= (unsigned)zero << v;
          }
          z |= abn;
          break;
        }
        case AND3: {
          const unsigned A = truth(a), B = truth(b);
          const unsigned is_false = ((~an & ~A) | (~bn & ~B)) & kAll;
          z = ~is_false & abn;
          const unsigned val = ~is_false & ~z & kAll;
#pragma unroll
          for (int v = 0; v < kV; ++v) x[v] = (val >> v) & 1u;
          break;
        }
        case OR3: {
          const unsigned A = truth(a), B = truth(b);
          const unsigned is_true = ((~an & A) | (~bn & B)) & kAll;
          z = ~is_true & abn;
#pragma unroll
          for (int v = 0; v < kV; ++v) x[v] = (is_true >> v) & 1u;
          break;
        }
        case XOR3: {
          const unsigned val = truth(a) ^ truth(b);
#pragma unroll
          for (int v = 0; v < kV; ++v) x[v] = (val >> v) & 1u;
          z = abn;
          break;
        }
        case IN: {
          unsigned hit = 0;
          for (int j = in_.k; j < in_.k + in_.n; ++j) {
            const long long c = prog.consts[j];
#pragma unroll
            for (int v = 0; v < kV; ++v) hit |= (unsigned)(a[v] == c) << v;
          }
          if (in_.m > 0) {
            double fa[kV];
#pragma unroll
            for (int v = 0; v < kV; ++v)
              fa[v] = (in_.flags & kInFloatOperand) ? f64(a[v])
                                                    : (double)a[v];
            for (int j = in_.k + in_.n; j < in_.k + in_.n + in_.m; ++j) {
              const double c = f64(prog.consts[j]);
#pragma unroll
              for (int v = 0; v < kV; ++v)
                hit |= (unsigned)(fa[v] == c) << v;
            }
          }
          z = an | ((in_.flags & kInHasNull) ? ~hit & kAll : 0u);
          const unsigned val =
              ((in_.flags & kInNegate) ? ~hit : hit) & ~z & kAll;
#pragma unroll
          for (int v = 0; v < kV; ++v) x[v] = (val >> v) & 1u;
          break;
        }
        default: z = kAll; break;
      }
      put<NR>(R, in_.d, x);
      const int sh = in_.d * kV;
      nul = (nul & ~((unsigned long long)kAll << sh))
            | ((unsigned long long)z << sh);
    }
    return live & truth(R[0]) & ~(unsigned)nul;
  }
};

// `LOAD col 0; CONST; CMP` with comparison C (0..5: == != < <= > >=) on
// an int (F false) or float column, compiled in.
template <int C, bool F>
struct Compare {
  static constexpr int kTile = 2048;
  static __device__ __forceinline__ unsigned eval(
      const Program& prog, const Slots& s, const Tile& t, int, unsigned,
      unsigned live, const int (&e)[kV]) {
    long long x[kV];
    gather(prog, s, t, prog.code[0].k, live, e, x);
    const long long c = prog.consts[prog.code[1].k];
    unsigned keep = 0;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      bool r, null;
      if constexpr (F) {
        const double a = f64(x[v]), b = f64(c);
        null = isnan(a);
        r = C == 0 ? a == b : C == 1 ? a != b : C == 2 ? a < b
            : C == 3 ? a <= b : C == 4 ? a > b : a >= b;
      } else {
        const long long a = x[v];
        null = a == kIntNull;
        r = C == 0 ? a == c : C == 1 ? a != c : C == 2 ? a < c
            : C == 3 ? a <= c : C == 4 ? a > c : a >= c;
      }
      keep |= (unsigned)(r && !null) << v;
    }
    return keep & live;
  }
};

// minBlocks 1: ptxas may then give the 8-register interpreter the
// registers its file needs (143) instead of spilling at 128
template <class Eval>
__global__ void __launch_bounds__(kThreads, 1)
predicate_kernel(const __grid_constant__ Program prog, const Slots s) {
  const int tiles = (s.EB + Eval::kTile - 1) / Eval::kTile;   // a row's
  const int q = blockIdx.x / tiles;              // lane * P + part
  const int j0 = (blockIdx.x - q * tiles) * Eval::kTile;
  Tile t;
  t.a = (long long)q * s.EB + j0;
  t.n = min(Eval::kTile, s.EB - j0);
  const int p = q % s.P;
  t.col0 = (long long)p * s.emax;
  t.dcol0 = (long long)p * s.dcap;
  // tile offsets below lim are valid on the prefix path
  const int lim = s.total != nullptr ? s.total[q] - j0 : t.n;
  uint8_t* keep = s.keep + t.a;
  if (prog.always_false || lim <= 0) {
    rowtile::zero_bytes(keep, t.n);
    return;
  }
  const int o0 = rowtile::first(t.a);
  const int ng = rowtile::groups(t.a, t.n);
  const int* et = s.eidx + t.a;
  const bool vec = s.vec;
  for (int g = threadIdx.x; g < ng; g += kThreads) {
    const int o = o0 + g * kV;
    const unsigned in = rowtile::between(o, 0, t.n);
    const unsigned live = s.total != nullptr
        ? rowtile::between(o, 0, lim) & in
        : rowtile::load_flags(s.valid + t.a, o, in, vec);
    unsigned k = 0;
    if (live) {
      int e[kV];
      rowtile::load(et, o, in, live, vec, e);
      k = Eval::eval(prog, s, t, o, in, live, e);
    }
    rowtile::store_flags(keep, o, in, k, vec);
  }
}

template <class Eval>
int launch(const Program& pr, const Slots& s, int R, cudaStream_t st) {
  const long long blocks =
      (long long)R * ((s.EB + Eval::kTile - 1) / Eval::kTile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks > 0)
    predicate_kernel<Eval><<<(unsigned)blocks, kThreads, 0, st>>>(pr, s);
  return (int)cudaGetLastError();
}

template <bool F>
int launch_compare(int cmp, const Program& pr, const Slots& s, int R,
                   cudaStream_t st) {
  switch (cmp) {
    case 0: return launch<Compare<0, F>>(pr, s, R, st);
    case 1: return launch<Compare<1, F>>(pr, s, R, st);
    case 2: return launch<Compare<2, F>>(pr, s, R, st);
    case 3: return launch<Compare<3, F>>(pr, s, R, st);
    case 4: return launch<Compare<4, F>>(pr, s, R, st);
    default: return launch<Compare<5, F>>(pr, s, R, st);
  }
}

// The comparison of a one-comparison program (0..5, float in *is_f), or
// -1 when the program has another shape.
int compare_shape(const Program& pr, bool* is_f) {
  if (pr.n_insns != 3 || pr.always_false) return -1;
  const Insn &l = pr.code[0], &c = pr.code[1], &x = pr.code[2];
  *is_f = l.op == LOAD_F;
  const int base = *is_f ? EQ_F : EQ_I;
  if ((l.op != LOAD_I && l.op != LOAD_F) || l.d != 0 || l.k < 0 ||
      l.k >= pr.n_cols || c.op != CONST || c.d != 1 || c.k < 0 ||
      c.k >= kMaxConsts || x.op < base || x.op > base + 5 || x.d != 0 ||
      x.a != 0 || x.b != 1)
    return -1;
  return x.op - base;
}

}  // namespace

extern "C" int nt_predicate_sizes(int* out) {
  out[0] = kRegs;
  out[1] = kMaxInsns;
  out[2] = kMaxConsts;
  out[3] = kMaxCols;
  out[4] = (int)sizeof(Program);
  out[5] = Compare<0, false>::kTile;
  out[6] = Interp<2>::kTile;
  return 0;
}

// prog: a host Program image (gpu/kernels.py packs it); copied into the
// launch's parameter space, so it may be freed when this returns.  The
// slots are (L * P, EB); exactly one of total (L * P,) and valid
// (L * P, EB) is non-null; dcap > 0 only with the delta halves in
// prog.dcols.  L = 1 for a solo call.  compare: 1 runs the program's
// compiled-in comparison (it must have that shape), 0 the interpreter.
extern "C" int nt_predicate_mask(const void* prog, const int* src,
                                 const int* dst, const int* rank,
                                 const int* eidx, const int* total,
                                 const uint8_t* valid, int P, int L, int EB,
                                 int emax, int dcap, uint8_t* keep,
                                 int compare, void* stream) {
  const Program& pr = *(const Program*)prog;
  if (pr.n_insns < 0 || pr.n_insns > kMaxInsns || pr.n_cols < 0 ||
      pr.n_cols > kMaxCols || pr.n_regs < 0 || pr.n_regs > kRegs ||
      (total == nullptr) == (valid == nullptr) || P < 1 || L < 1 ||
      EB < 0)
    return (int)cudaErrorInvalidValue;
  const int R = L * P;
  const int iv = 4 * kV < 16 ? 4 * kV : 16;
  Slots s{src, dst, rank, eidx, total, valid, keep, P, EB, emax, dcap,
          rowtile::aligned(src, iv) && rowtile::aligned(dst, iv) &&
              rowtile::aligned(rank, iv) && rowtile::aligned(eidx, iv) &&
              rowtile::aligned(valid, kV) && rowtile::aligned(keep, kV)};
  const cudaStream_t st = (cudaStream_t)stream;
  if (compare) {
    bool is_f = false;
    const int cmp = compare_shape(pr, &is_f);
    if (cmp < 0) return (int)cudaErrorInvalidValue;
    return is_f ? launch_compare<true>(cmp, pr, s, R, st)
                : launch_compare<false>(cmp, pr, s, R, st);
  }
  if (pr.n_regs <= 2) return launch<Interp<2>>(pr, s, R, st);
  if (pr.n_regs <= 4) return launch<Interp<4>>(pr, s, R, st);
  return launch<Interp<8>>(pr, s, R, st);
}
