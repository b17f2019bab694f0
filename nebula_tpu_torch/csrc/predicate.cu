// predicate — the WHERE keep mask of the final hop (Queue B K4).
//
// Replaces nebula_tpu/tpu/exprjit.py:compile_predicate (:201) with its
// term algebra `_term_alg` (:289), which XLA fused into the hop program,
// and the gather of each predicate column at the slot's eidx in
// nebula_tpu/tpu/hop.py:_build_local_fn (one_part_expand).  The predicate
// arrives as a small register program lowered by gpu/exprjit.py (the
// opcode numbers below mirror it): one interpreter, built once by nvcc,
// runs every predicate, so no compilation happens per query.
//
// One thread per slot (p, i) of the expanded (P, EB) arrays, grid-stride:
//   * invalid slots get keep = 0: those at and past total[p], or, on a
//     block merged with its delta plane (delta.cu), those whose byte in
//     the (P, EB) valid mask is 0 — one of the two is given;
//   * otherwise the thread runs the program over a register file of
//     (64-bit word, null bit) pairs, loading each predicate column
//     straight from the pinned (P, emax) column at [p, eidx] — no
//     (P, EB) int64 copy of any column is made; a delta slot's eidx is
//     emax + k, and it reads the column's (P, dcap) delta half at
//     [p, k] instead (the reference concatenated the halves per hop,
//     hop.py:494) — and writes
//     keep = value & ~null of register 0 as one byte.
// Query lanes (Queue B K10): the slot arrays may be (L, P, EB), total
// (L, P) or valid (L, P, EB), one lane a statement; the columns stay
// (P, emax) and shared.  Slot row q = l * P + p reads column row
// p = q % P; one launch covers every lane.
//
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
// string-code columns.
//
// Bound: bytes.  Each slot reads its eidx (4 bytes; rank/src/dst only if
// the program loads them), 8 bytes per predicate column at [p, eidx], and
// writes one keep byte.  The gathers follow eidx, which ascends within a
// part's row, so neighbouring threads mostly read neighbouring words.  The
// register file is indexed at run time, so it lives in local memory (L1);
// that and the instruction dispatch make it slower than a kernel generated
// per predicate, which is what a later change could do.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRegs = 8;
constexpr int kMaxInsns = 64;
constexpr int kMaxConsts = 128;
constexpr int kMaxCols = 8;
constexpr long long kIntNull = (long long)(-9223372036854775807LL - 1);

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
  int pad;
  Insn code[kMaxInsns];
  long long consts[kMaxConsts];
  const long long* cols[kMaxCols];
  const long long* dcols[kMaxCols];   // delta halves, (P, dcap) each
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

__global__ void __launch_bounds__(256)
predicate_kernel(const __grid_constant__ Program prog,
                 const int* __restrict__ src, const int* __restrict__ dst,
                 const int* __restrict__ rank, const int* __restrict__ eidx,
                 const int* __restrict__ total,
                 const uint8_t* __restrict__ valid, int P, int R, int EB,
                 int emax, int dcap, uint8_t* __restrict__ keep) {
  const long long n = (long long)R * EB;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       s < n; s += step) {
    const int q = (int)(s / EB);               // lane * P + part
    const int p = q % P;
    const int i = (int)(s % EB);
    if ((valid != nullptr ? !valid[s] : i >= total[q]) ||
        prog.always_false) {
      keep[s] = 0;
      continue;
    }
    const int e = eidx[s];
    const bool in_delta = e >= emax;
    const size_t row = in_delta ? (size_t)p * dcap + (e - emax)
                                : (size_t)p * emax + e;
    long long R[kRegs] = {};
    unsigned nul = 0;
    for (int pc = 0; pc < prog.n_insns; ++pc) {
      const Insn in = prog.code[pc];
      const long long av = R[in.a], bv = R[in.b];
      const bool an = (nul >> in.a) & 1u, bn = (nul >> in.b) & 1u;
      long long v = 0;
      bool z = false;
      switch (in.op) {
        case LOAD_I:
          v = (in_delta ? prog.dcols : prog.cols)[in.k][row];
          z = v == kIntNull;
          break;
        case LOAD_F:
          v = (in_delta ? prog.dcols : prog.cols)[in.k][row];
          z = isnan(f64(v));
          break;
        case LOAD_B: {
          const long long raw = (in_delta ? prog.dcols : prog.cols)[in.k][row];
          v = raw != 0;
          z = raw == kIntNull;
          break;
        }
        case LOAD_RANK: v = rank[s]; break;
        case LOAD_SRC: v = src[s]; break;
        case LOAD_DST: v = dst[s]; break;
        case CONST: v = prog.consts[in.k]; break;
        case NUL: z = true; break;
        case IS_NULL: v = an; break;
        case IS_NOT_NULL: v = !an; break;
        case NOT: v = !av; z = an; break;
        case NEG_I: v = wrap_sub(0, av); z = an; break;
        case NEG_F: v = w64(-f64(av)); z = an; break;
        case I2F: v = w64((double)av); z = an; break;
        case EQ_I: v = av == bv; z = an | bn; break;
        case NE_I: v = av != bv; z = an | bn; break;
        case LT_I: v = av < bv; z = an | bn; break;
        case LE_I: v = av <= bv; z = an | bn; break;
        case GT_I: v = av > bv; z = an | bn; break;
        case GE_I: v = av >= bv; z = an | bn; break;
        case EQ_F: v = f64(av) == f64(bv); z = an | bn; break;
        case NE_F: v = f64(av) != f64(bv); z = an | bn; break;
        case LT_F: v = f64(av) < f64(bv); z = an | bn; break;
        case LE_F: v = f64(av) <= f64(bv); z = an | bn; break;
        case GT_F: v = f64(av) > f64(bv); z = an | bn; break;
        case GE_F: v = f64(av) >= f64(bv); z = an | bn; break;
        case ADD_I: v = wrap_add(av, bv); z = an | bn; break;
        case SUB_I: v = wrap_sub(av, bv); z = an | bn; break;
        case MUL_I: v = wrap_mul(av, bv); z = an | bn; break;
        case DIV_I: {
          const long long b = bv == 0 ? 1 : bv;
          const long long q = floor_div(wrap_abs(av), wrap_abs(b));
          v = ((av >= 0) == (b >= 0)) ? q : wrap_sub(0, q);
          z = an | bn | (bv == 0);
          break;
        }
        case MOD_I: {
          const long long b = bv == 0 ? 1 : bv;
          const long long r = floor_mod(wrap_abs(av), wrap_abs(b));
          v = av >= 0 ? r : wrap_sub(0, r);
          z = an | bn | (bv == 0);
          break;
        }
        case ADD_F: v = w64(f64(av) + f64(bv)); z = an | bn; break;
        case SUB_F: v = w64(f64(av) - f64(bv)); z = an | bn; break;
        case MUL_F: v = w64(f64(av) * f64(bv)); z = an | bn; break;
        case DIV_F: {
          const double b = f64(bv) == 0.0 ? 1.0 : f64(bv);
          v = w64(f64(av) / b);
          z = an | bn | (f64(bv) == 0.0);
          break;
        }
        case MOD_F: {
          const double b = f64(bv) == 0.0 ? 1.0 : f64(bv);
          const double r = fmod(fabs(f64(av)), fabs(b));
          v = w64(signbit(f64(av)) ? -r : r);
          z = an | bn | (f64(bv) == 0.0);
          break;
        }
        case BAND: v = av & bv; z = an | bn; break;
        case BOR: v = av | bv; z = an | bn; break;
        case BXOR: v = av ^ bv; z = an | bn; break;
        case AND3: {
          const bool is_false = (!an && !av) || (!bn && !bv);
          z = !is_false && (an || bn);
          v = !is_false && !z;
          break;
        }
        case OR3: {
          const bool is_true = (!an && av) || (!bn && bv);
          z = !is_true && (an || bn);
          v = is_true;
          break;
        }
        case XOR3: v = (av != 0) != (bv != 0); z = an | bn; break;
        case IN: {
          bool hit = false;
          for (int j = in.k; j < in.k + in.n; ++j)
            hit |= av == prog.consts[j];
          const double fa = (in.flags & kInFloatOperand) ? f64(av)
                                                         : (double)av;
          for (int j = in.k + in.n; j < in.k + in.n + in.m; ++j)
            hit |= fa == f64(prog.consts[j]);
          z = an || ((in.flags & kInHasNull) && !hit);
          v = ((in.flags & kInNegate) ? !hit : hit) && !z;
          break;
        }
        default: z = true; break;
      }
      R[in.d] = v;
      nul = z ? (nul | (1u << in.d)) : (nul & ~(1u << in.d));
    }
    keep[s] = (R[0] != 0 && !(nul & 1u)) ? 1 : 0;
  }
}

}  // namespace

extern "C" int nt_predicate_sizes(int* out) {
  out[0] = kRegs;
  out[1] = kMaxInsns;
  out[2] = kMaxConsts;
  out[3] = kMaxCols;
  out[4] = (int)sizeof(Program);
  return 0;
}

// prog: a host Program image (gpu/kernels.py packs it); copied into the
// launch's parameter space, so it may be freed when this returns.  The
// slots are (L * P, EB); exactly one of total (L * P,) and valid
// (L * P, EB) is non-null; dcap > 0 only with the delta halves in
// prog.dcols.  L = 1 for a solo call.
extern "C" int nt_predicate_mask(const void* prog, const int* src,
                                 const int* dst, const int* rank,
                                 const int* eidx, const int* total,
                                 const uint8_t* valid, int P, int L, int EB,
                                 int emax, int dcap, uint8_t* keep,
                                 void* stream) {
  const Program& pr = *(const Program*)prog;
  if (pr.n_insns < 0 || pr.n_insns > kMaxInsns || pr.n_cols < 0 ||
      pr.n_cols > kMaxCols || (total == nullptr) == (valid == nullptr) ||
      P < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const int R = L * P;
  const long long n = (long long)R * EB;
  long long g = (n + 255) / 256;
  if (g > 132 * 16) g = 132 * 16;
  if (g > 0)
    predicate_kernel<<<(int)g, 256, 0, (cudaStream_t)stream>>>(
        pr, src, dst, rank, eidx, total, valid, P, R, EB, emax, dcap, keep);
  return (int)cudaGetLastError();
}
