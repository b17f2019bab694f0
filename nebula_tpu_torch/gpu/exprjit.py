"""Compile a GO WHERE edge predicate to a predicate program, and
evaluate YIELD columns columnar-side.

Port of `nebula_tpu/tpu/exprjit.py` (`compilable`, `compile_predicate`,
`_term_alg`, the vertex-predicate compiler, `yieldable`,
`eval_yield_column_np`).  The reference builds
ONE jnp expression that XLA fuses into the hop (Queue B K4); here the
typed term tree is lowered to a small register program (below), run by
the hand-written CUDA interpreter `csrc/predicate.cu` on the card and
by a torch evaluator on the CPU, with the host interpreter's exact
semantics:

  * three-valued logic: every register is a (value, is_null) pair with
    a static kind; Kleene AND/OR, null-propagating arithmetic and
    comparisons;
  * division / modulo by zero → null (drops the row under a WHERE);
  * integer `/` truncates toward zero and `%` takes the dividend's sign
    (computed on `abs()` operands, where floor division agrees with C);
  * strings are dictionary codes (int64): ==, !=, IN compile; ordering
    and pattern operators do not (`compilable` refuses, the statement
    stays on the host);
  * NULL sentinels: INT64_MIN in int/bool/string columns, NaN in floats.

Columns arrive as a dict: reserved keys `_rank`, `_src`, `_dst`
(endpoint DENSE ids for id($^)/id($$)) plus one key per edge property.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core import expr as E
from ..core.value import NULL_UNKNOWN_PROP, NullValue
from ..graphstore.csr import INT_NULL, StringPool
from ..graphstore.schema import PropType


class CannotCompile(Exception):
    pass


_NUMERIC = ("int", "float")
_CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")
_ARITH_OPS = ("+", "-", "*", "/", "%")
_BIT_OPS = ("&", "|", "^")          # int-only; others refuse
_LOGIC_OPS = ("AND", "OR", "XOR")


def _is_string_type(pt: PropType) -> bool:
    return pt in (PropType.STRING, PropType.FIXED_STRING)


def _kind_of(pt: PropType) -> str:
    if pt in (PropType.FLOAT, PropType.DOUBLE):
        return "float"
    if _is_string_type(pt):
        return "str"
    if pt == PropType.BOOL:
        return "bool"
    # temporal kinds stay distinct: the host answers BAD_TYPE for e.g.
    # DateTime < int, so their int encodings must not meet int literals
    if pt == PropType.DATE:
        return "date"
    if pt == PropType.TIME:
        return "time"
    if pt == PropType.DATETIME:
        return "datetime"
    if pt == PropType.DURATION:
        return "duration"
    if pt == PropType.GEOGRAPHY:
        return "geo"
    return "int"        # ints + TIMESTAMP


# ---------------------------------------------------------------------------
# Static compilability gate
# ---------------------------------------------------------------------------


def compilable(e: E.Expr, etypes: Sequence[str]) -> bool:
    """True iff `compile_predicate` will succeed for this expr against a
    single-block hop over one of `etypes`.  Conservative."""
    try:
        _check(e, set(etypes))
        return True
    except CannotCompile:
        return False


def _edge_prop_ref(e: E.Expr):
    """Normalize the three spellings of an edge-property reference:
    EdgeProp, AttributeExpr(LabelExpr) and rank(edge).  Returns
    (edge_name_or_None, prop) or None."""
    if isinstance(e, E.EdgeProp):
        return (e.edge, e.name)
    if isinstance(e, E.AttributeExpr) and isinstance(e.obj, E.LabelExpr):
        return (e.obj.name, e.attr)
    if (isinstance(e, E.FunctionCall) and e.name.lower() == "rank"
            and len(e.args) == 1 and isinstance(e.args[0], E.EdgeExpr)):
        return (None, "_rank")
    return None


def _vid_ref(e: E.Expr):
    """id($$) / id($^) → the column holding that endpoint's DENSE id."""
    if (isinstance(e, E.FunctionCall) and e.name.lower() == "id"
            and len(e.args) == 1 and getattr(e.args[0], "kind", "")
            == "vertex"):
        which = getattr(e.args[0], "which", "")
        if which == "$$":
            return "_dst"
        if which == "$^":
            return "_src"
    return None


def _nonnull_lit(x: E.Expr) -> bool:
    """Literal usable in a dense-id compare: not NULL, not bool."""
    return (isinstance(x, E.Literal) and x.value is not None
            and not isinstance(x.value, (NullValue, bool)))


def _id_pred_shape_ok(e: "E.Binary", l_ref: bool, r_ref: bool) -> bool:
    if e.op in ("==", "!=") and ((l_ref and _nonnull_lit(e.rhs))
                                 or (r_ref and _nonnull_lit(e.lhs))):
        return True
    if e.op in ("IN", "NOT IN") and l_ref \
            and isinstance(e.rhs, (E.ListExpr, E.SetExpr)) \
            and all(_nonnull_lit(i) for i in e.rhs.items):
        return True
    return False


def _check(e: E.Expr, etypes: Set[str]):
    if isinstance(e, E.Literal):
        v = e.value
        if v is None or isinstance(v, (bool, int, float, str, NullValue)):
            return
        raise CannotCompile(f"literal {type(v)}")
    ref = _edge_prop_ref(e)
    if ref is not None:
        edge, name = ref
        if name in ("_src", "_dst", "_type"):
            raise CannotCompile("edge reserved prop beyond _rank")
        if name != "_rank" and len(etypes) != 1:
            raise CannotCompile("prop predicate over multiple edge types")
        if name != "_rank" and edge != "__edge__" and edge not in etypes:
            raise CannotCompile(f"predicate on non-traversed edge {edge}")
        return
    if isinstance(e, E.Unary):
        if e.op in ("NOT", "-", "+", "IS_NULL", "IS_NOT_NULL"):
            _check(e.operand, etypes)
            return
        raise CannotCompile(f"unary {e.op}")
    if isinstance(e, E.Binary):
        lv, rv = _vid_ref(e.lhs), _vid_ref(e.rhs)
        if lv or rv:
            if _id_pred_shape_ok(e, bool(lv), bool(rv)):
                return
            raise CannotCompile(
                "id($$)/id($^) only compiles vs non-null literal vids")
        if e.op in _LOGIC_OPS + _CMP_OPS + _ARITH_OPS + _BIT_OPS:
            _check(e.lhs, etypes)
            _check(e.rhs, etypes)
            return
        if e.op in ("IN", "NOT IN"):
            _check(e.lhs, etypes)
            if not isinstance(e.rhs, (E.ListExpr, E.SetExpr)):
                raise CannotCompile("IN rhs must be a literal list")
            for item in e.rhs.items:
                if not isinstance(item, E.Literal):
                    raise CannotCompile("IN item not literal")
            return
        raise CannotCompile(f"binary {e.op}")
    raise CannotCompile(f"expr kind {e.kind}")


# ---------------------------------------------------------------------------
# Compilation — the typed term tree lowered to a predicate program
# ---------------------------------------------------------------------------
#
# A predicate program is a flat list of typed instructions over a register
# file of (64-bit word, null bit) pairs; a word holds an int64, the bits
# of a float64, or 0/1 for a bool.  Each instruction is eight int32
# fields (op, d, a, b, k, n, m, flags): d is the destination register,
# a and b the operand registers, k/n/m index the constant table or the
# column list.  Two evaluators run it: `Program.__call__` with torch ops
# (the plain version, over gathered columns), and csrc/predicate.cu on
# the card, one slot per thread, gathering each column at the slot's
# eidx itself (gpu/kernels.py:predicate_mask).  The mask is
# val & ~null of register 0, or all False when the predicate's value
# is not a bool (the host's to_bool3 gives null, which drops the row).

# opcodes — csrc/predicate.cu mirrors these numbers
(OP_LOAD_I, OP_LOAD_F, OP_LOAD_B, OP_LOAD_RANK, OP_LOAD_SRC, OP_LOAD_DST,
 OP_CONST, OP_NULL, OP_IS_NULL, OP_IS_NOT_NULL, OP_NOT, OP_NEG_I, OP_NEG_F,
 OP_I2F, OP_EQ_I, OP_NE_I, OP_LT_I, OP_LE_I, OP_GT_I, OP_GE_I, OP_EQ_F,
 OP_NE_F, OP_LT_F, OP_LE_F, OP_GT_F, OP_GE_F, OP_ADD_I, OP_SUB_I, OP_MUL_I,
 OP_DIV_I, OP_MOD_I, OP_ADD_F, OP_SUB_F, OP_MUL_F, OP_DIV_F, OP_MOD_F,
 OP_BAND, OP_BOR, OP_BXOR, OP_AND3, OP_OR3, OP_XOR3, OP_IN) = range(43)

# the kernel's fixed sizes (csrc/predicate.cu kRegs, kMaxInsns, ...).
# Operands are evaluated heavier-first, so a subtree needing r registers
# has at least 2**(r-1) leaves: a program within MAX_INSNS needs at most
# 6 registers, and the instruction budget is what refuses a predicate
# first; the register check guards the kernel's file all the same.
MAX_REGS = 8
MAX_INSNS = 64
MAX_CONSTS = 128
MAX_COLS = 8

IN_HAS_NULL, IN_NEGATE, IN_FLOAT_OPERAND = 1, 2, 4
CONST_INT, CONST_FLOAT, CONST_BOOL = 0, 1, 2    # the word's kind

_CMP_CODE = {"==": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
_ARITH_CODE = {"+": 0, "-": 1, "*": 2, "/": 3, "%": 4}
_BIT_CODE = {"&": OP_BAND, "|": OP_BOR, "^": OP_BXOR}
_LOGIC_CODE = {"AND": OP_AND3, "OR": OP_OR3, "XOR": OP_XOR3}
_LOADS = {"_rank": OP_LOAD_RANK, "_src": OP_LOAD_SRC, "_dst": OP_LOAD_DST}
_LOAD_NAMES = {op: name for name, op in _LOADS.items()}


def _f64_bits(x: float) -> int:
    return int(np.array(x, np.float64).view(np.int64))


def _bits_f64(w: int) -> float:
    return float(np.array(w, np.int64).view(np.float64))


class Program:
    """One lowered WHERE predicate.

    code: instructions (8-tuples); consts: int64 words; columns: the
    edge-prop names the LOAD instructions index, in slot order; n_regs:
    registers used; always_false: the value is not a bool.  A predicate
    whose typing fails, as the reference's `_term_alg` fails when its
    mask function runs, keeps that CannotCompile in `error` and raises
    it wherever the program is evaluated."""

    def __init__(self, code, consts, columns, n_regs, always_false,
                 device, error=None):
        self.code: List[Tuple[int, ...]] = code
        self.consts: List[int] = consts
        self.columns: List[str] = columns
        self.n_regs = n_regs
        self.always_false = always_false
        self.device = device
        self.error: Optional[CannotCompile] = error

    def __call__(self, cols: Dict[str, Any]) -> torch.Tensor:
        """The mask over per-slot columns (reserved keys `_rank`,
        `_src`, `_dst` and one per edge prop), evaluated with torch ops;
        0-d when the predicate reads no column."""
        if self.error is not None:
            raise self.error
        val, null = _run(self, cols)
        if self.always_false:
            return torch.zeros(val.shape, dtype=torch.bool,
                               device=val.device)
        return val & ~null


def _run(prog: Program, cols: Dict[str, Any]):
    """The plain evaluator: every register is a (value, null) pair of
    tensors — int64, float64 or bool values, bool nulls.  Returns
    register 0."""
    dev = next((t.device for t in cols.values()
                if isinstance(t, torch.Tensor)), prog.device)

    def bools(shape, fill):
        return torch.full(shape, fill, dtype=torch.bool, device=dev)

    def word(j, dtype):
        w = prog.consts[j]
        v = _bits_f64(w) if dtype == torch.float64 else w
        return torch.tensor(v, dtype=dtype, device=dev)

    R: List[Any] = [None] * prog.n_regs
    for op, d, a, b, k, n, m, flags in prog.code:
        if op in (OP_LOAD_I, OP_LOAD_F, OP_LOAD_B):
            x = cols[prog.columns[k]]
            if op == OP_LOAD_F:
                R[d] = (x, torch.isnan(x))
            elif op == OP_LOAD_B:
                R[d] = (x != 0, x == INT_NULL)
            else:
                R[d] = (x.long(), x == INT_NULL)
        elif op in _LOAD_NAMES:
            x = cols[_LOAD_NAMES[op]].long()
            R[d] = (x, bools(x.shape, False))
        elif op == OP_CONST:
            if flags == CONST_BOOL:
                val = torch.tensor(bool(prog.consts[k]), device=dev)
            else:
                val = word(k, torch.float64 if flags == CONST_FLOAT
                           else torch.int64)
            R[d] = (val, bools((), False))
        elif op == OP_NULL:
            R[d] = (torch.zeros((), dtype=torch.int64, device=dev),
                    bools((), True))
        elif op in (OP_IS_NULL, OP_IS_NOT_NULL):
            na = R[a][1]
            R[d] = (na if op == OP_IS_NULL else ~na, bools(na.shape, False))
        elif op == OP_NOT:
            R[d] = (~R[a][0], R[a][1])
        elif op in (OP_NEG_I, OP_NEG_F):
            R[d] = (-R[a][0], R[a][1])
        elif op == OP_I2F:
            R[d] = (R[a][0].to(torch.float64), R[a][1])
        elif OP_EQ_I <= op <= OP_GE_F:
            (av, an), (bv, bn) = R[a], R[b]
            val = (torch.eq, torch.ne, torch.lt, torch.le, torch.gt,
                   torch.ge)[(op - OP_EQ_I) % 6](av, bv)
            R[d] = (val, an | bn)
        elif OP_ADD_I <= op <= OP_MOD_F:
            R[d] = _arith(op, R[a], R[b], dev)
        elif op in (OP_BAND, OP_BOR, OP_BXOR):
            (av, an), (bv, bn) = R[a], R[b]
            val = {OP_BAND: av & bv, OP_BOR: av | bv, OP_BXOR: av ^ bv}[op]
            R[d] = (val, an | bn)
        elif op == OP_AND3:
            (av, an), (bv, bn) = R[a], R[b]
            is_false = (~an & ~av) | (~bn & ~bv)
            null = ~is_false & (an | bn)
            R[d] = (~is_false & ~null, null)
        elif op == OP_OR3:
            (av, an), (bv, bn) = R[a], R[b]
            is_true = (~an & av) | (~bn & bv)
            R[d] = (is_true, ~is_true & (an | bn))
        elif op == OP_XOR3:
            (av, an), (bv, bn) = R[a], R[b]
            R[d] = (av ^ bv, an | bn)
        elif op == OP_IN:
            av, an = R[a]
            hit = bools(av.shape, False)
            for j in range(k, k + n):           # int-compared items
                hit = hit | (av == word(j, torch.int64))
            fa = av.to(torch.float64)
            for j in range(k + n, k + n + m):   # float-compared items
                hit = hit | (fa == word(j, torch.float64))
            null = an | ~hit if flags & IN_HAS_NULL else an
            val = ~hit if flags & IN_NEGATE else hit
            R[d] = (val & ~null, null)
        else:
            raise CannotCompile(f"unknown opcode {op}")
    return R[0]


def _arith(op, x, y, dev):
    """+ - * / % over int64 or float64 registers: `/` and `%` by zero
    are null, int `/` truncates toward zero and `%` takes the
    dividend's sign (computed on `abs()` operands, where floor and
    truncation agree)."""
    (av, an), (bv, bn) = x, y
    c = (op - OP_ADD_I) % 5
    null = an | bn
    if c == 0:
        return av + bv, null
    if c == 1:
        return av - bv, null
    if c == 2:
        return av * bv, null
    zero = bv == 0
    safe = torch.where(zero, torch.ones((), dtype=bv.dtype, device=dev), bv)
    if op == OP_DIV_I:
        q = torch.abs(av) // torch.abs(safe)
        val = q * torch.where((av >= 0) == (safe >= 0), 1, -1)
    elif op == OP_DIV_F:
        val = av / safe
    elif op == OP_MOD_I:
        r = torch.abs(av) % torch.abs(safe)
        val = torch.where(av >= 0, r, -r)
    else:
        r = torch.fmod(torch.abs(av), torch.abs(safe))
        val = torch.where(torch.signbit(av), -r, r)
    return val, null | zero


def compile_predicate(e: E.Expr, prop_types: Dict[str, PropType],
                      pool: StringPool, vid_to_dense=None,
                      device: Any = "cpu") -> Tuple[Program, List[str]]:
    """Returns (program, needed_columns).  program(cols) -> bool tensor:
    True where the predicate evaluates to (non-null) true.

    Raises CannotCompile where the reference's `compile_predicate`
    raises at compile time (unknown prop, literal, id() shape) and for
    a program larger than the kernel's register file, instruction,
    constant or column budget; a typing failure, which the reference
    raises when its mask function runs, raises when the program runs.

    vid_to_dense: vid → dense id (-1 unknown), required to compile
    id($$)/id($^) comparisons."""
    needed: Set[str] = set()

    def dense_of(v):
        if vid_to_dense is None:
            raise CannotCompile("no vid→dense mapping for id() predicate")
        d = vid_to_dense(v)
        return int(d) if d is not None else -1

    def build(x: E.Expr):
        """Pass 1, the reference's `build`: the checks it makes while
        compiling and the columns it needs, into a tuple tree."""
        if isinstance(x, E.Binary):
            lv, rv = _vid_ref(x.lhs), _vid_ref(x.rhs)
            if lv or rv:
                if x.op in ("==", "!="):
                    col = lv or rv
                    lit = x.rhs if lv else x.lhs
                    if not isinstance(lit, E.Literal):
                        raise CannotCompile("id() vs non-literal")
                    needed.add(col)
                    return ("vid", col, x.op == "!=", [dense_of(lit.value)])
                if x.op in ("IN", "NOT IN") and lv:
                    needed.add(lv)
                    return ("vid", lv, x.op == "NOT IN",
                            [dense_of(it.value) for it in x.rhs.items])
                raise CannotCompile("id() predicate shape")
        if isinstance(x, E.Literal):
            return ("lit",) + _lit(x.value, pool)
        ref = _edge_prop_ref(x)
        if ref is not None:
            _, pname = ref
            if pname == "_rank":
                needed.add("_rank")
                return ("rank",)
            pt = prop_types.get(pname)
            if pt is None:
                raise CannotCompile(f"unknown edge prop {pname}")
            needed.add(pname)
            return ("col", pname, _kind_of(pt))
        if isinstance(x, E.Unary):
            return ("unary", x.op, build(x.operand))
        if isinstance(x, E.Binary):
            if x.op in ("IN", "NOT IN"):
                return ("in", build(x.lhs), [it.value for it in x.rhs.items],
                        x.op == "NOT IN")
            return ("binary", x.op, build(x.lhs), build(x.rhs))
        raise CannotCompile(f"expr kind {x.kind}")

    tree = build(e)
    dev = torch.device(device)
    try:
        prog = _lower(tree, pool, dev)
    except _Deferred as err:
        prog = Program([], [], [], 0, False, dev,
                       error=CannotCompile(str(err)))
    return prog, sorted(needed)


class _Deferred(Exception):
    """A typing failure: raised by the program when it runs."""


def _lit(v: Any, pool: StringPool) -> Tuple[str, Optional[int]]:
    """(kind, word) of a literal; word None is NULL."""
    if v is None or isinstance(v, NullValue):
        return ("int", None)
    if isinstance(v, bool):
        return ("bool", int(v))
    if isinstance(v, int):
        if not (-(1 << 63) <= v < (1 << 63)):
            # host compares arbitrary-precision ints; fall back
            raise CannotCompile("int literal outside int64")
        return ("int", v)
    if isinstance(v, float):
        return ("float", _f64_bits(v))
    if isinstance(v, str):
        # -2 when absent: equals nothing non-null
        return ("str", pool.lookup(v))
    raise CannotCompile(f"literal {type(v)}")


def _need(t) -> int:
    """Registers a subtree needs when the heavier operand of every
    binary node is evaluated first (Sethi-Ullman numbering)."""
    if t[0] in ("unary", "in"):
        return _need(t[2] if t[0] == "unary" else t[1])
    if t[0] == "binary":
        a, b = _need(t[2]), _need(t[3])
        return max(a, b) if a != b else a + 1
    return 1


def _in_items(items, kind: str, pool: StringPool):
    """An IN list's items as (int-compared words, float-compared words,
    has_null), with the reference's item typing."""
    ints, floats, has_null = [], [], False
    for it in items:
        if it is None or isinstance(it, NullValue):
            has_null = True
        elif isinstance(it, bool):
            if kind != "bool":
                raise _Deferred("IN bool item vs non-bool")
            ints.append(int(it))
        elif isinstance(it, int):
            if kind not in _NUMERIC or not (-(1 << 63) <= it < (1 << 63)):
                raise _Deferred("IN int item vs non-numeric")
            if kind == "int":
                ints.append(it)
            else:
                floats.append(_f64_bits(float(it)))
        elif isinstance(it, float):
            if kind not in _NUMERIC:
                raise _Deferred("IN float item vs non-numeric")
            floats.append(_f64_bits(it))
        elif isinstance(it, str):
            if kind != "str":
                raise _Deferred("IN str item vs non-string")
            ints.append(pool.lookup(it))
        else:
            raise _Deferred(f"IN item {type(it)}")
    return ints, floats, has_null


def _lower(tree, pool: StringPool, device) -> Program:
    """Pass 2: type the tree as the reference's `_term_alg` does and
    emit the program; raises _Deferred where the reference's mask
    function would raise CannotCompile."""
    code: List[Tuple[int, ...]] = []
    consts: List[int] = []
    columns: List[str] = []
    top = [0]

    def emit(op, d, a=0, b=0, k=0, n=0, m=0, flags=0):
        code.append((op, d, a, b, k, n, m, flags))
        top[0] = max(top[0], d + 1)

    def words(ws) -> int:
        consts.extend(int(w) for w in ws)
        return len(consts) - len(ws)

    def to_float(r, kind):
        if kind == "int":
            emit(OP_I2F, r, r)

    def coerce(ra, ak, rb, bk) -> str:
        if ak == bk:
            return ak
        if {ak, bk} == {"int", "float"}:
            to_float(ra, ak)
            to_float(rb, bk)
            return "float"
        raise _Deferred(f"type mix {ak}/{bk}")

    def gen(t, r: int) -> str:
        """Emit t into register r (scratch: r+1 and up); its kind."""
        tag = t[0]
        if tag == "lit":
            kind, w = t[1], t[2]
            if w is None:
                emit(OP_NULL, r)
            else:
                emit(OP_CONST, r, k=words([w]),
                     flags={"float": CONST_FLOAT, "bool": CONST_BOOL}.get(
                         kind, CONST_INT))
            return kind
        if tag == "rank":
            emit(OP_LOAD_RANK, r)
            return "int"
        if tag == "col":
            kind = t[2]
            if t[1] not in columns:
                columns.append(t[1])
            emit({"float": OP_LOAD_F, "bool": OP_LOAD_B}.get(kind, OP_LOAD_I),
                 r, k=columns.index(t[1]))
            return kind
        if tag == "vid":
            emit(_LOADS[t[1]], r)
            emit(OP_IN, r, r, k=words(t[3]), n=len(t[3]),
                 flags=IN_NEGATE if t[2] else 0)
            return "bool"
        if tag == "unary":
            op, kind = t[1], gen(t[2], r)
            if op in ("IS_NULL", "IS_NOT_NULL"):
                emit(OP_IS_NULL if op == "IS_NULL" else OP_IS_NOT_NULL, r, r)
                return "bool"
            if op == "NOT":
                if kind != "bool":
                    raise _Deferred("NOT on non-bool")
                emit(OP_NOT, r, r)
                return "bool"
            if op in ("-", "+"):
                if kind not in _NUMERIC:
                    raise _Deferred(f"unary {op} on non-numeric")
                if op == "-":
                    emit(OP_NEG_F if kind == "float" else OP_NEG_I, r, r)
                return kind
            raise _Deferred(f"unary {op}")
        if tag == "in":
            kind = gen(t[1], r)
            ints, floats, has_null = _in_items(t[2], kind, pool)
            flags = ((IN_HAS_NULL if has_null else 0)
                     | (IN_NEGATE if t[3] else 0)
                     | (IN_FLOAT_OPERAND if kind == "float" else 0))
            emit(OP_IN, r, r, k=words(ints + floats), n=len(ints),
                 m=len(floats), flags=flags)
            return "bool"
        # binary: the heavier operand first, into r; the other into r+1
        op, lt, rt = t[1], t[2], t[3]
        if _need(rt) > _need(lt):
            ra, rb = r + 1, r
            bk = gen(rt, rb)
            ak = gen(lt, ra)
        else:
            ra, rb = r, r + 1
            ak = gen(lt, ra)
            bk = gen(rt, rb)
        if op in _LOGIC_OPS:
            if ak != "bool" or bk != "bool":
                raise _Deferred("logic on non-bool")
            emit(_LOGIC_CODE[op], r, ra, rb)
            return "bool"
        if op in _CMP_OPS:
            if "str" in (ak, bk) or "bool" in (ak, bk) or "geo" in (ak, bk):
                if ak != bk:
                    raise _Deferred(f"compare {ak} vs {bk}")
                if op not in ("==", "!="):
                    # dict codes are insertion-ordered, not value-ordered
                    raise _Deferred(f"ordering on {ak}")
                emit(OP_EQ_I + _CMP_CODE[op], r, ra, rb)
                return "bool"
            kind = coerce(ra, ak, rb, bk)
            base = OP_EQ_F if kind == "float" else OP_EQ_I
            emit(base + _CMP_CODE[op], r, ra, rb)
            return "bool"
        if op in _ARITH_OPS:
            if ak not in _NUMERIC or bk not in _NUMERIC:
                raise _Deferred(f"arith on {ak}/{bk}")
            kind = coerce(ra, ak, rb, bk)
            base = OP_ADD_F if kind == "float" else OP_ADD_I
            emit(base + _ARITH_CODE[op], r, ra, rb)
            return kind
        if op in _BIT_OPS:
            if ak != "int" or bk != "int":
                raise _Deferred(f"bitwise on {ak}/{bk}")
            emit(_BIT_CODE[op], r, ra, rb)
            return "int"
        raise _Deferred(f"binary {op}")

    kind = gen(tree, 0)
    if top[0] > MAX_REGS or len(code) > MAX_INSNS \
            or len(consts) > MAX_CONSTS or len(columns) > MAX_COLS:
        raise CannotCompile(
            f"predicate program too large for the kernel: {top[0]} "
            f"registers (max {MAX_REGS}), {len(code)} instructions (max "
            f"{MAX_INSNS}), {len(consts)} constants (max {MAX_CONSTS}), "
            f"{len(columns)} columns (max {MAX_COLS})")
    return Program(code, consts, columns, top[0], kind != "bool", device)


# ---------------------------------------------------------------------------
# The (value, is_null, kind) term algebra over numpy
# ---------------------------------------------------------------------------
#
# The reference builds its in-kernel masks and its host vertex masks
# from one algebra (`_term_alg`, over jnp and over np).  The port's edge
# masks are the register program above; the vertex masks (fused MATCH,
# gpu/match_agg.py) keep the algebra over numpy, a copy of the
# reference's with the reference's typing, so the two packages cannot
# drift on a vertex predicate.

Term = Tuple[Any, Any, str]             # (val, isnull, kind)


def _np_lit(v: Any, pool: StringPool) -> Callable[[Dict[str, Any]], Term]:
    if v is None or isinstance(v, NullValue):
        return lambda c: (np.zeros((), np.int64), np.ones((), bool),
                          "int")
    if isinstance(v, bool):
        return lambda c: (np.asarray(v), np.zeros((), bool), "bool")
    if isinstance(v, int):
        if not (-(1 << 63) <= v < (1 << 63)):
            # host compares arbitrary-precision ints; fall back
            raise CannotCompile("int literal outside int64")
        return lambda c: (np.asarray(v, np.int64), np.zeros((), bool),
                          "int")
    if isinstance(v, float):
        return lambda c: (np.asarray(v, np.float64),
                          np.zeros((), bool), "float")
    if isinstance(v, str):
        code = pool.lookup(v)   # -2 when absent: equals nothing non-null
        return lambda c: (np.asarray(code, np.int64),
                          np.zeros((), bool), "str")
    raise CannotCompile(f"literal {type(v)}")


def _np_unary(op: str, f) -> Callable[[Dict[str, Any]], Term]:
    def g(c):
        v, n, k = f(c)
        if op == "IS_NULL":
            return (n, np.zeros(np.shape(n), bool), "bool")
        if op == "IS_NOT_NULL":
            return (np.logical_not(n), np.zeros(np.shape(n), bool),
                    "bool")
        if op == "NOT":
            if k != "bool":
                raise CannotCompile("NOT on non-bool")
            return (np.logical_not(v), n, "bool")
        if op == "-":
            if k not in _NUMERIC:
                raise CannotCompile("negate non-numeric")
            return (-v, n, k)
        if op == "+":
            if k not in _NUMERIC:
                raise CannotCompile("+x non-numeric")
            return (v, n, k)
        raise CannotCompile(f"unary {op}")
    return g


def _np_coerce_pair(av, ak, bv, bk):
    """Numeric promotion for mixed int/float operands."""
    if ak == bk:
        return av, bv, ak
    if set((ak, bk)) == {"int", "float"}:
        return (av.astype(np.float64) if ak == "int" else av,
                bv.astype(np.float64) if bk == "int" else bv, "float")
    raise CannotCompile(f"type mix {ak}/{bk}")


def _np_binary(op: str, fa, fb) -> Callable[[Dict[str, Any]], Term]:
    def g(c):
        av, an, ak = fa(c)
        bv, bn, bk = fb(c)
        if op in _LOGIC_OPS:
            if ak != "bool" or bk != "bool":
                raise CannotCompile("logic on non-bool")
            if op == "AND":
                is_false = (~an & ~av) | (~bn & ~bv)
                val = ~is_false
                null = ~is_false & (an | bn)
                return (val & ~null, null, "bool")
            if op == "OR":
                is_true = (~an & av) | (~bn & bv)
                null = ~is_true & (an | bn)
                return (is_true, null, "bool")
            # XOR
            return (np.logical_xor(av, bv), an | bn, "bool")
        if op in _CMP_OPS:
            null = an | bn
            if "str" in (ak, bk) or "bool" in (ak, bk) or "geo" in (ak, bk):
                if ak != bk:
                    raise CannotCompile(f"compare {ak} vs {bk}")
                if op not in ("==", "!="):
                    # dict codes are insertion-ordered, not value-ordered
                    raise CannotCompile(f"ordering on {ak}")
                val = (av == bv) if op == "==" else (av != bv)
                return (val, null, "bool")
            a2, b2, _ = _np_coerce_pair(av, ak, bv, bk)
            val = {"==": a2 == b2, "!=": a2 != b2, "<": a2 < b2,
                   "<=": a2 <= b2, ">": a2 > b2, ">=": a2 >= b2}[op]
            return (val, null, "bool")
        if op in _ARITH_OPS:
            if ak not in _NUMERIC or bk not in _NUMERIC:
                raise CannotCompile(f"arith on {ak}/{bk}")
            a2, b2, k = _np_coerce_pair(av, ak, bv, bk)
            null = an | bn
            if op == "+":
                return (a2 + b2, null, k)
            if op == "-":
                return (a2 - b2, null, k)
            if op == "*":
                return (a2 * b2, null, k)
            if op == "/":
                null = null | (b2 == 0)
                safe = np.where(b2 == 0, np.ones((), b2.dtype), b2)
                if k == "int":
                    # host semantics: truncation toward zero
                    q = np.abs(a2) // np.abs(safe)
                    sign = np.where((a2 >= 0) == (safe >= 0), 1, -1)
                    return (q * sign, null, "int")
                return (a2 / safe, null, "float")
            # %
            null = null | (b2 == 0)
            safe = np.where(b2 == 0, np.ones((), b2.dtype), b2)
            if k == "int":
                # host v_mod: sign follows the dividend (C fmod style)
                r = np.abs(a2) % np.abs(safe)
                return (np.where(a2 >= 0, r, -r), null, "int")
            return (np.where(np.signbit(a2),
                             -(np.abs(a2) % np.abs(safe)),
                             np.abs(a2) % np.abs(safe)), null, "float")
        if op in _BIT_OPS:
            # host gives BAD_TYPE (row-dropping) for non-int
            # operands incl. bools/floats — only the int/int shape
            # compiles; everything else falls back
            if ak != "int" or bk != "int":
                raise CannotCompile(f"bitwise on {ak}/{bk}")
            null = an | bn
            val = {"&": av & bv, "|": av | bv, "^": av ^ bv}[op]
            return (val, null, "int")
        raise CannotCompile(f"binary {op}")
    return g


def _np_in_list(fa, items: List[Any], pool: StringPool,
             negate: bool) -> Callable[[Dict[str, Any]], Term]:
    def g(c):
        av, an, ak = fa(c)
        any_true = np.zeros(np.shape(av), bool)
        any_null = np.zeros(np.shape(av), bool)
        for it in items:
            if it is None or isinstance(it, NullValue):
                any_null = np.ones(np.shape(av), bool)
                continue
            # type-mismatched items yield NULL from v_eq on the host
            # (not False), so anything not exactly comparable must
            # fall back
            if isinstance(it, bool):
                if ak != "bool":
                    raise CannotCompile("IN bool item vs non-bool")
                any_true = any_true | (av == it)
            elif isinstance(it, int):
                if ak not in _NUMERIC \
                        or not (-(1 << 63) <= it < (1 << 63)):
                    raise CannotCompile("IN int item vs non-numeric")
                if ak == "int":
                    any_true = any_true | (av == it)
                else:
                    any_true = any_true | (av == float(it))
            elif isinstance(it, float):
                if ak not in _NUMERIC:
                    raise CannotCompile("IN float item vs non-numeric")
                any_true = any_true | (av.astype(np.float64) == it)
            elif isinstance(it, str):
                if ak != "str":
                    raise CannotCompile("IN str item vs non-string")
                any_true = any_true | (av == pool.lookup(it))
            else:
                raise CannotCompile(f"IN item {type(it)}")
        val = any_true
        null = an | (~any_true & any_null)
        if negate:
            return (~val & ~null, null, "bool")
        return (val & ~null, null, "bool")
    return g


# ---------------------------------------------------------------------------
# Vertex-predicate compiler (numpy, host plane)
# ---------------------------------------------------------------------------
#
# The fused MATCH pipeline (tpu/match_agg.py) evaluates AppendVertices
# filters — `_hastag(v, "Tag")`, `v.Tag.prop > x`, compositions — as ONE
# numpy mask over the snapshot's TagTable columns instead of per-row
# Python `Expr.eval` over built Vertex objects, in the numpy term
# algebra above, so a host-side mask never dispatches to the device.


def _vertex_ref(x: "E.Expr", alias: str):
    """Classify a vertex-alias reference.  Returns ("prop", tag, prop) |
    ("attr", prop) | ("hastag", tag) | None; raises CannotCompile on a
    reference to a DIFFERENT alias (the caller's filter must be
    single-alias)."""
    if isinstance(x, E.LabelTagProp):
        if x.var != alias:
            raise CannotCompile(f"prop of other alias {x.var}")
        return ("prop", x.tag, x.prop)
    if isinstance(x, E.AttributeExpr) and isinstance(x.obj, E.LabelExpr):
        # tag-less `v.prop`: get_attribute over the MERGED tag props
        # (later tag in sorted order wins on a name collision)
        if x.obj.name != alias:
            raise CannotCompile(f"attr of other alias {x.obj.name}")
        return ("attr", x.attr)
    if (isinstance(x, E.FunctionCall) and x.name == "_hastag"
            and len(x.args) == 2 and isinstance(x.args[0], E.LabelExpr)
            and isinstance(x.args[1], E.Literal)
            and isinstance(x.args[1].value, str)):
        if x.args[0].name != alias:
            raise CannotCompile(f"_hastag of other alias {x.args[0].name}")
        return ("hastag", x.args[1].value)
    return None


def _vertex_id_ref(x: "E.Expr", alias: str) -> bool:
    """True iff x is id(<alias>)."""
    return (isinstance(x, E.FunctionCall) and x.name == "id"
            and len(x.args) == 1 and isinstance(x.args[0], E.LabelExpr)
            and x.args[0].name == alias)


def vertex_compilable(e: "E.Expr", alias: str) -> bool:
    """Static gate: will compile_vertex_predicate_np succeed (given the
    snapshot has the referenced tags)?  Conservative, schema-free."""
    try:
        _vertex_check(e, alias)
        return True
    except CannotCompile:
        return False


def _vertex_check(e: "E.Expr", alias: str):
    if isinstance(e, E.Literal):
        v = e.value
        if v is None or isinstance(v, (bool, int, float, str, NullValue)):
            return
        raise CannotCompile(f"literal {type(v)}")
    if _vertex_ref(e, alias) is not None:
        return
    if isinstance(e, E.Unary):
        if e.op in ("NOT", "-", "+", "IS_NULL", "IS_NOT_NULL"):
            _vertex_check(e.operand, alias)
            return
        raise CannotCompile(f"unary {e.op}")
    if isinstance(e, E.Binary):
        li, ri = _vertex_id_ref(e.lhs, alias), _vertex_id_ref(e.rhs, alias)
        if li or ri:
            if _id_pred_shape_ok(e, li, ri):
                return
            raise CannotCompile("id(v) only compiles vs non-null "
                                "literal vids")
        if e.op in _LOGIC_OPS + _CMP_OPS + _ARITH_OPS + _BIT_OPS:
            _vertex_check(e.lhs, alias)
            _vertex_check(e.rhs, alias)
            return
        if e.op in ("IN", "NOT IN"):
            _vertex_check(e.lhs, alias)
            if not isinstance(e.rhs, (E.ListExpr, E.SetExpr)):
                raise CannotCompile("IN rhs must be a literal list")
            for item in e.rhs.items:
                if not isinstance(item, E.Literal):
                    raise CannotCompile("IN item not literal")
            return
        raise CannotCompile(f"binary {e.op}")
    raise CannotCompile(f"expr kind {e.kind}")


def compile_vertex_predicate_np(e: "E.Expr", alias: str, snap,
                                sd) -> Callable[["np.ndarray"], "np.ndarray"]:
    """Compile a single-alias vertex predicate against CsrSnapshot tag
    tables.  Returns mask_fn(dense_ids) -> bool array: True where the
    predicate is (non-null) true for the vertex with that dense id.

    Tag-table null currency matches the edge plane: INT_NULL sentinel in
    int-coded columns, NaN in floats — absent-tag rows carry the fill,
    so `v.Tag.prop` on a vertex without Tag is NULL exactly like the
    host's per-row lookup (core/expr.py LabelTagProp)."""
    P = snap.num_parts
    pool = snap.pool

    def dense_of(v):
        d = sd.dense_id(v)
        return int(d) if d is not None else -1

    def vid_cmp(op, values):
        dv = [dense_of(x.value) for x in values]

        def g(c):
            ep = c["_dense"]
            m = np.zeros(np.shape(ep), bool)
            for d in dv:
                m = m | (ep == d)
            if op in ("!=", "NOT IN"):
                m = np.logical_not(m)
            return (m, np.zeros(np.shape(ep), bool), "bool")
        return g

    def build(x: "E.Expr"):
        if isinstance(x, E.Binary):
            li, ri = _vertex_id_ref(x.lhs, alias), _vertex_id_ref(x.rhs, alias)
            if li or ri:
                if x.op in ("==", "!="):
                    lit = x.rhs if li else x.lhs
                    if not isinstance(lit, E.Literal):
                        raise CannotCompile("id(v) vs non-literal")
                    return vid_cmp(x.op, [lit])
                if x.op in ("IN", "NOT IN") and li:
                    return vid_cmp(x.op, list(x.rhs.items))
                raise CannotCompile("id(v) predicate shape")
        if isinstance(x, E.Literal):
            return _np_lit(x.value, pool)
        ref = _vertex_ref(x, alias)
        if ref is not None:
            if ref[0] == "attr":
                return _attr_term(snap, P, ref[1])
            if ref[0] == "hastag":
                tt = snap.tags.get(ref[1])
                if tt is None:
                    return lambda c: (np.zeros(np.shape(c["_dense"]), bool),
                                      np.zeros(np.shape(c["_dense"]), bool),
                                      "bool")
                pres = tt.present

                def g(c, pres=pres):
                    d = c["_dense"]
                    m = pres[d % P, d // P]
                    return (m, np.zeros(m.shape, bool), "bool")
                return g
            _, tag, pname = ref
            tt = snap.tags.get(tag)
            if tt is None or pname not in tt.props:
                # unknown tag/prop → NULL (host LabelTagProp: absent)
                return lambda c: (np.zeros(np.shape(c["_dense"]), np.int64),
                                  np.ones(np.shape(c["_dense"]), bool),
                                  "int")
            kind = _kind_of(tt.prop_types[pname])
            col = tt.props[pname]

            def g(c, col=col, kind=kind):
                d = c["_dense"]
                raw = col[d % P, d // P]
                if kind == "float":
                    return (raw, np.isnan(raw), "float")
                if kind == "bool":
                    return (raw != 0, raw == INT_NULL, "bool")
                return (raw, raw == INT_NULL, kind)
            return g
        if isinstance(x, E.Unary):
            return _np_unary(x.op, build(x.operand))
        if isinstance(x, E.Binary):
            if x.op in ("IN", "NOT IN"):
                return _np_in_list(build(x.lhs),
                                   [it.value for it in x.rhs.items],
                                   pool, negate=x.op == "NOT IN")
            return _np_binary(x.op, build(x.lhs), build(x.rhs))
        raise CannotCompile(f"expr kind {x.kind}")

    term = build(e)

    def mask_fn(dense):
        val, isnull, kind = term({"_dense": dense})
        if kind != "bool":
            return np.zeros(np.shape(dense), bool)
        val = np.broadcast_to(val, np.shape(dense))
        isnull = np.broadcast_to(isnull, np.shape(dense))
        return np.logical_and(val, np.logical_not(isnull))

    return mask_fn


def merged_attr_columns(snap, prop: str):
    """(present, raw, kind) per tag whose schema carries `prop`, in the
    snapshot's sorted-tag order — the columnar mirror of
    Vertex.properties()'s dict merge (later tag wins).  Raises when the
    participating columns disagree on the value kind (a per-row merge
    of mixed encodings has no single columnar type)."""
    parts = []
    for tt in snap.tags.values():          # insertion = sorted tag order
        if prop in tt.props:
            parts.append((tt.present, tt.props[prop],
                          _kind_of(tt.prop_types[prop]),
                          tt.prop_types[prop]))
    kinds = {k for _, _, k, _ in parts}
    if len(kinds) > 1:
        raise CannotCompile(f"attr {prop} mixes value kinds across tags")
    return parts


def merged_attr_raw(snap, parts, dense: "np.ndarray"):
    """Merged raw column for `parts` at `dense` (sentinel nulls)."""
    P = snap.num_parts
    kind = parts[0][2]
    if kind == "float":
        val = np.full(np.shape(dense), np.nan)
    else:
        val = np.full(np.shape(dense), INT_NULL, np.int64)
    p_, li = dense % P, dense // P
    for pres, col, _, _ in parts:
        pm = pres[p_, li]
        val = np.where(pm, col[p_, li], val)
    return val


def _attr_term(snap, P, prop: str):
    parts = merged_attr_columns(snap, prop)
    if not parts:
        return lambda c: (np.zeros(np.shape(c["_dense"]), np.int64),
                          np.ones(np.shape(c["_dense"]), bool), "int")
    kind = parts[0][2]

    def g(c):
        raw = merged_attr_raw(snap, parts, c["_dense"])
        if kind == "float":
            return (raw, np.isnan(raw), "float")
        if kind == "bool":
            return (raw != 0, raw == INT_NULL, "bool")
        return (raw, raw == INT_NULL, kind)
    return g


# ---------------------------------------------------------------------------
# Columnar YIELD evaluation — the fused-Project output path
# ---------------------------------------------------------------------------

_YIELD_FNS = frozenset({"src", "dst", "rank", "type", "typeid"})


def yieldable(e: "E.Expr") -> bool:
    """Can this YIELD column be evaluated columnar-side?"""
    if e.kind == "literal":
        return True
    if e.kind == "edge_prop":
        return True
    if e.kind == "function" and e.name in _YIELD_FNS and len(e.args) == 1 \
            and e.args[0].kind == "edge":
        return True
    return False


def eval_yield_column_np(e: "E.Expr", b: Dict[str, Any]) -> np.ndarray:
    """One YIELD column over a materialized block, as a numpy array
    (object dtype for vids/strings, native dtype for numeric props).

    b: {"et", "etype" (signed), "n", "sv", "dv", "rr", "props"} from
    GpuRuntime._block_columns.  For reverse ("in") blocks etype < 0 and
    sv is the frontier vertex — the PHYSICAL edge is dv→sv."""
    n = b["n"]
    fwd = b["etype"] >= 0

    def _const(v, dtype=object):
        a = np.empty(n, dtype=dtype)
        a.fill(v)
        return a

    if e.kind == "literal":
        return _const(e.value)
    if e.kind == "function":
        name = e.name
        if name == "src":
            return b["sv"] if fwd else b["dv"]
        if name == "dst":
            return b["dv"] if fwd else b["sv"]
        if name == "rank":
            return np.asarray(b["rr"], dtype=np.int64)
        if name == "type":
            return _const(b["et"])
        if name == "typeid":
            return _const(int(b["etype"]), dtype=np.int64)
    if e.kind == "edge_prop":
        pname = e.name
        if pname == "_src":
            return b["sv"] if fwd else b["dv"]
        if pname == "_dst":
            return b["dv"] if fwd else b["sv"]
        if pname == "_rank":
            return np.asarray(b["rr"], dtype=np.int64)
        if pname == "_type":
            return _const(b["et"])
        col = b["props"].get(pname)
        if col is None:
            return _const(NULL_UNKNOWN_PROP)
        return col
    raise CannotCompile(f"yield not columnar: {e.kind}")
