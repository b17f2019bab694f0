"""Compile a GO WHERE edge predicate to a torch mask function, and
evaluate YIELD columns columnar-side.

Port of `nebula_tpu/tpu/exprjit.py` (`compilable`, `compile_predicate`,
`_term_alg`, `yieldable`, `eval_yield_column_np`).  The predicate is ONE
elementwise torch expression over the gathered edge columns (Queue B
K4: XLA fused it into the hop; here it runs as torch ops between the
`expand` and `compact_capture` kernels), with the host interpreter's
exact semantics:

  * three-valued logic: every term is a (value, is_null, kind) triple;
    Kleene AND/OR, null-propagating arithmetic and comparisons;
  * division / modulo by zero → null (drops the row under a WHERE);
  * integer `/` truncates toward zero and `%` takes the dividend's sign
    (computed on `abs()` operands, where torch's floor `//` and Python
    `%` agree with C);
  * strings are dictionary codes (int64): ==, !=, IN compile; ordering
    and pattern operators do not (`compilable` refuses, the statement
    stays on the host);
  * NULL sentinels: INT64_MIN in int/string columns, NaN in floats.

Columns arrive as a dict: reserved keys `_rank` (int64), `_src`, `_dst`
(endpoint DENSE ids for id($^)/id($$)) plus one key per edge property.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Set, Tuple

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
# Compilation — terms are (value_tensor, null_mask, kind)
# ---------------------------------------------------------------------------

Term = Tuple[Any, Any, str]             # (val, isnull, kind)
MaskFn = Callable[[Dict[str, Any]], Any]


class _TorchNS:
    """The array namespace `_term_alg` is written against, over torch on
    one device.  Literal tensors are created on that device so every
    elementwise op sees operands of one device."""

    int64 = torch.int64
    float64 = torch.float64

    def __init__(self, device: torch.device):
        self.device = device

    def asarray(self, v, dtype=None):
        return torch.tensor(v, dtype=dtype, device=self.device)

    def zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def ones(self, shape, dtype):
        return torch.ones(shape, dtype=dtype, device=self.device)

    def where(self, cond, a, b):
        return torch.where(cond, a, b)

    @staticmethod
    def shape(x):
        return tuple(x.shape)

    @staticmethod
    def astype(x, dtype):
        return x.to(dtype)

    logical_not = staticmethod(torch.logical_not)
    logical_xor = staticmethod(torch.logical_xor)
    abs = staticmethod(torch.abs)
    signbit = staticmethod(torch.signbit)


def compile_predicate(e: E.Expr, prop_types: Dict[str, PropType],
                      pool: StringPool, vid_to_dense=None,
                      device: Any = "cpu") -> Tuple[MaskFn, List[str]]:
    """Returns (mask_fn, needed_columns).  mask_fn(cols) -> bool tensor:
    True where the predicate evaluates to (non-null) true.

    vid_to_dense: vid → dense id (-1 unknown), required to compile
    id($$)/id($^) comparisons."""
    xp = _TorchNS(torch.device(device))
    _lit, _unary, _coerce_pair, _binary, _in_list = _term_alg(xp)
    needed: Set[str] = set()

    def dense_of(v):
        if vid_to_dense is None:
            raise CannotCompile("no vid→dense mapping for id() predicate")
        d = vid_to_dense(v)
        return int(d) if d is not None else -1

    def vid_cmp(col, op, values):
        """id(endpoint) ==/!=/IN literal vid(s) → dense comparison;
        unknown vids map to -1, which no real dense id equals."""
        needed.add(col)
        dv = [dense_of(v.value) for v in values]

        def g(c):
            ep = c[col]
            m = xp.zeros(ep.shape, torch.bool)
            for d in dv:
                m = m | (ep == d)
            if op in ("!=", "NOT IN"):
                m = torch.logical_not(m)
            return (m, xp.zeros(ep.shape, torch.bool), "bool")
        return g

    def build(x: E.Expr) -> Callable[[Dict[str, Any]], Term]:
        if isinstance(x, E.Binary):
            lv, rv = _vid_ref(x.lhs), _vid_ref(x.rhs)
            if lv or rv:
                if x.op in ("==", "!="):
                    col = lv or rv
                    lit = x.rhs if lv else x.lhs
                    if not isinstance(lit, E.Literal):
                        raise CannotCompile("id() vs non-literal")
                    return vid_cmp(col, x.op, [lit])
                if x.op in ("IN", "NOT IN") and lv:
                    return vid_cmp(lv, x.op, list(x.rhs.items))
                raise CannotCompile("id() predicate shape")
        if isinstance(x, E.Literal):
            return _lit(x.value, pool)
        ref = _edge_prop_ref(x)
        if ref is not None:
            _, pname = ref
            if pname == "_rank":
                needed.add("_rank")
                return lambda c: (c["_rank"],
                                  xp.zeros(c["_rank"].shape, torch.bool),
                                  "int")
            pt = prop_types.get(pname)
            if pt is None:
                raise CannotCompile(f"unknown edge prop {pname}")
            kind = _kind_of(pt)
            name = pname
            needed.add(name)
            if kind == "float":
                return lambda c: (c[name], torch.isnan(c[name]), "float")
            if kind == "bool":
                return lambda c: (c[name] != 0, c[name] == INT_NULL, "bool")
            return lambda c: (c[name], c[name] == INT_NULL, kind)
        if isinstance(x, E.Unary):
            return _unary(x.op, build(x.operand))
        if isinstance(x, E.Binary):
            if x.op in ("IN", "NOT IN"):
                return _in_list(build(x.lhs),
                                [it.value for it in x.rhs.items],
                                pool, negate=x.op == "NOT IN")
            return _binary(x.op, build(x.lhs), build(x.rhs))
        raise CannotCompile(f"expr kind {x.kind}")

    term = build(e)

    def mask_fn(cols: Dict[str, Any]):
        val, isnull, kind = term(cols)
        if kind != "bool":
            # non-bool WHERE result: host to_bool3 yields null → drop row
            return xp.zeros(val.shape, torch.bool)
        return torch.logical_and(val, torch.logical_not(isnull))

    return mask_fn, sorted(needed)


def _term_alg(xp):
    """The (value, is_null, kind) term algebra over one array namespace
    — the reference's `_term_alg` with `.astype` written as
    `xp.astype` (torch tensors have no `astype` method)."""

    def _lit(v: Any, pool: StringPool) -> Callable[[Dict[str, Any]], Term]:
        if v is None or isinstance(v, NullValue):
            return lambda c: (xp.zeros((), xp.int64), xp.ones((), bool),
                              "int")
        if isinstance(v, bool):
            return lambda c: (xp.asarray(v), xp.zeros((), bool), "bool")
        if isinstance(v, int):
            if not (-(1 << 63) <= v < (1 << 63)):
                # host compares arbitrary-precision ints; fall back
                raise CannotCompile("int literal outside int64")
            return lambda c: (xp.asarray(v, xp.int64), xp.zeros((), bool),
                              "int")
        if isinstance(v, float):
            return lambda c: (xp.asarray(v, xp.float64),
                              xp.zeros((), bool), "float")
        if isinstance(v, str):
            code = pool.lookup(v)   # -2 when absent: equals nothing non-null
            return lambda c: (xp.asarray(code, xp.int64),
                              xp.zeros((), bool), "str")
        raise CannotCompile(f"literal {type(v)}")

    def _unary(op: str, f) -> Callable[[Dict[str, Any]], Term]:
        def g(c):
            v, n, k = f(c)
            if op == "IS_NULL":
                return (n, xp.zeros(xp.shape(n), bool), "bool")
            if op == "IS_NOT_NULL":
                return (xp.logical_not(n), xp.zeros(xp.shape(n), bool),
                        "bool")
            if op == "NOT":
                if k != "bool":
                    raise CannotCompile("NOT on non-bool")
                return (xp.logical_not(v), n, "bool")
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

    def _coerce_pair(av, ak, bv, bk):
        """Numeric promotion for mixed int/float operands."""
        if ak == bk:
            return av, bv, ak
        if set((ak, bk)) == {"int", "float"}:
            return (xp.astype(av, xp.float64) if ak == "int" else av,
                    xp.astype(bv, xp.float64) if bk == "int" else bv,
                    "float")
        raise CannotCompile(f"type mix {ak}/{bk}")

    def _binary(op: str, fa, fb) -> Callable[[Dict[str, Any]], Term]:
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
                return (xp.logical_xor(av, bv), an | bn, "bool")
            if op in _CMP_OPS:
                null = an | bn
                if "str" in (ak, bk) or "bool" in (ak, bk) \
                        or "geo" in (ak, bk):
                    if ak != bk:
                        raise CannotCompile(f"compare {ak} vs {bk}")
                    if op not in ("==", "!="):
                        # dict codes are insertion-ordered, not value-ordered
                        raise CannotCompile(f"ordering on {ak}")
                    val = (av == bv) if op == "==" else (av != bv)
                    return (val, null, "bool")
                a2, b2, _ = _coerce_pair(av, ak, bv, bk)
                val = {"==": a2 == b2, "!=": a2 != b2, "<": a2 < b2,
                       "<=": a2 <= b2, ">": a2 > b2, ">=": a2 >= b2}[op]
                return (val, null, "bool")
            if op in _ARITH_OPS:
                if ak not in _NUMERIC or bk not in _NUMERIC:
                    raise CannotCompile(f"arith on {ak}/{bk}")
                a2, b2, k = _coerce_pair(av, ak, bv, bk)
                null = an | bn
                if op == "+":
                    return (a2 + b2, null, k)
                if op == "-":
                    return (a2 - b2, null, k)
                if op == "*":
                    return (a2 * b2, null, k)
                if op == "/":
                    null = null | (b2 == 0)
                    safe = xp.where(b2 == 0, xp.ones((), b2.dtype), b2)
                    if k == "int":
                        # host semantics: truncation toward zero
                        q = xp.abs(a2) // xp.abs(safe)
                        sign = xp.where((a2 >= 0) == (safe >= 0), 1, -1)
                        return (q * sign, null, "int")
                    return (a2 / safe, null, "float")
                # %
                null = null | (b2 == 0)
                safe = xp.where(b2 == 0, xp.ones((), b2.dtype), b2)
                if k == "int":
                    # host v_mod: sign follows the dividend (C fmod style)
                    r = xp.abs(a2) % xp.abs(safe)
                    return (xp.where(a2 >= 0, r, -r), null, "int")
                return (xp.where(xp.signbit(a2),
                                 -(xp.abs(a2) % xp.abs(safe)),
                                 xp.abs(a2) % xp.abs(safe)), null, "float")
            if op in _BIT_OPS:
                if ak != "int" or bk != "int":
                    raise CannotCompile(f"bitwise on {ak}/{bk}")
                null = an | bn
                val = {"&": av & bv, "|": av | bv, "^": av ^ bv}[op]
                return (val, null, "int")
            raise CannotCompile(f"binary {op}")
        return g

    def _in_list(fa, items: List[Any], pool: StringPool,
                 negate: bool) -> Callable[[Dict[str, Any]], Term]:
        def g(c):
            av, an, ak = fa(c)
            any_true = xp.zeros(xp.shape(av), bool)
            any_null = xp.zeros(xp.shape(av), bool)
            for it in items:
                if it is None or isinstance(it, NullValue):
                    any_null = xp.ones(xp.shape(av), bool)
                    continue
                # type-mismatched items yield NULL on the host (not
                # False), so anything not exactly comparable falls back
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
                    any_true = any_true | (xp.astype(av, xp.float64) == it)
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

    return _lit, _unary, _coerce_pair, _binary, _in_list


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
