"""Expression AST + reference interpreter.

A copy of `nebula_tpu/core/expr.py`: a redesign of NebulaGraph's
visitor-based expression engine (src/common/expression/*.h) as a compact
Python AST.  ~30 node kinds covering arithmetic, logical,
relational (incl. IN/CONTAINS/STARTS WITH/ENDS WITH/=~), property access
($^.tag.p, $$.tag.p, $-.p, $var.p, edge.p, v.tag.p), subscript/slice, CASE,
list comprehension / predicate (all/any/single/none) / reduce, function and
aggregate calls, type casting and path-build.

Evaluation goes through an :class:`ExprContext`, the analog of
NebulaGraph's ``ExpressionContext``.  This interpreter is the
row-at-a-time *oracle*; the device plane lowers WHERE predicates to a
program over columns (gpu/exprjit.py).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .value import (EMPTY, NULL, NULL_BAD_TYPE, NULL_UNKNOWN_PROP, DataSet,
                    Edge, EmptyValue, NullValue, Path, Vertex, is_empty,
                    is_null, logical_and, logical_not, logical_or, logical_xor,
                    to_bool3, type_name, v_add, v_div, v_eq, v_ge, v_gt, v_le,
                    v_lt, v_mod, v_mul, v_ne, v_neg, v_sub)


class ExprContext:
    """Evaluation context: where property/variable references resolve."""

    def get_input_prop(self, name: str) -> Any:        # $-.name
        return NULL_UNKNOWN_PROP

    def get_var(self, name: str) -> Any:               # $var
        return NULL_UNKNOWN_PROP

    def get_var_prop(self, var: str, name: str) -> Any:  # $var.name
        return NULL_UNKNOWN_PROP

    def get_src_prop(self, tag: str, name: str) -> Any:  # $^.tag.name
        return NULL_UNKNOWN_PROP

    def get_dst_prop(self, tag: str, name: str) -> Any:  # $$.tag.name
        return NULL_UNKNOWN_PROP

    def get_edge_prop(self, edge: str, name: str) -> Any:  # edgename.name / edge-reserved
        return NULL_UNKNOWN_PROP

    def get_vertex(self, which: str = "") -> Any:      # $^ / $$ / vertex
        return NULL_BAD_TYPE

    def get_edge(self) -> Any:                          # edge  (current edge)
        return NULL_BAD_TYPE

    def get_column(self, index: int) -> Any:            # COLUMN[i]
        return NULL_BAD_TYPE


class DictContext(ExprContext):
    """Context backed by plain dicts — used by tests and MATCH row eval."""

    def __init__(self, input_props: Optional[Dict[str, Any]] = None,
                 variables: Optional[Dict[str, Any]] = None,
                 src_props: Optional[Dict[str, Dict[str, Any]]] = None,
                 dst_props: Optional[Dict[str, Dict[str, Any]]] = None,
                 edge_props: Optional[Dict[str, Any]] = None,
                 vertex: Any = None, dst_vertex: Any = None, edge: Any = None):
        self.input_props = input_props or {}
        self.variables = variables or {}
        self.src_props = src_props or {}
        self.dst_props = dst_props or {}
        self.edge_props = edge_props or {}
        self.vertex = vertex
        self.dst_vertex = dst_vertex
        self.edge = edge

    def get_input_prop(self, name):
        return self.input_props.get(name, NULL_UNKNOWN_PROP)

    def get_var(self, name):
        if name in self.variables:
            return self.variables[name]
        return self.input_props.get(name, NULL_UNKNOWN_PROP)

    def get_var_prop(self, var, name):
        v = self.variables.get(var, NULL_UNKNOWN_PROP)
        if isinstance(v, dict):
            return v.get(name, NULL_UNKNOWN_PROP)
        return NULL_UNKNOWN_PROP

    def get_src_prop(self, tag, name):
        return self.src_props.get(tag, {}).get(name, NULL_UNKNOWN_PROP)

    def get_dst_prop(self, tag, name):
        return self.dst_props.get(tag, {}).get(name, NULL_UNKNOWN_PROP)

    def get_edge_prop(self, edge, name):
        return self.edge_props.get(name, NULL_UNKNOWN_PROP)

    def get_vertex(self, which=""):
        if which == "$$" and self.dst_vertex is not None:
            return self.dst_vertex
        return self.vertex if self.vertex is not None else NULL_BAD_TYPE

    def get_edge(self):
        return self.edge if self.edge is not None else NULL_BAD_TYPE


# --------------------------------------------------------------------------
# AST nodes
# --------------------------------------------------------------------------


class Expr:
    __slots__ = ()
    kind = "expr"

    def eval(self, ctx: ExprContext) -> Any:
        raise NotImplementedError

    def children(self) -> Sequence["Expr"]:
        return ()

    def __repr__(self):
        return to_text(self)

    def __eq__(self, other):
        return isinstance(other, Expr) and to_text(self) == to_text(other)

    def __hash__(self):
        return hash(to_text(self))


class Literal(Expr):
    __slots__ = ("value",)
    kind = "literal"

    def __init__(self, value: Any):
        self.value = value

    def eval(self, ctx):
        return self.value


class ListExpr(Expr):
    __slots__ = ("items",)
    kind = "list"

    def __init__(self, items: List[Expr]):
        self.items = items

    def eval(self, ctx):
        return [e.eval(ctx) for e in self.items]

    def children(self):
        return self.items


class SetExpr(Expr):
    __slots__ = ("items",)
    kind = "set"

    def __init__(self, items: List[Expr]):
        self.items = items

    def eval(self, ctx):
        out = set()
        for e in self.items:
            v = e.eval(ctx)
            try:
                out.add(v)
            except TypeError:
                return NULL_BAD_TYPE
        return out

    def children(self):
        return self.items


class MapExpr(Expr):
    __slots__ = ("items",)
    kind = "map"

    def __init__(self, items: List[Tuple[str, Expr]]):
        self.items = items

    def eval(self, ctx):
        return {k: e.eval(ctx) for k, e in self.items}

    def children(self):
        return [e for _, e in self.items]


class InputProp(Expr):
    __slots__ = ("name",)
    kind = "input_prop"

    def __init__(self, name: str):
        self.name = name

    def eval(self, ctx):
        return ctx.get_input_prop(self.name)


class VarExpr(Expr):
    __slots__ = ("name",)
    kind = "var"

    def __init__(self, name: str):
        self.name = name

    def eval(self, ctx):
        return ctx.get_var(self.name)


class VarProp(Expr):
    __slots__ = ("var", "name")
    kind = "var_prop"

    def __init__(self, var: str, name: str):
        self.var, self.name = var, name

    def eval(self, ctx):
        return ctx.get_var_prop(self.var, self.name)


class SrcProp(Expr):
    __slots__ = ("tag", "name")
    kind = "src_prop"

    def __init__(self, tag: str, name: str):
        self.tag, self.name = tag, name

    def eval(self, ctx):
        return ctx.get_src_prop(self.tag, self.name)


class DstProp(Expr):
    __slots__ = ("tag", "name")
    kind = "dst_prop"

    def __init__(self, tag: str, name: str):
        self.tag, self.name = tag, name

    def eval(self, ctx):
        return ctx.get_dst_prop(self.tag, self.name)


class EdgeProp(Expr):
    __slots__ = ("edge", "name")
    kind = "edge_prop"

    def __init__(self, edge: str, name: str):
        self.edge, self.name = edge, name

    def eval(self, ctx):
        # Reserved props route through the edge object when present.
        if self.name in ("_src", "_dst", "_rank", "_type"):
            e = ctx.get_edge()
            if isinstance(e, Edge):
                return {"_src": e.src, "_dst": e.dst, "_rank": e.ranking,
                        "_type": e.name}[self.name]
        return ctx.get_edge_prop(self.edge, self.name)


class VertexExpr(Expr):
    """``$^`` / ``$$`` / ``vertex`` — the whole vertex value."""
    __slots__ = ("which",)
    kind = "vertex"

    def __init__(self, which: str = ""):
        self.which = which  # "" | "$^" | "$$" | "vertex"

    def eval(self, ctx):
        return ctx.get_vertex(self.which)


class EdgeExpr(Expr):
    __slots__ = ()
    kind = "edge"

    def eval(self, ctx):
        return ctx.get_edge()


class LabelExpr(Expr):
    """A bare identifier — resolved as a variable in MATCH/YIELD contexts."""
    __slots__ = ("name",)
    kind = "label"

    def __init__(self, name: str):
        self.name = name

    def eval(self, ctx):
        return ctx.get_var(self.name)


class AttributeExpr(Expr):
    """``x.y`` where x is an arbitrary expression (map/vertex/edge/date)."""
    __slots__ = ("obj", "attr")
    kind = "attribute"

    def __init__(self, obj: Expr, attr: str):
        self.obj, self.attr = obj, attr

    def eval(self, ctx):
        o = self.obj.eval(ctx)
        return get_attribute(o, self.attr)

    def children(self):
        return (self.obj,)


class LabelTagProp(Expr):
    """``v.tag.prop`` in MATCH — variable, then tag, then prop."""
    __slots__ = ("var", "tag", "prop")
    kind = "label_tag_prop"

    def __init__(self, var: str, tag: str, prop: str):
        self.var, self.tag, self.prop = var, tag, prop

    def eval(self, ctx):
        v = ctx.get_var(self.var)
        if isinstance(v, Vertex):
            return v.prop(self.tag, self.prop)
        if is_null(v):
            # property access on a NULL variable (OPTIONAL MATCH miss)
            # is NULL, not a type error (openCypher)
            return NULL
        return NULL_BAD_TYPE


def get_attribute(o: Any, attr: str) -> Any:
    from .value import Date, DateTime, Time
    if is_null(o) or is_empty(o):
        return NULL if is_null(o) else NULL_UNKNOWN_PROP
    if isinstance(o, dict):
        return o.get(attr, NULL_UNKNOWN_PROP)
    if isinstance(o, Vertex):
        props = o.properties()
        if attr in props:
            return props[attr]
        return NULL_UNKNOWN_PROP
    if isinstance(o, Edge):
        if attr in o.props:
            return o.props[attr]
        return NULL_UNKNOWN_PROP
    if isinstance(o, (Date, DateTime, Time)):
        if attr in ("year", "month", "day", "hour", "minute", "microsec"):
            return getattr(o, attr, NULL_UNKNOWN_PROP)
        if attr == "second":
            return getattr(o, "sec", NULL_UNKNOWN_PROP)
        return NULL_UNKNOWN_PROP
    return NULL_BAD_TYPE


class Unary(Expr):
    __slots__ = ("op", "operand")
    kind = "unary"

    def __init__(self, op: str, operand: Expr):
        self.op, self.operand = op, operand

    def eval(self, ctx):
        if self.op == "IS_NULL":
            return is_null(self.operand.eval(ctx))
        if self.op == "IS_NOT_NULL":
            return not is_null(self.operand.eval(ctx))
        if self.op == "IS_EMPTY":
            return is_empty(self.operand.eval(ctx))
        if self.op == "IS_NOT_EMPTY":
            return not is_empty(self.operand.eval(ctx))
        v = self.operand.eval(ctx)
        if self.op == "-":
            return v_neg(v)
        if self.op == "+":
            if is_null(v) or isinstance(v, (int, float)):
                return v
            return NULL_BAD_TYPE
        if self.op == "NOT":
            return logical_not(v)
        if self.op == "++":  # increment (rare)
            return v_add(v, 1)
        if self.op == "--":
            return v_sub(v, 1)
        raise ValueError(f"unknown unary op {self.op}")

    def children(self):
        return (self.operand,)


def _bitop(fn):
    def op(a, b):
        if is_null(a) or is_null(b):
            return NULL
        if isinstance(a, bool) or isinstance(b, bool) \
                or not isinstance(a, int) or not isinstance(b, int):
            return NULL_BAD_TYPE
        return fn(a, b)
    return op


_ARITH = {"+": v_add, "-": v_sub, "*": v_mul, "/": v_div, "%": v_mod,
          "&": _bitop(lambda a, b: a & b),
          "|": _bitop(lambda a, b: a | b),
          "^": _bitop(lambda a, b: a ^ b)}
_REL = {"==": v_eq, "!=": v_ne, "<": v_lt, "<=": v_le, ">": v_gt, ">=": v_ge}


class Binary(Expr):
    __slots__ = ("op", "lhs", "rhs")
    kind = "binary"

    def __init__(self, op: str, lhs: Expr, rhs: Expr):
        self.op, self.lhs, self.rhs = op, lhs, rhs

    def eval(self, ctx):
        op = self.op
        if op == "AND":
            # short-circuit: false AND x == false without evaluating x
            a = self.lhs.eval(ctx)
            if to_bool3(a) is False:
                return False
            return logical_and(a, self.rhs.eval(ctx))
        if op == "OR":
            a = self.lhs.eval(ctx)
            if to_bool3(a) is True:
                return True
            return logical_or(a, self.rhs.eval(ctx))
        if op == "XOR":
            return logical_xor(self.lhs.eval(ctx), self.rhs.eval(ctx))
        a = self.lhs.eval(ctx)
        b = self.rhs.eval(ctx)
        if op in _ARITH:
            return _ARITH[op](a, b)
        if op in _REL:
            return _REL[op](a, b)
        if op in ("IN", "NOT IN"):
            r = _in(a, b)
            if op == "NOT IN":
                return logical_not(r)
            return r
        if op in ("CONTAINS", "NOT CONTAINS"):
            r = _str_rel(a, b, lambda x, y: y in x)
            return logical_not(r) if op.startswith("NOT") else r
        if op in ("STARTS WITH", "NOT STARTS WITH"):
            r = _str_rel(a, b, lambda x, y: x.startswith(y))
            return logical_not(r) if op.startswith("NOT") else r
        if op in ("ENDS WITH", "NOT ENDS WITH"):
            r = _str_rel(a, b, lambda x, y: x.endswith(y))
            return logical_not(r) if op.startswith("NOT") else r
        if op == "=~":
            if is_null(a) or is_null(b):
                return NULL
            if not isinstance(a, str) or not isinstance(b, str):
                return NULL_BAD_TYPE
            try:
                return re.fullmatch(b, a) is not None
            except re.error:
                return NULL_BAD_TYPE
        raise ValueError(f"unknown binary op {op}")

    def children(self):
        return (self.lhs, self.rhs)


def _in(a: Any, b: Any) -> Any:
    if is_null(b):
        return NULL
    if isinstance(b, (list, set)):
        saw_null = is_null(a)
        for x in b:
            e = v_eq(a, x)
            if e is True:
                return True
            if is_null(e):
                saw_null = True
        return NULL if saw_null else False
    if isinstance(b, dict):
        if is_null(a):
            return NULL
        return a in b
    return NULL_BAD_TYPE


def _str_rel(a, b, f) -> Any:
    if is_null(a) or is_null(b):
        return NULL
    if not isinstance(a, str) or not isinstance(b, str):
        return NULL_BAD_TYPE
    return f(a, b)


class Subscript(Expr):
    __slots__ = ("obj", "index")
    kind = "subscript"

    def __init__(self, obj: Expr, index: Expr):
        self.obj, self.index = obj, index

    def eval(self, ctx):
        o = self.obj.eval(ctx)
        i = self.index.eval(ctx)
        if is_null(o) or is_null(i):
            return NULL
        if isinstance(o, list):
            if isinstance(i, bool) or not isinstance(i, int):
                return NULL_BAD_TYPE
            if -len(o) <= i < len(o):
                return o[i]
            return NULL_OUT_OF_RANGE_
        if isinstance(o, dict):
            if not isinstance(i, str):
                return NULL_BAD_TYPE
            return o.get(i, NULL_UNKNOWN_PROP)
        if isinstance(o, (Vertex, Edge)):
            if not isinstance(i, str):
                return NULL_BAD_TYPE
            return get_attribute(o, i)
        return NULL_BAD_TYPE

    def children(self):
        return (self.obj, self.index)


from .value import NULL_OUT_OF_RANGE as NULL_OUT_OF_RANGE_  # noqa: E402


class Slice(Expr):
    __slots__ = ("obj", "lo", "hi")
    kind = "slice"

    def __init__(self, obj: Expr, lo: Optional[Expr], hi: Optional[Expr]):
        self.obj, self.lo, self.hi = obj, lo, hi

    def eval(self, ctx):
        o = self.obj.eval(ctx)
        if is_null(o):
            return NULL
        if not isinstance(o, list):
            return NULL_BAD_TYPE
        lo = self.lo.eval(ctx) if self.lo is not None else 0
        hi = self.hi.eval(ctx) if self.hi is not None else len(o)
        if is_null(lo) or is_null(hi):
            return NULL
        if not isinstance(lo, int) or not isinstance(hi, int):
            return NULL_BAD_TYPE
        return o[lo:hi]

    def children(self):
        return tuple(x for x in (self.obj, self.lo, self.hi) if x is not None)


class Case(Expr):
    """Both generic CASE WHEN c THEN v ... and CASE x WHEN m THEN v ..."""
    __slots__ = ("condition", "whens", "default")
    kind = "case"

    def __init__(self, whens: List[Tuple[Expr, Expr]],
                 default: Optional[Expr] = None, condition: Optional[Expr] = None):
        self.condition, self.whens, self.default = condition, whens, default

    def eval(self, ctx):
        if self.condition is not None:
            cv = self.condition.eval(ctx)
            for w, t in self.whens:
                if v_eq(cv, w.eval(ctx)) is True:
                    return t.eval(ctx)
        else:
            for w, t in self.whens:
                if to_bool3(w.eval(ctx)) is True:
                    return t.eval(ctx)
        return self.default.eval(ctx) if self.default is not None else NULL

    def children(self):
        out = []
        if self.condition is not None:
            out.append(self.condition)
        for w, t in self.whens:
            out += [w, t]
        if self.default is not None:
            out.append(self.default)
        return out


class _ScopedCtx(ExprContext):
    """Wraps a parent context adding one local binding (comprehensions)."""

    def __init__(self, parent: ExprContext, bindings: Dict[str, Any]):
        self.parent = parent
        self.bindings = bindings

    def get_var(self, name):
        if name in self.bindings:
            return self.bindings[name]
        return self.parent.get_var(name)

    def get_var_prop(self, var, name):
        if var in self.bindings:
            return get_attribute(self.bindings[var], name)
        return self.parent.get_var_prop(var, name)

    def __getattr__(self, item):
        return getattr(self.parent, item)


class ListComprehension(Expr):
    """[x IN list WHERE pred | mapExpr]"""
    __slots__ = ("var", "collection", "where", "mapping")
    kind = "list_comprehension"

    def __init__(self, var: str, collection: Expr,
                 where: Optional[Expr] = None, mapping: Optional[Expr] = None):
        self.var, self.collection = var, collection
        self.where, self.mapping = where, mapping

    def eval(self, ctx):
        coll = self.collection.eval(ctx)
        if is_null(coll):
            return NULL
        if not isinstance(coll, list):
            return NULL_BAD_TYPE
        out = []
        for x in coll:
            sub = _ScopedCtx(ctx, {self.var: x})
            if self.where is not None and to_bool3(self.where.eval(sub)) is not True:
                continue
            out.append(self.mapping.eval(sub) if self.mapping is not None else x)
        return out

    def children(self):
        return tuple(x for x in (self.collection, self.where, self.mapping) if x is not None)


class PredicateExpr(Expr):
    """all/any/single/none(x IN list WHERE pred) and exists()."""
    __slots__ = ("name", "var", "collection", "where")
    kind = "predicate"

    def __init__(self, name: str, var: str, collection: Expr, where: Expr):
        self.name, self.var = name.lower(), var
        self.collection, self.where = collection, where

    def eval(self, ctx):
        coll = self.collection.eval(ctx)
        if is_null(coll):
            return NULL
        if isinstance(coll, Path):
            coll = coll.nodes()
        if not isinstance(coll, list):
            return NULL_BAD_TYPE
        count, saw_null = 0, False
        for x in coll:
            r = to_bool3(self.where.eval(_ScopedCtx(ctx, {self.var: x})))
            if r is True:
                count += 1
            elif is_null(r):
                saw_null = True
        if self.name == "all":
            if count == len(coll):
                return NULL if saw_null else True
            return NULL if saw_null and count + 1 >= len(coll) else False
        if self.name == "any":
            return True if count > 0 else (NULL if saw_null else False)
        if self.name == "none":
            return False if count > 0 else (NULL if saw_null else True)
        if self.name == "single":
            return count == 1 if not saw_null else NULL
        raise ValueError(self.name)

    def children(self):
        return (self.collection, self.where)


class Reduce(Expr):
    """reduce(acc = init, x IN list | expr)"""
    __slots__ = ("acc", "init", "var", "collection", "mapping")
    kind = "reduce"

    def __init__(self, acc: str, init: Expr, var: str, collection: Expr, mapping: Expr):
        self.acc, self.init, self.var = acc, init, var
        self.collection, self.mapping = collection, mapping

    def eval(self, ctx):
        coll = self.collection.eval(ctx)
        if is_null(coll):
            return NULL
        if not isinstance(coll, list):
            return NULL_BAD_TYPE
        acc = self.init.eval(ctx)
        for x in coll:
            acc = self.mapping.eval(_ScopedCtx(ctx, {self.acc: acc, self.var: x}))
        return acc

    def children(self):
        return (self.init, self.collection, self.mapping)


class FunctionCall(Expr):
    __slots__ = ("name", "args")
    kind = "function"

    def __init__(self, name: str, args: List[Expr]):
        self.name, self.args = name.lower(), args

    def eval(self, ctx):
        from .functions import FUNCTIONS
        fn = FUNCTIONS.get(self.name)
        if fn is None:
            raise ExprEvalError(f"unknown function `{self.name}'")
        return fn(ctx, [a.eval(ctx) for a in self.args])

    def children(self):
        return self.args


AGG_NAMES = ("count", "sum", "avg", "min", "max", "collect", "collect_set",
             "std", "bit_and", "bit_or", "bit_xor")


class AggExpr(Expr):
    """An aggregate call site; evaluated by AggregateExecutor, not row-eval.

    Row-eval returns the inner expression value (used to feed the
    aggregator); `apply` folds a list of values.
    """
    __slots__ = ("func", "arg", "distinct")
    kind = "aggregate"

    def __init__(self, func: str, arg: Optional[Expr], distinct: bool = False):
        self.func, self.arg, self.distinct = func.lower(), arg, distinct

    def eval(self, ctx):
        if self.arg is None:  # COUNT(*)
            return 1
        return self.arg.eval(ctx)

    def children(self):
        return (self.arg,) if self.arg is not None else ()

    def apply(self, values: List[Any]) -> Any:
        from .aggregates import apply_aggregate
        return apply_aggregate(self.func, values, self.distinct, star=self.arg is None)


class TypeCast(Expr):
    __slots__ = ("target", "operand")
    kind = "cast"

    def __init__(self, target: str, operand: Expr):
        self.target, self.operand = target.lower(), operand

    def eval(self, ctx):
        from .functions import cast_value
        return cast_value(self.target, self.operand.eval(ctx))

    def children(self):
        return (self.operand,)


class PathBuild(Expr):
    __slots__ = ("items",)
    kind = "path_build"

    def __init__(self, items: List[Expr]):
        self.items = items

    def eval(self, ctx):
        from .value import Step
        vals = [e.eval(ctx) for e in self.items]
        if not vals or not isinstance(vals[0], Vertex):
            return NULL_BAD_TYPE
        p = Path(vals[0])
        i = 1
        while i < len(vals):
            e = vals[i]
            if not isinstance(e, Edge) or i + 1 >= len(vals):
                return NULL_BAD_TYPE
            v = vals[i + 1]
            if not isinstance(v, Vertex):
                return NULL_BAD_TYPE
            p.steps.append(Step(v, e.name, e.ranking, e.props, e.etype))
            i += 2
        return p

    def children(self):
        return self.items


class PatternPredExpr(Expr):
    """A boolean pattern predicate — `WHERE (a)-[:knows]->()` (NebulaGraph:
    MatchValidator's PatternExpression / RollUpApply planning).  Exists-semantics: true iff at least one
    expansion of the pattern matches with the bound aliases fixed.

    Carries the parsed `ast.PathPattern` opaquely (core stays independent
    of the query AST) plus its canonical source text for to_text/equality.
    The MATCH planner rewrites every occurrence into a deduplicated
    semi-join marker column before execution, so eval() is unreachable in
    a planned query; reaching it means a validator failed to reject a
    pattern predicate outside MATCH/WITH WHERE.
    """
    __slots__ = ("pattern", "text")
    kind = "pattern_pred"

    def __init__(self, pattern: Any, text: str):
        self.pattern, self.text = pattern, text

    def eval(self, ctx):
        raise ExprEvalError(
            "pattern predicate is only supported in a MATCH WHERE clause")


class ExprEvalError(Exception):
    pass


# --------------------------------------------------------------------------
# Traversal / analysis helpers (replaces the reference's visitor zoo)
# --------------------------------------------------------------------------


def walk(e: Expr):
    yield e
    for c in e.children():
        yield from walk(c)


def find_kinds(e: Expr, kinds: Tuple[str, ...]) -> List[Expr]:
    return [x for x in walk(e) if x.kind in kinds]


def has_aggregate(e: Expr) -> bool:
    return any(x.kind == "aggregate" for x in walk(e))


def collect_aggregates(e: Expr) -> List[AggExpr]:
    return [x for x in walk(e) if isinstance(x, AggExpr)]


def split_conjuncts(e: Expr) -> List[Expr]:
    """a AND b AND c → [a, b, c] (for filter pushdown)."""
    if isinstance(e, Binary) and e.op == "AND":
        return split_conjuncts(e.lhs) + split_conjuncts(e.rhs)
    return [e]


def join_conjuncts(parts: List[Expr]) -> Optional[Expr]:
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = Binary("AND", out, p)
    return out


def rewrite(e: Expr, fn) -> Expr:
    """Bottom-up rewrite: fn(node) returns replacement or None to keep."""
    cls = type(e)
    if isinstance(e, Binary):
        e2 = cls(e.op, rewrite(e.lhs, fn), rewrite(e.rhs, fn))
    elif isinstance(e, Unary):
        e2 = cls(e.op, rewrite(e.operand, fn))
    elif isinstance(e, ListExpr):
        e2 = cls([rewrite(x, fn) for x in e.items])
    elif isinstance(e, MapExpr):
        e2 = cls([(k, rewrite(x, fn)) for k, x in e.items])
    elif isinstance(e, FunctionCall):
        e2 = cls(e.name, [rewrite(x, fn) for x in e.args])
    elif isinstance(e, AggExpr):
        e2 = cls(e.func, rewrite(e.arg, fn) if e.arg else None, e.distinct)
    elif isinstance(e, Subscript):
        e2 = cls(rewrite(e.obj, fn), rewrite(e.index, fn))
    elif isinstance(e, AttributeExpr):
        e2 = cls(rewrite(e.obj, fn), e.attr)
    elif isinstance(e, TypeCast):
        e2 = cls(e.target, rewrite(e.operand, fn))
    elif isinstance(e, Case):
        e2 = cls([(rewrite(w, fn), rewrite(t, fn)) for w, t in e.whens],
                 rewrite(e.default, fn) if e.default else None,
                 rewrite(e.condition, fn) if e.condition else None)
    elif isinstance(e, SetExpr):
        e2 = cls([rewrite(x, fn) for x in e.items])
    elif isinstance(e, Slice):
        e2 = cls(rewrite(e.obj, fn),
                 rewrite(e.lo, fn) if e.lo is not None else None,
                 rewrite(e.hi, fn) if e.hi is not None else None)
    elif isinstance(e, ListComprehension):
        e2 = cls(e.var, rewrite(e.collection, fn),
                 rewrite(e.where, fn) if e.where is not None else None,
                 rewrite(e.mapping, fn) if e.mapping is not None else None)
    elif isinstance(e, PredicateExpr):
        e2 = cls(e.name, e.var, rewrite(e.collection, fn),
                 rewrite(e.where, fn))
    elif isinstance(e, Reduce):
        e2 = cls(e.acc, rewrite(e.init, fn), e.var,
                 rewrite(e.collection, fn), rewrite(e.mapping, fn))
    elif isinstance(e, PathBuild):
        e2 = cls([rewrite(x, fn) for x in e.items])
    else:
        e2 = e
    r = fn(e2)
    return r if r is not None else e2


# --------------------------------------------------------------------------
# Pretty printing (EXPLAIN output / golden plan tests)
# --------------------------------------------------------------------------


def to_text(e: Expr) -> str:
    from .value import value_to_string
    k = e.kind
    if k == "literal":
        return value_to_string(e.value)
    if k == "list":
        return "[" + ", ".join(to_text(x) for x in e.items) + "]"
    if k == "set":
        return "{" + ", ".join(to_text(x) for x in e.items) + "}"
    if k == "map":
        return "{" + ", ".join(f"{n}: {to_text(x)}" for n, x in e.items) + "}"
    if k == "input_prop":
        return f"$-.{e.name}"
    if k == "var":
        return f"${e.name}"
    if k == "var_prop":
        return f"${e.var}.{e.name}"
    if k == "src_prop":
        return f"$^.{e.tag}.{e.name}"
    if k == "dst_prop":
        return f"$$.{e.tag}.{e.name}"
    if k == "edge_prop":
        return f"{e.edge}.{e.name}"
    if k == "vertex":
        return e.which or "vertex"
    if k == "edge":
        return "edge"
    if k == "label":
        return e.name
    if k == "label_tag_prop":
        return f"{e.var}.{e.tag}.{e.prop}"
    if k == "attribute":
        return f"{to_text(e.obj)}.{e.attr}"
    if k == "unary":
        if e.op in ("IS_NULL", "IS_NOT_NULL", "IS_EMPTY", "IS_NOT_EMPTY"):
            return f"({to_text(e.operand)} {e.op.replace('_', ' ')})"
        if e.op == "NOT":
            return f"(NOT {to_text(e.operand)})"
        return f"({e.op}{to_text(e.operand)})"
    if k == "binary":
        return f"({to_text(e.lhs)} {e.op} {to_text(e.rhs)})"
    if k == "subscript":
        return f"{to_text(e.obj)}[{to_text(e.index)}]"
    if k == "slice":
        lo = to_text(e.lo) if e.lo else ""
        hi = to_text(e.hi) if e.hi else ""
        return f"{to_text(e.obj)}[{lo}..{hi}]"
    if k == "case":
        parts = ["CASE"]
        if e.condition is not None:
            parts.append(to_text(e.condition))
        for w, t in e.whens:
            parts.append(f"WHEN {to_text(w)} THEN {to_text(t)}")
        if e.default is not None:
            parts.append(f"ELSE {to_text(e.default)}")
        parts.append("END")
        return " ".join(parts)
    if k == "list_comprehension":
        s = f"[{e.var} IN {to_text(e.collection)}"
        if e.where is not None:
            s += f" WHERE {to_text(e.where)}"
        if e.mapping is not None:
            s += f" | {to_text(e.mapping)}"
        return s + "]"
    if k == "predicate":
        return f"{e.name}({e.var} IN {to_text(e.collection)} WHERE {to_text(e.where)})"
    if k == "reduce":
        return (f"reduce({e.acc} = {to_text(e.init)}, {e.var} IN "
                f"{to_text(e.collection)} | {to_text(e.mapping)})")
    if k == "function":
        return f"{e.name}(" + ", ".join(to_text(a) for a in e.args) + ")"
    if k == "aggregate":
        inner = "*" if e.arg is None else to_text(e.arg)
        d = "distinct " if e.distinct else ""
        return f"{e.func}({d}{inner})"
    if k == "cast":
        return f"({e.target}){to_text(e.operand)}"
    if k == "path_build":
        return " <JOIN> ".join(to_text(x) for x in e.items)
    if k == "pattern_pred":
        return e.text
    return f"<{k}>"
