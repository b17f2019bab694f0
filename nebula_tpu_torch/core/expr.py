"""The expression tree a GO statement's WHERE and YIELD are built from.

A copy of the node kinds of `nebula_tpu/core/expr.py` that the device
plane compiles or evaluates columnar-side: literals, lists and sets,
edge properties, `$^`/`$$`/`edge`, labels and attributes, unary and
binary operators and function calls, plus `walk` and `to_text`.  The
row-at-a-time interpreter (`eval`) stays in the reference: the port
evaluates predicates only as masks over columns (gpu/exprjit.py).
"""
from __future__ import annotations

from typing import Any, List, Sequence


class Expr:
    __slots__ = ()
    kind = "expr"

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


class ListExpr(Expr):
    __slots__ = ("items",)
    kind = "list"

    def __init__(self, items: List[Expr]):
        self.items = items

    def children(self):
        return self.items


class SetExpr(Expr):
    __slots__ = ("items",)
    kind = "set"

    def __init__(self, items: List[Expr]):
        self.items = items

    def children(self):
        return self.items


class EdgeProp(Expr):
    __slots__ = ("edge", "name")
    kind = "edge_prop"

    def __init__(self, edge: str, name: str):
        self.edge, self.name = edge, name


class VertexExpr(Expr):
    """``$^`` / ``$$`` / ``vertex`` — the whole vertex value."""
    __slots__ = ("which",)
    kind = "vertex"

    def __init__(self, which: str = ""):
        self.which = which  # "" | "$^" | "$$" | "vertex"


class EdgeExpr(Expr):
    __slots__ = ()
    kind = "edge"


class LabelExpr(Expr):
    """A bare identifier."""
    __slots__ = ("name",)
    kind = "label"

    def __init__(self, name: str):
        self.name = name


class AttributeExpr(Expr):
    """``x.y`` where x is an arbitrary expression."""
    __slots__ = ("obj", "attr")
    kind = "attribute"

    def __init__(self, obj: Expr, attr: str):
        self.obj, self.attr = obj, attr

    def children(self):
        return (self.obj,)


class Unary(Expr):
    __slots__ = ("op", "operand")
    kind = "unary"

    def __init__(self, op: str, operand: Expr):
        self.op, self.operand = op, operand

    def children(self):
        return (self.operand,)


class Binary(Expr):
    __slots__ = ("op", "lhs", "rhs")
    kind = "binary"

    def __init__(self, op: str, lhs: Expr, rhs: Expr):
        self.op, self.lhs, self.rhs = op, lhs, rhs

    def children(self):
        return (self.lhs, self.rhs)


class FunctionCall(Expr):
    __slots__ = ("name", "args")
    kind = "function"

    def __init__(self, name: str, args: List[Expr]):
        self.name, self.args = name.lower(), args

    def children(self):
        return self.args


def walk(e: Expr):
    yield e
    for c in e.children():
        yield from walk(c)


def to_text(e: Expr) -> str:
    from .value import value_to_string
    k = e.kind
    if k == "literal":
        return value_to_string(e.value)
    if k == "list":
        return "[" + ", ".join(to_text(x) for x in e.items) + "]"
    if k == "set":
        return "{" + ", ".join(to_text(x) for x in e.items) + "}"
    if k == "edge_prop":
        return f"{e.edge}.{e.name}"
    if k == "vertex":
        return e.which or "vertex"
    if k == "edge":
        return "edge"
    if k == "label":
        return e.name
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
    if k == "function":
        return f"{e.name}(" + ", ".join(to_text(a) for a in e.args) + ")"
    return f"<{k}>"
