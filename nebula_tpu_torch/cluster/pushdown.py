"""The port's copy of `nebula_tpu/cluster/pushdown.py`, whole.

Storage-side execution of pushed-down edge predicates and limits.

The reference compiles each GetNeighbors request into a storage-side
exec DAG (StoragePlan: ScanNode → FilterNode → LimitNode;
reference: src/storage/exec) so filtering happens WHERE THE DATA IS
and the RPC ships only
surviving rows.  Same essence here: graphd decides a predicate is
storage-evaluable (`pushable`), ships it as nGQL text (the wire-safe
canonical form — never pickled code), and storaged parses it once per
request and evaluates per edge row before serialization.

Pushable = references nothing beyond the edge being scanned: its props
(via `etype.prop` or the planner's `__edge__` alias), rank/src/dst/
type/typeid of `edge`, literals, and pure functions.  $$ / $^ vertex
props, input rows, variables, and nondeterministic functions stay on
graphd.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ..core import expr as E
from ..core.expr import to_bool3, to_text
from ..core.value import NullValue, make_edge

# nondeterministic or environment-reading functions must evaluate once,
# on graphd — per-row storage evaluation would change semantics
_NONPUSHABLE_FNS = {"rand", "rand32", "rand64", "now", "timestamp",
                    "date", "time", "datetime"}

_EDGE_FNS = {"rank", "src", "dst", "type", "typeid", "id"}


class NotPushable(Exception):
    pass


def pushable(e: E.Expr, etypes: Sequence[str]) -> bool:
    """True iff the predicate can evaluate storage-side against one
    scanned edge row with identical semantics."""
    try:
        _check(e, set(etypes))
        return True
    except NotPushable:
        return False


def _check(e: E.Expr, etypes: set):
    k = e.kind
    if k == "literal":
        v = e.value
        if v is None or isinstance(v, (bool, int, float, str, NullValue)):
            return
        raise NotPushable(f"literal {type(v)}")
    if k == "edge_prop":
        if e.edge != "__edge__" and e.edge not in etypes:
            raise NotPushable(f"prop of non-scanned edge {e.edge}")
        return
    if k == "attribute" and isinstance(e.obj, E.LabelExpr):
        if e.obj.name != "__edge__" and e.obj.name not in etypes:
            raise NotPushable(f"attribute of {e.obj.name}")
        return
    if k == "edge":
        return
    if k == "unary":
        _check(e.operand, etypes)
        return
    if k == "binary":
        _check(e.lhs, etypes)
        _check(e.rhs, etypes)
        return
    if k in ("list", "set"):
        for item in e.items:
            _check(item, etypes)
        return
    if k == "case":
        if e.condition is not None:
            _check(e.condition, etypes)
        for w, t in e.whens:
            _check(w, etypes)
            _check(t, etypes)
        if e.default is not None:
            _check(e.default, etypes)
        return
    if k == "function":
        name = e.name.lower()
        if name in _NONPUSHABLE_FNS:
            raise NotPushable(f"function {name}")
        if name in _EDGE_FNS and len(e.args) == 1 \
                and e.args[0].kind == "edge":
            return
        for a in e.args:
            _check(a, etypes)
        return
    raise NotPushable(f"expr kind {k}")


def filter_to_wire(e: Optional[E.Expr]) -> Optional[str]:
    return None if e is None else to_text(e)


_parse_cache: Dict[str, E.Expr] = {}


def filter_from_wire(text: Optional[str]) -> Optional[E.Expr]:
    if not text:
        return None
    e = _parse_cache.get(text)
    if e is None:
        from ..query.parser import parse_expression
        e = parse_expression(text)
        if len(_parse_cache) > 512:     # traversals re-ship one filter
            _parse_cache.clear()        # per request; bound the cache
        _parse_cache[text] = e
    return e


def apply_edge_filter(rows: Iterable[Tuple], space: str,
                      edge_filter: Optional[E.Expr],
                      etype_ids: Dict[str, int],
                      limit_per_src: Optional[int] = None,
                      stats_prefix: Optional[str] = None):
    """Run the pushed-down (filter, per-src limit) over get_neighbors
    rows — the FilterNode/LimitNode stage, shared by storaged (cluster)
    and GraphStore (standalone parity)."""
    from ..exec.context import RowContext
    if stats_prefix is not None:
        from ..utils.stats import stats as _stats
        reg = _stats()
    else:
        reg = None
    taken: Dict[Any, int] = {}
    for row in rows:
        (src, et, rank, other, props, sd) = row
        if reg is not None:
            reg.inc(stats_prefix + "_scanned")
        if limit_per_src is not None:
            key = repr(src)
            if taken.get(key, 0) >= limit_per_src:
                continue
        if edge_filter is not None:
            e = make_edge(src, other, et, rank, props, sd, etype_ids[et])
            # the wire round-trip (to_text → parse) renders EdgeProp as
            # `etype.prop`, which re-parses as attribute-of-label — bind
            # the edge under its type name (and the planner's __edge__
            # alias) so both spellings resolve
            rc = RowContext(None, space,
                            {"_src": src, "_edge": e, "_dst": other},
                            extra_vars={et: e, "__edge__": e})
            if to_bool3(edge_filter.eval(rc)) is not True:
                continue
        if limit_per_src is not None:
            taken[key] = taken.get(key, 0) + 1
        if reg is not None:
            reg.inc(stats_prefix + "_shipped")
        yield row
