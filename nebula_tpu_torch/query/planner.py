"""The port's copy of `nebula_tpu/query/planner.py`, whole.

Statement → ExecutionPlan: validation + planning.

Folds the reference's validator layer (per-sentence semantic checks +
symbol/type deduction; reference: src/graph/validator) and
planner layer (GoPlanner/MatchPlanner/...; reference: src/graph/planner) into one pass per statement: semantic validation happens
while the plan is built, against the live catalog.

Plan shapes (golden-plan tests pin these):

  GO n STEPS FROM x OVER e WHERE f YIELD c:
      Project ← Filter? ← ExpandAll ← [Dedup ← Project ← ExpandAll]×(n-1) ← Start
  GO m TO n: Union-ALL of the per-step branches sharing the frontier chain.
  MATCH (a)-[e]->(b):
      Project ← Filter? ← AppendVertices ← Traverse×k ← <seed> ← Start
  LOOKUP:  Project ← Filter? ← IndexScan
  FETCH:   Project ← GetVertices | GetEdges
  FIND PATH / GET SUBGRAPH: one algo node.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..core.expr import (AggExpr, AttributeExpr, Binary, Case, DictContext,
                         Expr, FunctionCall, InputProp, LabelExpr,
                         LabelTagProp, Literal, Unary, VarExpr, VarProp,
                         EdgeProp, VertexExpr, EdgeExpr, has_aggregate,
                         join_conjuncts, rewrite, split_conjuncts, to_text,
                         walk)
from ..core.value import NULL
from ..graphstore.schema import SchemaError
from . import ast as A
from .plan import ExecutionPlan, PlanNode


class QueryError(Exception):
    pass


class PlannerContext:
    """Carries catalog access + pipe/variable column bindings."""

    def __init__(self, qctx, space: Optional[str]):
        self.qctx = qctx              # QueryContext (exec/context.py)
        self.space = space
        self.input_node: Optional[PlanNode] = None
        self.input_cols: List[str] = []
        self.var_cols: Dict[str, List[str]] = {}   # $var → col names
        self.var_nodes: Dict[str, PlanNode] = {}

    @property
    def catalog(self):
        return self.qctx.catalog

    def need_space(self) -> str:
        if not self.space:
            raise QueryError("no space selected (USE <space> first)")
        return self.space


def plan_statement(qctx, stmt: A.Sentence, space: Optional[str]) -> ExecutionPlan:
    pctx = PlannerContext(qctx, space)
    root = _plan(pctx, stmt)
    return ExecutionPlan(root, pctx.space)


# ---------------------------------------------------------------------------


def _plan(pctx: PlannerContext, stmt: A.Sentence) -> PlanNode:
    h = _DISPATCH.get(type(stmt))
    if h is None:
        raise QueryError(f"unsupported statement {type(stmt).__name__}")
    return h(pctx, stmt)


def _start(pctx) -> PlanNode:
    return PlanNode("Start")


def _col_name(col: A.YieldColumn) -> str:
    return col.alias if col.alias else to_text(col.expr)


# ---- composition ----------------------------------------------------------


def _plan_seq(pctx, s: A.SeqSentence) -> PlanNode:
    nodes = [_plan(pctx, x) for x in s.stmts]
    # sequence: each depends on the previous for ordering; result = last
    for i in range(1, len(nodes)):
        seq = PlanNode("Sequence", deps=[nodes[i - 1], nodes[i]],
                       col_names=nodes[i].col_names)
        nodes[i] = seq
    return nodes[-1]


def _plan_pipe(pctx, s: A.PipedSentence) -> PlanNode:
    left = _plan(pctx, s.left)
    saved_node, saved_cols = pctx.input_node, pctx.input_cols
    pctx.input_node, pctx.input_cols = left, list(left.col_names)
    right = _plan(pctx, s.right)
    pctx.input_node, pctx.input_cols = saved_node, saved_cols
    return right


def _plan_assign(pctx, s: A.AssignSentence) -> PlanNode:
    node = _plan(pctx, s.stmt)
    pctx.var_cols[s.var] = list(node.col_names)
    pctx.var_nodes[s.var] = node
    # register in qctx for cross-statement $var reads inside one submit
    alias = PlanNode("SetVariable", deps=[node], col_names=node.col_names,
                     args={"var": s.var, "source": node.output_var})
    return alias


def _plan_setop(pctx, s: A.SetOpSentence) -> PlanNode:
    left = _plan(pctx, s.left)
    saved_node, saved_cols = pctx.input_node, pctx.input_cols
    right = _plan(pctx, s.right)
    pctx.input_node, pctx.input_cols = saved_node, saved_cols
    if len(left.col_names) != len(right.col_names):
        raise QueryError("set operation branches have different column counts")
    kind = {"UNION": "Union", "UNION ALL": "Union", "INTERSECT": "Intersect",
            "MINUS": "Minus"}[s.op]
    node = PlanNode(kind, deps=[left, right], col_names=list(left.col_names),
                    args={"distinct": s.op == "UNION"})
    return node


def _plan_explain(pctx, s: A.ExplainSentence) -> PlanNode:
    inner = _plan(pctx, s.stmt)
    return PlanNode("Explain", deps=[inner], col_names=["plan"],
                    args={"profile": s.profile, "fmt": s.fmt})


# ---- expression rewriting -------------------------------------------------


def _rewrite_go_expr(pctx, e: Expr, edge_names: List[str]) -> Expr:
    """knows.since → EdgeProp; validate prop refs against schemas."""
    space = pctx.need_space()
    cat = pctx.catalog

    def fn(x: Expr):
        if isinstance(x, AttributeExpr) and isinstance(x.obj, LabelExpr):
            name = x.obj.name
            if name in edge_names:
                _check_edge_prop(cat, space, name, x.attr)
                return EdgeProp(name, x.attr)
        return None

    e = rewrite(e, fn)
    for x in walk(e):
        if isinstance(x, (type(e),)):
            pass
        if x.kind == "src_prop" or x.kind == "dst_prop":
            _check_tag_prop(cat, space, x.tag, x.name)
        if x.kind == "edge_prop":
            if x.edge not in edge_names and x.edge != "*":
                _check_edge_prop(cat, space, x.edge, x.name)
        if x.kind == "input_prop" and pctx.input_cols and x.name not in pctx.input_cols:
            raise QueryError(f"unknown input column `$-.{x.name}'"
                             f" (have {pctx.input_cols})")
        if x.kind == "var_prop":
            cols = pctx.var_cols.get(x.var)
            if cols is not None and x.name not in cols:
                raise QueryError(f"unknown column `${x.var}.{x.name}'")
    return e


def _check_edge_prop(cat, space, edge, prop):
    if prop in ("_src", "_dst", "_rank", "_type"):
        return
    try:
        es = cat.get_edge(space, edge)
    except SchemaError as ex:
        raise QueryError(str(ex)) from None
    if es.latest.prop(prop) is None:
        raise QueryError(f"edge `{edge}' has no property `{prop}'")


def _check_tag_prop(cat, space, tag, prop):
    try:
        ts = cat.get_tag(space, tag)
    except SchemaError as ex:
        raise QueryError(str(ex)) from None
    if ts.latest.prop(prop) is None:
        raise QueryError(f"tag `{tag}' has no property `{prop}'")


def _rewrite_match_expr(e: Expr, aliases: Dict[str, str]) -> Expr:
    """v.tag.prop → LabelTagProp for known aliases."""
    def fn(x: Expr):
        if (isinstance(x, AttributeExpr) and isinstance(x.obj, AttributeExpr)
                and isinstance(x.obj.obj, LabelExpr)
                and x.obj.obj.name in aliases):
            return LabelTagProp(x.obj.obj.name, x.obj.attr, x.attr)
        return None
    return rewrite(e, fn)


# ---- GO -------------------------------------------------------------------


def _resolve_from(pctx, fc: A.FromClause) -> Tuple[Any, Optional[str]]:
    """Returns (vid_exprs|None, input_ref_col|None)."""
    if fc.ref is not None:
        if isinstance(fc.ref, InputProp):
            if pctx.input_cols and fc.ref.name not in pctx.input_cols:
                raise QueryError(f"unknown input column `$-.{fc.ref.name}'")
            return None, fc.ref.name
        if isinstance(fc.ref, VarProp):
            cols = pctx.var_cols.get(fc.ref.var)
            if cols is not None and fc.ref.name not in cols:
                raise QueryError(f"unknown column `${fc.ref.var}.{fc.ref.name}'")
            return None, f"${fc.ref.var}.{fc.ref.name}"
        raise QueryError("FROM clause reference must be $-.col or $var.col")
    return fc.vids, None


_GO_DEFAULT_YIELD = None  # built lazily


def _go_default_yield() -> A.YieldClause:
    return A.YieldClause([A.YieldColumn(
        FunctionCall("dst", [EdgeExpr()]), "dst")])


def _plan_go(pctx, s: A.GoSentence) -> PlanNode:
    space = pctx.need_space()
    cat = pctx.catalog
    edges = s.over.edges
    if s.over.is_all:
        edges = sorted(e.name for e in cat.edges(space))
    else:
        for e in edges:
            try:
                cat.get_edge(space, e)
            except SchemaError as ex:
                raise QueryError(str(ex)) from None

    yld = s.yield_ or _go_default_yield()
    where_expr = None
    if s.where:
        where_expr = _rewrite_go_expr(pctx, s.where.filter, edges)
    ycols = [A.YieldColumn(_rewrite_go_expr(pctx, c.expr, edges), c.alias)
             for c in yld.columns]
    col_names = [_col_name(c) for c in ycols]

    vids, ref_col = _resolve_from(pctx, s.from_)
    uses_input = ref_col is not None or any(
        x.kind == "input_prop" for c in ycols for x in walk(c.expr)) or (
        where_expr is not None and any(x.kind == "input_prop" for x in walk(where_expr)))

    if ref_col is not None and ref_col.startswith("$"):
        var = ref_col[1:].split(".")[0]
        src_node = _var_input_node(pctx, var)
        input_cols = pctx.var_cols.get(var, [])
        src_col = ref_col.split(".")[1]
    elif ref_col is not None:
        src_node = pctx.input_node
        input_cols = pctx.input_cols
        src_col = ref_col
    else:
        src_node = None
        input_cols = []
        src_col = None

    start: PlanNode
    if src_node is not None:
        start = src_node
    else:
        start = PlanNode("Start", col_names=["_vid"],
                         args={"vids": vids})

    m, n = s.steps.m, s.steps.n
    if n < m or n < 0 or m < 0:
        raise QueryError(f"invalid step range {m} TO {n}")
    go_pairs = [(c.expr, nm) for c, nm in zip(ycols, col_names)]
    go_agg = _implicit_agg_split(go_pairs)
    if n == 0:
        out = PlanNode("Project", deps=[start], col_names=col_names,
                       args={"columns": [], "empty": True})
        if go_agg is not None:
            # aggregate-over-empty yields its fold identity (count → 0),
            # same as a source vertex with no edges
            out = _plan_aggregate(out, go_agg[1], None)
        return out

    carry = list(input_cols) if uses_input and src_node is not None else []

    def expand(dep: PlanNode, step_src_col: Optional[str], first: bool) -> PlanNode:
        return PlanNode("ExpandAll", deps=[dep], args={
            "space": space, "edge_types": list(edges),
            "direction": s.over.direction,
            "src_col": step_src_col,          # None → use literal vids
            "vids": vids if first and src_node is None else None,
            "edge_filter": None, "limit": None,
            "sample": None, "carry": list(carry),
        }, col_names=(carry + ["_src", "_edge", "_dst"]))

    # frontier chain: F1 = expand(start); Fk = expand(dedup(project_dst(Fk-1)))
    branches: List[PlanNode] = []
    cur = start
    cur_src_col = src_col
    for step in range(1, n + 1):
        first = step == 1
        exp = expand(cur, cur_src_col, first)
        if m <= step:
            branch = exp
            if where_expr is not None:
                branch = PlanNode("Filter", deps=[branch],
                                  col_names=list(branch.col_names),
                                  args={"condition": where_expr})
            proj = PlanNode("Project", deps=[branch], col_names=col_names,
                            args={"columns": (go_agg[0] if go_agg
                                              else go_pairs),
                                  "go_row": True})
            branches.append(proj)
        if step < n:
            if carry:
                # keep full rows: next step expands from _dst, carrying cols
                nxt_cols = carry + ["_dst"]
                nxt = PlanNode("Project", deps=[exp], col_names=nxt_cols,
                               args={"columns":
                                     [(InputProp(c), c) for c in carry]
                                     + [(InputProp("_dst"), "_dst")],
                                     "go_row": False})
                cur, cur_src_col = nxt, "_dst"
            else:
                nxt = PlanNode("Project", deps=[exp], col_names=["_vid"],
                               args={"columns": [(InputProp("_dst"), "_vid")],
                                     "go_row": False})
                ddp = PlanNode("Dedup", deps=[nxt], col_names=["_vid"])
                cur, cur_src_col = ddp, "_vid"

    out = branches[0]
    for b in branches[1:]:
        out = PlanNode("Union", deps=[out, b], col_names=col_names,
                       args={"distinct": False})
    if go_agg is not None:
        # implicit aggregation folds over ALL steps' rows (after the
        # m-to-n union), grouped by the non-aggregate yield columns
        out = _plan_aggregate(out, go_agg[1], None)
    if yld.distinct:
        out = PlanNode("Dedup", deps=[out], col_names=col_names)
    if s.truncate is not None:
        counts = s.truncate.counts
        out = PlanNode("Sample" if s.truncate.is_sample else "Limit",
                       deps=[out], col_names=col_names,
                       args={"count": counts[-1] if counts else 0, "offset": 0})
    return out


# ---- YIELD / pipe segments ------------------------------------------------


def _var_input_node(pctx, var: str) -> PlanNode:
    """A node that reads a $var result saved earlier in the session."""
    node = pctx.var_nodes.get(var)
    if node is not None:
        return node
    cols = pctx.var_cols.get(var, [])
    n = PlanNode("VarInput", col_names=list(cols), args={"var": var})
    n.output_var = f"${var}"
    return n


def _plan_yield(pctx, s: A.YieldSentence) -> PlanNode:
    dep = pctx.input_node or PlanNode("Start", col_names=[])
    cols = s.yield_.columns
    # $var.col references: bind the variable's dataset as the input
    var_refs = {x.var for c in cols for x in walk(c.expr) if x.kind == "var_prop"}
    if s.where is not None:
        var_refs |= {x.var for x in walk(s.where.filter) if x.kind == "var_prop"}
    where_filter = s.where.filter if s.where is not None else None
    from_var = bool(var_refs)
    if from_var:
        # bind the $var's dataset as the input and read cols via $-.
        if len(var_refs) > 1:
            raise QueryError("YIELD over multiple $variables is unsupported")
        var = var_refs.pop()
        dep = _var_input_node(pctx, var)

        def _v2i(x):
            if isinstance(x, VarProp) and x.var == var:
                return InputProp(x.name)
            return None
        cols = [A.YieldColumn(rewrite(c.expr, _v2i),
                              c.alias or to_text(c.expr)) for c in cols]
        if where_filter is not None:
            where_filter = rewrite(where_filter, _v2i)
    exprs = []
    for c in cols:
        e = c.expr
        for x in walk(e):
            if x.kind == "input_prop" and pctx.input_cols and not from_var \
                    and x.name not in pctx.input_cols:
                raise QueryError(f"unknown input column `$-.{x.name}'")
        exprs.append(e)
    names = [_col_name(c) for c in cols]
    out = dep
    if where_filter is not None:
        out = PlanNode("Filter", deps=[out], col_names=list(out.col_names),
                       args={"condition": where_filter})
    if any(has_aggregate(e) for e in exprs):
        out = _plan_aggregate(out, list(zip(exprs, names)), group_keys=None)
    else:
        out = PlanNode("Project", deps=[out], col_names=names,
                       args={"columns": list(zip(exprs, names))})
    if s.yield_.distinct:
        out = PlanNode("Dedup", deps=[out], col_names=names)
    return out


def _implicit_agg_split(pairs: List[Tuple[Expr, str]]):
    """Implicit aggregation in GO/LOOKUP/FETCH YIELD (reference:
    GoValidator/LookupValidator semantics — `GO ... YIELD count(*)`
    folds over ALL result rows, grouped by the non-aggregate columns).

    Returns None when no column aggregates; otherwise (inner, outer):
    the per-row projection (each aggregate column replaced by its
    argument — the fold's feed) and the Aggregate columns that fold the
    projected values.  An aggregate nested inside a larger expression
    is refused (same restriction as the reference)."""
    if not any(has_aggregate(e) for e, _ in pairs):
        return None
    inner, outer = [], []
    for e, nm in pairs:
        if isinstance(e, AggExpr):
            if e.arg is not None and has_aggregate(e.arg):
                raise QueryError(
                    "aggregate functions can not be nested")
            inner.append((e.arg if e.arg is not None else Literal(1), nm))
            outer.append((AggExpr(e.func, InputProp(nm), e.distinct), nm))
        elif has_aggregate(e):
            raise QueryError(
                "an aggregate function must be the entire YIELD column")
        else:
            inner.append((e, nm))
            outer.append((InputProp(nm), nm))
    return inner, outer


def _plan_aggregate(dep: PlanNode, cols: List[Tuple[Expr, str]],
                    group_keys: Optional[List[Expr]]) -> PlanNode:
    keys = group_keys
    if keys is None:
        keys = [e for e, _ in cols if not has_aggregate(e)]
    return PlanNode("Aggregate", deps=[dep],
                    col_names=[n for _, n in cols],
                    args={"group_keys": keys, "columns": cols})


def _plan_group_by(pctx, s: A.GroupBySentence) -> PlanNode:
    dep = pctx.input_node
    if dep is None:
        raise QueryError("GROUP BY requires piped input")
    cols = [(c.expr, _col_name(c)) for c in s.yield_.columns]
    _check_input_cols(list(s.keys) + [e for e, _ in cols], dep,
                      "GROUP BY")
    return _plan_aggregate(dep, cols, s.keys)


def _check_input_cols(exprs, dep, what: str):
    """Every `$-.name` reference must name a column of the pipe input —
    a typo'd column otherwise sorts/groups on NULL silently (reference
    raises SemanticError at validation)."""
    from ..core.expr import walk as _walk
    cols = set(dep.col_names)
    for e in exprs:
        for x in _walk(e):
            if x.kind == "input_prop" and x.name not in cols:
                raise QueryError(
                    f"`$-.{x.name}' not found in {what} input "
                    f"(columns: {sorted(cols)})")


def _plan_order_by(pctx, s: A.OrderBySentence) -> PlanNode:
    dep = pctx.input_node
    if dep is None:
        raise QueryError("ORDER BY requires piped input")
    _check_input_cols([f.expr for f in s.factors], dep, "ORDER BY")
    return PlanNode("Sort", deps=[dep], col_names=list(dep.col_names),
                    args={"factors": [(f.expr, f.ascending) for f in s.factors]})


def _plan_limit(pctx, s: A.LimitSentence) -> PlanNode:
    dep = pctx.input_node
    if dep is None:
        raise QueryError("LIMIT requires piped input")
    return PlanNode("Limit", deps=[dep], col_names=list(dep.col_names),
                    args={"offset": s.offset, "count": s.count})


def _plan_sample(pctx, s: A.SampleSentence) -> PlanNode:
    dep = pctx.input_node
    if dep is None:
        raise QueryError("SAMPLE requires piped input")
    return PlanNode("Sample", deps=[dep], col_names=list(dep.col_names),
                    args={"count": s.count})


# ---- FETCH / LOOKUP -------------------------------------------------------


def _plan_fetch_vertices(pctx, s: A.FetchVerticesSentence) -> PlanNode:
    space = pctx.need_space()
    cat = pctx.catalog
    tags = s.tags
    for t in tags:
        try:
            cat.get_tag(space, t)
        except SchemaError as ex:
            raise QueryError(str(ex)) from None
    vids, ref_col = _resolve_from(pctx, s.vids)
    dep = pctx.input_node if ref_col else PlanNode("Start")
    gv = PlanNode("GetVertices", deps=[dep] if dep else [],
                  col_names=["vertices_"],
                  args={"space": space, "tags": tags, "vids": vids,
                        "src_col": ref_col})
    yld = s.yield_
    if yld is None:
        yld = A.YieldClause([A.YieldColumn(VertexExpr("vertex"), "vertices_")])
    # `Person.name` in a FETCH yield is a tag-prop access on the fetched
    # vertex (reference: TagPropertyExpression), not a variable lookup
    tag_names = {t.name for t in cat.tags(space)}

    def _tagprop(x: Expr):
        if (isinstance(x, AttributeExpr) and isinstance(x.obj, LabelExpr)
                and x.obj.name in tag_names):
            return LabelTagProp("vertices_", x.obj.name, x.attr)
        return None

    ycols = [(rewrite(c.expr, _tagprop), _col_name(c)) for c in yld.columns]
    names = [n for _, n in ycols]
    agg_split = _implicit_agg_split(ycols)
    out = PlanNode("Project", deps=[gv], col_names=names,
                   args={"columns": agg_split[0] if agg_split else ycols,
                         "fetch_row": True})
    if agg_split is not None:
        out = _plan_aggregate(out, agg_split[1], None)
    if yld.distinct:
        out = PlanNode("Dedup", deps=[out], col_names=names)
    return out


def _plan_fetch_edges(pctx, s: A.FetchEdgesSentence) -> PlanNode:
    space = pctx.need_space()
    try:
        pctx.catalog.get_edge(space, s.etype)
    except SchemaError as ex:
        raise QueryError(str(ex)) from None
    keys = [(_const_eval(k.src), _const_eval(k.dst), k.rank) for k in s.keys]
    ge = PlanNode("GetEdges", deps=[], col_names=["edges_"],
                  args={"space": space, "etype": s.etype, "keys": keys})
    yld = s.yield_
    if yld is None:
        yld = A.YieldClause([A.YieldColumn(EdgeExpr(), "edges_")])
    ycols = [(_rewrite_go_expr(pctx, c.expr, [s.etype]), _col_name(c))
             for c in yld.columns]
    names = [n for _, n in ycols]
    agg_split = _implicit_agg_split(ycols)
    out = PlanNode("Project", deps=[ge], col_names=names,
                   args={"columns": agg_split[0] if agg_split else ycols,
                         "fetch_row": True})
    if agg_split is not None:
        out = _plan_aggregate(out, agg_split[1], None)
    if yld.distinct:
        out = PlanNode("Dedup", deps=[out], col_names=names)
    return out


_REV_OP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}


def _lookup_field_cond(c: Expr, schema: str, is_edge: bool):
    """Conjunct of shape <schema>.<field> OP <const> (either order) →
    (field, op, value); else None."""
    if not isinstance(c, Binary) or c.op not in ("==", "<", "<=", ">", ">="):
        return None

    def field_of(x):
        if is_edge and isinstance(x, EdgeProp) and x.edge == schema \
                and not x.name.startswith("_"):
            return x.name
        if not is_edge and isinstance(x, AttributeExpr) \
                and isinstance(x.obj, LabelExpr) and x.obj.name == schema:
            return x.attr
        return None

    for lhs, rhs, op in ((c.lhs, c.rhs, c.op),
                         (c.rhs, c.lhs, _REV_OP.get(c.op, c.op))):
        f = field_of(lhs)
        if f is None:
            continue
        try:
            v = _const_eval(rhs)
        except Exception:  # noqa: BLE001 — non-constant operand
            return None
        from ..core.value import is_null
        if is_null(v) and not isinstance(v, bool):
            return None
        return (f, op, v)
    return None


_GEO_REGION_FNS = ("st_intersects", "st_covers", "st_coveredby")


def _geo_field_of(x: Expr, schema: str, is_edge: bool,
                  alias: Optional[str] = None):
    """<schema>.<field> in LOOKUP spelling, or <alias>.<schema>.<field>
    (LabelTagProp) in MATCH spelling when `alias` is given."""
    if is_edge and isinstance(x, EdgeProp) and x.edge == schema \
            and not x.name.startswith("_"):
        return x.name
    if not is_edge and isinstance(x, AttributeExpr) \
            and isinstance(x.obj, LabelExpr) and x.obj.name == schema:
        return x.attr
    if not is_edge and isinstance(x, LabelTagProp) and x.tag == schema \
            and (alias is None or x.var == alias):
        return x.prop
    return None


def _const_geography(e: Expr):
    """Constant-fold to a Geography (WKT strings coerce); raise else."""
    from ..core.geo import Geography, from_wkt
    v = _const_eval(e)
    if isinstance(v, str):
        v = from_wkt(v)
    if not isinstance(v, Geography):
        raise QueryError("not a geography constant")
    return v


def _lookup_geo_cond(c: Expr, schema: str, is_edge: bool,
                     alias: Optional[str] = None):
    """Conjunct a geo index can serve (reference: the storage geo index's
    predicate→cover extraction) → (field, covering token ranges); else None.  Shapes:

      ST_Intersects|ST_Covers|ST_CoveredBy(<schema>.<f>, <const geo>)
        (either argument order)
      ST_DWithin(<schema>.<f>, <const geo>, <const meters>)
      ST_Distance(<schema>.<f>, <const geo>) < r  (<=; either side)

    The cover is a bbox superset, so the caller must keep the ORIGINAL
    predicate as a residual filter — the index only prunes."""
    from ..core.geo import covering_ranges

    def dist_parts(fc):
        """st_distance(field, const) in either arg order → (field, geog)."""
        if not (isinstance(fc, FunctionCall) and fc.name == "st_distance"
                and len(fc.args) == 2):
            return None
        for a, b in ((fc.args[0], fc.args[1]), (fc.args[1], fc.args[0])):
            f = _geo_field_of(a, schema, is_edge, alias)
            if f is not None:
                try:
                    return f, _const_geography(b)
                except Exception:  # noqa: BLE001 — non-constant operand
                    return None
        return None

    if isinstance(c, FunctionCall) and c.name in _GEO_REGION_FNS \
            and len(c.args) == 2:
        for a, b in ((c.args[0], c.args[1]), (c.args[1], c.args[0])):
            f = _geo_field_of(a, schema, is_edge, alias)
            if f is not None:
                try:
                    g = _const_geography(b)
                except Exception:  # noqa: BLE001 — non-constant operand
                    return None
                return f, covering_ranges(g)
        return None
    if isinstance(c, FunctionCall) and c.name == "st_dwithin" \
            and len(c.args) == 3:
        m = dist_parts(FunctionCall("st_distance", c.args[:2]))
        if m is None:
            return None
        try:
            r = _const_eval(c.args[2])
        except Exception:  # noqa: BLE001 — non-constant radius
            return None
        if not isinstance(r, (int, float)) or isinstance(r, bool) or r < 0:
            return None
        return m[0], covering_ranges(m[1], pad_m=float(r))
    if isinstance(c, Binary) and c.op in ("<", "<=", ">", ">="):
        # normalize to st_distance(...) <-upper-bound- r
        for lhs, rhs, op in ((c.lhs, c.rhs, c.op),
                             (c.rhs, c.lhs, _REV_OP.get(c.op, c.op))):
            if op not in ("<", "<="):
                continue
            m = dist_parts(lhs)
            if m is None:
                continue
            try:
                r = _const_eval(rhs)
            except Exception:  # noqa: BLE001 — non-constant bound
                return None
            if not isinstance(r, (int, float)) or isinstance(r, bool) \
                    or r < 0:
                return None
            return m[0], covering_ranges(m[1], pad_m=float(r))
    return None


def _geo_index_for(pctx, space: str, schema: str, is_edge: bool,
                   field: str):
    """The geo (cell-token-keyed) index over `schema.field`, if any."""
    from ..graphstore.schema import PropType
    try:
        sv = (pctx.catalog.get_edge(space, schema).latest if is_edge
              else pctx.catalog.get_tag(space, schema).latest)
        p = sv.prop(field)
    except SchemaError:
        return None
    if p is None or p.ptype != PropType.GEOGRAPHY:
        return None
    for d in pctx.catalog.indexes_for(space, schema, is_edge):
        if d.fields == [field]:
            return d
    return None


_TEXT_OPS = ("PREFIX", "WILDCARD", "REGEXP", "FUZZY")


def _lookup_text_cond(c: Expr, schema: str, is_edge: bool):
    """Conjunct of shape PREFIX|WILDCARD|REGEXP|FUZZY(<schema>.<field>,
    <string const>) → (op, field, pattern); else None.  (The reference's
    ES-backed LOOKUP text predicates.)"""
    if not isinstance(c, FunctionCall) or c.name.upper() not in _TEXT_OPS \
            or len(c.args) != 2:
        return None
    a0, a1 = c.args
    field = None
    if is_edge and isinstance(a0, EdgeProp) and a0.edge == schema \
            and not a0.name.startswith("_"):
        field = a0.name
    elif not is_edge and isinstance(a0, AttributeExpr) \
            and isinstance(a0.obj, LabelExpr) and a0.obj.name == schema:
        field = a0.attr
    if field is None:
        return None
    try:
        pat = _const_eval(a1)
    except Exception:  # noqa: BLE001 — non-constant pattern
        return None
    if not isinstance(pat, str):
        return None
    return (c.name.upper(), field, pat)


def score_index_hints(indexes, conds: Dict[str, list]):
    """Shared predicate→IndexColumnHint scoring (reference analog:
    OptimizerUtils; SURVEY §2 rows 15/22).

    conds: {field: [(op, value, conjunct_idx), ...]}.  For each index,
    bind an equality prefix over its fields, then a range on the next
    field; score = (#eq, has_range).  Returns the best
    (score, index_name, eq_values, range_hint, used_conjunct_idxs) —
    used by both the LOOKUP planner and the optimizer's MATCH
    scan→index exploration rule.
    """
    from ..graphstore.index import MAX, MIN, norm
    best = None
    for d in indexes:
        used: set = set()
        eq = []
        for f in d.fields:
            hit = next(((v, i) for (op, v, i) in conds.get(f, [])
                        if op == "=="), None)
            if hit is None:
                break
            eq.append(hit[0])
            used.add(hit[1])
        rng = None
        if len(eq) < len(d.fields):
            nf = d.fields[len(eq)]
            lo, hi, lo_inc, hi_inc = MIN, MAX, True, True
            found = False
            for (op, v, i) in conds.get(nf, []):
                if op in (">", ">="):
                    inc = op == ">="
                    # keep the TIGHTEST lower bound (ties: exclusive wins)
                    if isinstance(lo, type(MIN)) or norm(v) > norm(lo) or \
                            (norm(v) == norm(lo) and not inc):
                        lo, lo_inc = v, inc
                    used.add(i)
                    found = True
                elif op in ("<", "<="):
                    inc = op == "<="
                    if isinstance(hi, type(MAX)) or norm(v) < norm(hi) or \
                            (norm(v) == norm(hi) and not inc):
                        hi, hi_inc = v, inc
                    used.add(i)
                    found = True
            if found:
                rng = (lo, hi, lo_inc, hi_inc)
        score = (len(eq), 1 if rng else 0)
        if best is None or score > best[0]:
            best = (score, d.name, eq, rng, used)
    return best


def _choose_index(pctx, space: str, schema: str, is_edge: bool,
                  filt: Optional[Expr]):
    """Pick the best index + column hints for a LOOKUP predicate.
    Returns (index_name, eq_values, range_hint, residual_filter)."""
    indexes = pctx.catalog.indexes_for(space, schema, is_edge)
    if not indexes:
        kind = "edge" if is_edge else "tag"
        raise QueryError(
            f"no valid index found on {kind} `{schema}' "
            f"(LOOKUP requires one; CREATE {kind.upper()} INDEX first)")
    if filt is None:
        return indexes[0].name, [], None, None
    conjs = split_conjuncts(filt)
    conds: Dict[str, list] = {}
    for i, c in enumerate(conjs):
        m = _lookup_field_cond(c, schema, is_edge)
        if m is not None:
            conds.setdefault(m[0], []).append((m[1], m[2], i))
    _, name, eq, rng, used = score_index_hints(indexes, conds)
    d = next(x for x in indexes if x.name == name)
    lens = list(getattr(d, "field_lens", None) or [])
    if any(lens):
        # string prefix index (name(10)): stored keys are truncated, so
        # probe values truncate the same way, bounds widen to inclusive
        # (a cut bound excludes keys whose full values qualify), and the
        # WHOLE predicate stays as residual — prefix hits over-match
        eq = [v[:lens[i]] if i < len(lens) and lens[i]
              and isinstance(v, str) else v for i, v in enumerate(eq)]
        if rng is not None:
            lo, hi, lo_inc, hi_inc = rng
            nf = len(eq)
            ln = lens[nf] if nf < len(lens) else 0
            if ln:
                # an exclusive lo of length >= ln collides with keys
                # truncated TO lo (value "alexander" > lo "alex" stores
                # key "alex") — widen to inclusive; hi only over-matches
                # when actually cut
                if isinstance(lo, str) and len(lo) >= ln:
                    lo, lo_inc = lo[:ln], True
                if isinstance(hi, str) and len(hi) > ln:
                    hi, hi_inc = hi[:ln], True
            rng = (lo, hi, lo_inc, hi_inc)
        return name, eq, rng, filt
    residual = join_conjuncts(
        [c for i, c in enumerate(conjs) if i not in used])
    return name, eq, rng, residual


def _plan_lookup(pctx, s: A.LookupSentence) -> PlanNode:
    space = pctx.need_space()
    cat = pctx.catalog
    is_edge = False
    try:
        cat.get_tag(space, s.schema_name)
    except SchemaError:
        try:
            cat.get_edge(space, s.schema_name)
            is_edge = True
        except SchemaError:
            raise QueryError(
                f"`{s.schema_name}' is neither tag nor edge in `{space}'") from None
    filt = None
    if s.where is not None:
        aliases = {s.schema_name: s.schema_name}
        filt = _rewrite_match_expr(s.where.filter, aliases)
        filt = _rewrite_go_expr(pctx, filt, [s.schema_name]) if is_edge else filt
    # text-search predicate → fulltext scan (reference: ES-backed LOOKUP)
    text = ft_pick = first_unindexed = None
    if filt is not None:
        conjs = split_conjuncts(filt)
        ft_descs = pctx.catalog.fulltext_indexes_for(
            space, s.schema_name, is_edge)
        for i, c in enumerate(conjs):
            m = _lookup_text_cond(c, s.schema_name, is_edge)
            if m is None:
                continue
            op, field, pat = m
            if op == "REGEXP":
                # validate const patterns at plan time so scan-planned
                # and residual placements fail identically
                import re as _re
                try:
                    _re.compile(pat)
                except _re.error as ex:
                    raise QueryError(
                        f"bad REGEXP pattern {pat!r}: {ex}") from None
            d = next((d for d in ft_descs if d.fields[0] == field), None)
            if d is None:
                # another conjunct may still be indexed; the host text
                # evaluators cover this one as a residual
                if first_unindexed is None:
                    first_unindexed = (op, field)
                continue
            if text is None:
                text = m
                ft_pick = d
                residual_t = join_conjuncts(
                    [x for j, x in enumerate(conjs) if j != i])
        if text is None and first_unindexed is not None:
            op, field = first_unindexed
            raise QueryError(
                f"no fulltext index on `{s.schema_name}.{field}' "
                f"({op} requires one; CREATE FULLTEXT INDEX first)")
    geo = None
    if filt is not None and text is None:
        # ST_ predicate over a cell-token geo index: scan the covering
        # ranges, keep the WHOLE predicate as residual (cover ⊇ region).
        # An equality/range binding on a B-tree index beats the bbox
        # cover (the geo branch must not preempt a more
        # selective probe), so the geo path only runs when the generic
        # hint extraction binds nothing.
        generic_binds = False
        try:
            _nm, eq_h, rng_h, _res = _choose_index(
                pctx, space, s.schema_name, is_edge, filt)
            generic_binds = bool(eq_h) or rng_h is not None
        except QueryError:
            pass                      # no B-tree index at all
        if not generic_binds:
            for c in split_conjuncts(filt):
                m = _lookup_geo_cond(c, s.schema_name, is_edge)
                if m is not None:
                    d = _geo_index_for(pctx, space, s.schema_name,
                                       is_edge, m[0])
                    if d is not None:
                        geo = (d.name, m[1])
                        break
    if text is not None:
        op, field, pat = text
        scan = PlanNode("FulltextIndexScan", deps=[],
                        col_names=["_matched"],
                        args={"space": space, "schema": s.schema_name,
                              "is_edge": is_edge, "filter": residual_t,
                              "index": ft_pick.name, "op": op,
                              "pattern": pat})
    elif geo is not None:
        scan = PlanNode("IndexScan", deps=[],
                        col_names=["_matched"],
                        args={"space": space, "schema": s.schema_name,
                              "is_edge": is_edge, "filter": filt,
                              "index": geo[0], "geo_ranges": geo[1]})
    else:
        index_name, eq, rng, residual = _choose_index(
            pctx, space, s.schema_name, is_edge, filt)
        scan = PlanNode("IndexScan", deps=[],
                        col_names=["_matched"],
                        args={"space": space, "schema": s.schema_name,
                              "is_edge": is_edge, "filter": residual,
                              "index": index_name, "eq": eq, "range": rng})
    yld = s.yield_
    if yld is None:
        default = (FunctionCall("id", [VertexExpr("vertex")]) if not is_edge
                   else EdgeExpr())
        yld = A.YieldClause([A.YieldColumn(default, "_matched")])
    ycols = []
    for c in yld.columns:
        e = _rewrite_match_expr(c.expr, {s.schema_name: s.schema_name})
        if is_edge:
            e = _rewrite_go_expr(pctx, e, [s.schema_name])
        ycols.append((e, _col_name(c)))
    names = [n for _, n in ycols]
    agg_split = _implicit_agg_split(ycols)
    out = PlanNode("Project", deps=[scan], col_names=names,
                   args={"columns": agg_split[0] if agg_split else ycols,
                         "lookup_row": True,
                         "schema": s.schema_name, "is_edge": is_edge})
    if agg_split is not None:
        out = _plan_aggregate(out, agg_split[1], None)
    if yld.distinct:
        out = PlanNode("Dedup", deps=[out], col_names=names)
    return out


# ---- MATCH ----------------------------------------------------------------


def _plan_match(pctx, s: A.MatchSentence) -> PlanNode:
    # a pure UNWIND/WITH/RETURN pipeline touches no graph data — like
    # YIELD, it must work before any USE (openCypher expression-only
    # queries); the first MATCH clause still demands a space
    if any(isinstance(c, A.MatchClauseAst) for c in s.clauses):
        pctx.need_space()
    current: Optional[PlanNode] = pctx.input_node
    aliases: Dict[str, str] = {}
    if current is not None:
        for c in current.col_names:
            aliases[c] = "input"

    for clause in s.clauses:
        if isinstance(clause, A.MatchClauseAst):
            if clause.optional and current is None:
                # leading OPTIONAL MATCH: one implicit input row, so a
                # miss null-extends to a single all-NULL row instead of
                # an empty result (openCypher).  A zero-column one-row
                # Project is the unit for the empty-key left join.
                current = PlanNode("Project", deps=[PlanNode("Start")],
                                  col_names=[],
                                  args={"columns": [],
                                        "match_row": True})
            current = _plan_match_clause(pctx, clause, current, aliases)
        elif isinstance(clause, A.UnwindClauseAst):
            e = _rewrite_match_expr(clause.expr, aliases)
            cols = (list(current.col_names) if current else []) + [clause.alias]
            current = PlanNode("Unwind", deps=[current] if current else [],
                               col_names=cols,
                               args={"expr": e, "alias": clause.alias})
            aliases[clause.alias] = "value"
        elif isinstance(clause, A.WithClauseAst):
            wcols = clause.columns
            if wcols is None:      # WITH *: carry every visible alias
                wcols = [A.YieldColumn(LabelExpr(a), a) for a in aliases
                         if not a.startswith("_")]
                if not wcols:
                    raise QueryError("WITH * with nothing in scope")
            current = _plan_projection(pctx, current, wcols,
                                       clause.distinct, clause.where,
                                       clause.order_by, clause.skip,
                                       clause.limit, aliases)
            # a bare alias carried through WITH keeps its kind: a later
            # clause can then Argument-seed a pattern from a projected
            # vertex instead of scanning every vertex and joining
            # (IC5-shaped multi-clause MATCH was scan-bound without this)
            carried = {}
            for c in wcols:
                if isinstance(c.expr, LabelExpr):
                    k = aliases.get(c.expr.name)
                    if k is not None:
                        carried[_col_name(c)] = k
            aliases = {c: carried.get(c, "value")
                       for c in current.col_names}
        else:
            raise QueryError(f"unsupported MATCH clause {type(clause).__name__}")

    ret = s.return_
    cols = ret.columns
    if cols is None:
        cols = [A.YieldColumn(LabelExpr(a), a) for a in aliases
                if not a.startswith("_")]
        if not cols:
            raise QueryError("RETURN * with nothing to return")
    return _plan_projection(pctx, current, cols, ret.distinct, None,
                            ret.order_by, ret.skip, ret.limit, aliases)


def _plan_projection(pctx, dep: Optional[PlanNode], cols: List[A.YieldColumn],
                     distinct: bool, where: Optional[Expr],
                     order_by, skip: int, limit: int,
                     aliases: Dict[str, str]) -> PlanNode:
    if dep is None:
        dep = PlanNode("Start")
    out = dep
    ycols = [(_rewrite_match_expr(c.expr, aliases), _col_name(c)) for c in cols]
    names = [n for _, n in ycols]
    if any(has_aggregate(e) for e, _ in ycols):
        out = _plan_aggregate(out, ycols, None)
        out.args["match_row"] = True
    else:
        out = PlanNode("Project", deps=[out], col_names=names,
                       args={"columns": ycols, "match_row": True})
    if where is not None:
        # WITH ... WHERE filters the PROJECTED columns (openCypher)
        w = _rewrite_match_expr(where, {n: "value" for n in names})
        out = PlanNode("Filter", deps=[out], col_names=names,
                       args={"condition": w, "match_row": True})
    if distinct:
        out = PlanNode("Dedup", deps=[out], col_names=names)
    if order_by:
        # ORDER BY items resolve against the PROJECTED columns
        # (openCypher scope after RETURN/WITH): a bare alias stays a
        # column lookup, an expression that textually matches an output
        # column (e.g. `ORDER BY id(a)` after `RETURN id(a), k`) is
        # re-homed to that column, and anything else is an error —
        # evaluating it against projected rows would silently sort on
        # NULL (the pattern variables are out of scope here).
        src_text = {to_text(e): nm for e, nm in ycols}
        factors = []
        for f in order_by:
            e2 = f.expr
            txt = to_text(e2)
            txt_m = to_text(_rewrite_match_expr(
                e2, aliases)) if aliases else txt
            if isinstance(e2, LabelExpr) and e2.name in names:
                pass                       # alias lookup — resolves as-is
            elif txt in names:
                e2 = LabelExpr(txt)        # same column, spelled as expr
            elif txt_m in src_text:
                # ORDER BY repeats a projected column's SOURCE expr
                # (`RETURN a.p.x AS x ORDER BY a.p.x`) — same column
                e2 = LabelExpr(src_text[txt_m])
            else:
                e2 = _rewrite_match_expr(
                    e2, {n: "value" for n in names})
                refs = {x.name for x in walk(e2)
                        if x.kind in ("label", "input_prop")}
                if refs and not refs <= set(names):
                    raise QueryError(
                        f"ORDER BY item `{txt}' must be a column of "
                        f"the RETURN/WITH list (have {names})")
            factors.append((e2, f.ascending))
        out = PlanNode("Sort", deps=[out], col_names=names,
                       args={"factors": factors, "match_row": True})
    if skip or (limit is not None and limit >= 0):
        out = PlanNode("Limit", deps=[out], col_names=names,
                       args={"offset": skip, "count": limit if limit >= 0 else -1})
    return out


def _plan_match_clause(pctx, mc: A.MatchClauseAst, current: Optional[PlanNode],
                       aliases: Dict[str, str]) -> PlanNode:
    pat_nodes = []
    for pat in mc.patterns:
        pat_nodes.append(_plan_pattern(pctx, pat, mc.where, aliases, current))
    node = pat_nodes[0]
    for other in pat_nodes[1:]:
        shared = [c for c in node.col_names if c in other.col_names]
        if shared:
            node = PlanNode("HashInnerJoin", deps=[node, other],
                            col_names=node.col_names + [c for c in other.col_names
                                                        if c not in node.col_names],
                            args={"keys": shared})
        else:
            node = PlanNode("CrossJoin", deps=[node, other],
                            col_names=node.col_names + other.col_names)
    clause_edges = [ep.alias for pat in mc.patterns for ep in pat.edges]
    if len(clause_edges) >= 2:
        # Cypher relationship isomorphism scopes to the WHOLE MATCH
        # clause: no edge binds two relationship variables across any of
        # its comma patterns — including cycles through the dup-alias
        # branch in _plan_pattern ((a)-[e1]-(b)-[e2]-(a) walking one
        # edge out and back).
        cond = FunctionCall("_edges_distinct",
                            [LabelExpr(al) for al in clause_edges])
        node = PlanNode("Filter", deps=[node],
                        col_names=list(node.col_names),
                        args={"condition": cond, "match_row": True})
    where = mc.where
    if where is not None and mc.optional and current is not None:
        # OPTIONAL MATCH ... WHERE filters DURING matching (openCypher):
        # a row failing the predicate is a non-match that null-extends,
        # not a dropped output row — so conjuncts whose references
        # (including any pattern predicate's node aliases) live entirely
        # in the pattern branch filter it BEFORE the left join.
        # Conjuncts reaching outer aliases fall through to the normal
        # above-join path, where their pattern predicates resolve
        # against the JOINED columns (legacy drop placement — they
        # cannot be evaluated inside the branch).
        w = _rewrite_match_expr(where, aliases)
        right_cols = set(node.col_names)
        pre, post = [], []
        for c in split_conjuncts(w):
            refs = {x.name for x in walk(c) if isinstance(x, LabelExpr)} \
                | {x.var for x in walk(c) if isinstance(x, LabelTagProp)}
            for x in walk(c):
                if x.kind == "pattern_pred":
                    refs |= {np_.alias for np_ in x.pattern.nodes
                             if np_.alias is not None}
            (pre if refs <= right_cols else post).append(c)
        if pre:
            wpre = join_conjuncts(pre)
            node, wpre, hidden_o = _apply_pattern_preds(pctx, node, wpre)
            node = PlanNode("Filter", deps=[node],
                            col_names=list(node.col_names),
                            args={"condition": wpre, "match_row": True})
            if hidden_o:
                keep = [c for c in node.col_names if c not in hidden_o]
                node = PlanNode("Project", deps=[node], col_names=keep,
                                args={"columns": [(LabelExpr(c), c)
                                                  for c in keep],
                                      "match_row": True})
        where = join_conjuncts(post) if post else None
    if current is not None:
        shared = [c for c in current.col_names if c in node.col_names]
        join_kind = "HashLeftJoin" if mc.optional else "HashInnerJoin"
        if shared:
            node = PlanNode(join_kind, deps=[current, node],
                            col_names=current.col_names
                            + [c for c in node.col_names if c not in current.col_names],
                            args={"keys": shared})
        elif mc.optional:
            # no shared aliases: openCypher semantics are a cartesian
            # product, degrading to one all-NULL row for the pattern's
            # columns when it matched nothing — exactly a hash left
            # join on the EMPTY key (every row shares the () key)
            node = PlanNode("HashLeftJoin", deps=[current, node],
                            col_names=current.col_names
                            + [c for c in node.col_names
                               if c not in current.col_names],
                            args={"keys": []})
        else:
            node = PlanNode("CrossJoin", deps=[current, node],
                            col_names=current.col_names + node.col_names)
    if where is not None:
        w = _rewrite_match_expr(where, aliases)
        node, w, hidden = _apply_pattern_preds(pctx, node, w)
        node = PlanNode("Filter", deps=[node], col_names=list(node.col_names),
                        args={"condition": w, "match_row": True})
        if hidden:
            keep = [c for c in node.col_names if c not in hidden]
            node = PlanNode("Project", deps=[node], col_names=keep,
                            args={"columns": [(LabelExpr(c), c)
                                              for c in keep],
                                  "match_row": True})
    return node


def _apply_pattern_preds(pctx, node: PlanNode, w: Expr):
    """WHERE (a)-[:e]->() — exists-semantics pattern predicates
    (reference: MatchValidator's PatternExpression planned as a
    RollUpApply semi-join).

    Each distinct pattern becomes a deduplicated semi-join branch: plan
    the pattern seeded from a bound alias (Argument over the current
    rows), project the bound alias columns plus a TRUE marker, left-join
    back on the bound aliases, and rewrite the predicate occurrence into
    `CASE WHEN <any bound alias IS NULL> THEN NULL ELSE marker IS NOT
    NULL END` — NULL bound variables (OPTIONAL MATCH misses) make the
    predicate NULL per openCypher 3VL; otherwise it is a two-valued
    boolean so NOT/AND/OR compose correctly.
    Returns (node, rewritten_where, hidden_cols)."""
    import copy

    markers: Dict[str, str] = {}
    pats = []
    for x in walk(w):
        if x.kind == "pattern_pred" and x.text not in markers:
            markers[x.text] = ""
            pats.append(x)
    if not pats:
        return node, w, []
    hidden: List[str] = []
    for pe in pats:
        n = getattr(pctx, "_pe_counter", 0)
        pctx._pe_counter = n + 1
        marker = f"__pe_{n}"
        pat = copy.deepcopy(pe.pattern)
        named = [np.alias for np in pat.nodes if np.alias is not None]
        # bound = present in the incoming rows, whatever the alias kind:
        # a vertex carried through WITH/UNWIND is typed "value" but its
        # runtime column holds the vertex, which is all the semi-join
        # seed needs (rejecting those as "new variables"
        # refused valid openCypher)
        bound = [a for a in dict.fromkeys(named) if a in node.col_names]
        fresh = sorted(set(named) - set(bound))
        if fresh:
            raise QueryError(
                "pattern predicate must not introduce new variables: "
                + ", ".join(fresh))
        if not bound:
            raise QueryError(
                "pattern predicate must use at least one bound variable")
        for ep in pat.edges:
            if ep.alias is not None:
                raise QueryError(
                    f"pattern predicate must not name its edges "
                    f"(`{ep.alias}')")
        scratch = {a: "vertex" for a in bound}
        sub = _plan_pattern(pctx, pat, None, scratch, node)
        cols = [(LabelExpr(a), a) for a in bound] + [(Literal(True), marker)]
        sub = PlanNode("Project", deps=[sub], col_names=bound + [marker],
                       args={"columns": cols, "match_row": True})
        sub = PlanNode("Dedup", deps=[sub], col_names=bound + [marker])
        node = PlanNode("HashLeftJoin", deps=[node, sub],
                        col_names=list(node.col_names) + [marker],
                        args={"keys": bound})
        markers[pe.text] = (marker, bound)
        hidden.append(marker)

    def fn(x: Expr):
        if x.kind == "pattern_pred":
            marker, bound = markers[x.text]
            found = Unary("IS_NOT_NULL", LabelExpr(marker))
            null_check = None
            for a in bound:
                c = Unary("IS_NULL", LabelExpr(a))
                null_check = c if null_check is None \
                    else Binary("OR", null_check, c)
            return Case([(null_check, Literal(NULL))], found, None)
        return None
    return node, rewrite(w, fn), hidden


def _anon_names(pctx):
    """Anonymous aliases must be unique across the WHOLE query: two
    patterns in one MATCH each having an anonymous edge must not share
    a column name, or the join between them keys on unrelated edges
    (anonymous elements are never join keys in Cypher)."""
    while True:
        n = getattr(pctx, "_anon_counter", 0)
        pctx._anon_counter = n + 1
        yield f"__anon_{n}"


def _plan_pattern(pctx, pat: A.PathPattern, where: Optional[Expr],
                  aliases: Dict[str, str], current: Optional[PlanNode]) -> PlanNode:
    space = pctx.need_space()
    cat = pctx.catalog
    anon = _anon_names(pctx)
    for np in pat.nodes:
        if np.alias is None:
            np.alias = next(anon)
    for ep in pat.edges:
        if ep.alias is None:
            ep.alias = next(anon)
        for t in ep.types:
            try:
                cat.get_edge(space, t)
            except SchemaError as ex:
                raise QueryError(str(ex)) from None
    for np in pat.nodes:
        for lbl, _ in np.labels:
            try:
                cat.get_tag(space, lbl)
            except SchemaError as ex:
                raise QueryError(str(ex)) from None

    # ---- choose seed node: id(x)==lit / id(x) IN [...] in WHERE, bound
    # alias from a previous clause, else labeled node, else first node.
    seed_idx, seed_vids = _choose_seed(pat, where, aliases, current)

    if seed_idx == len(pat.nodes) - 1 and len(pat.nodes) > 1:
        _reverse_pattern(pat)
        seed_idx = 0
    elif seed_idx != 0 and seed_idx != len(pat.nodes) - 1:
        seed_idx = 0
        seed_vids = None

    seed = pat.nodes[seed_idx]
    bound = seed.alias in aliases and aliases[seed.alias] == "vertex"
    if bound and current is not None:
        dep = PlanNode("Argument", deps=[], col_names=[seed.alias],
                       args={"from_var": current.output_var, "col": seed.alias})
    elif seed_vids is not None:
        dep = PlanNode("GetVertices", deps=[], col_names=[seed.alias],
                       args={"space": space, "tags": [], "vids": seed_vids,
                             "src_col": None, "as_col": seed.alias})
    else:
        tag = seed.labels[0][0] if seed.labels else None
        dep = PlanNode("ScanVertices", deps=[], col_names=[seed.alias],
                       args={"space": space, "tag": tag, "as_col": seed.alias})
    node_filter = _node_pred(seed)
    if node_filter is not None:
        dep = PlanNode("Filter", deps=[dep], col_names=list(dep.col_names),
                       args={"condition": node_filter, "match_row": True})
    aliases[seed.alias] = "vertex"

    cur = dep
    for i, ep in enumerate(pat.edges):
        dst = pat.nodes[i + 1]
        etypes = ep.types or sorted(e.name for e in cat.edges(space))
        edge_filter = _edge_pred(ep)
        # A repeated node alias within the pattern — (a)-[e]->(a), cycles
        # like (a)-->(b)-->(a) — is an EQUALITY constraint, not a second
        # column: traverse into a fresh alias, filter id(fresh)==id(orig),
        # then drop the fresh column.
        dup = dst.alias in cur.col_names
        use_alias = (next(anon) + "d") if dup else dst.alias
        cols = list(cur.col_names) + [ep.alias, use_alias]
        cur = PlanNode("Traverse", deps=[cur], col_names=cols, args={
            "space": space, "src_col": pat.nodes[i].alias,
            "edge_alias": ep.alias, "dst_alias": use_alias,
            "edge_types": etypes, "direction": ep.direction,
            "min_hop": ep.min_hop, "max_hop": ep.max_hop,
            "edge_filter": edge_filter,
        })
        aliases[ep.alias] = "edge_list" if ep.max_hop != 1 or ep.min_hop != 1 else "edge"
        aliases[dst.alias] = "vertex"
        dst_filter = _node_pred(dst)
        av_labels = [l for l, _ in dst.labels]
        cur = PlanNode("AppendVertices", deps=[cur], col_names=list(cur.col_names),
                       args={"space": space, "col": use_alias,
                             "labels": av_labels, "filter": dst_filter})
        if dup:
            eq = Binary("==", FunctionCall("id", [LabelExpr(use_alias)]),
                        FunctionCall("id", [LabelExpr(dst.alias)]))
            cur = PlanNode("Filter", deps=[cur],
                           col_names=list(cur.col_names),
                           args={"condition": eq, "match_row": True})
            keep = [c for c in cur.col_names if c != use_alias]
            cur = PlanNode("Project", deps=[cur], col_names=keep,
                           args={"columns": [(LabelExpr(c), c)
                                             for c in keep],
                                 "match_row": True})
    if not pat.edges:
        # single-node pattern: ensure label presence already filtered
        if seed.labels and seed_vids is not None:
            lbl_conds = [FunctionCall("_hastag",
                                      [LabelExpr(seed.alias), Literal(l)])
                         for l, _ in seed.labels]
            cond = lbl_conds[0]
            for c in lbl_conds[1:]:
                cond = Binary("AND", cond, c)
            cur = PlanNode("Filter", deps=[cur], col_names=list(cur.col_names),
                           args={"condition": cond, "match_row": True})
    if pat.alias is not None:
        # named path column
        cols = list(cur.col_names) + [pat.alias]
        cur = PlanNode("BuildPath", deps=[cur], col_names=cols, args={
            "alias": pat.alias,
            "nodes": [n.alias for n in pat.nodes],
            "edges": [e.alias for e in pat.edges],
        })
        aliases[pat.alias] = "path"
    return cur


def _node_pred(np: A.NodePattern) -> Optional[Expr]:
    conds: List[Expr] = []
    for lbl, lprops in np.labels:
        conds.append(FunctionCall("_hastag", [LabelExpr(np.alias), Literal(lbl)]))
        if lprops:
            for k, v in lprops.items():
                conds.append(Binary("==", LabelTagProp(np.alias, lbl, k), v))
    if np.props:
        for k, v in np.props.items():
            conds.append(Binary("==",
                                AttributeExpr(LabelExpr(np.alias), k), v))
    if not conds:
        return None
    out = conds[0]
    for c in conds[1:]:
        out = Binary("AND", out, c)
    return out


def _edge_pred(ep: A.EdgePattern) -> Optional[Expr]:
    if not ep.props:
        return None
    conds = [Binary("==", AttributeExpr(LabelExpr("__edge__"), k), v)
             for k, v in ep.props.items()]
    out = conds[0]
    for c in conds[1:]:
        out = Binary("AND", out, c)
    return out


def _choose_seed(pat, where, aliases, current):
    """Find id(x)==lit / id(x) IN [..] for a pattern node, or a bound alias."""
    node_aliases = [n.alias for n in pat.nodes]
    if current is not None:
        for i, a in enumerate(node_aliases):
            if a in aliases and aliases[a] == "vertex":
                return i, None
    if where is not None:
        for conj in split_conjuncts(where):
            if isinstance(conj, Binary) and conj.op in ("==", "IN"):
                for lhs, rhs in ((conj.lhs, conj.rhs), (conj.rhs, conj.lhs)):
                    if (isinstance(lhs, FunctionCall) and lhs.name == "id"
                            and len(lhs.args) == 1
                            and isinstance(lhs.args[0], LabelExpr)
                            and lhs.args[0].name in node_aliases
                            and _is_const(rhs)):
                        idx = node_aliases.index(lhs.args[0].name)
                        v = rhs.eval(DictContext())
                        vids = v if isinstance(v, list) else [v]
                        return idx, [Literal(x) for x in vids]
    for i, n in enumerate(pat.nodes):
        if n.labels or n.props:
            return i, None
    return 0, None


def _is_const(e: Expr) -> bool:
    return all(x.kind in ("literal", "list", "map", "set") for x in walk(e))


def _reverse_pattern(pat: A.PathPattern):
    pat.nodes.reverse()
    pat.edges.reverse()
    for ep in pat.edges:
        if ep.direction == "out":
            ep.direction = "in"
        elif ep.direction == "in":
            ep.direction = "out"


# ---- FIND PATH / SUBGRAPH -------------------------------------------------


def _plan_find_path(pctx, s: A.FindPathSentence) -> PlanNode:
    space = pctx.need_space()
    edges = s.over.edges
    if s.over.is_all:
        edges = sorted(e.name for e in pctx.catalog.edges(space))
    src_vids, src_ref = _resolve_from(pctx, s.from_)
    dst_vids, dst_ref = _resolve_from(pctx, s.to)
    deps = [pctx.input_node] if (src_ref or dst_ref) and pctx.input_node else []
    where_expr = None
    if s.where is not None:
        where_expr = _rewrite_go_expr(pctx, s.where.filter, edges)
    col = "path"
    if s.yield_ is not None and s.yield_.columns:
        col = _col_name(s.yield_.columns[0])
    return PlanNode("FindPath", deps=deps, col_names=[col], args={
        "space": space, "kind": s.kind, "edge_types": edges,
        "direction": s.over.direction,
        "src_vids": src_vids, "src_ref": src_ref,
        "dst_vids": dst_vids, "dst_ref": dst_ref,
        "upto": s.upto, "with_prop": s.with_prop, "filter": where_expr,
    })


def _plan_call_algo(pctx, s: A.CallAlgoSentence) -> PlanNode:
    """CALL algo.<func>(...) → one CallAlgo node.  The
    validator vetted names/required/yields; parameter values are
    constant expressions evaluated HERE so the executor sees plain
    python values (the plan is the wire/cache form)."""
    from ..algo import ALGORITHMS
    space = pctx.need_space()
    params = {k: _const_eval(v) for k, v in s.params.items()}
    spec = ALGORITHMS[s.func]
    if s.yield_ is not None and s.yield_.columns:
        ycols = [(c.expr.name, _col_name(c)) for c in s.yield_.columns]
    else:
        ycols = [(c, c) for c in spec.yield_cols]
    return PlanNode("CallAlgo", col_names=[al for _, al in ycols],
                    args={"space": space, "algo": s.func,
                          "params": params, "yield": ycols})


def _plan_subgraph(pctx, s: A.SubgraphSentence) -> PlanNode:
    space = pctx.need_space()
    cat = pctx.catalog
    all_names = sorted(e.name for e in cat.edges(space))
    in_e, out_e, both_e = s.in_edges, s.out_edges, s.both_edges
    if s.all_edges or not (in_e or out_e or both_e):
        both_e = all_names
    vids, ref = _resolve_from(pctx, s.from_)
    names = ["_vertices", "_edges"]
    if s.yield_ is not None:
        names = [_col_name(c) for c in s.yield_.columns]
    where_expr = None
    if s.where is not None:
        where_expr = _rewrite_go_expr(pctx, s.where.filter, all_names)
    deps = [pctx.input_node] if ref and pctx.input_node else []
    yield_spec = []
    if s.yield_ is not None:
        for c in s.yield_.columns:
            t = to_text(c.expr).lower()
            yield_spec.append("vertices" if "vertices" in t else "edges")
    else:
        yield_spec = ["vertices", "edges"]
    return PlanNode("Subgraph", deps=deps, col_names=names, args={
        "space": space, "steps": s.steps, "vids": vids, "src_ref": ref,
        "in_edges": in_e, "out_edges": out_e, "both_edges": both_e,
        "with_prop": s.with_prop, "filter": where_expr, "yield": yield_spec,
    })


# ---- DML ------------------------------------------------------------------


def _const_eval(e: Expr) -> Any:
    return e.eval(DictContext())


def _plan_insert_vertices(pctx, s: A.InsertVerticesSentence) -> PlanNode:
    space = pctx.need_space()
    for tag, names in s.tags:
        try:
            ts = pctx.catalog.get_tag(space, tag)
        except SchemaError as ex:
            raise QueryError(str(ex)) from None
        for n in names:
            if ts.latest.prop(n) is None:
                raise QueryError(f"tag `{tag}' has no property `{n}'")
    total = len(s.prop_names)
    rows = []
    for r in s.rows:
        if len(r.values) != total:
            raise QueryError("value count does not match prop count")
        vals = [_const_eval(v) for v in r.values]
        per_tag, off = [], 0
        for _tag, names in s.tags:
            per_tag.append(dict(zip(names, vals[off:off + len(names)])))
            off += len(names)
        rows.append((_const_eval(r.vid), per_tag))
    return PlanNode("InsertVertices", col_names=[], args={
        "space": space, "tags": list(s.tags), "rows": rows,
        "if_not_exists": s.if_not_exists})


def _plan_insert_edges(pctx, s: A.InsertEdgesSentence) -> PlanNode:
    space = pctx.need_space()
    try:
        es = pctx.catalog.get_edge(space, s.etype)
    except SchemaError as ex:
        raise QueryError(str(ex)) from None
    for n in s.prop_names:
        if es.latest.prop(n) is None:
            raise QueryError(f"edge `{s.etype}' has no property `{n}'")
    rows = []
    for r in s.rows:
        if len(r.values) != len(s.prop_names):
            raise QueryError("value count does not match prop count")
        rows.append((_const_eval(r.src), _const_eval(r.dst), r.rank,
                     {n: _const_eval(v) for n, v in zip(s.prop_names, r.values)}))
    return PlanNode("InsertEdges", col_names=[], args={
        "space": space, "etype": s.etype, "rows": rows,
        "prop_names": s.prop_names, "if_not_exists": s.if_not_exists})


def _plan_delete_vertices(pctx, s: A.DeleteVerticesSentence) -> PlanNode:
    space = pctx.need_space()
    vids, ref = _resolve_from(pctx, s.vids)
    deps = [pctx.input_node] if ref and pctx.input_node else []
    return PlanNode("DeleteVertices", deps=deps, col_names=[], args={
        "space": space, "vids": vids, "src_ref": ref, "with_edge": s.with_edge})


def _plan_delete_edges(pctx, s: A.DeleteEdgesSentence) -> PlanNode:
    space = pctx.need_space()
    keys = [(_const_eval(k.src), _const_eval(k.dst), k.rank) for k in s.keys]
    deps = []
    ref = None
    if s.ref is not None:
        deps = [pctx.input_node] if pctx.input_node else []
        ref = tuple(s.ref)
    return PlanNode("DeleteEdges", deps=deps, col_names=[], args={
        "space": space, "etype": s.etype, "keys": keys, "ref": ref})


def _plan_delete_tags(pctx, s: A.DeleteTagsSentence) -> PlanNode:
    space = pctx.need_space()
    vids, ref = _resolve_from(pctx, s.vids)
    return PlanNode("DeleteTags", col_names=[], args={
        "space": space, "tags": s.tags, "vids": vids, "src_ref": ref})


def _plan_update(pctx, s: A.UpdateSentence) -> PlanNode:
    space = pctx.need_space()
    cat = pctx.catalog
    try:
        schema = (cat.get_edge(space, s.schema_name) if s.is_edge
                  else cat.get_tag(space, s.schema_name))
    except SchemaError as ex:
        raise QueryError(str(ex)) from None
    for name, _ in s.sets:
        if schema.latest.prop(name) is None:
            raise QueryError(f"no property `{name}' on `{s.schema_name}'")
    args: Dict[str, Any] = {
        "space": space, "is_edge": s.is_edge, "schema": s.schema_name,
        "sets": s.sets, "when": s.when, "insertable": s.insertable,
        "yield": [(c.expr, _col_name(c)) for c in (s.yield_.columns if s.yield_ else [])],
    }
    if s.is_edge:
        k = s.edge_key
        args["edge_key"] = (_const_eval(k.src), _const_eval(k.dst), k.rank)
    else:
        args["vid"] = _const_eval(s.vid)
    cols = [n for _, n in args["yield"]]
    return PlanNode("Update", col_names=cols, args=args)


# ---- DDL / admin ----------------------------------------------------------


def _admin(node_kind: str, cols: List[str] = None, **args) -> PlanNode:
    return PlanNode(node_kind, col_names=cols or [], args=args)


def _plan_use(pctx, s: A.UseSentence) -> PlanNode:
    try:
        pctx.catalog.get_space(s.space)
    except SchemaError as ex:
        raise QueryError(str(ex)) from None
    pctx.space = s.space
    return _admin("SwitchSpace", space=s.space)


_DISPATCH = {}


def _register_dispatch():
    _DISPATCH.update({
        A.SeqSentence: _plan_seq,
        A.PipedSentence: _plan_pipe,
        A.AssignSentence: _plan_assign,
        A.SetOpSentence: _plan_setop,
        A.ExplainSentence: _plan_explain,
        A.GoSentence: _plan_go,
        A.YieldSentence: _plan_yield,
        A.GroupBySentence: _plan_group_by,
        A.OrderBySentence: _plan_order_by,
        A.LimitSentence: _plan_limit,
        A.SampleSentence: _plan_sample,
        A.FetchVerticesSentence: _plan_fetch_vertices,
        A.FetchEdgesSentence: _plan_fetch_edges,
        A.LookupSentence: _plan_lookup,
        A.MatchSentence: _plan_match,
        A.FindPathSentence: _plan_find_path,
        A.SubgraphSentence: _plan_subgraph,
        A.CallAlgoSentence: _plan_call_algo,
        A.InsertVerticesSentence: _plan_insert_vertices,
        A.InsertEdgesSentence: _plan_insert_edges,
        A.DeleteVerticesSentence: _plan_delete_vertices,
        A.DeleteEdgesSentence: _plan_delete_edges,
        A.DeleteTagsSentence: _plan_delete_tags,
        A.UpdateSentence: _plan_update,
        A.UseSentence: _plan_use,
        A.CreateSpaceSentence: lambda p, s: _admin(
            "CreateSpace", name=s.name, if_not_exists=s.if_not_exists,
            partition_num=s.partition_num, replica_factor=s.replica_factor,
            vid_type=s.vid_type),
        A.DropSpaceSentence: lambda p, s: _admin(
            "DropSpace", name=s.name, if_exists=s.if_exists),
        A.CreateSpaceAsSentence: lambda p, s: _admin(
            "CreateSpaceAs", name=s.name, source=s.source,
            if_not_exists=s.if_not_exists),
        A.CreateSchemaSentence: lambda p, s: _admin(
            "CreateSchema", is_edge=s.is_edge, name=s.name,
            props=s.props, if_not_exists=s.if_not_exists,
            ttl_duration=s.ttl_duration, ttl_col=s.ttl_col,
            space=p.need_space()),
        A.AlterSchemaSentence: lambda p, s: _admin(
            "AlterSchema", is_edge=s.is_edge, name=s.name, adds=s.adds,
            drops=s.drops, changes=s.changes, ttl_duration=s.ttl_duration,
            ttl_col=s.ttl_col, space=p.need_space()),
        A.DropSchemaSentence: lambda p, s: _admin(
            "DropSchema", is_edge=s.is_edge, name=s.name,
            if_exists=s.if_exists, space=p.need_space()),
        A.DescribeSentence: lambda p, s: _admin(
            "Describe", cols=["Field", "Type", "Null", "Default"],
            kind=s.kind, name=s.name,
            space=p.space if s.kind != "space" else None),
        A.ShowSentence: lambda p, s: _admin(
            "Show", cols=["Name"], kind=s.kind, extra=s.extra, space=p.space),
        A.CreateIndexSentence: lambda p, s: _admin(
            "CreateIndex", is_edge=s.is_edge, index_name=s.index_name,
            schema_name=s.schema_name, fields=s.fields,
            field_lens=getattr(s, "field_lens", None) or None,
            if_not_exists=s.if_not_exists, space=p.need_space()),
        A.DropIndexSentence: lambda p, s: _admin(
            "DropIndex", is_edge=s.is_edge, index_name=s.index_name,
            if_exists=s.if_exists, space=p.need_space()),
        A.RebuildIndexSentence: lambda p, s: _admin(
            "RebuildIndex", is_edge=s.is_edge, index_name=s.index_name,
            space=p.need_space()),
        A.CreateFulltextIndexSentence: lambda p, s: _admin(
            "CreateFulltextIndex", is_edge=s.is_edge,
            index_name=s.index_name, schema_name=s.schema_name,
            field=s.field, if_not_exists=s.if_not_exists,
            space=p.need_space()),
        A.DropFulltextIndexSentence: lambda p, s: _admin(
            "DropFulltextIndex", index_name=s.index_name,
            if_exists=s.if_exists, space=p.need_space()),
        A.RebuildFulltextIndexSentence: lambda p, s: _admin(
            "RebuildFulltextIndex", index_name=s.index_name,
            space=p.need_space()),
        A.AddListenerSentence: lambda p, s: _admin(
            "AddListener", ltype=s.ltype, endpoints=s.endpoints,
            space=p.need_space()),
        A.RemoveListenerSentence: lambda p, s: _admin(
            "RemoveListener", ltype=s.ltype, space=p.need_space()),
        A.SubmitJobSentence: lambda p, s: _admin(
            "SubmitJob", cols=["New Job Id"], job=s.job, space=p.space),
        A.ShowJobsSentence: lambda p, s: _admin(
            "ShowJobs", cols=["Job Id", "Command", "Status"], job_id=s.job_id),
        A.CreateSnapshotSentence: lambda p, s: _admin("CreateSnapshot"),
        A.DropSnapshotSentence: lambda p, s: _admin("DropSnapshot", name=s.name),
        A.CreateBackupSentence: lambda p, s: _admin(
            "CreateBackup", cols=["Name"], name=s.name),
        A.DropBackupSentence: lambda p, s: _admin("DropBackup", name=s.name),
        A.RestoreBackupSentence: lambda p, s: _admin(
            "RestoreBackup", cols=["Restored Spaces"], name=s.name),
        A.KillQuerySentence: lambda p, s: _admin(
            "KillQuery", session_id=s.session_id, plan_id=s.plan_id),
        A.KillSessionSentence: lambda p, s: _admin(
            "KillSession", session_id=s.session_id),
        A.UpdateConfigsSentence: lambda p, s: _admin(
            "UpdateConfigs", updates=s.updates),
        A.GetConfigsSentence: lambda p, s: _admin(
            "GetConfigs", cols=["Module", "Name", "Type", "Mode", "Value"],
            name=s.name),
        A.AddHostsSentence: lambda p, s: _admin(
            "AddHosts", hosts=s.hosts, zone=s.zone),
        A.DropHostsSentence: lambda p, s: _admin(
            "DropHosts", hosts=s.hosts),
        A.DropZoneSentence: lambda p, s: _admin(
            "DropZone", zone=s.zone),
        A.MergeZoneSentence: lambda p, s: _admin(
            "MergeZone", zones=s.zones, into=s.into),
        A.RenameZoneSentence: lambda p, s: _admin(
            "RenameZone", old=s.old, new=s.new),
        A.DivideZoneSentence: lambda p, s: _admin(
            "DivideZone", zone=s.zone, parts=s.parts),
        A.DescZoneSentence: lambda p, s: _admin(
            "DescZone", cols=["Hosts"], zone=s.zone),
        A.ClearSpaceSentence: lambda p, s: _admin(
            "ClearSpace", name=s.name, if_exists=s.if_exists),
        A.StopJobSentence: lambda p, s: _admin(
            "StopJob", cols=["Result"], job_id=s.job_id),
        A.RecoverJobSentence: lambda p, s: _admin(
            "RecoverJob", cols=["Recovered job num"], job_id=s.job_id),
        A.SignInTextServiceSentence: lambda p, s: _admin(
            "SignInTextService", endpoints=s.endpoints, user=s.user,
            password=s.password),
        A.SignOutTextServiceSentence: lambda p, s: _admin(
            "SignOutTextService"),
        A.DescribeUserSentence: lambda p, s: _admin(
            "DescribeUser", cols=["role", "space"], name=s.name),
        A.AlterSpaceSentence: lambda p, s: _admin(
            "AlterSpace", name=s.name, op=s.op, zone=s.zone),
        A.DownloadSentence: lambda p, s: _admin(
            "Download", url=s.url),
        A.IngestSentence: lambda p, s: _admin(
            "SubmitJob", cols=["New Job Id"], job="ingest", space=p.space),
        A.CreateUserSentence: lambda p, s: _admin(
            "CreateUser", name=s.name, password=s.password,
            if_not_exists=s.if_not_exists),
        A.DropUserSentence: lambda p, s: _admin(
            "DropUser", name=s.name, if_exists=s.if_exists),
        A.AlterUserSentence: lambda p, s: _admin(
            "AlterUser", name=s.name, password=s.password),
        A.ChangePasswordSentence: lambda p, s: _admin(
            "ChangePassword", name=s.name, old=s.old, new=s.new),
        A.GrantRoleSentence: lambda p, s: _admin(
            "GrantRole", role=s.role, space=s.space, user=s.user),
        A.RevokeRoleSentence: lambda p, s: _admin(
            "RevokeRole", role=s.role, space=s.space, user=s.user),
    })


_register_dispatch()
