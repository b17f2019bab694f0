"""The port's copy of `nebula_tpu/tpu/pipeline.py`, whole.

TpuMatchPipeline: columnar MATCH-pipeline fusion.

TpuMatchAgg fuses ONE chain ending in a count — but IC-shaped pipelines
(`MATCH …KNOWS*1..2` → `WITH DISTINCT` → second `MATCH` → `OPTIONAL
MATCH` → aggregate) ran their tails on per-row host executors.  This
module fuses the WHOLE pipeline: the optimizer rule compiles a
multi-clause plan subtree into one `TpuMatchPipeline` node holding a
straight-line segment program (seed / chain / vmask / vpred / edist /
project / dedup / join / agg / sort / limit / result) interpreted over
`ColumnarFrame`s — dense-id columns + null masks (exec/frame.py) — so
Python rows are never built mid-plan:

  * chains run through `GpuRuntime.traverse_hops` (one device dispatch
    per chain, through the every-hop kernels; consecutive uniform 1-hop
    Traverses merge into one multi-hop dispatch) with the same
    layered-HopFrame trail assembly TpuMatchAgg uses;
  * `WITH DISTINCT` is a lexsort dedup over id columns; joins are
    sort-merge joins over shared code spaces; `OPTIONAL MATCH` is a
    frame-level left join whose misses null-extend the right columns
    (3VL: predicates over null columns evaluate exactly like the host's
    NULL propagation);
  * aggregates are grouped counts over code columns; ORDER BY / LIMIT
    are columnar lexsorts.

Fusion bails out PER NODE at plan time — any node or expression the
compiler can't prove leaves that node (and everything above it) on the
row executors, counted in `match_pipeline_fallback{reason}`.  Parity
contract (tests/unit/test_frame_pipeline.py, run on this package by
tests/test_torch_pipeline.py): fused rows == host row-executor rows ==
brute-force oracle, including OPTIONAL MATCH null extension and
first-occurrence dedup/group order.

At run time the node answers from its stashed host subplan only where
the reference's outcome is no device fault: a `CannotCompile` raised
while running (a store without a dense-id surface among them, recorded
in `qctx.last_tpu_fallback`), an injected `FailpointError` (a test
instrument: the `tpu:dispatch` site stands for a rejected dispatch),
the dispatch-queue shed (`_dispatch_overloaded`), and the
`tpu_match_device` flag off.  A `SnapshotRetired` (a rebuild or a
compaction's swap replaced the snapshot mid-run) runs the whole program
again on the snapshot now pinned, up to `RETIRED_ATTEMPTS` runs, as
`traverse.run_on_device` does.  A `GpuUnavailable`, a CUDA error or a
failed kernel build is the statement's error: no fallback hides the
card.  `QueryKilled` and `DeadlineExceeded` propagate, as in the
reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core import expr as E
from ..core.expr import to_bool3
from ..core.value import NULL, DataSet, ColumnarDataSet, is_null
from ..exec.context import RowContext
from ..exec.executors import executor, run_node
from ..exec.frame import (ColumnarFrame, EdgeCol, OpaqueCol, ValCol,
                          VidCol, col_codes, group_ids, join_codes,
                          materialize_column)
from ..graphstore.csr import INT_NULL
from ..graphstore.schema import PropType
from ..query import optimizer as opt
from ..query.plan import PlanNode, walk_plan
from ..utils import admission as _admission  # noqa: F401 — defines the
# overload flags (tpu_dispatch_queue_cap) before any config lookup
from ..utils import cancel as _cancel
from ..utils import trace
from ..utils.failpoints import FailpointError, fail
from ..utils.config import define_flag, get_config
from ..utils.stats import stats
from ..utils.workload import current_live, dispatch_table
from .device import SnapshotRetired
from .exprjit import (CannotCompile, compilable,
                      compile_vertex_predicate_np, merged_attr_columns,
                      merged_attr_raw, vertex_compilable)
from .match_agg import _exists_flat, _seed_vids, _tag_flat
from .runtime import (HopFrame, TraverseStats, _d2v, join_frontier_trails,
                      trail_distinct_keep)
from .traverse import RETIRED_ATTEMPTS

define_flag("tpu_match_pipeline", True,
            "fuse multi-clause MATCH pipelines into one columnar "
            "device node (off = only single-chain fusions)")


# ---------------------------------------------------------------------------
# Compile-time schema
# ---------------------------------------------------------------------------


class _Sch:
    """Per-register column typing: name → kind, plus which vertex
    columns carry an existence check (prop reads / predicates are only
    valid on checked columns — host parity over shell vertices)."""
    __slots__ = ("names", "kinds", "checked")

    def __init__(self, names, kinds, checked):
        self.names = list(names)
        self.kinds = dict(kinds)
        self.checked = set(checked)

    def copy(self) -> "_Sch":
        return _Sch(self.names, self.kinds, self.checked)


class _Stash:
    """Original subtree kept for the runtime host fallback; repr-opaque
    so EXPLAIN doesn't inline the whole subplan."""
    __slots__ = ("node",)

    def __init__(self, node: PlanNode):
        self.node = node

    def __repr__(self):
        return f"<subplan {self.node.kind}#{self.node.id}>"


def _is_count_agg(e: E.Expr) -> bool:
    return isinstance(e, E.AggExpr) and e.func == "count"


def _rehome_edge_filter(ef: E.Expr, alias: Optional[str]) -> E.Expr:
    """A Traverse edge filter references the edge via its pattern alias
    (`membership.joinDate > …`); the device predicate compiler speaks
    `__edge__`.  Rewrite alias-qualified prop reads onto the traversed
    edge — the same binding the row executor's RowContext installs."""
    if not alias:
        return ef

    def sub(x: E.Expr):
        if isinstance(x, E.AttributeExpr) and isinstance(x.obj, E.LabelExpr) \
                and x.obj.name == alias:
            return E.EdgeProp("__edge__", x.attr)
        if isinstance(x, E.EdgeProp) and x.edge == alias:
            return E.EdgeProp("__edge__", x.name)
        return None

    return E.rewrite(ef, sub)


# ---------------------------------------------------------------------------
# Compiler: plan subtree → segment program
# ---------------------------------------------------------------------------


class _Compiler:
    def __init__(self, uses: Dict[int, int]):
        self.uses = uses
        self.ops: List[Dict[str, Any]] = []
        self.schemas: List[_Sch] = []
        self.var2reg: Dict[str, int] = {}
        self.gone_vars: set = set()      # absorbed, not register-backed
        self.nodes: set = set()
        self.space: Optional[str] = None
        self.memo: Dict[int, int] = {}
        self.n_chains = 0

    # -- helpers ---------------------------------------------------------

    def _emit(self, op: Dict[str, Any], sch: _Sch) -> int:
        self.ops.append(op)
        self.schemas.append(sch)
        op["out"] = len(self.schemas) - 1
        return op["out"]

    def _space(self, sp) -> None:
        if sp is None:
            raise CannotCompile("node without space")
        if self.space is None:
            self.space = sp
        elif self.space != sp:
            raise CannotCompile("cross-space pipeline")

    def _vid_col(self, sch: _Sch, name: str) -> None:
        if sch.kinds.get(name) != "vid":
            raise CannotCompile(f"column {name!r} is not a vertex column")

    # -- entry -----------------------------------------------------------

    def compile(self, node: PlanNode) -> int:
        got = self.memo.get(node.id)
        if got is not None:
            return got
        fn = _NODE_COMPILERS.get(node.kind)
        if fn is None:
            raise CannotCompile(f"node:{node.kind}")
        reg = fn(self, node)
        self.memo[node.id] = reg
        self.var2reg[node.output_var] = reg
        self.nodes.add(node.id)
        return reg

    # -- leaves ----------------------------------------------------------

    def _c_get_vertices(self, node: PlanNode) -> int:
        a = node.args
        self._space(a.get("space"))
        if a.get("src_col") or a.get("tags"):
            raise CannotCompile("GetVertices over input rows")
        if node.deps and not (len(node.deps) == 1
                              and node.dep().kind == "Start"):
            raise CannotCompile("GetVertices with deps")
        vids = a.get("vids") or []
        for v in vids:
            if isinstance(v, E.Expr) and not isinstance(v, E.Literal):
                raise CannotCompile("non-literal seed vid")
        alias = a.get("as_col") or (node.col_names[0] if node.col_names
                                    else None)
        if not alias:
            raise CannotCompile("GetVertices without alias")
        sch = _Sch([alias], {alias: "vid"}, {alias})
        return self._emit({"op": "seed", "vids": list(vids),
                           "alias": alias}, sch)

    def _c_argument(self, node: PlanNode) -> int:
        fv = node.args.get("from_var")
        reg = self.var2reg.get(fv)
        if reg is None:
            raise CannotCompile("argument-outside-region")
        col = node.args.get("col")
        src = self.schemas[reg]
        self._vid_col(src, col)
        sch = _Sch([col], {col: "vid"},
                   {col} if col in src.checked else ())
        return self._emit({"op": "argument", "in": reg, "col": col}, sch)

    # -- chains ----------------------------------------------------------

    def _c_traverse(self, node: PlanNode) -> int:
        a = node.args
        self._space(a.get("space"))
        etypes = list(a.get("edge_types") or [])
        direction = a.get("direction")
        min_hop, max_hop = a.get("min_hop"), a.get("max_hop")
        if min_hop is None or max_hop is None or max_hop < 1 \
                or min_hop < 0 or min_hop > max_hop:
            raise CannotCompile("unbounded or malformed hop range")
        var_len = not (min_hop == 1 and max_hop == 1)
        ef = a.get("edge_filter")
        if ef is not None:
            ef = _rehome_edge_filter(ef, a.get("edge_filter_alias"))
            if not compilable(ef, etypes):
                raise CannotCompile("edge filter not device-compilable")

        # merge a chain of uniform 1-hop Traverses (with optional
        # filter-compilable AppendVertices between them) into ONE
        # multi-hop device dispatch — the TpuMatchAgg chain walk,
        # generalized to any pipeline position
        chain = [node]            # outermost (= last hop) first
        mid_specs: Dict[int, PlanNode] = {}   # index into chain → AppendV
        cur = node.dep()
        if not var_len and ef is None:
            while True:
                spec = None
                nxt = cur
                if nxt.kind == "AppendVertices" \
                        and self.uses.get(nxt.id, 2) == 1 \
                        and len(nxt.deps) == 1 \
                        and nxt.args.get("space") == a.get("space") \
                        and nxt.args.get("col") == chain[-1].args.get(
                            "src_col") \
                        and nxt.dep().kind == "Traverse":
                    filt = nxt.args.get("filter")
                    if filt is not None and not vertex_compilable(
                            filt, nxt.args.get("col")):
                        break
                    spec = nxt
                    nxt = nxt.dep()
                if nxt.kind != "Traverse" \
                        or self.uses.get(nxt.id, 2) != 1:
                    break
                ia = nxt.args
                if (ia.get("edge_types") != a.get("edge_types")
                        or ia.get("direction") != direction
                        or ia.get("space") != a.get("space")
                        or ia.get("min_hop") != 1 or ia.get("max_hop") != 1
                        or ia.get("edge_filter") is not None
                        or ia.get("dst_alias") != chain[-1].args.get(
                            "src_col")):
                    break
                if spec is not None:
                    mid_specs[len(chain)] = spec
                    self.nodes.add(spec.id)
                    self.gone_vars.add(spec.output_var)
                chain.append(nxt)
                cur = nxt.dep()
        hops_nodes = chain[::-1]               # innermost (hop 1) first

        in_reg = self.compile(cur)
        in_sch = self.schemas[in_reg]
        src_col = hops_nodes[0].args.get("src_col")
        self._vid_col(in_sch, src_col)

        names = list(in_sch.names)
        kinds = dict(in_sch.kinds)
        checked = set(in_sch.checked)
        hops: List[Dict[str, Any]] = []
        steps = max_hop if var_len else len(hops_nodes)
        for i, h in enumerate(hops_nodes):
            ha = h.args
            e_alias, d_alias = ha.get("edge_alias"), ha.get("dst_alias")
            if not e_alias or not d_alias or e_alias in kinds \
                    or d_alias in kinds or e_alias == d_alias:
                raise CannotCompile("alias rebound inside a chain")
            spec = mid_specs.get(len(hops_nodes) - 1 - i)
            hop = {"edge": e_alias, "dst": d_alias,
                   "labels": list(spec.args.get("labels") or [])
                   if spec is not None else [],
                   "pred": spec.args.get("filter")
                   if spec is not None else None,
                   "checked": spec is not None}
            hops.append(hop)
            kinds[e_alias] = "opaque" if var_len else "edge"
            kinds[d_alias] = "vid"
            if spec is not None:
                checked.add(d_alias)
            names += [e_alias, d_alias]
            self.nodes.add(h.id)
            if h is not node:
                self.gone_vars.add(h.output_var)
        self.n_chains += 1
        sch = _Sch(names, kinds, checked)
        return self._emit(
            {"op": "chain", "in": in_reg, "src": src_col,
             "etypes": etypes, "direction": direction,
             "min_hop": min_hop if var_len else steps, "steps": steps,
             "var_len": var_len, "edge_filter": ef, "hops": hops}, sch)

    def _c_append_vertices(self, node: PlanNode) -> int:
        a = node.args
        self._space(a.get("space"))
        in_reg = self.compile(node.dep())
        sch = self.schemas[in_reg].copy()
        col = a.get("col")
        self._vid_col(sch, col)
        filt = a.get("filter")
        if filt is not None and not vertex_compilable(filt, col):
            raise CannotCompile("vertex filter not compilable")
        sch.checked.add(col)
        return self._emit({"op": "vmask", "in": in_reg, "col": col,
                           "labels": list(a.get("labels") or []),
                           "pred": filt}, sch)

    # -- row-set ops -----------------------------------------------------

    def _c_filter(self, node: PlanNode) -> int:
        cond = node.args.get("condition")
        if cond is None:
            raise CannotCompile("filter without condition")
        reg = self.compile(node.dep())
        sch = self.schemas[reg]
        for c in E.split_conjuncts(cond):
            if (isinstance(c, E.FunctionCall)
                    and c.name == "_edges_distinct"
                    and all(isinstance(x, E.LabelExpr) for x in c.args)):
                aliases = [x.name for x in c.args]
                for al in aliases:
                    if sch.kinds.get(al) != "edge":
                        raise CannotCompile(
                            "edge-uniqueness over a var-len binding")
                reg = self._emit({"op": "edist", "in": reg,
                                  "aliases": aliases}, sch.copy())
                sch = self.schemas[reg]
                continue
            placed = False
            for al in sch.names:
                if sch.kinds.get(al) == "vid" and al in sch.checked \
                        and vertex_compilable(c, al):
                    reg = self._emit({"op": "vpred", "in": reg,
                                      "alias": al, "pred": c}, sch.copy())
                    sch = self.schemas[reg]
                    placed = True
                    break
            if not placed:
                raise CannotCompile("filter conjunct not columnar")
        return reg

    def _col_desc(self, e: E.Expr, sch: _Sch) -> Tuple:
        if isinstance(e, (E.LabelExpr, E.InputProp)) \
                and e.name in sch.kinds:
            if sch.kinds[e.name] == "opaque":
                raise CannotCompile("opaque column read")
            return ("col", e.name)
        if (isinstance(e, E.FunctionCall) and e.name == "id"
                and len(e.args) == 1
                and isinstance(e.args[0], E.LabelExpr)
                and sch.kinds.get(e.args[0].name) == "vid"):
            return ("id", e.args[0].name)
        if isinstance(e, E.LabelTagProp) \
                and sch.kinds.get(e.var) == "vid":
            if e.var not in sch.checked:
                # host shells answer NULL for every prop — the snapshot
                # gather would answer real values; refuse
                raise CannotCompile("prop read on unchecked column")
            return ("prop", e.var, e.tag, e.prop)
        if isinstance(e, E.AttributeExpr) \
                and isinstance(e.obj, E.LabelExpr) \
                and sch.kinds.get(e.obj.name) == "vid":
            if e.obj.name not in sch.checked:
                raise CannotCompile("prop read on unchecked column")
            return ("vattr", e.obj.name, e.attr)
        if isinstance(e, E.Literal) and (
                e.value is None
                or isinstance(e.value, (bool, int, float, str))):
            return ("lit", e.value)
        raise CannotCompile(f"expression not columnar: {e.kind}")

    def _desc_kind(self, d: Tuple, sch: _Sch) -> Tuple[str, bool]:
        if d[0] == "col":
            return sch.kinds[d[1]], d[1] in sch.checked
        return ("val", False)

    def _c_project(self, node: PlanNode) -> int:
        a = node.args
        if a.get("empty"):
            raise CannotCompile("empty-marker project")
        if any(a.get(f) for f in ("go_row", "lookup_row", "fetch_row")):
            raise CannotCompile("non-MATCH project context")
        reg = self.compile(node.dep())
        sch = self.schemas[reg]
        descs, names, kinds, checked = [], [], {}, set()
        for e, n in a.get("columns") or []:
            d = self._col_desc(e, sch)
            descs.append((d, n))
            names.append(n)
            k, ck = self._desc_kind(d, sch)
            kinds[n] = k
            if ck:
                checked.add(n)
        return self._emit({"op": "project", "in": reg, "cols": descs},
                          _Sch(names, kinds, checked))

    def _c_dedup(self, node: PlanNode) -> int:
        reg = self.compile(node.dep())
        sch = self.schemas[reg]
        if any(sch.kinds[n] == "opaque" for n in sch.names):
            raise CannotCompile("dedup over a var-len binding")
        return self._emit({"op": "dedup", "in": reg}, sch.copy())

    def _c_join(self, node: PlanNode, outer: bool) -> int:
        keys = node.args.get("keys") or []
        if len(node.deps) != 2 or not keys:
            raise CannotCompile("join shape")
        l = self.compile(node.dep(0))
        r = self.compile(node.dep(1))
        ls, rs = self.schemas[l], self.schemas[r]
        for k in keys:
            lk, rk = ls.kinds.get(k), rs.kinds.get(k)
            if lk is None or rk is None or lk != rk \
                    or lk not in ("vid", "val"):
                raise CannotCompile("join key not columnar")
        r_extra = [n for n in rs.names if n not in ls.names]
        names = list(ls.names) + r_extra
        kinds = dict(ls.kinds)
        checked = set(ls.checked)
        for n in r_extra:
            kinds[n] = rs.kinds[n]
            if n in rs.checked:
                checked.add(n)
        return self._emit({"op": "join", "left": l, "right": r,
                           "keys": list(keys), "outer": outer,
                           "r_extra": r_extra},
                          _Sch(names, kinds, checked))

    def _c_aggregate(self, node: PlanNode) -> int:
        a = node.args
        reg = self.compile(node.dep())
        sch = self.schemas[reg]
        group_keys = a.get("group_keys") or []
        key_descs = [self._col_desc(k, sch) for k in group_keys]
        key_texts = [E.to_text(k) for k in group_keys]
        cols = []
        names, kinds, checked = [], {}, set()
        for e, n in a.get("columns") or []:
            names.append(n)
            if _is_count_agg(e):
                if e.arg is None:
                    cols.append((("count", None, False), n))
                else:
                    d = self._col_desc(e.arg, sch)
                    cols.append((("count", d, bool(e.distinct)), n))
                kinds[n] = "val"
                continue
            txt = E.to_text(e)
            if txt in key_texts:
                ki = key_texts.index(txt)
                cols.append((("key", ki), n))
                k, ck = self._desc_kind(key_descs[ki], sch)
                kinds[n] = k
                if ck:
                    checked.add(n)
                continue
            raise CannotCompile("aggregate column not a count/group key")
        return self._emit({"op": "agg", "in": reg, "keys": key_descs,
                           "cols": cols}, _Sch(names, kinds, checked))

    def _c_sort(self, node: PlanNode, topn: bool) -> int:
        a = node.args
        reg = self.compile(node.dep())
        sch = self.schemas[reg]
        factors = []
        for e, asc in a.get("factors") or []:
            d = self._col_desc(e, sch)
            if d[0] == "col" and sch.kinds[d[1]] == "edge":
                raise CannotCompile("sort key over an edge column")
            if d[0] == "lit":
                continue                     # constant key: no-op factor
            factors.append((d, bool(asc)))
        op = {"op": "sort", "in": reg, "factors": factors}
        if topn:
            op["offset"] = a.get("offset", 0) or 0
            op["count"] = a.get("count")
        return self._emit(op, sch.copy())

    def _c_limit(self, node: PlanNode) -> int:
        reg = self.compile(node.dep())
        return self._emit({"op": "limit", "in": reg,
                           "offset": node.args.get("offset", 0) or 0,
                           "count": node.args.get("count")},
                          self.schemas[reg].copy())


_NODE_COMPILERS = {
    "GetVertices": _Compiler._c_get_vertices,
    "Argument": _Compiler._c_argument,
    "Traverse": _Compiler._c_traverse,
    "AppendVertices": _Compiler._c_append_vertices,
    "Filter": _Compiler._c_filter,
    "Project": _Compiler._c_project,
    "Dedup": _Compiler._c_dedup,
    "HashInnerJoin": lambda c, n: _Compiler._c_join(c, n, False),
    "HashLeftJoin": lambda c, n: _Compiler._c_join(c, n, True),
    "Aggregate": _Compiler._c_aggregate,
    "Sort": lambda c, n: _Compiler._c_sort(c, n, False),
    "TopN": lambda c, n: _Compiler._c_sort(c, n, True),
    "Limit": _Compiler._c_limit,
}


# ---------------------------------------------------------------------------
# Fusion rule
# ---------------------------------------------------------------------------

_ROOT_KINDS = frozenset((
    "TopN", "Sort", "Limit", "Aggregate", "Project", "Dedup",
    "HashInnerJoin", "HashLeftJoin", "Filter"))
_TAIL_KINDS = frozenset((
    "Dedup", "HashInnerJoin", "HashLeftJoin", "Aggregate"))


def make_match_pipeline_rule(uses: Dict[int, int],
                             root: Optional[PlanNode] = None):
    if not get_config().get("tpu_match_pipeline"):
        return lambda node: None
    # Argument nodes anywhere in the plan: fusing a region one of them
    # reads INTO from outside would orphan its from_var
    plan_args = [] if root is None else \
        [(n.id, n.args.get("from_var"))
         for n in walk_plan(root) if n.kind == "Argument"]
    state = {"counted": False}

    def rule(node: PlanNode) -> Optional[PlanNode]:
        if node.kind not in _ROOT_KINDS:
            return None
        kinds = set()
        n_traverse = 0
        for n in walk_plan(node):
            kinds.add(n.kind)
            if n.kind == "Traverse":
                n_traverse += 1
        if n_traverse == 0:
            return None
        if not (kinds & _TAIL_KINDS) and n_traverse < 2:
            return None                  # single-clause: existing rules
        try:
            c = _Compiler(uses)
            out = c.compile(node)
            for n in node.col_names:
                if c.schemas[out].kinds.get(n) == "opaque":
                    raise CannotCompile("var-len binding at the boundary")
            for aid, fv in plan_args:
                if aid not in c.nodes and (fv in c.var2reg
                                           or fv in c.gone_vars):
                    raise CannotCompile("region referenced from outside")
            c.ops.append({"op": "result", "in": out,
                          "cols": list(node.col_names)})
        except CannotCompile as ex:
            if not state["counted"]:
                state["counted"] = True
                stats().inc_labeled(
                    "match_pipeline_fallback",
                    {"stage": "plan", "reason": str(ex)[:60]})
            return None
        stats().inc("match_pipeline_fused_plans")
        return PlanNode(
            "TpuMatchPipeline", deps=[],
            args={"space": c.space, "ops": c.ops,
                  "n_chains": c.n_chains,
                  "fallback": _Stash(node)},
            col_names=list(node.col_names))

    return rule


opt.TPU_RULES.append(make_match_pipeline_rule)


# ---------------------------------------------------------------------------
# Runtime: segment interpreter over ColumnarFrames
# ---------------------------------------------------------------------------


def _vertex_mask_fn(snap, sd, alias, labels, pred, check_exists=True):
    """Combined existence + label + predicate mask over dense ids
    (compile once, evaluate per batch — same contract as
    match_agg._position_mask_fn)."""
    tag_flats = []
    dead = False
    for lb in labels:
        tf = _tag_flat(snap, lb)
        if tf is None:
            dead = True
            break
        tag_flats.append(tf)
    pred_fn = compile_vertex_predicate_np(pred, alias, snap, sd) \
        if pred is not None else None
    exists = _exists_flat(snap) if check_exists else None

    def mask(dense: np.ndarray) -> np.ndarray:
        if dead:
            return np.zeros(dense.shape, bool)
        m = exists[dense] if exists is not None \
            else np.ones(dense.shape, bool)
        for tf in tag_flats:
            m &= tf[dense]
        if pred_fn is not None:
            m &= pred_fn(dense)
        return m

    return mask


def _null_extend(col, n: int):
    """An all-null column shaped like `col` with n rows (left-join miss
    extension)."""
    ones = np.ones(n, bool)
    if col.kind == "vid":
        return VidCol(np.zeros(n, np.int64), ones, col.checked)
    if col.kind == "val":
        dt = col.vals.dtype
        return ValCol(np.zeros(n, dt) if dt != object
                      else np.full(n, None, object), ones, col.vkind)
    if col.kind == "edge":
        z = np.zeros(n, np.int64)
        return EdgeCol(z, z, z, z, col.frame, z, ones)
    return OpaqueCol()


class _Runner:
    def __init__(self, qctx, ectx, rt, space: str):
        self.qctx, self.ectx, self.rt = qctx, ectx, rt
        self.space = space
        store = qctx.store
        try:
            sd = store.space(space)
            sd.dense_id
        except AttributeError:
            # no device fault: the reference's outcome, the host subplan
            raise CannotCompile("store has no dense-id surface") from None
        self.store, self.sd = store, sd
        self.dev = rt.pin(store, space)
        self.snap = self.dev.host
        self.d2v = _d2v(self.snap)
        self.regs: List[ColumnarFrame] = []
        self.stats = TraverseStats()

    # -- ops -------------------------------------------------------------

    def run(self, ops: List[Dict[str, Any]]):
        import time as _time
        out = None
        for op in ops:
            # KILL QUERY / deadline between segments: a kill lands at
            # the next segment instead of after the whole program
            _cancel.check()
            # per-SEGMENT attribution: each segment records its own wall
            # time, output rows and device-dispatch delta, so PROFILE
            # breaks the fused node down instead of reporting one
            # opaque TpuMatchPipeline row
            t0 = _time.perf_counter()
            dev0 = self.stats.device_s
            # live workload row: SHOW QUERIES shows WHICH fused segment
            # is running, not just the opaque TpuMatchPipeline node
            lv = current_live()
            if lv is not None:
                lv.set_operator(f"TpuMatchPipeline/{op['op']}")
            out = getattr(self, "_x_" + op["op"])(op)
            seg = {"op": op["op"],
                   "us": int((_time.perf_counter() - t0) * 1e6)}
            dev_us = int((self.stats.device_s - dev0) * 1e6)
            if dev_us:
                seg["device_us"] = dev_us
            if isinstance(out, ColumnarFrame):
                self.regs.append(out)
                seg["rows"] = out.n
            elif out is not None and hasattr(out, "rows"):
                try:
                    seg["rows"] = len(out)
                except TypeError:
                    pass
            self.stats.segments.append(seg)
        return out

    def _frame(self, op, key="in") -> ColumnarFrame:
        return self.regs[op[key]]

    def _x_seed(self, op) -> ColumnarFrame:
        vids = _seed_vids({"vids": op["vids"]})
        ds = []
        for v in vids:
            d = self.sd.dense_id(v)
            ds.append(-1 if d is None else int(d))
        dense = np.asarray(ds, np.int64) if ds else np.empty(0, np.int64)
        if dense.size:
            dense = dense[dense >= 0]
            dense = dense[_exists_flat(self.snap)[dense]]
        alias = op["alias"]
        return ColumnarFrame(int(dense.size), [alias],
                             {alias: VidCol(dense, checked=True)})

    def _x_argument(self, op) -> ColumnarFrame:
        f = self._frame(op)
        col = f.col(op["col"])
        _, reps = group_ids(col_codes(col, f.n), f.n)
        return ColumnarFrame(int(reps.size), [op["col"]],
                             {op["col"]: col.take(reps)})

    def _x_vmask(self, op) -> ColumnarFrame:
        f = self._frame(op)
        col = f.col(op["col"])
        nn = ~col.null_mask(f.n)
        keep = np.zeros(f.n, bool)
        if nn.any():
            mfn = _vertex_mask_fn(self.snap, self.sd, op["col"],
                                  op["labels"], op["pred"])
            d = col.dense[nn]
            keep[nn] = mfn(d)
        out = f.take(np.flatnonzero(keep))
        oc = out.cols[op["col"]]
        out.cols[op["col"]] = VidCol(oc.dense, oc.null, True)
        return out

    def _x_vpred(self, op) -> ColumnarFrame:
        f = self._frame(op)
        col = f.col(op["alias"])
        nullm = col.null_mask(f.n)
        keep = np.zeros(f.n, bool)
        nn = ~nullm
        if nn.any():
            mfn = _vertex_mask_fn(self.snap, self.sd, op["alias"], [],
                                  op["pred"], check_exists=False)
            keep[nn] = mfn(col.dense[nn])
        if nullm.any():
            # every null row evaluates the predicate with the alias
            # bound to NULL — one constant 3VL evaluation (IS NULL forms
            # keep such rows; anything else propagates NULL → dropped)
            rc = RowContext(self.qctx, self.space, {op["alias"]: NULL})
            keep[nullm] = to_bool3(op["pred"].eval(rc)) is True
        return f.take(np.flatnonzero(keep))

    def _x_edist(self, op) -> ColumnarFrame:
        f = self._frame(op)
        cols = [f.col(a) for a in op["aliases"]]
        keep = np.ones(f.n, bool)
        for i in range(len(cols)):
            for j in range(i + 1, len(cols)):
                a, b = cols[i], cols[j]
                eq = ((a.et == b.et) & (a.ks == b.ks)
                      & (a.kd == b.kd) & (a.rank == b.rank))
                eq &= ~a.null_mask(f.n) & ~b.null_mask(f.n)
                keep &= ~eq
        return f.take(np.flatnonzero(keep))

    def _x_chain(self, op) -> ColumnarFrame:
        f = self._frame(op)
        col = f.col(op["src"])
        nullm = col.null_mask(f.n)
        codes = col.dense.copy()
        codes[nullm] = -1
        gid, reps = group_ids([codes], f.n)
        rep_vals = codes[reps]
        live = rep_vals >= 0
        seed_dense = rep_vals[live]
        g2s = np.full(reps.size, -1, np.int64)
        g2s[live] = np.arange(int(live.sum()), dtype=np.int64)
        row_seed = g2s[gid]                 # -1 on null-src rows
        n_seeds = int(seed_dense.size)

        steps = op["steps"]
        hops = op["hops"]
        if n_seeds:
            # chaos site: an armed raise here stands for a rejected
            # dispatch; the executor answers from the stashed row
            # subplan, as the reference's does
            fail.hit("tpu:dispatch", key=self.space)
            vids = [self.d2v[d] for d in seed_dense.tolist()]
            frames, st = self.rt.traverse_hops(
                self.store, self.space, vids, op["etypes"],
                op["direction"], steps, edge_filter=op["edge_filter"])
            self._merge_stats(st)
        else:
            frames = [HopFrame.empty() for _ in range(steps)]

        tracker = getattr(self.ectx, "tracker", None)
        new_names = []
        for h in hops:
            new_names += [h["edge"], h["dst"]]

        if op["var_len"]:
            min_hop = op["min_hop"]
            em_ord: List[np.ndarray] = []
            em_dst: List[np.ndarray] = []
            sidx = np.arange(n_seeds, dtype=np.int64)
            last = seed_dense
            path: List[np.ndarray] = []
            if min_hop == 0:
                em_ord.append(sidx.copy())
                em_dst.append(seed_dense.copy())
            for h in range(steps):
                if last.size == 0 or frames[h].n == 0:
                    break
                parent, fidx = join_frontier_trails(frames[h], last)
                if fidx.size == 0:
                    break
                if path:
                    keep = trail_distinct_keep(frames, path, parent,
                                               frames[h], fidx)
                    sel = np.flatnonzero(keep)
                    parent, fidx = parent[sel], fidx[sel]
                    if fidx.size == 0:
                        break
                sidx = sidx[parent]
                last = frames[h].dst[fidx]
                path = [p[parent] for p in path] + [fidx]
                if tracker is not None:
                    tracker.charge(int(fidx.size) * 8 * (h + 2))
                if h + 1 >= max(min_hop, 1):
                    em_ord.append(sidx)
                    em_dst.append(last)
            ords = np.concatenate(em_ord) if em_ord \
                else np.empty(0, np.int64)
            dsts = np.concatenate(em_dst) if em_dst \
                else np.empty(0, np.int64)
            new_cols = {hops[0]["edge"]: OpaqueCol(),
                        hops[0]["dst"]: VidCol(dsts, checked=False)}
            return self._attach(f, row_seed, n_seeds, ords,
                                new_names, new_cols)

        # fixed-length (possibly merged) chain: assemble trails hop by
        # hop, pruning each mid position by its absorbed AppendVertices
        sidx = np.arange(n_seeds, dtype=np.int64)
        vcols = [seed_dense]
        path: List[np.ndarray] = []
        for h in range(steps):
            if vcols[-1].size == 0 or frames[h].n == 0:
                sidx = np.empty(0, np.int64)
                vcols = [np.empty(0, np.int64)] * (steps + 1)
                path = [np.empty(0, np.int64)] * steps
                break
            parent, fidx = join_frontier_trails(frames[h], vcols[-1])
            nxt = frames[h].dst[fidx]
            hop = hops[h]
            if hop["checked"] and fidx.size:
                mfn = _vertex_mask_fn(self.snap, self.sd, hop["dst"],
                                      hop["labels"], hop["pred"])
                sel = np.flatnonzero(mfn(nxt))
                parent, fidx, nxt = parent[sel], fidx[sel], nxt[sel]
            sidx = sidx[parent]
            vcols = [c[parent] for c in vcols] + [nxt]
            path = [p[parent] for p in path] + [fidx]
            if tracker is not None and fidx.size:
                tracker.charge(int(fidx.size) * 8 * (h + 2))
        new_cols = {}
        for h, hop in enumerate(hops):
            new_cols[hop["edge"]] = EdgeCol.from_frame(frames[h], path[h]) \
                if path[h].size or frames[h].n else \
                EdgeCol.from_frame(frames[h], np.empty(0, np.int64))
            new_cols[hop["dst"]] = VidCol(vcols[h + 1],
                                          checked=hop["checked"])
        return self._attach(f, row_seed, n_seeds, sidx,
                            new_names, new_cols)

    def _attach(self, f: ColumnarFrame, row_seed: np.ndarray,
                n_seeds: int, ords: np.ndarray, new_names: List[str],
                new_cols: Dict[str, Any]) -> ColumnarFrame:
        """Join chain emissions (ords = seed ordinal per emission, in
        chain order) back to the input rows: per input row, its seed's
        emissions in chain order — the host Traverse's (input row,
        expansion) nesting."""
        order = np.argsort(ords, kind="stable")
        so = ords[order]
        starts = np.searchsorted(so, np.arange(n_seeds, dtype=np.int64))
        ends = np.searchsorted(so, np.arange(1, n_seeds + 1,
                                             dtype=np.int64))
        safe = np.maximum(row_seed, 0)
        cnt = np.where(row_seed >= 0, ends[safe] - starts[safe], 0) \
            if n_seeds else np.zeros(f.n, np.int64)
        ecum = np.cumsum(cnt)
        total = int(ecum[-1]) if cnt.size else 0
        if total == 0:
            prow = np.empty(0, np.int64)
            esel = np.empty(0, np.int64)
        else:
            k = np.arange(total, dtype=np.int64)
            prow = np.searchsorted(ecum, k, side="right")
            within = k - (ecum[prow] - cnt[prow])
            esel = order[starts[row_seed[prow]] + within]
        out_cols = {nm: f.cols[nm].take(prow) for nm in f.names}
        for nm in new_names:
            out_cols[nm] = new_cols[nm].take(esel)
        return ColumnarFrame(total, list(f.names) + new_names, out_cols)

    def _x_project(self, op) -> ColumnarFrame:
        f = self._frame(op)
        cols, names = {}, []
        for d, n in op["cols"]:
            cols[n] = self._desc_col(f, d)
            names.append(n)
        return ColumnarFrame(f.n, names, cols)

    def _desc_col(self, f: ColumnarFrame, d: Tuple):
        if d[0] == "col":
            return f.col(d[1])
        if d[0] == "id":
            col = f.col(d[1])
            vals = self.d2v[col.dense]
            vk = "int" if vals.dtype != object else "obj"
            return ValCol(vals, col.null, vk)
        if d[0] == "prop":
            return self._prop_col(f, d[1], d[2], d[3])
        if d[0] == "vattr":
            return self._attr_col(f, d[1], d[2])
        if d[0] == "lit":
            v = d[1]
            n = f.n
            if v is None or is_null(v):
                return ValCol(np.zeros(n, np.int64), np.ones(n, bool),
                              "int")
            if isinstance(v, bool):
                return ValCol(np.full(n, v, bool), None, "bool")
            if isinstance(v, int):
                return ValCol(np.full(n, v, np.int64), None, "int")
            if isinstance(v, float):
                return ValCol(np.full(n, v, np.float64), None, "float")
            return ValCol(np.full(n, v, object), None, "str")
        raise CannotCompile(f"descriptor {d[0]}")

    def _prop_col(self, f: ColumnarFrame, alias: str, tag: str,
                  prop: str) -> ValCol:
        col = f.col(alias)
        n = f.n
        nullm = col.null_mask(n).copy()
        tt = self.snap.tags.get(tag)
        if tt is None or prop not in tt.props:
            return ValCol(np.zeros(n, np.int64), np.ones(n, bool), "int")
        P = self.snap.num_parts
        d = np.where(nullm, 0, col.dense)
        raw = tt.props[prop][d % P, d // P]
        pt = tt.prop_types[prop]
        return self._decode_raw(raw, pt, nullm, n)

    def _attr_col(self, f: ColumnarFrame, alias: str, prop: str) -> ValCol:
        """Tag-less `v.prop`: merged across every tag carrying the prop
        (exprjit.merged_attr_columns — later tag wins), then decoded."""
        col = f.col(alias)
        n = f.n
        nullm = col.null_mask(n).copy()
        parts = merged_attr_columns(self.snap, prop)
        if not parts:
            return ValCol(np.zeros(n, np.int64), np.ones(n, bool), "int")
        pts = {p[3] for p in parts}
        if len(pts) > 1:
            raise CannotCompile(f"attr {prop} mixes prop types")
        d = np.where(nullm, 0, col.dense)
        raw = merged_attr_raw(self.snap, parts, d)
        return self._decode_raw(raw, parts[0][3], nullm, n)

    def _decode_raw(self, raw: np.ndarray, pt, nullm: np.ndarray,
                    n: int) -> ValCol:
        if pt in (PropType.FLOAT, PropType.DOUBLE):
            vals = raw.astype(np.float64)
            return ValCol(vals, nullm | np.isnan(vals), "float")
        if pt == PropType.BOOL:
            return ValCol(raw != 0, nullm | (raw == INT_NULL), "bool")
        if pt in (PropType.STRING, PropType.FIXED_STRING):
            pool = self.snap.pool
            ns = len(pool.strings)
            bad = (raw < 0) | (raw >= ns)
            if ns == 0:
                vals = np.full(n, None, object)
            else:
                vals = pool.obj_array()[np.where(bad, 0, raw)]
            return ValCol(vals, nullm | bad, "str")
        if pt in (PropType.DATE, PropType.DATETIME, PropType.TIME,
                  PropType.DURATION, PropType.GEOGRAPHY):
            from ..graphstore.csr import decode_prop
            nullm = nullm | (raw == INT_NULL)
            vals = np.empty(n, object)
            nn = np.flatnonzero(~nullm)
            for i in nn.tolist():
                vals[i] = decode_prop(pt, raw[i], self.snap.pool)
            return ValCol(vals, nullm, "obj")
        return ValCol(raw.astype(np.int64), nullm | (raw == INT_NULL),
                      "int")

    def _x_dedup(self, op) -> ColumnarFrame:
        f = self._frame(op)
        codes: List[np.ndarray] = []
        for nm in f.names:
            codes.extend(col_codes(f.col(nm), f.n))
        _, reps = group_ids(codes, f.n)
        return f.take(reps)

    def _x_join(self, op) -> ColumnarFrame:
        l = self.regs[op["left"]]
        r = self.regs[op["right"]]
        outer = op["outer"]
        lc_all: List[np.ndarray] = []
        rc_all: List[np.ndarray] = []
        for k in op["keys"]:
            lc, rc = join_codes(l.col(k), r.col(k), l.n, r.n)
            lc_all.extend(lc)
            rc_all.extend(rc)
        both = [np.concatenate([a, b]) for a, b in zip(lc_all, rc_all)]
        gid, _ = group_ids(both, l.n + r.n)
        lg, rg = gid[:l.n], gid[l.n:]
        rorder = np.argsort(rg, kind="stable")
        rs = rg[rorder]
        starts = np.searchsorted(rs, lg)
        ends = np.searchsorted(rs, lg, side="right")
        cnt = ends - starts
        eff = np.maximum(cnt, 1) if outer else cnt
        ecum = np.cumsum(eff) if eff.size else eff
        total = int(ecum[-1]) if eff.size else 0
        if total == 0:
            prow = np.empty(0, np.int64)
            matched = np.empty(0, bool)
            rsel = np.empty(0, np.int64)
        else:
            k = np.arange(total, dtype=np.int64)
            prow = np.searchsorted(ecum, k, side="right")
            within = k - (ecum[prow] - eff[prow])
            matched = within < cnt[prow]
            if r.n:
                idx = np.minimum(starts[prow] + within, rs.size - 1)
                rsel = rorder[idx]
            else:
                rsel = np.zeros(total, np.int64)
        out_cols = {nm: l.cols[nm].take(prow) for nm in l.names}
        for nm in op["r_extra"]:
            col = r.cols[nm]
            if r.n:
                taken = col.take(rsel)
                if outer and not matched.all() \
                        and taken.kind != "opaque":
                    miss = ~matched
                    nl = taken.null_mask(total).copy()
                    nl |= miss
                    taken.null = nl
                out_cols[nm] = taken
            else:
                out_cols[nm] = _null_extend(col, total)
        return ColumnarFrame(total, list(l.names) + op["r_extra"],
                             out_cols)

    def _x_agg(self, op) -> ColumnarFrame:
        f = self._frame(op)
        key_cols = [self._desc_col(f, d) for d in op["keys"]]
        codes: List[np.ndarray] = []
        for c in key_cols:
            codes.extend(col_codes(c, f.n))
        gid, reps = group_ids(codes, f.n)
        ng = int(reps.size)
        if not op["keys"] and ng == 0:
            # global aggregate over empty input: one all-zero count row
            names = [n for _, n in op["cols"]]
            cols = {n: ValCol(np.zeros(1, np.int64), None, "int")
                    for n in names}
            return ColumnarFrame(1, names, cols)
        names, cols = [], {}
        for spec, n in op["cols"]:
            names.append(n)
            if spec[0] == "key":
                cols[n] = key_cols[spec[1]].take(reps)
                continue
            _, d, distinct = spec
            if d is None:
                counts = np.bincount(gid, minlength=ng)
            else:
                c = self._desc_col(f, d)
                nn = ~c.null_mask(f.n)
                if not distinct:
                    counts = np.bincount(gid[nn], minlength=ng)
                else:
                    sub = np.flatnonzero(nn)
                    ccodes = [x[sub] for x in col_codes(c, f.n)]
                    _, reps2 = group_ids([gid[sub]] + ccodes,
                                         int(sub.size))
                    counts = np.bincount(gid[sub[reps2]], minlength=ng)
            cols[n] = ValCol(counts.astype(np.int64), None, "int")
        return ColumnarFrame(ng, names, cols)

    def _sort_key(self, f: ColumnarFrame, d: Tuple, asc: bool
                  ) -> np.ndarray:
        col = self._desc_col(f, d)
        if col.kind == "vid":
            vals = self.d2v[col.dense]
            col = ValCol(vals, col.null,
                         "int" if vals.dtype != object else "obj")
        if col.kind != "val":
            raise CannotCompile("sort key not a value column")
        try:
            codes = col_codes(col, f.n, ordered=True)[0]
        except TypeError:
            raise CannotCompile("sort key not totally ordered")
        ncodes = int(codes.max()) + 1 if codes.size else 0
        key = np.where(codes < 0, ncodes, codes)   # nulls last (asc)
        return key if asc else -key

    def _x_sort(self, op) -> ColumnarFrame:
        f = self._frame(op)
        keys = [self._sort_key(f, d, asc) for d, asc in op["factors"]]
        order = np.lexsort(keys[::-1]) if keys \
            else np.arange(f.n, dtype=np.int64)
        if "count" in op:
            off = op.get("offset", 0) or 0
            cnt = op.get("count")
            end = None if cnt is None or cnt < 0 else off + cnt
            order = order[off:end]
        return f.take(order)

    def _x_limit(self, op) -> ColumnarFrame:
        f = self._frame(op)
        off = op.get("offset", 0) or 0
        cnt = op.get("count")
        end = f.n if cnt is None or cnt < 0 else min(f.n, off + cnt)
        return f.take(np.arange(off, max(off, end), dtype=np.int64))

    def _x_result(self, op):
        f = self._frame(op)
        arrays = [materialize_column(f.col(nm), f.n, self.qctx,
                                     self.space, self.d2v)
                  for nm in op["cols"]]
        return ColumnarDataSet(list(op["cols"]), arrays)

    def _merge_stats(self, st):
        s = self.stats
        s.hop_edges.extend(st.hop_edges)
        s.frontier_sizes.extend(st.frontier_sizes)
        s.result_edges += st.result_edges
        s.steps += st.steps
        s.retries += st.retries
        s.e_cap = st.e_cap          # slot widths: report the last chain's
        s.hbm_bytes = max(s.hbm_bytes, getattr(st, "hbm_bytes", 0))
        for ph in ("pin_s", "put_s", "fetch_s", "mat_s", "device_s",
                   "total_s", "queue_s"):
            setattr(s, ph, getattr(s, ph) + getattr(st, ph, 0.0))


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


def _run_subplan(root: PlanNode, qctx, ectx, space):
    """Inline host interpreter for the stashed original subtree: every
    node in deps-then-from_var order, results registered under the
    nodes' own output vars (the scheduler's sequencing contract)."""
    order: List[PlanNode] = []
    seen: set = set()
    by_var: Dict[str, PlanNode] = {}
    for n in walk_plan(root):
        by_var[n.output_var] = n

    def rec(n: PlanNode):
        if n.id in seen:
            return
        seen.add(n.id)
        fv = n.args.get("from_var") if n.args else None
        if fv and fv in by_var:
            rec(by_var[fv])
        for d in n.deps:
            rec(d)
        order.append(n)

    rec(root)
    ds = DataSet()
    for n in order:
        ds = run_node(n, qctx, ectx, space)
        ectx.set_result(n.output_var, ds)
    return ds


def _dispatch_overloaded() -> bool:
    """Device dispatch-queue depth cap: beyond
    `tpu_dispatch_queue_cap` queued dispatches, fused pipelines degrade
    to their stashed host subplan instead of piling onto the device —
    never wrong, only slower.  0 (the default) disables the cap."""
    try:
        cap = int(get_config().get("tpu_dispatch_queue_cap"))
    except Exception:  # noqa: BLE001 — config not initialized
        return False
    if cap <= 0:
        return False
    if dispatch_table().queued_depth() < cap:
        return False
    stats().inc("tpu_dispatch_queue_shed")
    return True


def _run_fused(qctx, ectx, rt, a) -> Tuple[Any, "_Runner"]:
    """The segment program on the device plane: a `SnapshotRetired` runs
    it again from the first segment on the snapshot now pinned, up to
    RETIRED_ATTEMPTS runs (every register of a run reads one pin)."""
    for attempt in range(1, RETIRED_ATTEMPTS + 1):
        runner = _Runner(qctx, ectx, rt, a["space"])
        try:
            return runner.run(a["ops"]), runner
        except SnapshotRetired:
            if attempt == RETIRED_ATTEMPTS:
                raise


@executor("TpuMatchPipeline")
def _tpu_match_pipeline(node, qctx, ectx, space):
    a = node.args
    rt = getattr(qctx, "tpu_runtime", None)
    reason = "no-runtime"
    if rt is not None and get_config().get("tpu_match_device") \
            and _dispatch_overloaded():
        reason = "overload"
        rt = None       # fall through to the stashed host subplan
    if rt is not None and get_config().get("tpu_match_device"):
        try:
            with trace.span("tpu:match_pipeline",
                            segments=len(a["ops"]),
                            chains=a.get("n_chains", 0)):
                ds, runner = _run_fused(qctx, ectx, rt, a)
            qctx.last_tpu_stats = runner.stats
            stats().inc("match_pipeline_fused")
            return ds
        except (CannotCompile, FailpointError) as ex:
            # a statement the device cannot express, or the injected
            # dispatch failure (chaos schedule 5): the stashed row
            # subplan answers.  GpuUnavailable, CUDA errors,
            # QueryKilled and DeadlineExceeded are NOT caught: a device
            # fault is the statement's error, a killed statement dies.
            qctx.last_tpu_fallback = f"{type(ex).__name__}: {ex}"
            reason = f"runtime:{type(ex).__name__}"
    elif rt is not None:
        reason = "device-flag-off"
    stats().inc_labeled("match_pipeline_fallback",
                        {"stage": "execute", "reason": reason})
    return _run_subplan(a["fallback"].node, qctx, ectx, space)
