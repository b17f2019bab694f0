"""The port's copy of `nebula_tpu/tpu/traverse.py`, whole.

TpuTraverse: the fused plan node, its executor, and the fusion rule.

The optimizer rule is the north-star plugin (SURVEY §2 row 22): when a
GO plan's frontier chain —

    ExpandAll ← [Dedup ← Project(_dst→_vid) ← ExpandAll]×(n-1) ← Start(vids)

— has no carried input columns, no per-src limits, and a final-hop edge
filter that the predicate compiler can vectorize (or none), the whole
chain collapses into ONE TpuTraverse node.  Its executor runs the entire
multi-hop expansion on the device (`GpuRuntime.traverse`: the frontier
never leaves device memory between hops; see hop.py) and materializes
only the final edge set.

The reference's equivalent seam is a new OptRule producing a fused plan
node in src/graph/optimizer + an Executor in src/graph/executor.

One difference from the JAX package's executor: the host path answers
only a `CannotCompile` (a statement the device cannot express, such as a
WHERE program past the predicate interpreter's limits), recorded in
`qctx.last_tpu_fallback`.  A `GpuUnavailable`, a CUDA error or a failed
kernel build is the statement's error, as `run_algorithm`'s device
errors are: a device fault is never hidden behind the host's rows.  A
snapshot retired by a concurrent pin (`SnapshotRetired`) is no fault:
the run goes again on the snapshot now pinned, up to
`RETIRED_ATTEMPTS` runs.  The
node keeps the reference's name, `TpuTraverse`, so EXPLAIN and PROFILE
read the same in both packages.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..core.value import DataSet, is_null
from ..exec.executors import executor
from ..query import optimizer as opt
from ..query.plan import PlanNode
from .device import SnapshotRetired
from .exprjit import CannotCompile, compilable, yieldable

#: runs of a device call whose snapshot a concurrent pin keeps retiring
RETIRED_ATTEMPTS = 3


def run_on_device(qctx, call):
    """`call()`, the device half of a statement, under the executors'
    error policy: a `SnapshotRetired` (a rebuild or a compaction's swap
    replaced the snapshot mid-run) runs it again on the snapshot now
    pinned, up to RETIRED_ATTEMPTS runs; a `CannotCompile` (a statement
    the device cannot express) is recorded in `qctx.last_tpu_fallback`
    and answered with None, and the caller takes its host path, which
    has identical semantics.  Anything else propagates: a
    `GpuUnavailable`, a CUDA error or a failed kernel build is the
    statement's error."""
    for attempt in range(1, RETIRED_ATTEMPTS + 1):
        try:
            return call()
        except SnapshotRetired:
            if attempt == RETIRED_ATTEMPTS:
                raise
        except CannotCompile as ex:
            qctx.last_tpu_fallback = f"{type(ex).__name__}: {ex}"
            return None

# ---------------------------------------------------------------------------
# Fusion rule
# ---------------------------------------------------------------------------


def _match_frontier_chain(final: PlanNode, uses: Dict[int, int]
                          ) -> Optional[Tuple[List[Any], int]]:
    """If `final` (an ExpandAll) terminates a pure literal-vid frontier
    chain, return (vids, steps); else None.  Every mid-chain node must be
    single-use (m<n GO plans branch off mid chain — those stay host)."""
    a = final.args
    steps = 1
    cur = final
    while True:
        ca = cur.args
        if (ca.get("carry") or ca.get("limit") is not None
                or ca.get("sample") is not None):
            return None
        if ca.get("space") != a.get("space"):
            return None
        if ca.get("edge_types") != a.get("edge_types"):
            return None
        if ca.get("direction") != a.get("direction"):
            return None
        if cur is not final and ca.get("edge_filter") is not None:
            return None
        if ca.get("src_col") is None:
            # chain head: literal vids
            vids = ca.get("vids") or []
            dep = cur.deps[0] if cur.deps else None
            if dep is not None and dep.kind != "Start":
                return None
            return (vids, steps)
        # walk down: ExpandAll ← Dedup ← Project ← ExpandAll
        if ca.get("src_col") != "_vid" or len(cur.deps) != 1:
            return None
        ddp = cur.deps[0]
        if ddp.kind != "Dedup" or uses.get(ddp.id, 2) != 1 or len(ddp.deps) != 1:
            return None
        prj = ddp.deps[0]
        if (prj.kind != "Project" or uses.get(prj.id, 2) != 1
                or prj.col_names != ["_vid"] or len(prj.deps) != 1):
            return None
        nxt = prj.deps[0]
        if nxt.kind != "ExpandAll" or uses.get(nxt.id, 2) != 1:
            return None
        steps += 1
        cur = nxt


def make_tpu_rule(uses: Dict[int, int], root=None):
    """Rule closure for one optimize() pass; `uses` maps node id → number
    of parents in the plan DAG (`root` is unused here — the pipeline
    fusion needs it for by-name Argument references)."""

    def rule(node: PlanNode) -> Optional[PlanNode]:
        # Preferred match: Project(go_row) over the chain — the YIELD
        # columns are absorbed too, so materialization emits the FINAL
        # output rows from numpy columns (no per-edge Edge objects, no
        # per-row expression eval: the E2E fast path).
        yields = None
        expand = node
        if node.kind == "Project" and node.args.get("go_row") \
                and len(node.deps) == 1 and node.dep().kind == "ExpandAll" \
                and uses.get(node.dep().id, 2) == 1:
            cols = node.args.get("columns") or []
            if cols and all(yieldable(e) for e, _ in cols):
                yields = cols
                expand = node.dep()
        if expand.kind != "ExpandAll":
            return None
        a = expand.args
        ef = a.get("edge_filter")
        etypes = a.get("edge_types") or []
        if ef is not None and not compilable(ef, etypes):
            return None
        m = _match_frontier_chain(expand, uses)
        if m is None:
            return None
        vids, steps = m
        if steps == 1:
            # duplicate literal FROM vids produce duplicate rows on host;
            # the device frontier dedups — refuse that edge case
            from ..core.expr import Expr
            from ..core.expr import DictContext
            vals = [v.eval(DictContext()) if isinstance(v, Expr) else v
                    for v in vids]
            keys = [repr(v) for v in vals]
            if len(set(keys)) != len(keys):
                return None
        return PlanNode(
            "TpuTraverse", deps=[],
            args={"space": a["space"], "edge_types": list(etypes),
                  "direction": a["direction"], "vids": list(vids),
                  "steps": steps, "edge_filter": ef, "yields": yields},
            col_names=(list(node.col_names) if yields is not None
                       else ["_src", "_edge", "_dst"]))

    return rule


opt.TPU_RULES.append(make_tpu_rule)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


@executor("TpuTraverse")
def _tpu_traverse(node, qctx, ectx, space):
    from ..core.expr import DictContext, Expr
    a = node.args
    sp = a["space"]
    vids = [v.eval(DictContext()) if isinstance(v, Expr) else v
            for v in a.get("vids") or []]
    vids = [v for v in vids if not is_null(v)]
    rt = getattr(qctx, "tpu_runtime", None)
    yields = a.get("yields")
    got = None if rt is None else run_on_device(qctx, lambda: rt.traverse(
        qctx.store, sp, vids, a["edge_types"], a["direction"], a["steps"],
        edge_filter=a.get("edge_filter"), yields=yields))
    if got is not None:
        rows, stats = got
        qctx.last_tpu_stats = stats
        if yields is not None:
            if isinstance(rows, DataSet):
                # ColumnarDataSet: rows stay numpy columns until a
                # consumer crosses the row boundary (lazy handle)
                rows.column_names = list(node.col_names)
                return rows
            return DataSet(list(node.col_names), rows)
        return DataSet(["_src", "_edge", "_dst"],
                       [[s, e, d] for (s, e, d) in rows])
    return _host_traverse(node, qctx, sp, vids)


def _host_traverse(node, qctx, space, vids):
    """CPU fallback with identical semantics (frontier chain with per-hop
    dedup; filter on the final hop)."""
    from ..core.expr import to_bool3
    from ..exec.context import RowContext
    from ..exec.executors import _make_edge

    a = node.args
    store = qctx.store
    etypes = a["edge_types"]
    etype_ids = {e: store.catalog.get_edge(space, e).edge_type
                 for e in etypes}
    direction = a["direction"]
    ef = a.get("edge_filter")
    steps = a["steps"]

    frontier = []
    seen = set()
    for v in vids:
        if repr(v) not in seen:
            seen.add(repr(v))
            frontier.append(v)
    for _ in range(steps - 1):
        nxt, seen2 = [], set()
        for (s, et, rank, other, props, sd) in store.get_neighbors(
                space, frontier, etypes, direction):
            k = repr(other)
            if k not in seen2:
                seen2.add(k)
                nxt.append(other)
        frontier = nxt
    yields = a.get("yields")
    rows = []
    for (s, et, rank, other, props, sd) in store.get_neighbors(
            space, frontier, etypes, direction):
        e = _make_edge(s, other, et, rank, props, sd, etype_ids[et])
        rc = None
        if ef is not None or yields is not None:
            rc = RowContext(qctx, space,
                            {"_src": s, "_edge": e, "_dst": other})
        if ef is not None and to_bool3(ef.eval(rc)) is not True:
            continue
        if yields is not None:
            rows.append([ye.eval(rc) for ye, _ in yields])
        else:
            rows.append([s, e, other])
    if yields is not None:
        return DataSet(list(node.col_names), rows)
    return DataSet(["_src", "_edge", "_dst"], rows)
