"""The port's copy of `nebula_tpu/query/optimizer.py`, whole.

Rule-based optimizer over the plan DAG.

Analog of the reference's memo-based RBO (reference: src/graph/optimizer,
~50 rules).  Python plans are small
trees, so instead of an OptGroup memo we run bottom-up rewrite rules to a
fixpoint.  The rule set mirrors the reference's pushdown family; the TPU
fusion rule (`TpuTraverseRule`) registers itself from nebula_tpu.tpu at
import time — a new rule here is exactly where the TPU rewrite plugs in.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

from ..core.expr import (Binary, Expr, InputProp, join_conjuncts,
                         split_conjuncts, to_text, walk)
from .plan import ExecutionPlan, PlanNode, transform_plan, walk_plan

Rule = Callable[[PlanNode], Optional[PlanNode]]

RULES: List[Rule] = []

# Exploration rules (the OptGroup-memo leg): called as fn(node, pctx)
# and return a LIST of alternative subtrees for the node's group; the
# cost model picks the cheapest member (see find_best_plan).  Unlike
# RULES (rewrites that are always-better), these are choices — e.g.
# which index seeds a MATCH label scan.
ExploreRule = Callable[[PlanNode, Any], List[PlanNode]]
EXPLORE_RULES: List[ExploreRule] = []

# TPU fusion rule factories: each is called per-pass with a {node_id:
# parent_count} map AND the plan root (pipeline fusion must see
# by-name Argument references that dep edges don't carry) and returns
# a Rule.  Populated by nebula_tpu.tpu (kept here so query/ has no jax
# dependency).  Order matters: the first factory whose rule matches a
# node wins it, so specialized single-chain fusions register before
# the general pipeline fusion.
TPU_RULES: List = []


def register_rule(fn: Rule) -> Rule:
    RULES.append(fn)
    return fn


def register_explore_rule(fn: ExploreRule) -> ExploreRule:
    EXPLORE_RULES.append(fn)
    return fn


# ---------------------------------------------------------------------------
# Cost-lite memo (reference analog: Optimizer::findBestPlan over OptGroup
# alternatives).  Plans here
# are trees of tens of nodes, so the memo is a per-node group of
# alternative subtrees with a cardinality-flow cost; exhaustive
# exploration is affordable and deterministic.
# ---------------------------------------------------------------------------

_BASE_ROWS = 1_000_000.0          # assumed table cardinality for scans
_EQ_SELECTIVITY = 100.0           # one bound eq column divides rows by this
_RANGE_SELECTIVITY = 10.0


def est_rows(node: PlanNode, child_rows: List[float]) -> float:
    """Heuristic output cardinality of one node."""
    k = node.kind
    inp = max(child_rows) if child_rows else 0.0
    if k in ("ScanVertices", "ScanEdges"):
        return _BASE_ROWS
    if k in ("IndexScan", "FulltextIndexScan"):
        if not node.args.get("index"):
            return _BASE_ROWS
        sel = _EQ_SELECTIVITY ** len(node.args.get("eq") or ())
        if node.args.get("range"):
            sel *= _RANGE_SELECTIVITY
        if node.args.get("geo_ranges"):
            # covering-cell scan ≈ a range binding (bbox-selective)
            sel *= _RANGE_SELECTIVITY
        return max(_BASE_ROWS / sel, 1.0)
    if k == "Filter":
        return inp / 4.0
    if k in ("Limit", "TopN", "Sample"):
        lim = node.args.get("count")
        return min(inp, float(lim)) if lim is not None else inp
    if k == "Dedup":
        return inp / 2.0
    if k == "Aggregate":
        return max(inp / 10.0, 1.0)
    if k in ("GetNeighbors", "Traverse", "Expand", "TpuTraverse"):
        return inp * 10.0
    return inp


def est_cost(node: PlanNode, memo: dict) -> float:
    """Total cardinality flowing through the subtree (each node costs
    its own output rows; children shared by id are costed once)."""
    got = memo.get(node.id)
    if got is not None:
        return got[1]
    child_rows = []
    total = 0.0
    for d in node.deps:
        est_cost(d, memo)
        rows_d, cost_d = memo[d.id]
        child_rows.append(rows_d)
        total += cost_d
    rows = est_rows(node, child_rows)
    total += rows
    memo[node.id] = (rows, total)
    return total


def find_best_plan(root: PlanNode, pctx) -> PlanNode:
    """Bottom-up group exploration: children first, then this node's
    alternatives from EXPLORE_RULES; the cheapest subtree (est_cost)
    wins its group.  Memoized by node id (shared deps explored once)."""
    chosen: dict = {}

    def rec(node: PlanNode) -> PlanNode:
        got = chosen.get(node.id)
        if got is not None:
            return got
        new_deps = [rec(d) for d in node.deps]
        if new_deps != node.deps:
            node.deps = new_deps
            node.input_vars = [d.output_var for d in new_deps]
        alts = [node]
        for rule in EXPLORE_RULES:
            try:
                alts.extend(rule(node, pctx) or ())
            except Exception:  # noqa: BLE001 — exploration must not fail a plan
                continue
        best = min(alts, key=lambda n: est_cost(n, {}))
        chosen[node.id] = best
        return best

    return rec(root)


def optimize(plan: ExecutionPlan, enable: bool = True,
             tpu: bool = False, pctx=None) -> ExecutionPlan:
    if not enable:
        return plan
    # When a rule replaces a node with one of its children, any by-name
    # reference to the removed node's output_var (e.g. Argument.from_var)
    # must be re-pointed at the survivor.
    var_alias = {}
    for _ in range(8):  # fixpoint with a safety bound
        changed = [False]

        def apply_once(node: PlanNode) -> Optional[PlanNode]:
            for rule in RULES:
                r = rule(node)
                if r is not None:
                    changed[0] = True
                    if r.output_var != node.output_var:
                        var_alias[node.output_var] = r.output_var
                    return r
            return None

        plan.root = transform_plan(plan.root, apply_once)
        if not changed[0]:
            break
    if pctx is not None and EXPLORE_RULES:
        plan.root = find_best_plan(plan.root, pctx)
    if tpu and TPU_RULES:
        # Fusion pass after pushdowns.  TOP-down (outermost node first) so a
        # whole N-step frontier chain fuses as one unit — bottom-up would
        # fuse the 1-step chain head and break the outer match.  Rules get
        # parent counts to refuse fusing chains other branches reference.
        uses: dict = {}
        for n in walk_plan(plan.root):
            for d in n.deps:
                uses[d.id] = uses.get(d.id, 0) + 1
        rules = [factory(uses, plan.root) for factory in TPU_RULES]
        memo: dict = {}

        def rec(node: PlanNode) -> PlanNode:
            if node.id in memo:
                return memo[node.id]
            for rule in rules:
                r = rule(node)
                if r is not None:
                    if r.output_var != node.output_var:
                        var_alias[node.output_var] = r.output_var
                    memo[node.id] = r
                    return r
            memo[node.id] = node        # pre-seed: cycles impossible in DAG
            new_deps = [rec(d) for d in node.deps]
            if new_deps != node.deps:
                node.deps = new_deps
                node.input_vars = [d.output_var for d in new_deps]
            return node

        plan.root = rec(plan.root)
    if var_alias:
        # Only references to nodes that actually LEFT the plan may be
        # re-pointed.  Swap rules (e.g. Limit(Project) → Project(Limit))
        # alias the old root to the new one, but BOTH nodes survive —
        # rewriting the new root's own input would self-loop it.
        live = {n.output_var for n in walk_plan(plan.root)}

        def resolve(v):
            seen = set()
            while v not in live and v in var_alias and v not in seen:
                seen.add(v)
                v = var_alias[v]
            return v
        for n in walk_plan(plan.root):
            if "from_var" in n.args:
                n.args["from_var"] = resolve(n.args["from_var"])
            n.input_vars = [resolve(v) for v in n.input_vars]
    return plan


# ---------------------------------------------------------------------------
# Rules (reference analogs noted per rule)
# ---------------------------------------------------------------------------


def _refs_only(e: Expr, kinds: tuple) -> bool:
    leaf_kinds = ("literal", "list", "set", "map") + kinds
    for x in walk(e):
        if x.kind in ("src_prop", "edge_prop", "dst_prop", "input_prop",
                      "var", "var_prop", "label", "label_tag_prop",
                      "vertex", "edge", "attribute"):
            if x.kind not in kinds:
                return False
    return True


@register_rule
def push_filter_down_expand(node: PlanNode) -> Optional[PlanNode]:
    """Filter(ExpandAll) → ExpandAll{edge_filter} for conjuncts that only
    touch edge props / src props (reference: PushFilterDownGetNbrsRule)."""
    if node.kind != "Filter" or not node.deps or node.dep().kind != "ExpandAll":
        return None
    exp = node.dep()
    cond = node.args.get("condition")
    if cond is None:
        return None
    pushable, rest = [], []
    for c in split_conjuncts(cond):
        if _refs_only(c, ("edge_prop", "src_prop")):
            pushable.append(c)
        else:
            rest.append(c)
    if not pushable:
        return None
    prev = exp.args.get("edge_filter")
    allp = ([prev] if prev is not None else []) + pushable
    exp.args["edge_filter"] = join_conjuncts(allp)
    if rest:
        node.args["condition"] = join_conjuncts(rest)
        return None  # keep the (reduced) filter
    return exp  # filter fully absorbed


@register_rule
def push_filter_down_traverse(node: PlanNode) -> Optional[PlanNode]:
    """Filter(AppendVertices(Traverse)) edge-only conjuncts → Traverse
    (reference: PushFilterDownTraverseRule)."""
    if node.kind != "Filter" or not node.deps:
        return None
    av = node.dep()
    if av.kind != "AppendVertices" or not av.deps or av.dep().kind != "Traverse":
        return None
    tv = av.dep()
    cond = node.args.get("condition")
    if cond is None:
        return None
    edge_alias = tv.args.get("edge_alias")
    if tv.args.get("min_hop") != 1 or tv.args.get("max_hop") != 1:
        return None
    pushable, rest = [], []
    for c in split_conjuncts(cond):
        refs = [x for x in walk(c)
                if x.kind in ("label", "label_tag_prop", "attribute",
                              "input_prop", "var", "var_prop")]
        names = set()
        for r in refs:
            if r.kind == "label":
                names.add(r.name)
            elif r.kind == "label_tag_prop":
                names.add(r.var)
            elif r.kind == "attribute":
                o = r.obj
                while o.kind == "attribute":
                    o = o.obj
                if o.kind == "label":
                    names.add(o.name)
                else:
                    names.add("__other__")
            else:
                names.add("__other__")
        if names and names <= {edge_alias}:
            pushable.append(c)
        else:
            rest.append(c)
    if not pushable:
        return None
    prev = tv.args.get("edge_filter")
    tv.args["edge_filter"] = join_conjuncts(
        ([prev] if prev is not None else []) + pushable)
    tv.args["edge_filter_alias"] = edge_alias
    if rest:
        node.args["condition"] = join_conjuncts(rest)
        return None
    return av


@register_rule
def push_limit_down_expand(node: PlanNode) -> Optional[PlanNode]:
    """Limit(ExpandAll) → ExpandAll{limit} (reference: PushLimitDownGetNeighborsRule)."""
    if node.kind != "Limit" or not node.deps or node.dep().kind != "ExpandAll":
        return None
    exp = node.dep()
    if node.args.get("offset"):
        return None
    cnt = node.args.get("count", -1)
    if cnt is None or cnt < 0:
        return None
    if exp.args.get("limit") is not None:
        return None
    exp.args["limit"] = cnt
    return None  # keep Limit for exactness; Expand just over-produces less


@register_rule
def collapse_project(node: PlanNode) -> Optional[PlanNode]:
    """Project(Project(x)) where the outer only renames InputProp columns
    (reference: CollapseProjectRule)."""
    if node.kind != "Project" or not node.deps or node.dep().kind != "Project":
        return None
    inner = node.dep()
    if node.args.get("go_row") or node.args.get("match_row") or \
       inner.args.get("go_row") or inner.args.get("match_row"):
        return None
    inner_map = {n: e for e, n in inner.args.get("columns", [])}
    new_cols = []
    for e, n in node.args.get("columns", []):
        if isinstance(e, InputProp) and e.name in inner_map:
            new_cols.append((inner_map[e.name], n))
        else:
            return None
    node.args["columns"] = new_cols
    # the substituted expressions came from the inner project — they need
    # its evaluation context (lookup_row/fetch_row resolve Tag.prop etc.
    # against the scanned entity, not plain input columns)
    for flag in ("lookup_row", "fetch_row", "schema", "is_edge"):
        if flag in inner.args:
            node.args[flag] = inner.args[flag]
    node.deps = list(inner.deps)
    node.input_vars = [d.output_var for d in node.deps]
    return node


@register_rule
def merge_sort_limit_to_topn(node: PlanNode) -> Optional[PlanNode]:
    """Limit(Sort(x)) → TopN (reference: TopNRule)."""
    if node.kind != "Limit" or not node.deps or node.dep().kind != "Sort":
        return None
    srt = node.dep()
    cnt = node.args.get("count", -1)
    if cnt is None or cnt < 0:
        return None
    return PlanNode("TopN", deps=list(srt.deps),
                    col_names=list(node.col_names),
                    args={"factors": srt.args["factors"],
                          "offset": node.args.get("offset", 0),
                          "count": cnt,
                          "match_row": srt.args.get("match_row", False)})


@register_rule
def dedup_before_expand(node: PlanNode) -> Optional[PlanNode]:
    """ExpandAll fed by a Project of dsts without Dedup gains dedup_src
    (reference: the GetDstBySrc dedup optimization)."""
    if node.kind != "ExpandAll" or not node.deps:
        return None
    d = node.dep()
    if d.kind == "Dedup":
        node.args["dedup_input"] = True
    return None


def _col_refs(e: Expr) -> Optional[set]:
    """Column names a predicate reads, or None if it touches anything
    that is not a plain column reference (then it can't be re-homed)."""
    names = set()
    for x in walk(e):
        if x.kind in ("input_prop", "var"):
            names.add(x.name)
        elif x.kind == "label":
            names.add(x.name)
        elif x.kind == "var_prop":
            names.add(x.var)
        elif x.kind == "label_tag_prop":
            names.add(x.var)
        elif x.kind in ("src_prop", "edge_prop", "dst_prop", "vertex",
                        "edge"):
            return None
    return names


@register_rule
def merge_adjacent_filters(node: PlanNode) -> Optional[PlanNode]:
    """Filter(Filter(x)) → Filter(x) with the conjunction (reference:
    CombineFilterRule)."""
    if node.kind != "Filter" or not node.deps or node.dep().kind != "Filter":
        return None
    inner = node.dep()
    a, b = node.args.get("condition"), inner.args.get("condition")
    if a is None or b is None:
        return None
    if node.args.get("match_row") != inner.args.get("match_row"):
        return None
    node.args["condition"] = join_conjuncts([b, a])
    node.deps = list(inner.deps)
    node.input_vars = [d.output_var for d in node.deps]
    return node


@register_rule
def eliminate_true_filter(node: PlanNode) -> Optional[PlanNode]:
    """Filter(cond=true) → child (reference: the constant-fold/remove
    family)."""
    if node.kind != "Filter" or not node.deps:
        return None
    cond = node.args.get("condition")
    if cond is not None and cond.kind == "literal" and cond.value is True:
        return node.dep()
    return None


@register_rule
def eliminate_false_filter(node: PlanNode) -> Optional[PlanNode]:
    """Filter(cond=false|null) → empty result (reference: the
    degenerate-plan constant-fold family).  A constant-false predicate
    can skip the whole subtree — the columns survive, the rows never
    materialize."""
    if node.kind != "Filter" or not node.deps:
        return None
    cond = node.args.get("condition")
    if cond is None or cond.kind != "literal":
        return None
    from ..core.value import is_null
    if cond.value is False or (is_null(cond.value)
                               and not isinstance(cond.value, bool)):
        return PlanNode("Project", deps=[],
                        col_names=list(node.col_names),
                        args={"empty": True})
    return None


@register_rule
def merge_adjacent_limits(node: PlanNode) -> Optional[PlanNode]:
    """Limit(Limit(x)) → one Limit (reference: MergeGetNbrsAndDedupRule
    sibling cleanups).  rows[o2:o2+c2][o1:o1+c1] = rows[o1+o2 : ...]."""
    if node.kind != "Limit" or not node.deps or node.dep().kind != "Limit":
        return None
    inner = node.dep()
    o1, c1 = node.args.get("offset", 0) or 0, node.args.get("count", -1)
    o2, c2 = inner.args.get("offset", 0) or 0, inner.args.get("count", -1)
    if c2 is None or c2 < 0:
        cnt = c1
    else:
        avail = max(0, c2 - o1)
        cnt = avail if c1 is None or c1 < 0 else min(c1, avail)
    node.args["offset"] = o1 + o2
    node.args["count"] = cnt
    node.deps = list(inner.deps)
    node.input_vars = [d.output_var for d in node.deps]
    return node


# NOTE on Sort(Sort(x)): a plain drop-the-inner-sort collapse would be
# WRONG — the engine's Sort is stable, so the inner sort is observable
# through ties of the outer keys.  merge_consecutive_sorts (below)
# instead folds the inner keys in as SECONDARY factors of one Sort,
# which is order-identical and deletes the extra O(n log n) pass.

@register_rule
def eliminate_limit_zero(node: PlanNode) -> Optional[PlanNode]:
    """Limit(count=0) → empty result: the subtree can't contribute rows
    (reference: the degenerate-plan prune family)."""
    if node.kind != "Limit" or not node.deps:
        return None
    if node.args.get("count") == 0:
        return PlanNode("Project", deps=[],
                        col_names=list(node.col_names),
                        args={"empty": True})
    return None


@register_rule
def eliminate_topn_zero(node: PlanNode) -> Optional[PlanNode]:
    """TopN(count=0) → empty result: sorting zero output rows is pure
    waste (same degenerate-plan prune as Limit 0)."""
    if node.kind != "TopN" or not node.deps:
        return None
    if node.args.get("count") == 0:
        return PlanNode("Project", deps=[],
                        col_names=list(node.col_names),
                        args={"empty": True})
    return None


@register_rule
def eliminate_dedup_after_distinct_union(node: PlanNode
                                         ) -> Optional[PlanNode]:
    """Dedup(Union{distinct}) → Union{distinct}: a distinct set op
    already emits unique rows, the outer Dedup re-hashes them for
    nothing (UNION DISTINCT ... | YIELD DISTINCT shapes)."""
    if node.kind != "Dedup" or len(node.deps) != 1:
        return None
    u = node.dep()
    if u.kind in ("Union", "Intersect", "Minus") \
            and u.args.get("distinct"):
        return u
    return None


@register_rule
def eliminate_noop_limit(node: PlanNode) -> Optional[PlanNode]:
    """Limit(offset=0, count=unbounded) → child."""
    if node.kind != "Limit" or not node.deps:
        return None
    cnt = node.args.get("count", -1)
    off = node.args.get("offset", 0) or 0
    if off == 0 and (cnt is None or cnt < 0):
        return node.dep()
    return None


@register_rule
def collapse_dedup(node: PlanNode) -> Optional[PlanNode]:
    """Dedup(Dedup(x)) → Dedup(x)."""
    if node.kind != "Dedup" or not node.deps or node.dep().kind != "Dedup":
        return None
    return node.dep()


@register_rule
def push_filter_through_dedup(node: PlanNode) -> Optional[PlanNode]:
    """Filter(Dedup(x)) → Dedup(Filter(x)) — row-wise filters commute
    with dedup, and filtering first shrinks the dedup set (reference:
    PushFilterDownNode family)."""
    if node.kind != "Filter" or not node.deps or node.dep().kind != "Dedup":
        return None
    dd = node.dep()
    if len(dd.deps) != 1:
        return None
    node.deps = list(dd.deps)
    node.input_vars = [d.output_var for d in node.deps]
    dd.deps = [node]
    dd.input_vars = [node.output_var]
    return dd


@register_rule
def push_limit_down_project(node: PlanNode) -> Optional[PlanNode]:
    """Limit(Project(x)) → Project(Limit(x)) — Project is 1:1, so limit
    first and evaluate fewer rows (reference: PushLimitDownProjectRule)."""
    if node.kind != "Limit" or not node.deps or node.dep().kind != "Project":
        return None
    pj = node.dep()
    if len(pj.deps) != 1:
        return None
    # constant-YIELD projects synthesize one row from column-less empty
    # input; moving the limit below them would bypass it (LIMIT 0 bug)
    if not pj.dep(0).col_names:
        return None
    cnt = node.args.get("count", -1)
    if cnt == 0:
        return None
    node.deps = list(pj.deps)
    node.input_vars = [d.output_var for d in node.deps]
    node.col_names = list(pj.dep(0).col_names) if pj.deps else node.col_names
    pj.deps = [node]
    pj.input_vars = [node.output_var]
    return pj


@register_rule
def push_limit_down_scan(node: PlanNode) -> Optional[PlanNode]:
    """Limit(ScanVertices) plants a scan stop bound (reference:
    PushLimitDownScanVerticesRule)."""
    if node.kind != "Limit" or not node.deps:
        return None
    sc = node.dep()
    if sc.kind != "ScanVertices":
        return None
    cnt = node.args.get("count", -1)
    if cnt is None or cnt < 0 or sc.args.get("limit") is not None:
        return None
    sc.args["limit"] = (node.args.get("offset", 0) or 0) + cnt
    return None     # Limit stays for exactness


@register_rule
def push_limit_down_index_scan(node: PlanNode) -> Optional[PlanNode]:
    """Limit(IndexScan) / Limit(Project(IndexScan)) plants a scan bound
    (reference: PushLimitDownIndexScanRule); the scan counts rows AFTER
    its residual filter, so the bound is exact."""
    if node.kind != "Limit" or not node.deps:
        return None
    cnt = node.args.get("count", -1)
    if cnt is None or cnt < 0:
        return None
    target = node.dep()
    if target.kind == "Project" and target.deps:
        target = target.dep()
    if target.kind not in ("IndexScan", "FulltextIndexScan") or \
            target.args.get("limit") is not None:
        return None
    target.args["limit"] = (node.args.get("offset", 0) or 0) + cnt
    return None


@register_rule
def push_filter_down_append_vertices(node: PlanNode) -> Optional[PlanNode]:
    """Filter(AppendVertices) conjuncts that only touch the appended
    vertex alias merge into the node's own filter (reference:
    PushFilterDownAppendVerticesRule)."""
    if node.kind != "Filter" or not node.deps:
        return None
    av = node.dep()
    if av.kind != "AppendVertices":
        return None
    alias = av.args.get("col")
    cond = node.args.get("condition")
    if cond is None or not alias:
        return None
    pushable, rest = [], []
    for c in split_conjuncts(cond):
        refs = _col_refs(c)
        if refs is not None and refs and refs <= {alias}:
            pushable.append(c)
        else:
            rest.append(c)
    if not pushable:
        return None
    prev = av.args.get("filter")
    av.args["filter"] = join_conjuncts(
        ([prev] if prev is not None else []) + pushable)
    if rest:
        node.args["condition"] = join_conjuncts(rest)
        return None
    return av


@register_rule
def push_filter_into_join_sides(node: PlanNode) -> Optional[PlanNode]:
    """Filter(HashInnerJoin/CrossJoin) conjuncts that read only one
    side's columns move below the join (reference:
    PushFilterDownInnerJoinRule)."""
    if node.kind != "Filter" or not node.deps:
        return None
    jn = node.dep()
    if jn.kind not in ("HashInnerJoin", "CrossJoin") or len(jn.deps) != 2:
        return None
    cond = node.args.get("condition")
    if cond is None:
        return None
    sides = [set(jn.dep(0).col_names), set(jn.dep(1).col_names)]
    moved = {0: [], 1: []}
    rest = []
    for c in split_conjuncts(cond):
        refs = _col_refs(c)
        if refs is None or not refs:
            rest.append(c)
        elif refs <= sides[0]:
            moved[0].append(c)
        elif refs <= sides[1]:
            moved[1].append(c)
        else:
            rest.append(c)
    if not moved[0] and not moved[1]:
        return None
    match_row = node.args.get("match_row", False)
    for i in (0, 1):
        if moved[i]:
            child = jn.dep(i)
            f = PlanNode("Filter", deps=[child],
                         col_names=list(child.col_names),
                         args={"condition": join_conjuncts(moved[i]),
                               "match_row": match_row})
            jn.deps[i] = f
    jn.input_vars = [d.output_var for d in jn.deps]
    if rest:
        node.args["condition"] = join_conjuncts(rest)
        return None
    return jn


@register_rule
def eliminate_noop_project(node: PlanNode) -> Optional[PlanNode]:
    """Project that only re-emits its input columns unchanged and in
    order → child (reference: RemoveNoopProjectRule)."""
    if node.kind != "Project" or len(node.deps) != 1:
        return None
    if any(node.args.get(f) for f in
           ("go_row", "match_row", "lookup_row", "fetch_row")):
        return None
    child = node.dep()
    cols = node.args.get("columns", [])
    if [n for _, n in cols] != list(child.col_names):
        return None
    for e, n in cols:
        if not (isinstance(e, InputProp) and e.name == n):
            return None
    return child


def _rename_only_project(node: PlanNode) -> bool:
    """Project whose every column is a bare input reference (possibly
    renamed) — commuting row-count operators through it is safe."""
    if node.kind != "Project" or len(node.deps) != 1:
        return False
    if any(node.args.get(f) for f in
           ("go_row", "match_row", "lookup_row", "fetch_row")):
        return False
    return all(isinstance(e, InputProp)
               for e, _ in node.args.get("columns", []))


@register_rule
def push_topn_down_project(node: PlanNode) -> Optional[PlanNode]:
    """TopN(Project[rename-only]) → Project(TopN') with sort keys
    remapped through the rename (reference: PushTopNDownProjectRule) —
    the Project then materializes only the kept rows."""
    if node.kind != "TopN" or len(node.deps) != 1:
        return None
    proj = node.dep()
    if not _rename_only_project(proj) or len(proj.deps) != 1:
        return None
    rename = {n: e.name for e, n in proj.args.get("columns", [])}
    factors = node.args.get("factors", [])
    try:
        new_factors = [(rename[name], asc) for name, asc in factors]
    except (KeyError, TypeError, ValueError):
        return None
    child = proj.dep()
    topn = PlanNode("TopN", deps=[child], col_names=list(child.col_names),
                    args={"factors": new_factors,
                          "count": node.args.get("count"),
                          "offset": node.args.get("offset", 0),
                          "match_row": node.args.get("match_row", False)})
    return PlanNode("Project", deps=[topn],
                    col_names=list(proj.col_names),
                    args=dict(proj.args))


@register_rule
def push_dedup_through_project(node: PlanNode) -> Optional[PlanNode]:
    """Dedup(Project[rename-only, no duplicated source col]) →
    Project(Dedup) (reference: PushDedupDownProjectRule analog): dedup
    on the narrower pre-rename rows is the same row set when the
    projection is a bijection of columns."""
    if node.kind != "Dedup" or len(node.deps) != 1:
        return None
    proj = node.dep()
    if not _rename_only_project(proj) or len(proj.deps) != 1:
        return None
    srcs = [e.name for e, _ in proj.args.get("columns", [])]
    child = proj.dep()
    # bijection: every input column referenced exactly once, all of them
    if sorted(srcs) != sorted(child.col_names):
        return None
    dd = PlanNode("Dedup", deps=[child], col_names=list(child.col_names),
                  args={"match_row": node.args.get("match_row", False)})
    return PlanNode("Project", deps=[dd], col_names=list(proj.col_names),
                    args=dict(proj.args))


@register_rule
def push_filter_into_index_scan(node: PlanNode) -> Optional[PlanNode]:
    """Filter(IndexScan) in LOOKUP (schema-name) form → IndexScan with
    the residual filter applied during the scan (reference:
    PushFilterDownIndexScanRule): entities are dropped before the
    Project materializes them."""
    if node.kind != "Filter" or len(node.deps) != 1:
        return None
    if node.args.get("match_row"):      # MATCH-form exprs bind aliases,
        return None                     # not the schema name
    scan = node.dep()
    if scan.kind != "IndexScan" or scan.args.get("filter") is not None \
            or scan.args.get("limit") is not None:
        return None
    schema = scan.args.get("schema")
    cond = node.args.get("condition")
    if cond is None:
        return None
    # only conditions over the scanned schema's own props evaluate
    # identically inside the scan's row context
    for x in walk(cond):
        if x.kind == "label_tag_prop":
            if x.var != schema:
                return None
        elif x.kind not in ("literal", "binary", "unary", "list", "set",
                            "edge_prop"):
            return None
        elif x.kind == "edge_prop" and x.edge not in (schema, "__edge__"):
            return None
    new_args = dict(scan.args)
    new_args["filter"] = node.args["condition"]
    return PlanNode("IndexScan", deps=[], col_names=list(scan.col_names),
                    args=new_args)


@register_rule
def eliminate_dedup_after_unique_scan(node: PlanNode) -> Optional[PlanNode]:
    """Dedup over a scan that already emits unique single-entity rows
    (ScanVertices / vertex IndexScan dedup by vid internally) → child
    (reference: RemoveNoopDedupRule class)."""
    if node.kind != "Dedup" or len(node.deps) != 1:
        return None
    child = node.dep()
    if child.kind == "ScanVertices" and len(child.col_names) == 1:
        return child
    if child.kind == "IndexScan" and not child.args.get("is_edge") \
            and len(child.col_names) == 1:
        return child
    return None


@register_rule
def const_fold_filter_condition(node: PlanNode) -> Optional[PlanNode]:
    """Filter whose condition is a literal-only expression folds to the
    TRUE/FALSE form the eliminate_{true,false}_filter rules consume
    (reference: FoldConstantExprRule, filter leg)."""
    from ..core.expr import DictContext, Literal, to_bool3
    if node.kind != "Filter":
        return None
    cond = node.args.get("condition")
    if cond is None or cond.kind == "literal":
        return None
    if any(x.kind not in ("literal", "binary", "unary", "list", "set")
           for x in walk(cond)):
        return None
    try:
        val = to_bool3(cond.eval(DictContext()))
    except Exception:  # noqa: BLE001 — leave runtime errors to runtime
        return None
    new_args = dict(node.args)
    new_args["condition"] = Literal(val is True)
    return PlanNode("Filter", deps=list(node.deps),
                    col_names=list(node.col_names), args=new_args)


def _setop_pushable(node: PlanNode) -> bool:
    if len(node.deps) != 2:
        return False
    l, r = node.deps
    return list(l.col_names) == list(node.col_names) \
        and list(r.col_names) == list(node.col_names)


@register_rule
def push_filter_down_set_op(node: PlanNode) -> Optional[PlanNode]:
    """Filter(Union/Intersect/Minus) → SetOp(Filter(l), Filter(r)) —
    row-level predicates commute with all three set ops (reference:
    PushFilterDownUnionRule family); each branch shrinks before the
    hash-join/dedup work."""
    if node.kind != "Filter" or len(node.deps) != 1:
        return None
    op = node.dep()
    if op.kind not in ("Union", "Intersect", "Minus") \
            or not _setop_pushable(op):
        return None
    if any(x.kind == "input_prop" and x.name not in op.col_names
           for x in walk(node.args.get("condition"))):
        return None
    branches = []
    for d in op.deps:
        f = PlanNode("Filter", deps=[d], col_names=list(d.col_names),
                     args=dict(node.args))
        branches.append(f)
    return PlanNode(op.kind, deps=branches,
                    col_names=list(op.col_names), args=dict(op.args))


def _planted_bound(d: PlanNode, kinds: Tuple[str, ...]) -> bool:
    """True when a branch already carries a planted row-bound node,
    looking THROUGH rename-only Projects: the push-through-project
    rules rewrite a planted Limit/TopN into Project(Limit/TopN), and a
    guard on the immediate child kind alone would re-plant every
    fixpoint round."""
    while _rename_only_project(d):
        d = d.dep()
    return d.kind in kinds


@register_rule
def push_limit_into_union_all(node: PlanNode) -> Optional[PlanNode]:
    """Limit(UNION ALL) keeps its outer cut but plants the same bound on
    each branch (reference: PushLimitDownUnionAllRule): each side stops
    producing past offset+count rows."""
    if node.kind != "Limit" or len(node.deps) != 1:
        return None
    u = node.dep()
    if u.kind != "Union" or u.args.get("distinct") \
            or not _setop_pushable(u):
        return None
    cnt = node.args.get("count")
    if cnt is None or cnt < 0:
        return None
    bound = cnt + (node.args.get("offset") or 0)
    if any(_planted_bound(d, ("Limit", "TopN")) for d in u.deps):
        return None                      # already planted (fixpoint stop)
    branches = [PlanNode("Limit", deps=[d], col_names=list(d.col_names),
                         args={"count": bound, "offset": 0})
                for d in u.deps]
    nu = PlanNode("Union", deps=branches, col_names=list(u.col_names),
                  args=dict(u.args))
    return PlanNode("Limit", deps=[nu], col_names=list(node.col_names),
                    args=dict(node.args))


def _is_empty_marker(n: PlanNode) -> bool:
    return n.kind == "Project" and n.args.get("empty") and not n.deps


@register_rule
def eliminate_empty_set_op_branch(node: PlanNode) -> Optional[PlanNode]:
    """Set op with a statically-empty branch simplifies (reference: the
    degenerate-plan prune family): UNION keeps the live side (deduped
    when distinct), INTERSECT dies, MINUS keeps/dies by side."""
    if node.kind not in ("Union", "Intersect", "Minus") \
            or not _setop_pushable(node):
        return None                      # branch col names must equal the
    l, r = node.deps                     # op's: the survivor replaces it
    le, re_ = _is_empty_marker(l), _is_empty_marker(r)
    if not le and not re_:
        return None

    def empty():
        return PlanNode("Project", deps=[], col_names=list(node.col_names),
                        args={"empty": True})

    def distinct_of(side):
        # set-op executors dedup their output; the surviving branch
        # must keep that semantics
        return PlanNode("Dedup", deps=[side],
                        col_names=list(side.col_names), args={})

    if node.kind == "Union":
        if le and re_:
            return empty()
        live = r if le else l
        return distinct_of(live) if node.args.get("distinct") else live
    if node.kind == "Intersect":
        return empty()
    # Minus
    if le:
        return empty()
    return distinct_of(l)


@register_rule
def fold_constant_project_columns(node: PlanNode) -> Optional[PlanNode]:
    """Project columns that are literal-only arithmetic fold to their
    value at plan time (reference: FoldConstantExprRule, project leg)."""
    from ..core.expr import DictContext, Literal
    if node.kind != "Project":
        return None
    cols = node.args.get("columns") or []
    new_cols, changed = [], False
    for e, n in cols:
        if e.kind in ("binary", "unary") and all(
                x.kind in ("literal", "binary", "unary")
                for x in walk(e)):
            try:
                val = e.eval(DictContext())
            except Exception:  # noqa: BLE001 — leave runtime errors alone
                new_cols.append((e, n))
                continue
            from ..core.value import is_null
            if is_null(val) or isinstance(val, (list, tuple, set, dict)):
                # null KINDS and container identity must survive to
                # runtime untouched
                new_cols.append((e, n))
                continue
            new_cols.append((Literal(val), n))
            changed = True
        else:
            new_cols.append((e, n))
    if not changed:
        return None
    new_args = dict(node.args)
    new_args["columns"] = new_cols
    return PlanNode("Project", deps=list(node.deps),
                    col_names=list(node.col_names), args=new_args)


@register_rule
def push_sample_down_project(node: PlanNode) -> Optional[PlanNode]:
    """Sample(Project[rename-only]) → Project(Sample) — sampling rows
    commutes with a column rename; the Project then materializes only
    the sampled rows (reference: PushSampleDownProjectRule class)."""
    if node.kind != "Sample" or len(node.deps) != 1:
        return None
    proj = node.dep()
    if not _rename_only_project(proj) or len(proj.deps) != 1:
        return None
    child = proj.dep()
    smp = PlanNode("Sample", deps=[child], col_names=list(child.col_names),
                   args=dict(node.args))
    return PlanNode("Project", deps=[smp], col_names=list(proj.col_names),
                    args=dict(proj.args))


@register_rule
def merge_dedup_into_distinct_union(node: PlanNode) -> Optional[PlanNode]:
    """Dedup(UNION DISTINCT) → the union (its executor already dedups)
    (reference: RemoveNoopDedupRule over distinct set ops)."""
    if node.kind != "Dedup" or len(node.deps) != 1:
        return None
    child = node.dep()
    if child.kind in ("Union",) and child.args.get("distinct"):
        return child
    if child.kind in ("Intersect", "Minus"):
        return child                     # both executors emit distinct rows
    return None


@register_rule
def push_filter_down_sort(node: PlanNode) -> Optional[PlanNode]:
    """Filter(Sort) → Sort(Filter): filtering preserves a stable sort's
    order, and the sort then works on fewer rows (reference:
    PushFilterDownSortRule class)."""
    if node.kind != "Filter" or len(node.deps) != 1:
        return None
    srt = node.dep()
    if srt.kind != "Sort" or len(srt.deps) != 1:
        return None
    child = srt.dep()
    f = PlanNode("Filter", deps=[child], col_names=list(child.col_names),
                 args=dict(node.args))
    return PlanNode("Sort", deps=[f], col_names=list(srt.col_names),
                    args=dict(srt.args))


@register_rule
def eliminate_dedup_after_aggregate(node: PlanNode) -> Optional[PlanNode]:
    """Dedup(Aggregate) → Aggregate when every group key is among the
    projected columns — each group emits exactly one row, and rows from
    different groups differ on the key columns."""
    from ..core.expr import to_text
    if node.kind != "Dedup" or len(node.deps) != 1:
        return None
    agg = node.dep()
    if agg.kind != "Aggregate":
        return None
    keys = agg.args.get("group_keys") or []
    if not keys:
        return agg                       # global aggregate: single row
    col_texts = {to_text(e) for e, _ in agg.args.get("columns", [])}
    if all(to_text(k) in col_texts for k in keys):
        return agg
    return None


@register_rule
def merge_limit_into_topn(node: PlanNode) -> Optional[PlanNode]:
    """Limit(TopN) → TopN with the composed window (same offset
    composition as merge_adjacent_limits)."""
    if node.kind != "Limit" or len(node.deps) != 1:
        return None
    tn = node.dep()
    if tn.kind != "TopN":
        return None
    lo, lc = node.args.get("offset") or 0, node.args.get("count")
    to_, tc = tn.args.get("offset") or 0, tn.args.get("count")
    if lc is None or lc < 0 or tc is None or tc < 0:
        return None
    new_off = to_ + lo
    new_cnt = max(0, min(tc - lo, lc))
    new_args = dict(tn.args)
    new_args["offset"], new_args["count"] = new_off, new_cnt
    return PlanNode("TopN", deps=list(tn.deps),
                    col_names=list(node.col_names), args=new_args)


@register_rule
def push_filter_down_left_join(node: PlanNode) -> Optional[PlanNode]:
    """Filter(HashLeftJoin) conjuncts reading only LEFT-side columns
    merge into the left branch's OWN Filter (reference:
    PushFilterDownLeftJoinRule): filtering preserved-side rows before
    the join is equivalent, while right-side conjuncts must stay above
    (they'd drop null-extended rows differently).

    The merge is IN PLACE into an existing left-root Filter — never a
    new node: OPTIONAL MATCH right sides reference the left root by
    output_var (Argument.from_var), so replacing the root would orphan
    that linkage.  When the left root
    isn't a Filter the rule simply doesn't fire."""
    if node.kind != "Filter" or not node.deps:
        return None
    jn = node.dep()
    if jn.kind != "HashLeftJoin" or len(jn.deps) != 2:
        return None
    lroot = jn.dep(0)
    if lroot.kind != "Filter":
        return None
    cond = node.args.get("condition")
    if cond is None:
        return None
    left_cols = set(lroot.col_names)
    moved, rest = [], []
    for c in split_conjuncts(cond):
        refs = _col_refs(c)
        if refs and refs <= left_cols:
            moved.append(c)
        else:
            rest.append(c)
    if not moved:
        return None
    lroot.args["condition"] = join_conjuncts(
        [lroot.args["condition"]] + moved)
    if rest:
        node.args["condition"] = join_conjuncts(rest)
        return None
    return jn


@register_rule
def merge_project_into_aggregate(node: PlanNode) -> Optional[PlanNode]:
    """Project[rename-only](Aggregate) → Aggregate emitting the renamed
    (possibly reordered / pruned) columns directly (reference:
    MergeProjectWithAggregateRule analog): grouping is defined by
    group_keys, so dropping or renaming output columns cannot change
    the groups — and one plan node's row materialization disappears."""
    if node.kind != "Project" or len(node.deps) != 1:
        return None
    if not _rename_only_project(node):
        return None
    agg = node.dep()
    if agg.kind != "Aggregate":
        return None
    by_name = {n: e for e, n in agg.args.get("columns", [])}
    new_cols = []
    for e, out in node.args.get("columns", []):
        src = by_name.get(e.name)
        if src is None:
            return None
        new_cols.append((src, out))
    new_args = dict(agg.args)
    new_args["columns"] = new_cols
    return PlanNode("Aggregate", deps=list(agg.deps),
                    col_names=list(node.col_names), args=new_args)


@register_rule
def push_topn_into_union_all(node: PlanNode) -> Optional[PlanNode]:
    """TopN(UNION ALL) keeps its outer cut but plants a bound-sized
    TopN on each branch (reference: PushTopNDownUnionAllRule analog):
    any row beyond each side's top offset+count can never make the
    overall window."""
    if node.kind != "TopN" or len(node.deps) != 1:
        return None
    u = node.dep()
    if u.kind != "Union" or u.args.get("distinct") \
            or not _setop_pushable(u):
        return None
    cnt = node.args.get("count")
    if cnt is None or cnt < 0:
        return None
    bound = cnt + (node.args.get("offset") or 0)
    if any(_planted_bound(d, ("TopN",)) for d in u.deps):
        return None                      # already planted (fixpoint stop)
    branches = [PlanNode("TopN", deps=[d], col_names=list(d.col_names),
                         args={"factors": list(node.args.get("factors", [])),
                               "count": bound, "offset": 0})
                for d in u.deps]
    nu = PlanNode("Union", deps=branches, col_names=list(u.col_names),
                  args=dict(u.args))
    return PlanNode("TopN", deps=[nu], col_names=list(node.col_names),
                    args=dict(node.args))


@register_rule
def push_filter_through_unwind(node: PlanNode) -> Optional[PlanNode]:
    """Filter(Unwind) conjuncts that don't read the unwound alias move
    below the Unwind (reference: PushFilterDownUnwindRule analog): they
    hold once per input row instead of once per unwound element."""
    if node.kind != "Filter" or not node.deps:
        return None
    uw = node.dep()
    if uw.kind != "Unwind" or len(uw.deps) != 1:
        return None
    alias = uw.args.get("alias")
    child = uw.dep()
    child_cols = set(child.col_names)
    cond = node.args.get("condition")
    if cond is None:
        return None
    moved, rest = [], []
    for c in split_conjuncts(cond):
        refs = _col_refs(c)
        if refs and alias not in refs and refs <= child_cols:
            moved.append(c)
        else:
            rest.append(c)
    if not moved:
        return None
    f = PlanNode("Filter", deps=[child], col_names=list(child.col_names),
                 args={"condition": join_conjuncts(moved),
                       "match_row": node.args.get("match_row", False)})
    uw.deps[0] = f
    uw.input_vars = [d.output_var for d in uw.deps]
    if rest:
        node.args["condition"] = join_conjuncts(rest)
        return None
    return uw


# expr kinds expr.rewrite() traverses AND whose column references are
# plain names — a WHITELIST: substitution through any other kind (slice,
# list_comprehension, reduce, compound refs, ...) either can't reach the
# nested reference or can't re-home it, so such conjuncts never move
_SUBSTITUTABLE_KINDS = frozenset((
    "literal", "input_prop", "var", "label", "binary", "unary", "list",
    "map", "function", "aggregate", "subscript", "case", "cast"))


def _plain_col_refs(e: Expr) -> Optional[set]:
    """Column names read through PLAIN references only — None when the
    expr contains ANY node kind outside the substitution whitelist
    (rewrite() must be able to traverse to, and rename, every column
    reference; a nested ref it can't reach would be pushed verbatim and
    bind to the wrong input column)."""
    names = set()
    for x in walk(e):
        if x.kind not in _SUBSTITUTABLE_KINDS:
            return None
        if x.kind in ("input_prop", "var", "label"):
            names.add(x.name)
    return names


@register_rule
def push_filter_through_aggregate(node: PlanNode) -> Optional[PlanNode]:
    """Filter(Aggregate) conjuncts reading only group-key OUTPUT columns
    move below the Aggregate with the key exprs substituted back in
    (reference: PushFilterDownAggregateRule): a group key is constant
    within its group, so pre-filtering input rows drops exactly the
    rejected groups — and the aggregate hashes fewer rows."""
    from ..core.expr import rewrite
    if node.kind != "Filter" or len(node.deps) != 1:
        return None
    agg = node.dep()
    if agg.kind != "Aggregate" or len(agg.deps) != 1:
        return None
    # a MATCH tail (Aggregate over AppendVertices/Traverse) is the
    # TpuMatchAgg fusion shape; planting a Filter inside it would break
    # the device fusion for a host-side win that doesn't pay for it
    if any(n.kind in ("AppendVertices", "Traverse")
           for n in walk_plan(agg)):
        return None
    keys = agg.args.get("group_keys") or []
    if not keys:
        return None
    key_texts = {to_text(k) for k in keys}
    key_cols = {}
    for e, n in agg.args.get("columns", []):
        if to_text(e) in key_texts \
                and not any(x.kind == "aggregate" for x in walk(e)):
            key_cols[n] = e
    cond = node.args.get("condition")
    if cond is None or not key_cols:
        return None
    moved, rest = [], []
    for c in split_conjuncts(cond):
        refs = _plain_col_refs(c)
        if refs and refs <= set(key_cols):
            moved.append(rewrite(
                c, lambda x: key_cols[x.name]
                if x.kind in ("input_prop", "var", "label")
                and x.name in key_cols else None))
        else:
            rest.append(c)
    if not moved:
        return None
    child = agg.dep()
    f = PlanNode("Filter", deps=[child], col_names=list(child.col_names),
                 args={"condition": join_conjuncts(moved),
                       "match_row": node.args.get("match_row", False)})
    agg.deps[0] = f
    agg.input_vars = [d.output_var for d in agg.deps]
    if rest:
        # return the mutated node (not None) so the fixpoint records a
        # change and the next pass can keep pushing the planted Filter
        # (e.g. through a Dedup below); re-entry terminates because the
        # remaining conjuncts no longer reference only key columns
        node.args["condition"] = join_conjuncts(rest)
        return node
    return agg


@register_rule
def merge_consecutive_sorts(node: PlanNode) -> Optional[PlanNode]:
    """Sort/TopN over Sort → ONE node ordering by (outer keys, inner
    keys).  Both executors sort stably, so the outer pass over
    inner-sorted rows IS the composite order — merging preserves
    byte-identical output while deleting a full O(n log n) pass
    (reference: EliminateSortRule-family analog, kept exact)."""
    if node.kind not in ("Sort", "TopN") or len(node.deps) != 1:
        return None
    inner = node.dep()
    if inner.kind != "Sort" or len(inner.deps) != 1:
        return None
    outer_f = list(node.args.get("factors") or [])
    inner_f = list(inner.args.get("factors") or [])
    seen = {to_text(e) for e, _ in outer_f}
    merged = outer_f + [(e, d) for e, d in inner_f
                        if to_text(e) not in seen]
    node.args["factors"] = merged
    node.deps[0] = inner.dep()
    node.input_vars = [d.output_var for d in node.deps]
    return node


# duplicate rows cannot change these folds: min/max are idempotent
# under repetition, collect_set and bit_and/bit_or absorb duplicates
_DUP_INSENSITIVE_AGGS = {"min", "max", "collect_set", "bit_and", "bit_or"}


@register_rule
def eliminate_dedup_under_dupfree_aggregate(node: PlanNode
                                            ) -> Optional[PlanNode]:
    """Aggregate(Dedup(x)) → Aggregate(x) when every output column is a
    group key or a duplicate-insensitive / DISTINCT aggregate: dup rows
    land in the same group and cannot move any such fold (reference:
    EliminateAggDedupRule analog)."""
    if node.kind != "Aggregate" or len(node.deps) != 1:
        return None
    dd = node.dep()
    if dd.kind != "Dedup" or len(dd.deps) != 1:
        return None
    key_texts = {to_text(k) for k in (node.args.get("group_keys") or [])}
    for e, _ in node.args.get("columns", []):
        aggs = [x for x in walk(e) if x.kind == "aggregate"]
        if aggs:
            if not all(x.distinct or x.func in _DUP_INSENSITIVE_AGGS
                       for x in aggs):
                return None
        elif to_text(e) not in key_texts:
            return None          # impl-picked value could change
    node.deps[0] = dd.dep()
    node.input_vars = [d.output_var for d in node.deps]
    return node


@register_explore_rule
def index_seed_for_match_scan(node: PlanNode, pctx) -> List[PlanNode]:
    """MATCH (a:T) WHERE a.T.prop ... : offer Filter(IndexScan) as an
    alternative to Filter(ScanVertices) — one alternative per index
    whose column hints bind at least one predicate (reference:
    OptimizeTagIndexScanByFilterRule).  The full filter stays on top
    (the hints are implied by it), so rows are identical; the cost
    model picks the most selective binding."""
    if node.kind != "Filter" or len(node.deps) != 1:
        return []
    scan = node.dep()
    if scan.kind != "ScanVertices" or not scan.args.get("tag"):
        return []
    tag = scan.args["tag"]
    alias = scan.args.get("as_col") or scan.col_names[0]
    space = scan.args["space"]
    cond = node.args.get("condition")
    if cond is None:
        return []
    conds = {}
    for i, c in enumerate(split_conjuncts(cond)):
        if c.kind != "binary" or c.op not in ("==", "<", "<=", ">", ">="):
            continue
        lhs, rhs, op = c.lhs, c.rhs, c.op
        if rhs.kind == "label_tag_prop" and lhs.kind == "literal":
            lhs, rhs = rhs, lhs
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        if lhs.kind != "label_tag_prop" or rhs.kind != "literal":
            continue
        if lhs.var != alias or lhs.tag != tag:
            continue
        conds.setdefault(lhs.prop, []).append((op, rhs.value, i))
    if not conds:
        return []
    try:
        indexes = pctx.catalog.indexes_for(space, tag, False)
    except Exception:  # noqa: BLE001 — schema raced away; no alternative
        return []
    from .planner import score_index_hints
    alts = []
    for d in indexes:
        if any(getattr(d, "field_lens", None) or []):
            # string-prefix indexes need value truncation + a full
            # residual; the LOOKUP planner handles that — this scan
            # alternative would probe with untruncated values and miss
            continue
        best = score_index_hints([d], conds)
        if best is None:
            continue
        (n_eq, has_rng), name, eq, rng, _used = best
        if n_eq == 0 and not has_rng:
            continue
        iscan = PlanNode("IndexScan", deps=[], col_names=[alias],
                         args={"space": space, "schema": tag,
                               "is_edge": False, "index": name,
                               "eq": eq, "range": rng})
        filt = PlanNode("Filter", deps=[iscan],
                        col_names=list(node.col_names),
                        args=dict(node.args))
        filt.output_var = node.output_var
        alts.append(filt)
    return alts


@register_explore_rule
def geo_index_seed_for_match_scan(node: PlanNode, pctx) -> List[PlanNode]:
    """MATCH (a:T) WHERE ST_Intersects(a.T.g, <const>) ...: offer
    Filter(IndexScan geo_ranges) over the cell-token geo index as an
    alternative to Filter(ScanVertices) (reference: the geo variant of
    OptimizeTagIndexScanByFilterRule).  The full filter stays on top — the covering ranges
    are a bbox superset, so rows are identical."""
    if node.kind != "Filter" or len(node.deps) != 1:
        return []
    scan = node.dep()
    if scan.kind != "ScanVertices" or not scan.args.get("tag"):
        return []
    tag = scan.args["tag"]
    alias = scan.args.get("as_col") or scan.col_names[0]
    space = scan.args["space"]
    cond = node.args.get("condition")
    if cond is None:
        return []
    from .planner import _geo_index_for, _lookup_geo_cond
    for c in split_conjuncts(cond):
        m = _lookup_geo_cond(c, tag, False, alias=alias)
        if m is None:
            continue
        d = _geo_index_for(pctx, space, tag, False, m[0])
        if d is None:
            continue
        iscan = PlanNode("IndexScan", deps=[], col_names=[alias],
                         args={"space": space, "schema": tag,
                               "is_edge": False, "index": d.name,
                               "geo_ranges": m[1]})
        filt = PlanNode("Filter", deps=[iscan],
                        col_names=list(node.col_names),
                        args=dict(node.args))
        filt.output_var = node.output_var
        return [filt]
    return []
