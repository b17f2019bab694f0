"""The port's copy of `nebula_tpu/tpu/match_agg.py`, whole.

TpuMatchAgg: fused fixed-length MATCH → aggregate device pipeline.

The reference executes an IC-shaped aggregate MATCH —

    MATCH (p)-[:E]->(f)-[:E]->(ff) WHERE <vertex preds>
    RETURN id(ff), count(*)

— as a chain of per-hop GetNeighbors RPC fan-outs with row-at-a-time
filter/aggregate executors above them (reference: the Traverse /
AppendVertices / Aggregate executor stack in src/graph/executor).
Here the whole chain collapses into ONE plan node:

  * one multi-hop device expansion (`GpuRuntime.traverse_hops`) — the
    frontier never leaves device memory between hops;
  * columnar trail assembly on host numpy (the same searchsorted join
    the unfused device Traverse uses, but never decoding Edge/Vertex
    objects at all);
  * vertex predicates (labels, `_hastag`, `v.Tag.prop` filters)
    evaluated as numpy masks over the snapshot's TagTable columns
    (exprjit.compile_vertex_predicate_np) — per POSITION in the
    pattern, pruning trails hop-by-hop;
  * relationship-uniqueness (`_edges_distinct`) enforced by the
    assembly's columnar canonical-key compare — the planner's Filter
    conjunct is absorbed, not re-checked per row;
  * the aggregate itself is a numpy lexsort group-by: count(*) /
    count(id(v)) / count(DISTINCT id(v)) over int64 dense-id columns.

Python row objects are never built: the node's output is the final
(tiny) aggregate table.  Variable-length patterns (`-[e:E*m..M]->`,
the Twitter-proxy benchmark shape) fuse too: one device expansion to
M hops, with the terminal checks gating EMISSION per depth — never
continuation — exactly like the unfused AppendVertices-after-Traverse
ordering.  Anything the rule cannot prove — per-hop edge filters,
non-id group keys, cross-alias predicates, aggregates beyond counts,
unbounded `*m..` — leaves the plan unfused on the general executors.
At run time the executors' error policy holds (`run_on_device`): only a
`CannotCompile` (a store without a dense-id surface among them) takes
`_host_match_agg`, a host implementation with the exact chain
semantics; a device error is the statement's error.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core import expr as E
from ..core.value import DataSet, Vertex, is_null
from ..exec.executors import executor, _make_edge
from ..query import optimizer as opt
from ..query.plan import PlanNode
from .exprjit import (CannotCompile, compile_vertex_predicate_np,
                      vertex_compilable)
from .runtime import _d2v, join_frontier_trails, trail_distinct_keep
from .traverse import run_on_device


# ---------------------------------------------------------------------------
# Plan-shape helpers
# ---------------------------------------------------------------------------


def _is_edges_distinct(e: E.Expr, edge_aliases: List[str]) -> bool:
    return (isinstance(e, E.FunctionCall) and e.name == "_edges_distinct"
            and all(isinstance(a, E.LabelExpr) for a in e.args)
            and {a.name for a in e.args} == set(edge_aliases))


def _id_alias(e: E.Expr) -> Optional[str]:
    """alias for `id(<alias>)`, else None."""
    if (isinstance(e, E.FunctionCall) and e.name == "id"
            and len(e.args) == 1 and isinstance(e.args[0], E.LabelExpr)):
        return e.args[0].name
    return None


def _head_hastag_tags(cond: E.Expr, alias: str) -> Optional[List[str]]:
    """Filter over the seed GetVertices: AND of _hastag(alias, T) only."""
    tags = []
    for c in E.split_conjuncts(cond):
        if (isinstance(c, E.FunctionCall) and c.name == "_hastag"
                and len(c.args) == 2 and isinstance(c.args[0], E.LabelExpr)
                and c.args[0].name == alias
                and isinstance(c.args[1], E.Literal)
                and isinstance(c.args[1].value, str)):
            tags.append(c.args[1].value)
            continue
        return None
    return tags


# ---------------------------------------------------------------------------
# Fusion rule
# ---------------------------------------------------------------------------


def _single(uses: Dict[int, int], node: PlanNode) -> bool:
    return uses.get(node.id, 2) == 1 and len(node.deps) == 1


def make_match_agg_rule(uses: Dict[int, int], root=None):
    def rule(node: PlanNode) -> Optional[PlanNode]:
        if node.kind != "Aggregate":
            return None
        if len(node.deps) != 1:
            return None
        cur = node.dep()
        filt_conjs: List[E.Expr] = []
        if cur.kind == "Filter":
            if not _single(uses, cur):
                return None
            filt_conjs = E.split_conjuncts(cur.args["condition"])
            cur = cur.dep()
        if cur.kind != "AppendVertices" or not _single(uses, cur):
            return None
        term = cur
        term_alias = term.args["col"]
        sp = term.args.get("space")
        term_labels = list(term.args.get("labels") or [])
        term_filter = term.args.get("filter")
        if term_filter is not None \
                and not vertex_compilable(term_filter, term_alias):
            return None
        cur = term.dep()

        # walk the Traverse[←AppendVertices]←Traverse chain, outermost
        # (= terminal hop) first; record which mid positions carry an
        # AppendVertices (the host plane only existence-checks those)
        hops_rev: List[PlanNode] = []
        checked_aliases = set()
        while cur.kind == "Traverse":
            if not _single(uses, cur):
                return None
            a = cur.args
            if a.get("edge_filter") is not None:
                return None
            if a.get("space") != sp:
                return None
            hops_rev.append(cur)
            nxt = cur.dep()
            if nxt.kind == "AppendVertices":
                if not _single(uses, nxt):
                    return None
                if nxt.args.get("filter") is not None \
                        or nxt.args.get("labels"):
                    return None
                if nxt.args.get("space") != sp:
                    return None
                if nxt.args.get("col") != a.get("src_col"):
                    return None
                checked_aliases.add(a.get("src_col"))
                nxt = nxt.dep()
                if nxt.kind != "Traverse":
                    return None
            cur = nxt
        if not hops_rev:
            return None
        hops = hops_rev[::-1]
        # hop-count shape: either a chain of fixed 1-hop Traverses, or
        # ONE variable-length Traverse (MATCH *m..M — config-4 shape);
        # a var-len node inside a longer chain stays on the general path
        if len(hops) == 1:
            min_hop = hops[0].args.get("min_hop")
            max_hop = hops[0].args.get("max_hop")
            if min_hop is None or max_hop is None or max_hop < 1 \
                    or min_hop < 0 or min_hop > max_hop:
                return None              # unbounded (*m..) stays unfused
            var_len = not (min_hop == 1 and max_hop == 1)
        else:
            if any(h.args.get("min_hop") != 1 or h.args.get("max_hop") != 1
                   for h in hops):
                return None
            min_hop, max_hop = len(hops), len(hops)
            var_len = False
        # chain wiring + uniform expansion parameters
        etypes = hops[0].args.get("edge_types")
        direction = hops[0].args.get("direction")
        for i, h in enumerate(hops):
            if h.args.get("edge_types") != etypes \
                    or h.args.get("direction") != direction:
                return None
            if i > 0 and h.args.get("src_col") != hops[i - 1].args.get(
                    "dst_alias"):
                return None
        if hops[-1].args.get("dst_alias") != term_alias:
            return None

        # chain head: optional label Filter over literal-vid GetVertices
        head = cur
        head_tags: List[str] = []
        src_alias = hops[0].args.get("src_col")
        if head.kind == "Filter":
            if not _single(uses, head):
                return None
            tags = _head_hastag_tags(head.args["condition"], src_alias)
            if tags is None:
                return None
            head_tags = tags
            head = head.dep()
        if head.kind != "GetVertices":
            return None
        if uses.get(head.id, 2) != 1 or head.deps:
            return None
        ha = head.args
        if ha.get("src_col") or ha.get("tags") or ha.get("space") != sp:
            return None
        if (ha.get("as_col") or (head.col_names[0] if head.col_names
                                 else None)) != src_alias:
            return None
        vids = ha.get("vids") or []
        for v in vids:
            if isinstance(v, E.Expr) and not isinstance(v, E.Literal):
                return None

        edge_aliases = [h.args.get("edge_alias") for h in hops]
        vertex_aliases = [src_alias] + [h.args.get("dst_alias")
                                        for h in hops]
        if len(set(vertex_aliases)) != len(vertex_aliases):
            # a cyclic pattern re-binds an alias: equality join between
            # positions — not modeled here, stay on the general path
            return None
        checked_aliases.add(src_alias)       # GetVertices builds vertices
        checked_aliases.add(term_alias)      # terminal AppendVertices

        # classify residual Filter conjuncts: relationship uniqueness
        # (absorbed into assembly) or a single-alias vertex predicate
        # (absorbed into that pattern position).  A predicate may only
        # land on a position whose vertex the host plane materialized
        # (an unchecked mid carries a props-less shell Vertex, whose
        # prop reads answer NULL — different semantics).
        edges_distinct = False
        alias_preds: Dict[str, List[E.Expr]] = {}
        for cj in filt_conjs:
            if _is_edges_distinct(cj, edge_aliases):
                edges_distinct = True
                continue
            placed = False
            for al in vertex_aliases:
                if al in checked_aliases and vertex_compilable(cj, al):
                    alias_preds.setdefault(al, []).append(cj)
                    placed = True
                    break
            if not placed:
                return None
        if term_filter is not None:
            alias_preds.setdefault(term_alias, []).append(term_filter)

        # aggregate surface: id(alias) group keys, count aggregates
        group_keys = node.args.get("group_keys") or []
        group_aliases: List[str] = []
        for gk in group_keys:
            al = _id_alias(gk)
            if al is None or al not in vertex_aliases:
                return None
            group_aliases.append(al)
        agg_specs: List[Tuple] = []
        key_texts = [E.to_text(gk) for gk in group_keys]
        for ce, _name in node.args.get("columns") or []:
            if isinstance(ce, E.AggExpr):
                if ce.func != "count":
                    return None
                if ce.arg is None:
                    agg_specs.append(("count", None, False))
                    continue
                al = _id_alias(ce.arg)
                if al is None or al not in vertex_aliases:
                    return None
                agg_specs.append(("count", al, bool(ce.distinct)))
                continue
            txt = E.to_text(ce)
            if txt in key_texts:
                agg_specs.append(("key", group_aliases[key_texts.index(txt)]))
                continue
            return None

        if var_len:
            # the var-len Traverse's DFS enforces distinct edges within
            # each path internally — not via a planner Filter conjunct
            edges_distinct = True
        return PlanNode(
            "TpuMatchAgg", deps=[],
            args={"space": sp, "vids": list(vids), "src_alias": src_alias,
                  "etypes": list(etypes or []), "direction": direction,
                  "steps": max_hop, "min_hop": min_hop, "var_len": var_len,
                  "vertex_aliases": vertex_aliases,
                  "checked_aliases": sorted(checked_aliases),
                  "head_tags": head_tags,
                  "term_labels": term_labels,
                  "alias_preds": {al: E.join_conjuncts(ps)
                                  for al, ps in alias_preds.items()},
                  "edges_distinct": edges_distinct,
                  "group_aliases": group_aliases,
                  "agg_specs": agg_specs},
            col_names=list(node.col_names))

    return rule


opt.TPU_RULES.append(make_match_agg_rule)


# ---------------------------------------------------------------------------
# Executor — device plane
# ---------------------------------------------------------------------------


def _seed_vids(a: Dict[str, Any]) -> List[Any]:
    from ..core.expr import DictContext
    from ..core.value import hashable_key
    out, seen = [], set()
    for ve in a.get("vids") or []:
        v = ve.eval(DictContext()) if isinstance(ve, E.Expr) else ve
        if isinstance(v, Vertex):
            v = v.vid
        if is_null(v):
            continue
        k = hashable_key(v)
        if k in seen:
            continue
        seen.add(k)
        out.append(v)
    return out


def _exists_flat(snap) -> np.ndarray:
    """dense-indexed 'vertex exists' mask (any tag present, mirroring
    build_vertex returning None for tag-less vids); cached on the
    snapshot (epoch-keyed object, so the cache dies with the epoch)."""
    m = getattr(snap, "_exists_flat", None)
    if m is None:
        P = snap.num_parts
        m = np.zeros(P * snap.vmax, bool)
        for tt in snap.tags.values():
            m |= tt.present.T.ravel()
        try:
            snap._exists_flat = m
        except AttributeError:
            pass
    return m


def _tag_flat(snap, tag: str) -> Optional[np.ndarray]:
    tt = snap.tags.get(tag)
    return None if tt is None else tt.present.T.ravel()


def _position_mask_fn(alias: str, a: Dict[str, Any], snap, sd):
    """Build the combined existence + label + predicate mask function
    for one pattern position (compile once, evaluate per depth).
    Positions without an AppendVertices in the unfused plan are never
    existence-checked by the host plane, so they aren't here either
    (parity over dangling edges)."""
    checked = alias in (a.get("checked_aliases") or ())
    labels = a["term_labels"] if alias == a["vertex_aliases"][-1] else []
    tag_flats = []
    dead = False
    for lb in labels:
        tf = _tag_flat(snap, lb)
        if tf is None:
            dead = True
            break
        tag_flats.append(tf)
    pred = (a.get("alias_preds") or {}).get(alias)
    pred_fn = compile_vertex_predicate_np(pred, alias, snap, sd) \
        if pred is not None else None
    exists = _exists_flat(snap) if checked else None

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


def _position_mask(dense: np.ndarray, alias: str, a: Dict[str, Any],
                   snap, sd) -> np.ndarray:
    return _position_mask_fn(alias, a, snap, sd)(dense)


def _group_rows(a: Dict[str, Any], cols: Dict[str, np.ndarray],
                d2v: np.ndarray) -> List[List[Any]]:
    """numpy lexsort group-by over emitted-trail dense-id columns (one
    per referenced vertex alias, all equal length) → output rows."""
    group_aliases = a["group_aliases"]
    agg_specs = a["agg_specs"]
    n = next(iter(cols.values())).size if cols else 0

    def col(al):
        return cols.get(al, np.empty(0, np.int64))

    if not group_aliases:
        row = []
        for spec in agg_specs:
            if spec[1] is None or not spec[2]:
                row.append(int(n))
            else:
                row.append(int(np.unique(col(spec[1])).size) if n else 0)
        return [row]

    if n == 0:
        return []
    keys = [col(al) for al in group_aliases]
    order = np.lexsort(keys[::-1])
    sk = [k[order] for k in keys]
    new_grp = np.zeros(n, bool)
    new_grp[0] = True
    for k in sk:
        new_grp[1:] |= k[1:] != k[:-1]
    starts = np.flatnonzero(new_grp)
    sizes = np.diff(np.concatenate([starts, [n]]))
    gid = np.cumsum(new_grp) - 1          # group id per sorted trail

    out_cols: List[Any] = []
    for spec in agg_specs:
        if spec[0] == "key":
            out_cols.append(d2v[sk[group_aliases.index(spec[1])][starts]])
        elif spec[1] is None or not spec[2]:
            out_cols.append(sizes)
        else:
            tcol = col(spec[1])[order]
            o2 = np.lexsort((tcol, gid))
            g2, t2 = gid[o2], tcol[o2]
            first = np.ones(n, bool)
            first[1:] = (g2[1:] != g2[:-1]) | (t2[1:] != t2[:-1])
            out_cols.append(np.bincount(g2[first],
                                        minlength=starts.size))
    rows = []
    cols_py = [c.tolist() for c in out_cols]
    for i in range(starts.size):
        rows.append([c[i] for c in cols_py])
    return rows


@executor("TpuMatchAgg")
def _tpu_match_agg(node, qctx, ectx, space):
    a = node.args
    rt = getattr(qctx, "tpu_runtime", None)
    if rt is not None:
        from ..utils.config import get_config
        if get_config().get("tpu_match_device"):
            ds = run_on_device(
                qctx, lambda: _device_match_agg(node, qctx, ectx, a, rt))
            if ds is not None:
                return ds
    return _host_match_agg(node, qctx, a)


def _device_match_agg(node, qctx, ectx, a, rt):
    sp = a["space"]
    store = qctx.store
    try:
        sd = store.space(sp)
        sd.dense_id
    except AttributeError:
        # no device fault: the reference's outcome, the host path
        raise CannotCompile("store has no dense-id surface") from None

    dev = rt.pin(store, sp)
    snap = dev.host
    steps = a["steps"]
    src_alias = a["src_alias"]

    vids = _seed_vids(a)
    dense = np.asarray([sd.dense_id(v) for v in vids], np.int64) \
        if vids else np.empty(0, np.int64)
    keep_vids: List[Any] = []
    if dense.size:
        m = dense >= 0
        if m.any():
            d = dense[m]
            pm = _exists_flat(snap)[d]
            for tg in a.get("head_tags") or []:
                tf = _tag_flat(snap, tg)
                pm &= tf[d] if tf is not None else False
            pred = (a.get("alias_preds") or {}).get(src_alias)
            if pred is not None:
                pm &= compile_vertex_predicate_np(pred, src_alias, snap,
                                                  sd)(d)
            kept = d[pm]
            kv = np.asarray(vids, object)[m][pm]
            keep_vids = kv.tolist()
            dense = kept
        else:
            dense = np.empty(0, np.int64)

    if not keep_vids:
        return DataSet(list(node.col_names),
                       _group_rows(a, {}, None)
                       if not a["group_aliases"] else [])

    frames, stats = rt.traverse_hops(store, sp, keep_vids, a["etypes"],
                                     a["direction"], steps)
    qctx.last_tpu_stats = stats
    tracker = getattr(ectx, "tracker", None)
    term_alias = a["vertex_aliases"][-1]
    min_hop = a.get("min_hop", steps)
    d2v = _d2v(snap)

    if a.get("var_len"):
        # MATCH *m..M: terminal checks gate EMISSION at each depth in
        # [max(m,1), M] — they never prune continuation (the unfused
        # plan's AppendVertices filters rows AFTER the whole var-len
        # Traverse).  Edge-distinctness always applies within a path.
        scol, last = dense, dense
        path: List[np.ndarray] = []
        emit_s: List[np.ndarray] = []
        emit_d: List[np.ndarray] = []
        term_mask = _position_mask_fn(term_alias, a, snap, sd)
        if min_hop == 0:
            pm = term_mask(dense)
            emit_s.append(dense[pm])
            emit_d.append(dense[pm])
        for h in range(steps):
            fr = frames[h]
            if scol.size == 0 or fr.n == 0:
                break
            parent, fidx = join_frontier_trails(fr, last)
            if fidx.size == 0:
                break
            if path:
                keep = trail_distinct_keep(frames, path, parent, fr, fidx)
                sel = np.flatnonzero(keep)
                parent, fidx = parent[sel], fidx[sel]
                if fidx.size == 0:
                    break
            scol = scol[parent]
            last = fr.dst[fidx]
            path = [pe[parent] for pe in path] + [fidx]
            if tracker is not None:
                tracker.charge(int(fidx.size) * 8 * (h + 2))
            if h + 1 >= max(min_hop, 1):
                pm = term_mask(last)
                emit_s.append(scol[pm])
                emit_d.append(last[pm])
        es = np.concatenate(emit_s) if emit_s else np.empty(0, np.int64)
        ed = np.concatenate(emit_d) if emit_d else np.empty(0, np.int64)
        cols = {a["src_alias"]: es, term_alias: ed}
        return DataSet(list(node.col_names), _group_rows(a, cols, d2v))

    vcols: List[np.ndarray] = [dense]
    path = []
    alive = True
    for h in range(steps):
        fr = frames[h]
        if vcols[0].size == 0 or fr.n == 0:
            alive = False
            break
        parent, fidx = join_frontier_trails(fr, vcols[-1])
        if fidx.size == 0:
            alive = False
            break
        if a["edges_distinct"] and path:
            keep = trail_distinct_keep(frames, path, parent, fr, fidx)
            sel = np.flatnonzero(keep)
            parent, fidx = parent[sel], fidx[sel]
        nxt = fr.dst[fidx]
        al = a["vertex_aliases"][h + 1]
        pm = _position_mask(nxt, al, a, snap, sd)
        if pm is not None and not pm.all():
            sel = np.flatnonzero(pm)
            parent, fidx, nxt = parent[sel], fidx[sel], nxt[sel]
        vcols = [c[parent] for c in vcols] + [nxt]
        path = [pe[parent] for pe in path] + [fidx]
        if vcols[0].size == 0:
            alive = False
            break

    if not alive:
        vcols = [np.empty(0, np.int64)] * len(a["vertex_aliases"])

    if tracker is not None and vcols[0].size:
        tracker.charge(int(vcols[0].size) * 8 * (steps + 1))

    cols = {al: vcols[i] for i, al in enumerate(a["vertex_aliases"])}
    return DataSet(list(node.col_names), _group_rows(a, cols, d2v))


# ---------------------------------------------------------------------------
# Host fallback — exact chain semantics, no device
# ---------------------------------------------------------------------------


def _host_match_agg(node, qctx, a):
    from ..core.expr import to_bool3
    from ..core.value import hashable_key
    from ..exec.context import RowContext

    sp = a["space"]
    store = qctx.store
    steps = a["steps"]
    etypes = a["etypes"]
    etype_ids = {e: store.catalog.get_edge(sp, e).edge_type for e in etypes}
    direction = a["direction"]
    aliases = a["vertex_aliases"]
    alias_preds = a.get("alias_preds") or {}
    term_alias = aliases[-1]

    vcache: Dict[Any, Optional[Vertex]] = {}

    def vertex_of(vid):
        if vid not in vcache:
            vcache[vid] = qctx.build_vertex(sp, vid)
        return vcache[vid]

    vd_cache: Dict[Tuple[str, Any], bool] = {}

    checked = set(a.get("checked_aliases") or ())

    def position_ok(alias: str, vid) -> bool:
        key = (alias, hashable_key(vid))
        v = vd_cache.get(key)
        if v is None:
            if alias not in checked:
                vd_cache[key] = v = True
                return v
            full = vertex_of(vid)
            ok = full is not None
            if ok and alias == term_alias:
                ok = all(lb in full.tag_names()
                         for lb in a.get("term_labels") or [])
            if ok and alias == aliases[0]:
                ok = all(tg in full.tag_names()
                         for tg in a.get("head_tags") or [])
            pred = alias_preds.get(alias)
            if ok and pred is not None:
                rc = RowContext(qctx, sp, {alias: full})
                ok = to_bool3(pred.eval(rc)) is True
            vd_cache[key] = v = ok
        return v

    groups: Dict[Tuple, Dict[str, Any]] = {}
    order: List[Tuple] = []
    group_aliases = a["group_aliases"]
    agg_specs = a["agg_specs"]
    var_len = a.get("var_len")
    min_hop = a.get("min_hop", steps)
    term_alias = aliases[-1]

    def emit(vals: Dict[str, Any]):
        key = tuple(hashable_key(vals[al]) for al in group_aliases)
        g = groups.get(key)
        if g is None:
            g = groups[key] = {"vids": [vals[al] for al in group_aliases],
                               "n": 0,
                               "sets": [set() for _ in agg_specs]}
            order.append(key)
        g["n"] += 1
        for i, spec in enumerate(agg_specs):
            if spec[0] == "count" and spec[1] is not None and spec[2]:
                g["sets"][i].add(hashable_key(vals[spec[1]]))

    def dfs(vid, depth: int, trail: List[Any], eseen: set):
        if depth == steps:
            emit({al: trail[i] for i, al in enumerate(aliases)})
            return
        for (s, et, rank, other, props, sgn) in store.get_neighbors(
                sp, [vid], etypes, direction):
            e = _make_edge(s, other, et, rank, props, sgn, etype_ids[et])
            ek = e.key()
            if a["edges_distinct"] and ek in eseen:
                continue
            if not position_ok(aliases[depth + 1], other):
                continue
            trail.append(other)
            if a["edges_distinct"]:
                eseen.add(ek)
            dfs(other, depth + 1, trail, eseen)
            if a["edges_distinct"]:
                eseen.discard(ek)
            trail.pop()

    def dfs_var(seed, vid, depth: int, eseen: set):
        # emission gates on the terminal checks; continuation does not
        # (the unfused AppendVertices filters rows AFTER the Traverse)
        for (s, et, rank, other, props, sgn) in store.get_neighbors(
                sp, [vid], etypes, direction):
            e = _make_edge(s, other, et, rank, props, sgn, etype_ids[et])
            ek = e.key()
            if ek in eseen:
                continue
            if depth + 1 >= max(min_hop, 1) \
                    and position_ok(term_alias, other):
                emit({aliases[0]: seed, term_alias: other})
            if depth + 1 < steps:
                eseen.add(ek)
                dfs_var(seed, other, depth + 1, eseen)
                eseen.discard(ek)

    for vid in _seed_vids(a):
        if not position_ok(aliases[0], vid):
            continue
        if var_len:
            if min_hop == 0 and position_ok(term_alias, vid):
                emit({aliases[0]: vid, term_alias: vid})
            dfs_var(vid, vid, 0, set())
        else:
            dfs(vid, 0, [vid], set())

    rows: List[List[Any]] = []
    if not order and not group_aliases:
        row = []
        for spec in agg_specs:
            row.append(0)
        return DataSet(list(node.col_names), [row])
    for key in order:
        g = groups[key]
        row: List[Any] = []
        for i, spec in enumerate(agg_specs):
            if spec[0] == "key":
                row.append(g["vids"][group_aliases.index(spec[1])])
            elif spec[1] is not None and spec[2]:
                row.append(len(g["sets"][i]))
            else:
                row.append(g["n"])
        rows.append(row)
    return DataSet(list(node.col_names), rows)
