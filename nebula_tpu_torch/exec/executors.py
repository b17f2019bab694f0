"""The port's copy of `nebula_tpu/exec/executors.py`, whole.

Executors: one per PlanNode kind.

Analog of the reference's Executor hierarchy (reference: src/graph/executor).  Each executor is a function
``(node, qctx, ectx, space) -> DataSet`` reading its inputs from the
ExecutionContext by the node's input_vars and returning its output DataSet.

The CPU path here is the row-parity oracle; `TpuTraverse` (registered from
nebula_tpu_torch.gpu) replaces ExpandAll chains on device.
"""
from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.expr import (AggExpr, DictContext, Expr, collect_aggregates,
                         has_aggregate, to_bool3)
from ..core.value import (NULL, DataSet, Edge, Path, Step, Tag, Vertex,
                          hashable_key, is_null, total_order_key)
from ..graphstore.schema import PropDef, PropType, SchemaError
from ..graphstore.store import GraphStore
from .context import ExecutionContext, QueryContext, ResultSet, RowContext, row_dict


class ExecError(Exception):
    pass


EXECUTORS: Dict[str, Callable] = {}


def executor(kind: str):
    def deco(fn):
        EXECUTORS[kind] = fn
        return fn
    return deco


def run_node(node, qctx: QueryContext, ectx: ExecutionContext,
             space: Optional[str]) -> DataSet:
    fn = EXECUTORS.get(node.kind)
    if fn is None:
        raise ExecError(f"no executor for plan node `{node.kind}'")
    return fn(node, qctx, ectx, space)


def _input(node, ectx: ExecutionContext, i: int = 0) -> DataSet:
    if not node.input_vars:
        return DataSet()
    return ectx.get_result(node.input_vars[i])


# ---------------------------------------------------------------------------
# control
# ---------------------------------------------------------------------------


@executor("Start")
def _start(node, qctx, ectx, space):
    return DataSet(list(node.col_names), [])


@executor("PassThrough")
def _passthrough(node, qctx, ectx, space):
    return _input(node, ectx)


@executor("Sequence")
def _sequence(node, qctx, ectx, space):
    return _input(node, ectx, 1)


@executor("SetVariable")
def _set_variable(node, qctx, ectx, space):
    ds = _input(node, ectx)
    ectx.set_result(f"${node.args['var']}", ds)
    return ds


@executor("Argument")
def _argument(node, qctx, ectx, space):
    from ..core.value import ColumnarDataSet
    src = ectx.get_result(node.args["from_var"])
    col = node.args["col"]
    i = src.col_index(col)
    if isinstance(src, ColumnarDataSet) and src._cols is not None \
            and src._cols[i].dtype != object:
        # columnar input (device results): first-occurrence distinct
        # without boxing the rows
        c = src._cols[i]
        _, idx = np.unique(c, return_index=True)
        return ColumnarDataSet([col], [c[np.sort(idx)]])
    seen, rows = set(), []
    for r in src.rows:
        k = hashable_key(r[i])
        if k not in seen:
            seen.add(k)
            rows.append([r[i]])
    return DataSet([col], rows)


# ---------------------------------------------------------------------------
# explore
# ---------------------------------------------------------------------------


def _make_edge(src_vid, other_vid, etype_name, rank, props, signed_dir, etype_id):
    from ..core.value import make_edge
    return make_edge(src_vid, other_vid, etype_name, rank, props,
                     signed_dir, etype_id)


@executor("ExpandAll")
def _expand_all(node, qctx, ectx, space):
    a = node.args
    sp = a["space"]
    store: GraphStore = qctx.store
    etypes = a["edge_types"]
    etype_ids = {e: store.catalog.get_edge(sp, e).edge_type for e in etypes}
    direction = a["direction"]
    edge_filter: Optional[Expr] = a.get("edge_filter")
    limit = a.get("limit")
    carry: List[str] = a.get("carry") or []

    # resolve sources: literal vids or an input column
    src_rows: List[Tuple[List[Any], Any]] = []  # (carried values, src vid)
    if a.get("src_col") is None:
        for ve in a.get("vids") or []:
            vid = ve.eval(DictContext()) if isinstance(ve, Expr) else ve
            src_rows.append(([], vid))
    else:
        ds = _input(node, ectx)
        ci = ds.col_index(a["src_col"])
        carry_idx = [ds.col_index(c) for c in carry]
        seen = set()
        dedup = a.get("dedup_input") and not carry
        for r in ds.rows:
            vid = r[ci]
            if isinstance(vid, Vertex):
                vid = vid.vid
            if is_null(vid):
                continue
            if dedup:
                k = hashable_key(vid)
                if k in seen:
                    continue
                seen.add(k)
            src_rows.append(([r[j] for j in carry_idx], vid))

    # storage-side pushdown (SURVEY §2 row 12): an edge-only predicate
    # executes where the data is; graphd then skips the re-check.  The
    # per-src limit rides along only when the filter went too (a
    # pre-filter limit would under-produce).
    from ..cluster.pushdown import pushable
    pushed = edge_filter is not None and pushable(edge_filter, etypes)
    push_filter = edge_filter if pushed else None
    push_limit = limit if (edge_filter is None or pushed) else None

    out_cols = carry + ["_src", "_edge", "_dst"]
    rows: List[List[Any]] = []
    for carried, vid in src_rows:
        n_for_src = 0
        for (s, et, rank, other, props, sd) in store.get_neighbors(
                sp, [vid], etypes, direction,
                edge_filter=push_filter, limit_per_src=push_limit):
            e = _make_edge(s, other, et, rank, props, sd, etype_ids[et])
            if edge_filter is not None and not pushed:
                rc = RowContext(qctx, sp, {"_src": s, "_edge": e, "_dst": other,
                                           **dict(zip(carry, carried))})
                if to_bool3(edge_filter.eval(rc)) is not True:
                    continue
            rows.append(carried + [s, e, other])
            n_for_src += 1
            if limit is not None and n_for_src >= limit:
                break
    return DataSet(out_cols, rows)


@executor("ScanVertices")
def _scan_vertices(node, qctx, ectx, space):
    a = node.args
    sp = a["space"]
    tag = a.get("tag")
    col = a.get("as_col") or node.col_names[0]
    seen = set()
    rows = []
    for vid, t, props in qctx.store.scan_vertices(sp, tag=tag):
        if vid in seen:
            continue
        seen.add(vid)
        v = qctx.build_vertex(sp, vid)
        if v is not None:
            rows.append([v])
    rows.sort(key=lambda r: total_order_key(r[0].vid))
    lim = a.get("limit")
    if lim is not None:
        rows = rows[:lim]       # bound planted by push_limit_down_scan
    return DataSet([col], rows)


@executor("GetVertices")
def _get_vertices(node, qctx, ectx, space):
    a = node.args
    sp = a["space"]
    tags = a.get("tags") or None
    col = a.get("as_col") or node.col_names[0]
    vids: List[Any] = []
    if a.get("src_col"):
        ds = _input(node, ectx)
        ref = a["src_col"]
        if ref.startswith("$"):
            var = ref[1:].split(".")[0]
            ds = ectx.get_result(f"${var}")
            ref = ref.split(".")[1]
        ci = ds.col_index(ref)
        for r in ds.rows:
            vids.append(r[ci])
    else:
        for ve in a.get("vids") or []:
            vids.append(ve.eval(DictContext()) if isinstance(ve, Expr) else ve)
    rows = []
    seen = set()
    for vid in vids:
        if isinstance(vid, Vertex):
            vid = vid.vid
        if is_null(vid):
            continue
        k = hashable_key(vid)
        if k in seen:
            continue
        seen.add(k)
        v = qctx.build_vertex(sp, vid, tags)
        if v is not None:
            rows.append([v])
    return DataSet([col], rows)


@executor("GetEdges")
def _get_edges(node, qctx, ectx, space):
    a = node.args
    sp = a["space"]
    et = a["etype"]
    etype_id = qctx.store.catalog.get_edge(sp, et).edge_type
    rows = []
    for (src, dst, rank) in a["keys"]:
        props = qctx.store.get_edge(sp, src, et, dst, rank)
        if props is not None:
            rows.append([Edge(src, dst, et, rank, props, etype_id)])
    return DataSet([node.col_names[0]], rows)


@executor("IndexScan")
def _index_scan(node, qctx, ectx, space):
    a = node.args
    sp = a["space"]
    schema = a["schema"]
    filt = a.get("filter")
    if a.get("index"):
        return _index_scan_indexed(node, qctx, sp, schema, filt, a)
    rows = []
    if a["is_edge"]:
        etype_id = qctx.store.catalog.get_edge(sp, schema).edge_type
        for (src, et, rank, dst, props) in qctx.store.scan_edges(sp, schema):
            e = Edge(src, dst, et, rank, dict(props), etype_id)
            if filt is not None:
                rc = RowContext(qctx, sp, {"_matched": e, "_edge": e},
                                extra_vars={schema: e})
                if to_bool3(filt.eval(rc)) is not True:
                    continue
            rows.append([e])
        rows.sort(key=lambda r: total_order_key(r[0].key()))
    else:
        seen = set()
        for vid, t, props in qctx.store.scan_vertices(sp, tag=schema):
            if vid in seen:
                continue
            seen.add(vid)
            v = qctx.build_vertex(sp, vid)
            if filt is not None:
                rc = RowContext(qctx, sp, {"_matched": v}, extra_vars={schema: v})
                if to_bool3(filt.eval(rc)) is not True:
                    continue
            rows.append([v])
        rows.sort(key=lambda r: total_order_key(r[0].vid))
    lim = a.get("limit")
    if lim is not None:
        rows = rows[:lim]       # planted by push_limit_down_index_scan
    return DataSet([node.col_names[0]], rows)


def _index_scan_indexed(node, qctx, sp, schema, filt, a):
    """LOOKUP via secondary index: prefix/range scan → entity fetch →
    residual filter (SURVEY §2 row 15).  geo_ranges (cell-token
    intervals from covering_ranges) route to the geo index scan; the
    exact ST_ predicate stays in `filt` because the cover is a bbox
    superset of the query region."""
    if a.get("geo_ranges"):
        entities = qctx.store.index_scan_geo(sp, a["index"],
                                             a["geo_ranges"])
    else:
        entities = qctx.store.index_scan(sp, a["index"], a.get("eq") or [],
                                         a.get("range"))
    rows = []
    if a["is_edge"]:
        etype_id = qctx.store.catalog.get_edge(sp, schema).edge_type
        seen_e = set()
        for (src, rank, dst) in entities:
            # a multi-cell geo entry yields its entity once per cell
            # when the scan crosses parts or rides the generic path
            ek = (hashable_key(src), rank, hashable_key(dst))
            if ek in seen_e:
                continue
            seen_e.add(ek)
            props = qctx.store.get_edge(sp, src, schema, dst, rank)
            if props is None:
                continue
            e = Edge(src, dst, schema, rank, dict(props), etype_id)
            if filt is not None:
                rc = RowContext(qctx, sp, {"_matched": e, "_edge": e},
                                extra_vars={schema: e})
                if to_bool3(filt.eval(rc)) is not True:
                    continue
            rows.append([e])
        rows.sort(key=lambda r: total_order_key(r[0].key()))
    else:
        seen = set()
        for vid in entities:
            if vid in seen:
                continue
            seen.add(vid)
            v = qctx.build_vertex(sp, vid)
            if v is None:
                continue
            if filt is not None:
                rc = RowContext(qctx, sp, {"_matched": v},
                                extra_vars={schema: v})
                if to_bool3(filt.eval(rc)) is not True:
                    continue
            rows.append([v])
        rows.sort(key=lambda r: total_order_key(r[0].vid))
    lim = a.get("limit")
    if lim is not None:
        rows = rows[:lim]       # planted by push_limit_down_index_scan
    return DataSet([node.col_names[0]], rows)


@executor("FulltextIndexScan")
def _fulltext_index_scan(node, qctx, ectx, space):
    """LOOKUP via text predicate: inverted-index search → entity fetch →
    residual filter (reference: ES-backed LOOKUP; SURVEY §2 row 10
    Listener + row 15)."""
    a = node.args
    sp = a["space"]
    schema = a["schema"]
    filt = a.get("filter")
    entities = qctx.store.fulltext_search(sp, a["index"], a["op"],
                                          a["pattern"])
    rows = []
    if a["is_edge"]:
        etype_id = qctx.store.catalog.get_edge(sp, schema).edge_type
        for (src, rank, dst) in entities:
            props = qctx.store.get_edge(sp, src, schema, dst, rank)
            if props is None:
                continue
            e = Edge(src, dst, schema, rank, dict(props), etype_id)
            if filt is not None:
                rc = RowContext(qctx, sp, {"_matched": e, "_edge": e},
                                extra_vars={schema: e})
                if to_bool3(filt.eval(rc)) is not True:
                    continue
            rows.append([e])
        rows.sort(key=lambda r: total_order_key(r[0].key()))
    else:
        seen = set()
        for vid in entities:
            if vid in seen:
                continue
            seen.add(vid)
            v = qctx.build_vertex(sp, vid)
            if v is None:
                continue
            if filt is not None:
                rc = RowContext(qctx, sp, {"_matched": v},
                                extra_vars={schema: v})
                if to_bool3(filt.eval(rc)) is not True:
                    continue
            rows.append([v])
        rows.sort(key=lambda r: total_order_key(r[0].vid))
    lim = a.get("limit")
    if lim is not None:
        rows = rows[:lim]       # planted by push_limit_down_index_scan
    return DataSet([node.col_names[0]], rows)


def _traverse_device(node, qctx, ectx, ds, ci, sp, etypes, direction,
                     min_hop, max_hop, var_len, edge_filter, edge_ok,
                     out_cols):
    """MATCH Traverse on the device plane.

    One batched device expansion to max_hop over ALL distinct sources —
    predicate applied per hop on device when it vectorizes, else frames
    are a superset re-checked by edge_ok during assembly — then a
    vectorized trail assembly over the layered HopFrames.  Rows are
    emitted in LEVEL order across all input rows (not the host DFS's
    per-row stack order); parity with the host path holds up to row
    reordering, which the unordered-MATCH contract permits (consumers
    sort or aggregate).  Returns rows, or None to take the host path
    (no runtime, flag off, store without a device snapshot surface,
    non-convergent escalation...).
    """
    rt = getattr(qctx, "tpu_runtime", None)
    if rt is None or not ds.rows or max_hop < 1:
        return None
    from ..utils.config import get_config
    if not get_config().get("tpu_match_device"):
        return None
    from ..gpu.exprjit import compilable
    from ..gpu.traverse import run_on_device

    store = qctx.store
    try:
        sd = store.space(sp)
        sd.dense_id
    except AttributeError:
        return None

    # distinct source vids across input rows
    srcs, seen = [], set()
    src_of_row = []
    for r in ds.rows:
        sv = r[ci]
        svid = sv.vid if isinstance(sv, Vertex) else sv
        src_of_row.append(svid)
        k = hashable_key(svid)
        if not is_null(svid) and k not in seen:
            seen.add(k)
            srcs.append(svid)

    dev_pred = edge_filter if (edge_filter is not None
                               and compilable(edge_filter, etypes)) else None
    got = run_on_device(qctx, lambda: rt.traverse_hops(
        store, sp, srcs, etypes, direction, max_hop, edge_filter=dev_pred))
    if got is None:
        return None
    frames, qctx.last_tpu_stats = got
    host_check = edge_filter is not None and dev_pred is None

    tracker = getattr(ectx, "tracker", None)
    if tracker is not None:
        # frames are columnar (7 int64 columns per entry); Edge objects
        # are decoded lazily during emission and charged per row below
        tracker.charge(sum(f.n for f in frames) * 64)

    # Vectorized trail assembly over the layered frames: per hop,
    # ONE searchsorted join of all current path
    # endpoints against the frame's src index, then a component-wise
    # canonical-key comparison against every earlier hop for trail
    # (distinct-edge) semantics — the per-path Python DFS with set
    # copies becomes numpy batch work; Python touches only emitted rows.
    rows: List[List[Any]] = []
    in_rows = ds.rows
    n_in = len(in_rows)
    d0 = np.full(n_in, -1, np.int64)
    for i, svid in enumerate(src_of_row):
        if is_null(svid):
            continue
        if min_hop == 0:
            rows.append(list(in_rows[i])
                        + [[] if var_len else NULL, Vertex(svid)])
        d0[i] = sd.dense_id(svid)
    ridx = np.flatnonzero(d0 >= 0)
    last = d0[ridx]
    path: List[np.ndarray] = []       # per-hop frame indices, path-major
    pending = 0
    from ..gpu.runtime import join_frontier_trails, trail_distinct_keep
    for h in range(max_hop):
        if ridx.size == 0:
            break
        fr = frames[h]
        if fr.n == 0:
            break
        parent, fidx = join_frontier_trails(fr, last)
        total = fidx.size
        if total == 0:
            break
        keep = trail_distinct_keep(frames, path, parent, fr, fidx)
        if host_check and keep.any():
            # non-vectorizable predicate: frames are a superset; re-check
            # each surviving candidate against its input row on host
            cand = np.flatnonzero(keep)
            eobj = fr.decode(fidx[cand])
            rsel = ridx[parent[cand]]
            for j, kidx in enumerate(cand.tolist()):
                if not edge_ok(eobj[j], in_rows[rsel[j]]):
                    keep[kidx] = False
        sel = np.flatnonzero(keep)
        if sel.size == 0:
            break
        parent = parent[sel]
        fidx = fidx[sel]
        ridx = ridx[parent]
        last = fr.dst[fidx]
        path = [pe[parent] for pe in path] + [fidx]
        depth = h + 1
        if tracker is not None:
            pending += sel.size * 8 * (depth + 2)
            if pending > (1 << 20):
                tracker.charge(pending)
                pending = 0
        if depth >= min_hop or min_hop == 0:
            eobjs = [frames[kk].decode(path[kk]) for kk in range(depth)]
            elast = eobjs[-1]
            if tracker is not None:
                pending += ridx.size * (128 + 96 * depth)
                if pending > (1 << 20):
                    tracker.charge(pending)
                    pending = 0
            if var_len:
                for i in range(ridx.size):
                    rows.append(list(in_rows[ridx[i]])
                                + [[eo[i] for eo in eobjs],
                                   Vertex(elast[i].dst)])
            else:
                for i in range(ridx.size):
                    e = eobjs[0][i]
                    rows.append(list(in_rows[ridx[i]])
                                + [e, Vertex(e.dst)])
    if tracker is not None and pending:
        tracker.charge(pending)
    return rows


@executor("Traverse")
def _traverse(node, qctx, ectx, space):
    a = node.args
    sp = a["space"]
    store = qctx.store
    etypes = a["edge_types"]
    etype_ids = {e: store.catalog.get_edge(sp, e).edge_type for e in etypes}
    direction = a["direction"]
    min_hop, max_hop = a["min_hop"], a["max_hop"]
    if max_hop < 0:
        max_hop = qctx.max_match_hops
    edge_filter = a.get("edge_filter")
    filter_alias = a.get("edge_filter_alias", "__edge__")
    ds = _input(node, ectx)
    src_col = a["src_col"]
    ci = ds.col_index(src_col)
    var_len = not (min_hop == 1 and max_hop == 1)

    out_cols = list(ds.column_names) + [a["edge_alias"], a["dst_alias"]]
    rows: List[List[Any]] = []

    def edge_ok(e: Edge, row) -> bool:
        if edge_filter is None:
            return True
        rc = RowContext(qctx, sp, row_dict(ds, row),
                        extra_vars={filter_alias: e, "__edge__": e})
        return to_bool3(edge_filter.eval(rc)) is True

    dev_rows = _traverse_device(node, qctx, ectx, ds, ci, sp, etypes,
                                direction, min_hop, max_hop, var_len,
                                edge_filter, edge_ok, out_cols)
    if dev_rows is not None:
        return DataSet(out_cols, dev_rows)

    # variable-length expansion explodes (path lists + per-path edge
    # sets); charge the memory tracker mid-loop so a runaway MATCH is
    # killed before it OOMs the process (SURVEY §2 row 5)
    tracker = getattr(ectx, "tracker", None)
    pending = 0

    # MATCH edge predicates apply per hop — push them into the storage
    # scan when they reference only the edge (SURVEY §2 row 12)
    from ..cluster.pushdown import pushable
    ef_pushed = edge_filter is not None and pushable(edge_filter, etypes)
    push_filter = edge_filter if ef_pushed else None

    if not var_len:
        # single-hop fast path: ONE storage call over the distinct
        # sources instead of one per input row — multi-clause MATCH
        # repeats sources heavily (IC5's membership clause spent 100 ms
        # in per-row get_neighbors calls; batched it is one pass)
        per_src: Dict[Any, List] = {}
        order: List[Any] = []
        for r in ds.rows:
            sv = r[ci]
            svid = sv.vid if isinstance(sv, Vertex) else sv
            if is_null(svid):
                continue
            k = hashable_key(svid)
            if k not in per_src:
                per_src[k] = []
                order.append(svid)
        for (s, et, rank, other, props, sd) in store.get_neighbors(
                sp, order, etypes, direction, edge_filter=push_filter):
            e = _make_edge(s, other, et, rank, props, sd, etype_ids[et])
            per_src[hashable_key(s)].append((e, other))
            # staging holds real Edge objects — charge DURING the build
            # so a runaway frontier is killed before it allocates, same
            # invariant as the DFS path below (SURVEY §2 row 5)
            pending += 200
            if tracker is not None and pending > (1 << 20):
                tracker.charge(pending)
                pending = 0
        eval_filter = edge_filter is not None and not ef_pushed
        for r in ds.rows:
            sv = r[ci]
            svid = sv.vid if isinstance(sv, Vertex) else sv
            if is_null(svid):
                continue
            edges = per_src.get(hashable_key(svid), ())
            if not edges:
                continue
            if eval_filter:
                # one context per ROW; only the edge slot mutates per
                # edge (a fresh RowContext + row_dict per edge dominated
                # the IC5 membership clause)
                extra = {filter_alias: None, "__edge__": None}
                rc = RowContext(qctx, sp, row_dict(ds, r),
                                extra_vars=extra)
            for (e, other) in edges:
                if eval_filter:
                    extra[filter_alias] = e
                    extra["__edge__"] = e
                    if to_bool3(edge_filter.eval(rc)) is not True:
                        continue
                rows.append(list(r) + [e, Vertex(other)])
                pending += 224
                if tracker is not None and pending > (1 << 20):
                    tracker.charge(pending)
                    pending = 0
        if tracker is not None and pending:
            tracker.charge(pending)
        return DataSet(out_cols, rows)

    for r in ds.rows:
        sv = r[ci]
        svid = sv.vid if isinstance(sv, Vertex) else sv
        if is_null(svid):
            continue
        # DFS with trail semantics (no repeated edge within one path)
        stack: List[Tuple[Any, List[Edge], set]] = [(svid, [], set())]
        if min_hop == 0:
            rows.append(list(r) + [[] if var_len else NULL, Vertex(svid)])
        while stack:
            cur, epath, eseen = stack.pop()
            depth = len(epath)
            if depth >= max_hop:
                continue
            for (s, et, rank, other, props, sd) in store.get_neighbors(
                    sp, [cur], etypes, direction,
                    edge_filter=push_filter):
                e = _make_edge(s, other, et, rank, props, sd, etype_ids[et])
                ek = e.key()
                if ek in eseen:
                    continue
                if not ef_pushed and not edge_ok(e, r):
                    continue
                npath = epath + [e]
                if min_hop <= len(npath):
                    ev = npath if var_len else npath[0]
                    rows.append(list(r) + [list(ev) if var_len else ev,
                                           Vertex(other)])
                    pending += 128 + 96 * len(npath)
                if len(npath) < max_hop:
                    stack.append((other, npath, eseen | {ek}))
                    pending += 96 * (len(npath) + len(eseen))
                if tracker is not None and pending > (1 << 20):
                    tracker.charge(pending)
                    pending = 0
    if tracker is not None and pending:
        tracker.charge(pending)
    return DataSet(out_cols, rows)


@executor("AppendVertices")
def _append_vertices(node, qctx, ectx, space):
    from ..core.expr import walk as _walk
    a = node.args
    sp = a["space"]
    ds = _input(node, ectx)
    col = a["col"]
    ci = ds.col_index(col)
    labels = a.get("labels") or []
    filt = a.get("filter")
    # a filter that reads ONLY the appended vertex has a constant
    # verdict per vid — evaluate once per unique vertex, not per row
    # (MATCH rows repeat terminal vertices heavily)
    per_vertex = False
    if filt is not None:
        refs = set()
        only_vertex_refs = True
        for x in _walk(filt):
            k = x.kind
            if k == "label":
                refs.add(x.name)
            elif k == "label_tag_prop":
                refs.add(x.var)
            elif k in ("literal", "binary", "unary", "function", "list",
                       "set", "map", "case", "subscript", "slice"):
                pass                     # composition over the leaves
            else:
                # anything that can read OTHER row state ($-.col, $var,
                # vertex/edge context, props of other aliases) — or a
                # kind this classifier doesn't model — disables the
                # per-vertex shortcut
                only_vertex_refs = False
        per_vertex = only_vertex_refs and refs <= {col}
    verdicts: Dict[Any, bool] = {}
    rows = []
    cache: Dict[Any, Optional[Vertex]] = {}
    for r in ds.rows:
        v = r[ci]
        vid = v.vid if isinstance(v, Vertex) else v
        if vid not in cache:
            cache[vid] = qctx.build_vertex(sp, vid)
        full = cache[vid]
        if full is None:
            continue
        if labels and not all(l in full.tag_names() for l in labels):
            continue
        nr = list(r)
        nr[ci] = full
        if filt is not None:
            if per_vertex:
                vd = verdicts.get(vid)
                if vd is None:
                    rc = RowContext(qctx, sp, {col: full})
                    vd = to_bool3(filt.eval(rc)) is True
                    verdicts[vid] = vd
                if not vd:
                    continue
            else:
                rc = RowContext(qctx, sp, row_dict(ds, nr))
                if to_bool3(filt.eval(rc)) is not True:
                    continue
        rows.append(nr)
    return DataSet(list(ds.column_names), rows)


@executor("BuildPath")
def _build_path(node, qctx, ectx, space):
    a = node.args
    ds = _input(node, ectx)
    n_idx = [ds.col_index(c) for c in a["nodes"]]
    e_idx = [ds.col_index(c) for c in a["edges"]]
    rows = []
    for r in ds.rows:
        src = r[n_idx[0]]
        p = Path(src if isinstance(src, Vertex) else Vertex(src))
        ok = True
        prev = p.src
        for k, ei in enumerate(e_idx):
            ev = r[ei]
            edges = ev if isinstance(ev, list) else ([] if is_null(ev) else [ev])
            for e in edges:
                nxt_vid = e.dst
                prev_vid = prev.vid if isinstance(prev, Vertex) else prev
                # e.src should equal prev for forward chaining
                if e.src != prev_vid and e.dst == prev_vid:
                    nxt_vid = e.src
                dstv = r[n_idx[k + 1]]
                dst_final = dstv.vid if isinstance(dstv, Vertex) else dstv
                nv = Vertex(nxt_vid)
                p.steps.append(Step(nv, e.name, e.ranking, e.props, e.etype))
                prev = nv
            # snap final node of this hop to the full vertex value
            dstv = r[n_idx[k + 1]]
            if isinstance(dstv, Vertex) and p.steps:
                p.steps[-1] = Step(dstv, p.steps[-1].name, p.steps[-1].ranking,
                                   p.steps[-1].props, p.steps[-1].etype)
                prev = dstv
        if ok:
            rows.append(list(r) + [p])
    return DataSet(list(ds.column_names) + [a["alias"]], rows)


# ---------------------------------------------------------------------------
# relational
# ---------------------------------------------------------------------------


@executor("Filter")
def _filter(node, qctx, ectx, space):
    ds = _input(node, ectx)
    cond = node.args["condition"]
    rows = []
    for r in ds.rows:
        rc = RowContext(qctx, space, row_dict(ds, r))
        if to_bool3(cond.eval(rc)) is True:
            rows.append(r)
    return DataSet(list(ds.column_names), rows)


@executor("Project")
def _project(node, qctx, ectx, space):
    from ..core.expr import InputProp, LabelExpr
    from ..core.value import ColumnarDataSet
    a = node.args
    ds = _input(node, ectx)
    if a.get("empty"):
        return DataSet(list(node.col_names), [])
    cols: List[Tuple[Expr, str]] = a["columns"]
    names = [n for _, n in cols]
    schema_alias = a.get("schema") if a.get("lookup_row") else None
    if isinstance(ds, ColumnarDataSet) and ds._cols is not None \
            and schema_alias is None:
        # bare column selection over a columnar input stays columnar —
        # the GO/MATCH bulk path never boxes per-row values just to
        # rename/reorder columns (RowContext would return row[name]
        # verbatim for these expression shapes)
        sel = []
        for e, _ in cols:
            if isinstance(e, (InputProp, LabelExpr)) \
                    and e.name in ds.column_names:
                sel.append(ds._cols[ds.col_index(e.name)])
            else:
                sel = None
                break
        if sel is not None:
            return ColumnarDataSet(names, sel)
    rows = []
    src_rows = ds.rows
    if not ds.column_names and not ds.rows:
        src_rows = [[]]  # constant YIELD with no input: one row
    for r in src_rows:
        rd = row_dict(ds, r)
        extra = {schema_alias: rd.get("_matched")} if schema_alias else None
        if schema_alias and a.get("is_edge"):
            # edge LOOKUP yields reference edge props as EdgeProp exprs
            # (rewritten by _rewrite_go_expr) — bind the matched edge
            # where edge-prop resolution looks for it
            rd.setdefault("_edge", rd.get("_matched"))
        rc = RowContext(qctx, space, rd, extra_vars=extra)
        rows.append([e.eval(rc) for e, _ in cols])
    return DataSet(names, rows)


@executor("VarInput")
def _var_input(node, qctx, ectx, space):
    return ectx.get_result(f"${node.args['var']}")


@executor("Unwind")
def _unwind(node, qctx, ectx, space):
    a = node.args
    ds = _input(node, ectx)
    rows = []
    source_rows = ds.rows if ds.column_names else [[]]
    for r in source_rows:
        rc = RowContext(qctx, space, row_dict(ds, r))
        v = a["expr"].eval(rc)
        items = v if isinstance(v, list) else ([] if is_null(v) else [v])
        for item in items:
            rows.append(list(r) + [item])
    return DataSet(list(ds.column_names) + [a["alias"]], rows)


@executor("Dedup")
def _dedup(node, qctx, ectx, space):
    ds = _input(node, ectx)
    seen, rows = set(), []
    for r in ds.rows:
        k = tuple(hashable_key(c) for c in r)
        if k not in seen:
            seen.add(k)
            rows.append(r)
    return DataSet(list(ds.column_names), rows)


@executor("Aggregate")
def _aggregate(node, qctx, ectx, space):
    a = node.args
    ds = _input(node, ectx)
    group_keys: List[Expr] = a.get("group_keys") or []
    cols: List[Tuple[Expr, str]] = a["columns"]
    names = [n for _, n in cols]

    # per-column aggregate structure is static — derive it ONCE, not per
    # row (has_aggregate/collect_aggregates per row dominated the whole
    # executor on wide inputs)
    col_aggs = [collect_aggregates(e) if has_aggregate(e) else None
                for e, _ in cols]

    groups: Dict[Tuple, Dict[str, Any]] = {}
    order: List[Tuple] = []
    src_rows = ds.rows
    if not ds.column_names and not src_rows:
        # constant aggregate with no input (standalone `RETURN max(5)`,
        # incl. mixed `RETURN 1 AS a, count(*) AS c` where the constant
        # becomes a derived group key): one implicit row, same contract
        # as the Project executor's constant-YIELD case — 0 rows would
        # report the empty-input aggregate identities (NULL/0/[])
        # instead of folding the value
        src_rows = [[]]
    for r in src_rows:
        rc = RowContext(qctx, space, row_dict(ds, r))
        key_vals = [k.eval(rc) for k in group_keys]
        key = tuple(hashable_key(v) for v in key_vals)
        g = groups.get(key)
        if g is None:
            g = groups[key] = {"key_vals": key_vals,
                               "agg_inputs": [[] for _ in cols]}
            order.append(key)
        for i, (e, _) in enumerate(cols):
            aggs = col_aggs[i]
            if aggs is not None:
                g["agg_inputs"][i].append(
                    [ag.eval(rc) if ag.arg is not None else 1 for ag in aggs])
            else:
                g["agg_inputs"][i].append([e.eval(rc)])

    rows = []
    if not groups and not group_keys:
        # aggregates over empty input: one row (COUNT→0, SUM→0, others NULL)
        out = []
        for e, _ in cols:
            if isinstance(e, AggExpr):
                out.append(e.apply([]))
            elif has_aggregate(e):
                out.append(_eval_with_aggs(e, [], qctx, space))
            else:
                out.append(NULL)
        return DataSet(names, [out])

    for key in order:
        g = groups[key]
        out = []
        for i, (e, _) in enumerate(cols):
            vals = g["agg_inputs"][i]
            if isinstance(e, AggExpr):
                out.append(e.apply([v[0] for v in vals]))
            elif col_aggs[i] is not None:
                out.append(_eval_with_aggs(e, vals, qctx, space))
            else:
                out.append(vals[0][0] if vals else NULL)
        rows.append(out)
    return DataSet(names, rows)


def _eval_with_aggs(e: Expr, rows_inputs: List[List[Any]], qctx, space):
    """Evaluate an expression containing AggExpr nodes by substituting each
    agg's folded value in traversal order (supports count(*)+1, avg(x)/sum(y)).

    collect_aggregates and rewrite both traverse depth-first, so the i-th
    AggExpr encountered during rewrite corresponds to folded[i]."""
    from ..core.expr import rewrite, Literal
    aggs = collect_aggregates(e)
    folded = [ag.apply([ri[i] for ri in rows_inputs])
              for i, ag in enumerate(aggs)]
    idx = [0]

    def substitute(x):
        if isinstance(x, AggExpr):
            v = folded[idx[0]]
            idx[0] += 1
            return Literal(v)
        return None

    e2 = rewrite(e, substitute)
    return e2.eval(DictContext())


@executor("Sort")
def _sort(node, qctx, ectx, space):
    a = node.args
    ds = _input(node, ectx)
    factors = a["factors"]
    # precompute all factor keys once per row; mixed asc/desc via repeated
    # stable sorts on the cached keys, last factor first
    keyed = []
    for r in ds.rows:
        rc = RowContext(qctx, space, row_dict(ds, r))
        keyed.append(([total_order_key(e.eval(rc)) for e, _ in factors], r))
    for fi in range(len(factors) - 1, -1, -1):
        asc = factors[fi][1]
        keyed.sort(key=lambda kr, _fi=fi: kr[0][_fi], reverse=not asc)
    return DataSet(list(ds.column_names), [r for _, r in keyed])


@executor("TopN")
def _topn(node, qctx, ectx, space):
    ds = _sort(node, qctx, ectx, space)
    off = node.args.get("offset", 0)
    cnt = node.args.get("count", -1)
    rows = ds.rows[off:] if cnt < 0 else ds.rows[off:off + cnt]
    return DataSet(ds.column_names, rows)


@executor("Limit")
def _limit(node, qctx, ectx, space):
    from ..core.value import ColumnarDataSet
    ds = _input(node, ectx)
    off = node.args.get("offset", 0)
    cnt = node.args.get("count", -1)
    if isinstance(ds, ColumnarDataSet) and ds._cols is not None:
        # columnar input (device GO results): slice the numpy columns —
        # LIMIT over a million-row result never boxes the dropped rows
        end = None if cnt is None or cnt < 0 else off + cnt
        return ColumnarDataSet(list(ds.column_names),
                               [c[off:end] for c in ds._cols])
    rows = ds.rows[off:] if cnt is None or cnt < 0 else ds.rows[off:off + cnt]
    return DataSet(list(ds.column_names), rows)


@executor("Sample")
def _sample(node, qctx, ectx, space):
    ds = _input(node, ectx)
    n = node.args.get("count", 0)
    rows = ds.rows if len(ds.rows) <= n else random.sample(ds.rows, n)
    return DataSet(list(ds.column_names), rows)


@executor("Union")
def _union(node, qctx, ectx, space):
    l = _input(node, ectx, 0)
    r = _input(node, ectx, 1)
    rows = list(l.rows) + list(r.rows)
    ds = DataSet(list(node.col_names) or list(l.column_names), rows)
    if node.args.get("distinct"):
        seen, out = set(), []
        for row in ds.rows:
            k = tuple(hashable_key(c) for c in row)
            if k not in seen:
                seen.add(k)
                out.append(row)
        ds.rows = out
    return ds


@executor("Intersect")
def _intersect(node, qctx, ectx, space):
    l = _input(node, ectx, 0)
    r = _input(node, ectx, 1)
    rkeys = {tuple(hashable_key(c) for c in row) for row in r.rows}
    out, seen = [], set()
    for row in l.rows:
        k = tuple(hashable_key(c) for c in row)
        if k in rkeys and k not in seen:
            seen.add(k)
            out.append(row)
    return DataSet(list(l.column_names), out)


@executor("Minus")
def _minus(node, qctx, ectx, space):
    l = _input(node, ectx, 0)
    r = _input(node, ectx, 1)
    rkeys = {tuple(hashable_key(c) for c in row) for row in r.rows}
    out, seen = [], set()
    for row in l.rows:
        k = tuple(hashable_key(c) for c in row)
        if k not in rkeys and k not in seen:
            seen.add(k)
            out.append(row)
    return DataSet(list(l.column_names), out)


def _join_common(node, qctx, ectx, left_outer: bool):
    l = _input(node, ectx, 0)
    r = _input(node, ectx, 1)
    keys = node.args["keys"]
    li = [l.col_index(k) for k in keys]
    ri = [r.col_index(k) for k in keys]
    r_extra = [j for j, c in enumerate(r.column_names) if c not in l.column_names]
    out_cols = list(l.column_names) + [r.column_names[j] for j in r_extra]
    index: Dict[Tuple, List[List[Any]]] = {}
    for row in r.rows:
        k = tuple(hashable_key(row[j]) for j in ri)
        index.setdefault(k, []).append(row)
    rows = []
    for row in l.rows:
        k = tuple(hashable_key(row[j]) for j in li)
        matches = index.get(k, [])
        if matches:
            for m in matches:
                rows.append(list(row) + [m[j] for j in r_extra])
        elif left_outer:
            rows.append(list(row) + [NULL for _ in r_extra])
    return DataSet(out_cols, rows)


@executor("HashInnerJoin")
def _inner_join(node, qctx, ectx, space):
    return _join_common(node, qctx, ectx, False)


@executor("HashLeftJoin")
def _left_join(node, qctx, ectx, space):
    return _join_common(node, qctx, ectx, True)


@executor("CrossJoin")
def _cross_join(node, qctx, ectx, space):
    l = _input(node, ectx, 0)
    r = _input(node, ectx, 1)
    out_cols = list(l.column_names) + list(r.column_names)
    rows = [list(a) + list(b) for a in l.rows for b in r.rows]
    return DataSet(out_cols, rows)


# ---------------------------------------------------------------------------
# algorithms (host reference; device versions in nebula_tpu_torch.gpu)
# ---------------------------------------------------------------------------


def _resolve_vid_list(a, key_vids, key_ref, ectx) -> List[Any]:
    out = []
    if a.get(key_ref):
        ref = a[key_ref]
        if ref.startswith("$"):
            var = ref[1:].split(".")[0]
            ds = ectx.get_result(f"${var}")
            ref = ref.split(".")[1]
        else:
            ds = None
        if ds is None:
            return []
        ci = ds.col_index(ref)
        for r in ds.rows:
            out.append(r[ci])
    else:
        for ve in a.get(key_vids) or []:
            out.append(ve.eval(DictContext()) if isinstance(ve, Expr) else ve)
    uniq, seen = [], set()
    for v in out:
        if isinstance(v, Vertex):
            v = v.vid
        k = hashable_key(v)
        if k not in seen:
            seen.add(k)
            uniq.append(v)
    return uniq


@executor("FindPath")
def _find_path(node, qctx, ectx, space):
    """FIND PATH: the shortest path over the runtime's BFS
    (gpu/paths.py), ALL/NOLOOP over its hop frames; the host path
    answers without a runtime and after a `CannotCompile`."""
    from .algorithms import find_path_device, find_path_host
    rt = getattr(qctx, "tpu_runtime", None)
    a = node.args
    if rt is not None and a["kind"] == "shortest":
        from ..gpu.paths import find_shortest_device
        from ..gpu.traverse import run_on_device
        ds = run_on_device(
            qctx, lambda: find_shortest_device(node, qctx, ectx))
        if ds is not None:
            return ds
    if a["kind"] in ("all", "noloop"):
        ds = find_path_device(node, qctx, ectx)
        if ds is not None:
            return ds
    return find_path_host(node, qctx, ectx)


@executor("Subgraph")
def _subgraph(node, qctx, ectx, space):
    from .algorithms import subgraph_device, subgraph_host
    ds = subgraph_device(node, qctx, ectx)
    if ds is not None:
        return ds
    return subgraph_host(node, qctx, ectx)


@executor("CallAlgo")
def _call_algo(node, qctx, ectx, space):
    """CALL algo.*: the vertex-program engine — device iterations with
    live per-iteration progress and kill/deadline checks BETWEEN
    iterations, numpy host oracle without a runtime.  A device error
    is the statement's error."""
    from ..algo.engine import AlgoError, run_call_algo
    try:
        return run_call_algo(node, qctx, ectx)
    except AlgoError as ex:
        raise ExecError(str(ex)) from None


# ---------------------------------------------------------------------------
# mutate
# ---------------------------------------------------------------------------


@executor("InsertVertices")
def _insert_vertices(node, qctx, ectx, space):
    a = node.args
    rows = []
    seen = set()
    for vid, per_tag in a["rows"]:
        if a["if_not_exists"]:
            # first occurrence wins WITHIN the statement too (the
            # per-row path saw its own earlier insert via get_vertex;
            # batching defers the writes, so dedupe explicitly)
            key = repr(vid)
            if key in seen or qctx.store.get_vertex(a["space"], vid):
                continue
            seen.add(key)
        for (tag, names), props in zip(a["tags"], per_tag):
            rows.append((vid, tag, props, names))
    # cluster store: the whole statement buffers per partition and
    # ships one batched rpc_write per part (group commit);
    # the standalone GraphStore keeps the per-row path
    bulk = getattr(qctx.store, "insert_vertices", None)
    if bulk is not None:
        bulk(a["space"], rows)
    else:
        for vid, tag, props, names in rows:
            qctx.store.insert_vertex(a["space"], vid, tag, props, names)
    return DataSet()


@executor("InsertEdges")
def _insert_edges(node, qctx, ectx, space):
    a = node.args
    rows = []
    seen = set()
    for src, dst, rank, props in a["rows"]:
        if a["if_not_exists"]:
            key = (repr(src), repr(dst), rank)
            if key in seen or qctx.store.get_edge(
                    a["space"], src, a["etype"], dst, rank) is not None:
                continue
            seen.add(key)
        rows.append((src, dst, rank, props))
    # cluster store: one coalesced TOSS chain per (src_pid, dst_pid)
    # pair for the whole statement instead of 3 consensus rounds/edge
    bulk = getattr(qctx.store, "insert_edges", None)
    if bulk is not None:
        bulk(a["space"], a["etype"], rows, a["prop_names"])
    else:
        for src, dst, rank, props in rows:
            qctx.store.insert_edge(a["space"], src, a["etype"], dst, rank,
                                   props, a["prop_names"])
    return DataSet()


@executor("DeleteVertices")
def _delete_vertices(node, qctx, ectx, space):
    a = node.args
    vids = _resolve_vid_list(a, "vids", "src_ref", ectx)
    for vid in vids:
        qctx.store.delete_vertex(a["space"], vid, with_edges=True)
    return DataSet()


@executor("DeleteEdges")
def _delete_edges(node, qctx, ectx, space):
    a = node.args
    keys = list(a["keys"])
    if a.get("ref") is not None:
        ds = _input(node, ectx)
        se, de, re_ = a["ref"]
        for r in ds.rows:
            rc = RowContext(qctx, a["space"], row_dict(ds, r))
            rank = re_.eval(rc) if re_ is not None else 0
            keys.append((se.eval(rc), de.eval(rc), rank))
    for (src, dst, rank) in keys:
        qctx.store.delete_edge(a["space"], src, a["etype"], dst, rank)
    return DataSet()


@executor("DeleteTags")
def _delete_tags(node, qctx, ectx, space):
    a = node.args
    vids = _resolve_vid_list(a, "vids", "src_ref", ectx)
    tags = a["tags"]
    for vid in vids:
        if not tags:
            tv = qctx.store.get_vertex(a["space"], vid)
            tags_here = list(tv.keys()) if tv else []
            qctx.store.delete_tag(a["space"], vid, tags_here)
        else:
            qctx.store.delete_tag(a["space"], vid, tags)
    return DataSet()


@executor("Update")
def _update(node, qctx, ectx, space):
    a = node.args
    sp = a["space"]
    store = qctx.store
    if a["is_edge"]:
        src, dst, rank = a["edge_key"]
        cur = store.get_edge(sp, src, a["schema"], dst, rank)
        if cur is None:
            if not a["insertable"]:
                raise ExecError("edge not found for UPDATE")
            cur = {}
    else:
        vid = a["vid"]
        tv = store.get_vertex(sp, vid)
        cur = (tv or {}).get(a["schema"])
        if cur is None:
            if not a["insertable"]:
                raise ExecError("vertex not found for UPDATE")
            cur = {}

    rc = RowContext(qctx, sp, dict(cur))
    if a.get("when") is not None:
        if to_bool3(a["when"].eval(rc)) is not True:
            return DataSet([n for _, n in a["yield"]], [])
    updates = {}
    for name, e in a["sets"]:
        updates[name] = e.eval(rc)
    if a["is_edge"]:
        src, dst, rank = a["edge_key"]
        ok = store.update_edge(sp, src, a["schema"], dst, rank, updates)
        if not ok and a["insertable"]:
            store.insert_edge(sp, src, a["schema"], dst, rank, updates)
    else:
        ok = store.update_vertex(sp, a["vid"], a["schema"], updates)
        if not ok and a["insertable"]:
            store.insert_vertex(sp, a["vid"], a["schema"], updates)
    if a["yield"]:
        newp = dict(cur)
        newp.update(updates)
        rc2 = RowContext(qctx, sp, newp)
        return DataSet([n for _, n in a["yield"]],
                       [[e.eval(rc2) for e, _ in a["yield"]]])
    return DataSet()


# ---------------------------------------------------------------------------
# DDL / admin
# ---------------------------------------------------------------------------


def _ptype_from_ast(p) -> PropDef:
    pt = PropType.parse(p.type_name)
    default = None
    has_default = False
    if p.default is not None:
        default = p.default.eval(DictContext())
        has_default = True
    return PropDef(p.name, pt, p.nullable, default, has_default, p.fixed_len)


@executor("SwitchSpace")
def _switch_space(node, qctx, ectx, space):
    return DataSet()


@executor("CreateSpace")
def _create_space(node, qctx, ectx, space):
    a = node.args
    qctx.store.create_space(a["name"], partition_num=a["partition_num"],
                            replica_factor=a["replica_factor"],
                            vid_type=a["vid_type"],
                            if_not_exists=a["if_not_exists"])
    return DataSet()


@executor("DropSpace")
def _drop_space(node, qctx, ectx, space):
    qctx.store.drop_space(node.args["name"], if_exists=node.args["if_exists"])
    return DataSet()


@executor("CreateSchema")
def _create_schema(node, qctx, ectx, space):
    a = node.args
    props = [_ptype_from_ast(p) for p in a["props"]]
    if a["is_edge"]:
        qctx.catalog.create_edge(a["space"], a["name"], props,
                                 a["if_not_exists"], a["ttl_col"], a["ttl_duration"])
    else:
        qctx.catalog.create_tag(a["space"], a["name"], props,
                                a["if_not_exists"], a["ttl_col"], a["ttl_duration"])
    return DataSet()


@executor("AlterSchema")
def _alter_schema(node, qctx, ectx, space):
    a = node.args
    cat = qctx.catalog
    get = cat.get_edge if a["is_edge"] else cat.get_tag
    schema = get(a["space"], a["name"])
    props = list(schema.latest.props)
    for d in a["drops"]:
        props = [p for p in props if p.name != d]
    for ch in a["changes"]:
        props = [p for p in props if p.name != ch.name]
        props.append(_ptype_from_ast(ch))
    for ad in a["adds"]:
        if any(p.name == ad.name for p in props):
            raise ExecError(f"prop `{ad.name}' already exists")
        props.append(_ptype_from_ast(ad))
    if a["is_edge"]:
        cat.alter_edge(a["space"], a["name"], props, a["ttl_col"], a["ttl_duration"])
    else:
        cat.alter_tag(a["space"], a["name"], props, a["ttl_col"], a["ttl_duration"])
    return DataSet()


@executor("DropSchema")
def _drop_schema(node, qctx, ectx, space):
    a = node.args
    if a["is_edge"]:
        qctx.catalog.drop_edge(a["space"], a["name"], a["if_exists"])
    else:
        qctx.catalog.drop_tag(a["space"], a["name"], a["if_exists"])
    return DataSet()


@executor("CreateIndex")
def _create_index(node, qctx, ectx, space):
    a = node.args
    qctx.catalog.create_index(a["space"], a["index_name"], a["schema_name"],
                              a["fields"], a["is_edge"], a["if_not_exists"],
                              field_lens=a.get("field_lens"))
    return DataSet()


@executor("DropIndex")
def _drop_index(node, qctx, ectx, space):
    a = node.args
    qctx.catalog.drop_index(a["space"], a["index_name"], a["if_exists"])
    return DataSet()


@executor("RebuildIndex")
def _rebuild_index(node, qctx, ectx, space):
    a = node.args
    from .jobs import submit_tracked
    job = submit_tracked(qctx, f"rebuild index {a['index_name']}",
                         a["space"])
    return DataSet(["New Job Id"], [[job.job_id]])


@executor("CreateSpaceAs")
def _create_space_as(node, qctx, ectx, space):
    """CREATE SPACE <new> AS <src>: clone the schema plane (options,
    tags, edges, secondary + fulltext indexes) — never the data
    (reference semantics).  Composed from the ordinary catalog ops, so
    it works identically against the standalone catalog and the
    metad-replicated CatalogProxy."""
    a = node.args
    cat = qctx.catalog
    src = a["source"]
    ine = a["if_not_exists"]
    sp = cat.get_space(src)
    # every step is individually idempotent under IF NOT EXISTS, so a
    # retry after a partial failure COMPLETES the clone instead of
    # short-circuiting on the half-created space
    qctx.store.create_space(a["name"], partition_num=sp.partition_num,
                            replica_factor=sp.replica_factor,
                            vid_type=sp.vid_type, if_not_exists=ine)
    for t in cat.tags(src):
        sv = t.latest
        cat.create_tag(a["name"], t.name, sv.props, if_not_exists=ine,
                       ttl_col=sv.ttl_col, ttl_duration=sv.ttl_duration)
    for e in cat.edges(src):
        sv = e.latest
        cat.create_edge(a["name"], e.name, sv.props, if_not_exists=ine,
                        ttl_col=sv.ttl_col, ttl_duration=sv.ttl_duration)
    for d in cat.indexes(src):
        cat.create_index(a["name"], d.name, d.schema_name, d.fields,
                         d.is_edge, if_not_exists=ine,
                         field_lens=getattr(d, "field_lens", None))
    for d in cat.fulltext_indexes(src):
        cat.create_fulltext_index(a["name"], d.name, d.schema_name,
                                  d.fields[0], d.is_edge,
                                  if_not_exists=ine)
    return DataSet()


@executor("CreateFulltextIndex")
def _create_ft_index(node, qctx, ectx, space):
    a = node.args
    qctx.catalog.create_fulltext_index(
        a["space"], a["index_name"], a["schema_name"], a["field"],
        a["is_edge"], a["if_not_exists"])
    return DataSet()


@executor("DropFulltextIndex")
def _drop_ft_index(node, qctx, ectx, space):
    a = node.args
    qctx.catalog.drop_fulltext_index(a["space"], a["index_name"],
                                     a["if_exists"])
    return DataSet()


@executor("RebuildFulltextIndex")
def _rebuild_ft_index(node, qctx, ectx, space):
    a = node.args
    from .jobs import submit_tracked
    cmd = "rebuild fulltext" + (f" {a['index_name']}"
                                if a.get("index_name") else "")
    job = submit_tracked(qctx, cmd, a["space"])
    return DataSet(["New Job Id"], [[job.job_id]])


@executor("AddListener")
def _add_listener(node, qctx, ectx, space):
    a = node.args
    qctx.catalog.add_listener(a["space"], a["ltype"],
                              ",".join(a["endpoints"]))
    return DataSet()


@executor("RemoveListener")
def _remove_listener(node, qctx, ectx, space):
    a = node.args
    qctx.catalog.remove_listener(a["space"], a["ltype"])
    return DataSet()


@executor("Describe")
def _describe(node, qctx, ectx, space):
    a = node.args
    cat = qctx.catalog
    if a["kind"] == "space":
        sp = cat.get_space(a["name"])
        return DataSet(["ID", "Name", "Partition Number", "Replica Factor",
                        "Vid Type"],
                       [[sp.space_id, sp.name, sp.partition_num,
                         sp.replica_factor, sp.vid_type]])
    space_name = a.get("space")
    if not space_name:
        raise ExecError("no space selected")
    if a["kind"] == "index":
        d = next((x for x in cat.indexes(space_name)
                  if x.name == a["name"]), None)
        if d is None:
            raise ExecError(f"index `{a['name']}' not found "
                            f"in space `{space_name}'")
        schema = (cat.get_edge if d.is_edge else cat.get_tag)(
            space_name, d.schema_name)
        lens = list(getattr(d, "field_lens", None) or [])
        lens += [0] * (len(d.fields) - len(lens))
        return DataSet(
            ["Field", "Type"],
            [[(f"{f}({ln})" if ln else f),
              (p.ptype.value if (p := schema.latest.prop(f))
               else "(dropped)")]
             for f, ln in zip(d.fields, lens)])
    get = cat.get_edge if a["kind"] == "edge" else cat.get_tag
    schema = get(space_name, a["name"])
    rows = []
    for p in schema.latest.props:
        rows.append([p.name, p.ptype.value, "YES" if p.nullable else "NO",
                     p.default if p.has_default else NULL])
    return DataSet(["Field", "Type", "Null", "Default"], rows)


@executor("Show")
def _show(node, qctx, ectx, space):
    a = node.args
    cat = qctx.catalog
    kind = a["kind"]
    if kind == "spaces":
        return DataSet(["Name"], [[n] for n in sorted(cat.spaces)])
    if kind in ("tags", "edges"):
        sp = a.get("space")
        if not sp:
            raise ExecError("no space selected")
        items = cat.tags(sp) if kind == "tags" else cat.edges(sp)
        return DataSet(["Name"], [[t.name] for t in
                                  sorted(items, key=lambda x: x.name)])
    if kind == "users":
        return DataSet(["Account"], [[n] for n in sorted(cat.users)])
    if kind == "zones":
        cluster = getattr(qctx, "cluster", None)
        zones = cluster.list_zones() if cluster is not None else {}
        return DataSet(["Name", "Host", "Port"],
                       [[z, h.rsplit(":", 1)[0], int(h.rsplit(":", 1)[1])]
                        for z in sorted(zones) for h in zones[z]])
    if kind == "roles":
        sp = a.get("extra")
        cat.get_space(sp)
        rows = [[n, u.roles[sp]] for n, u in sorted(cat.users.items())
                if sp in u.roles]
        return DataSet(["Account", "Role Type"], rows)
    if kind in ("tag_indexes", "edge_indexes"):
        sp = a.get("space")
        want_edge = kind == "edge_indexes"
        idx = [d for d in cat.indexes(sp) if d.is_edge == want_edge]
        def _cols(d):
            lens = list(getattr(d, "field_lens", None) or [])
            lens += [0] * (len(d.fields) - len(lens))
            return [f"{f}({ln})" if ln else f
                    for f, ln in zip(d.fields, lens)]
        return DataSet(["Index Name", "By Tag" if not want_edge else "By Edge",
                        "Columns"],
                       [[d.name, d.schema_name, _cols(d)] for d in idx])
    if kind == "traces":
        # newest first; the running SHOW TRACES statement's own trace is
        # still open (stored at statement end), so it never lists itself
        from ..utils.trace import trace_store
        return DataSet(
            ["Trace Id", "Name", "Spans", "Latency (us)"],
            [[t["tid"], t["name"], t["spans"], t["dur_us"]]
             for t in trace_store().list()])
    if kind == "flight_recorder":
        # newest first; like SHOW TRACES, the running statement itself
        # is not recorded yet (it records on completion)
        from ..utils.flight import flight_recorder
        return DataSet(
            ["Id", "Status", "Kind", "Latency (us)", "Operators",
             "Trace Id", "Statement"],
            [[e["id"], e["status"], e["kind"], e["latency_us"],
              e["operators"], e["trace_id"], e["stmt"]]
             for e in flight_recorder().list()])
    if kind == "stalls":
        # stall-watchdog captures — summaries only; the full
        # thread stacks / dispatch table / kernel ledger of one capture
        # are served by GET /stalls?id=<n>
        from ..utils.workload import stall_watchdog
        rows = []
        for e in stall_watchdog().list(limit=50):
            subj = e["subject"]
            rows.append([e["id"], e["kind"],
                         subj.get("stmt") or subj.get("kernel", ""),
                         e["elapsed_s"], e["threshold_s"],
                         e["threads"]])
        return DataSet(["Id", "Kind", "Subject", "Elapsed (s)",
                        "Threshold (s)", "Threads"], rows)
    if kind == "slo":
        from ..utils.slo import slo_engine
        return DataSet(
            ["Objective", "Window", "Target", "Total", "Bad",
             "Bad Ratio", "Burn Rate"],
            [[r["objective"], r["window"], r["target"], r["total"],
              r["bad"], r["bad_ratio"], r["burn"]]
             for r in slo_engine().burn_rates()])
    if kind == "charset":
        return DataSet(
            ["Charset", "Description", "Default collation", "Maxlen"],
            [["utf8", "UTF-8 Unicode", "utf8_bin", 4]])
    if kind == "collation":
        return DataSet(["Collation", "Charset"], [["utf8_bin", "utf8"]])
    if kind == "fulltext_indexes":
        sp = a.get("space")
        if not sp:
            raise ExecError("no space selected")
        return DataSet(
            ["Name", "Schema Type", "Schema Name", "Fields"],
            [[d.name, "Edge" if d.is_edge else "Tag", d.schema_name,
              d.fields[0]]
             for d in sorted(cat.fulltext_indexes(sp),
                             key=lambda x: x.name)])
    if kind == "listener":
        sp = a.get("space")
        if not sp:
            raise ExecError("no space selected")
        lsn = getattr(qctx.store, "_ft_listener", None)
        if lsn is not None:
            lsn.drain()     # report settled lag, not a racing snapshot
        rows = []
        for ltype, ep in cat.listeners(sp):
            st = lsn.status() if lsn is not None else {"lag": 0}
            rows.append([0, ltype, ep, "ONLINE", st.get("lag", 0)])
        return DataSet(["PartId", "Type", "Host", "Status", "Lag"], rows)
    if kind == "hosts":
        role = a.get("extra")               # None | graph | storage | meta
        cluster = getattr(qctx, "cluster", None)
        if cluster is not None:
            with cluster.lock:
                pm = dict(cluster.part_map)
            rows = []
            for h in cluster.list_hosts():
                if role is not None and h.get("role") != role:
                    continue
                host, port = h["addr"].rsplit(":", 1)
                leaders = sum(1 for parts in pm.values()
                              for reps in parts if reps[:1] == [h["addr"]])
                dist = ", ".join(f"{sp}:{len(pids)}" for sp, pids in
                                 sorted(h["parts"].items())) or "No valid partition"
                # a fresh metad leader reports UNKNOWN (not OFFLINE)
                # for hosts it has not heard from yet
                status = h.get("status") or \
                    ("ONLINE" if h["alive"] else "OFFLINE")
                rows.append([host, int(port), status, leaders, dist])
            return DataSet(["Host", "Port", "Status", "Leader count",
                            "Partition distribution"], rows)
        return DataSet(["Host", "Port", "Status", "Leader count",
                        "Partition distribution"],
                       [["127.0.0.1", 0, "ONLINE", 0, "in-process"]])
    if kind in ("tag_indexes_status", "edge_indexes_status"):
        cluster = getattr(qctx, "cluster", None)
        if cluster is not None:
            # rebuild jobs live in metad's table: status is visible from
            # every graphd, not just the one that ran the rebuild
            rows = [[j["cmd"][len("rebuild index "):], j["status"]]
                    for j in cluster.list_jobs()
                    if j["cmd"].startswith("rebuild index ")]
            return DataSet(["Name", "Index Status"], rows)
        from .jobs import job_manager
        rows = [[j.command[len("rebuild index "):], j.status]
                for j in sorted(job_manager(qctx.store).jobs.values(),
                                key=lambda x: x.job_id)
                if j.command.startswith("rebuild index ")]
        return DataSet(["Name", "Index Status"], rows)
    if kind == "meta_leader":
        cluster = getattr(qctx, "cluster", None)
        if cluster is not None:
            cluster.call("meta.ready")           # refresh the hint
            addr = cluster._leader or ""
            host, _, port = addr.partition(":")
            return DataSet(["Meta Leader", "secs from last heart beat"],
                           [[f"{host}:{port}", 0]])
        return DataSet(["Meta Leader", "secs from last heart beat"],
                       [["in-process", 0]])
    if kind == "text_search_clients":
        from ..graphstore.fulltext import text_services
        return DataSet(["Host", "Port", "Connection type"],
                       [[c["host"], c["port"], c["conn"]]
                        for c in text_services(qctx.store).clients])
    if kind == "parts":
        sp = a.get("space")
        if not sp:
            raise ExecError("no space selected")
        meta = getattr(qctx.store, "meta", None)
        if meta is not None:
            # cluster: real replica sets from the meta part map
            # (replicas[0] is the placement leader)
            return DataSet(["Partition Id", "Leader", "Peers"],
                           [[pid, reps[0] if reps else "", list(reps)]
                            for pid, reps in
                            enumerate(meta.parts_of(sp))])
        sd = qctx.store.space(sp)
        return DataSet(["Partition Id", "Leader", "Peers"],
                       [[p, "127.0.0.1", ["127.0.0.1"]]
                        for p in range(sd.num_parts)])
    if kind == "stats":
        sp = a.get("space")
        if not sp:
            raise ExecError("no space selected")
        det = qctx.store.stats_detail(sp)   # ONE scan/fan-out: the
        # per-schema rows and the Space totals come from one snapshot
        rows = [["Tag", t, n] for t, n in sorted(det["tags"].items())]
        rows += [["Edge", e, n] for e, n in sorted(det["edges"].items())]
        rows += [["Space", "vertices", det["vertices"]],
                 ["Space", "edges", det["total_edges"]]]
        return DataSet(["Type", "Name", "Count"], rows)
    if kind == "sessions":
        scols = ["SessionId", "UserName", "SpaceName", "CreateTime",
                 "UpdateTime", "ActiveQueries", "GraphAddr"]
        cluster = getattr(qctx, "cluster", None)
        if a.get("extra") == "local":
            cluster = None      # SHOW LOCAL SESSIONS: this graphd only
        if cluster is not None:
            # metad's replicated table has user/space/created; the LIVE
            # half (last-used time, in-flight statement count) lives on
            # each owning graphd — one short fan-out fills it in, a
            # dead graphd's sessions just show blanks
            sess = cluster.list_sessions()
            live = {}
            for addr in sorted({s["graphd"] for s in sess
                                if s.get("graphd")}):
                try:
                    got = _graphd_call(addr, "graph.session_live")
                except Exception:  # noqa: BLE001 — graphd down
                    continue
                for k, v in got.items():
                    live[int(k)] = v
            rows = []
            for s in sess:
                lu = live.get(s["sid"])
                # None (rendered blank), never 0: a dead graphd's
                # sessions must not read as epoch-1970 idle sessions
                rows.append([s["sid"], s["user"], s.get("space"),
                             int(s.get("created", 0)),
                             int(lu[0]) if lu else None,
                             int(lu[1]) if lu else None,
                             s["graphd"]])
            return DataSet(scols, rows)
        eng = getattr(qctx, "engine", None)
        rows = [[s.id, s.user, s.space, int(s.created),
                 int(s.last_used), len(s.queries), "in-process"]
                for s in (list(eng.sessions.values()) if eng else ())]
        return DataSet(scols, sorted(rows))
    if kind == "repairs":
        # auto-repair plans: the metad leader's raft-
        # persisted RepairPlan table — visible from every graphd, like
        # SHOW JOBS.  Standalone stores have no repair plane.
        rcols = ["Repair Id", "Space", "Part", "Dead Host", "Target",
                 "Phase", "Status", "Created", "Updated", "Error"]
        cluster = getattr(qctx, "cluster", None)
        if cluster is None:
            return DataSet(rcols, [])
        return DataSet(rcols, [
            [r["rid"], r["space"], r["part"], r["dead"], r["target"],
             r["phase"], r["status"], int(r.get("created") or 0),
             int(r.get("updated") or 0), r.get("error")]
            for r in cluster.list_repairs()])
    if kind == "snapshots":
        from .jobs import list_snapshots
        return list_snapshots()
    if kind == "backups":
        from .jobs import list_backups
        return list_backups()
    if kind == "queries":
        # live workload rows: current plan node, rows so far,
        # queue-wait vs device vs host µs, memory charged — the columns
        # come straight from the engine's WorkloadRegistry rows
        # Batch: "bid/lane" while the statement is enrolled
        # in a multi-lane device batch (forming or in flight), else ""
        qcols = ["SessionId", "ExecutionPlanId", "User", "Query",
                 "Status", "Operator", "Rows", "DurationUs", "QueueUs",
                 "DeviceUs", "HostUs", "MemoryBytes", "Consistency",
                 "Batch", "Fingerprint", "GraphAddr"]
        cluster = getattr(qctx, "cluster", None)
        if a.get("extra") == "local":
            cluster = None      # SHOW LOCAL QUERIES: this graphd only
        if cluster is not None:
            # fan out over every graphd in metad's session table — a
            # running query always belongs to a registered session, so
            # the addr set is complete; a dead graphd's queries died
            # with it (skip).  Short timeout, no retries: one hung
            # graphd must not stall an interactive statement.
            rows = []
            for addr in sorted({s["graphd"]
                                for s in cluster.list_sessions()
                                if s.get("graphd")}):
                try:
                    got = _graphd_call(addr, "graph.list_queries")
                except Exception:  # noqa: BLE001 — graphd down
                    continue
                rows.extend(list(r) + [addr] for r in got)
            return DataSet(qcols, rows)
        eng = getattr(qctx, "engine", None)
        rows = [r + ["in-process"]
                for r in (eng.list_running_queries() if eng else ())]
        return DataSet(qcols, rows)
    if kind == "statements":
        # aggregate workload digest: per-fingerprint calls,
        # triage, mergeable latency quantiles, device share and plan
        # history — the column contract lives in docs/OBSERVABILITY.md
        # §10.  Cluster-wide by default (per-graphd registries merged
        # exactly: fixed shared buckets); SHOW LOCAL STATEMENTS reads
        # only this graphd's registry.
        from ..utils.insights import (merge_statement_snapshots,
                                      statement_columns)
        stcols = ["Fingerprint", "Sample", "Calls", "Errors", "P50 Us",
                  "P95 Us", "Rows", "DeviceShare", "PlanHash",
                  "PlanChanged", "Regressed"]
        cluster = getattr(qctx, "cluster", None)
        if a.get("extra") == "local":
            cluster = None      # SHOW LOCAL STATEMENTS: this graphd only
        eng = getattr(qctx, "engine", None)
        if cluster is not None:
            # fan out over every registered graph host (idle graphds
            # still hold history, unlike the SHOW QUERIES session set);
            # a dead graphd's registry died with it (skip)
            snaps = []
            for h in cluster.list_hosts():
                if h.get("role") != "graph" or not h.get("addr"):
                    continue
                try:
                    snaps.append(_graphd_call(h["addr"],
                                              "graph.list_statements"))
                except Exception:  # noqa: BLE001 — graphd down
                    continue
            if not snaps and eng is not None:
                snaps = [eng.insights.snapshot()]
            return DataSet(stcols,
                           statement_columns(
                               merge_statement_snapshots(snaps)))
        snap = eng.insights.snapshot() if eng is not None else []
        return DataSet(stcols, statement_columns(snap))
    if kind == "tenants":
        # fleet tenant QoS view: per-tenant DWRR weight,
        # live running/queued and lifetime admission share, summed
        # across every graph host's admission controller.  SHOW LOCAL
        # TENANTS reads only this process's controller.
        tcols = ["Tenant", "Weight", "Running", "Queued", "Admitted",
                 "Share", "Graphds"]
        from ..utils.admission import admission
        cluster = getattr(qctx, "cluster", None)
        if a.get("extra") == "local":
            cluster = None
        snaps = []
        if cluster is not None:
            for h in cluster.list_hosts():
                if h.get("role") != "graph" or not h.get("addr"):
                    continue
                try:
                    snaps.append(_graphd_call(h["addr"],
                                              "graph.tenant_snapshot"))
                except Exception:  # noqa: BLE001 — graphd down
                    continue
        if not snaps:
            snaps = [admission().tenant_snapshot()]
        merged: Dict[str, list] = {}
        for snap in snaps:
            for r in snap or []:
                m = merged.get(r["tenant"])
                if m is None:
                    merged[r["tenant"]] = [r["tenant"], r["weight"],
                                           r["running"], r["queued"],
                                           r["admitted"], 0.0, 1]
                else:
                    m[1] = max(m[1], r["weight"])
                    m[2] += r["running"]
                    m[3] += r["queued"]
                    m[4] += r["admitted"]
                    m[6] += 1
        total = sum(m[4] for m in merged.values()) or 1
        rows = []
        for m in sorted(merged.values()):
            m[5] = round(m[4] / total, 4)
            rows.append(m)
        return DataSet(tcols, rows)
    if kind == "hotspots":
        # per-partition heat map: metad merges the PartHeat
        # tables ridden up on every storaged heartbeat and ranks parts
        # by load, with replica placement for balancing context
        hcols = ["Space", "Part", "Score", "ReadQps", "WriteQps",
                 "Reads", "Writes", "ReadRows", "WriteRows",
                 "ReadLatUs", "WriteLatUs", "Leader", "Replicas"]
        cluster = getattr(qctx, "cluster", None)
        if cluster is None:
            # standalone engines have no storaged partition plane
            return DataSet(hcols, [])
        rows = [[r["space"], r["part"], r["score"], r["read_qps"],
                 r["write_qps"], r["reads"], r["writes"],
                 r["read_rows"], r["write_rows"], r["read_lat_us"],
                 r["write_lat_us"], r.get("leader", ""),
                 list(r.get("replicas", []))]
                for r in cluster.call("meta.hotspots")]
        return DataSet(hcols, rows)
    if kind == "configs":
        return DataSet(["Module", "Name", "Type", "Mode", "Value"],
                       _config_rows(qctx))
    if kind == "create":
        which, name = a["extra"]
        sp = a.get("space")
        if which == "space":
            spd = cat.get_space(name)
            return DataSet(["Space", "Create Space"],
                           [[name, f"CREATE SPACE `{name}` (partition_num = "
                             f"{spd.partition_num}, replica_factor = "
                             f"{spd.replica_factor}, vid_type = {spd.vid_type})"]])
        get = cat.get_edge if which == "edge" else cat.get_tag
        schema = get(sp, name)
        sv = schema.latest
        parts = []
        for p in sv.props:
            s = f"`{p.name}` {p.ptype.value}"
            s += " NULL" if p.nullable else " NOT NULL"
            if p.has_default:
                s += f" DEFAULT {p.default!r}"
            parts.append(s)
        kw = "EDGE" if which == "edge" else "TAG"
        ddl = f"CREATE {kw} `{name}` (" + ", ".join(parts) + ")"
        if sv.ttl_col and sv.ttl_duration > 0:
            # the emitted DDL must round-trip the FULL schema — TTL
            # included (it was silently dropped before)
            ddl += (f" TTL_DURATION = {sv.ttl_duration}, "
                    f"TTL_COL = \"{sv.ttl_col}\"")
        return DataSet([kw.title(), f"Create {kw.title()}"],
                       [[name, ddl]])
    raise ExecError(f"unsupported SHOW {kind}")


def _need_cluster(qctx, what: str):
    cluster = getattr(qctx, "cluster", None)
    if cluster is None:
        raise ExecError(f"{what} needs cluster mode "
                        "(hosts/zones are a metad placement concept)")
    return cluster


def _graphd_call(addr: str, method: str, **params):
    """One short-deadline, no-retry call to a peer graphd (SHOW/KILL
    QUERY fan-out): an unreachable peer costs ≤3 s, never the RPC
    default of 30 s × 3 attempts, and the socket is closed."""
    from ..cluster.rpc import RpcClient
    cl = RpcClient.from_addr(addr, timeout=3.0, retries=0)
    try:
        return cl.call(method, **params)
    finally:
        cl.close()


@executor("AddHosts")
def _add_hosts(node, qctx, ectx, space):
    cluster = _need_cluster(qctx, "ADD HOSTS ... INTO ZONE")
    cluster.add_hosts_to_zone(node.args["hosts"], node.args["zone"])
    return DataSet()


@executor("DropHosts")
def _drop_hosts(node, qctx, ectx, space):
    cluster = _need_cluster(qctx, "DROP HOSTS")
    from ..cluster.rpc import RpcError
    try:
        cluster.drop_hosts(node.args["hosts"])
    except RpcError as ex:
        raise ExecError(str(ex)) from None
    return DataSet()


@executor("DropZone")
def _drop_zone(node, qctx, ectx, space):
    cluster = _need_cluster(qctx, "DROP ZONE")
    cluster.drop_zone(node.args["zone"])
    return DataSet()


@executor("MergeZone")
def _merge_zone(node, qctx, ectx, space):
    cluster = _need_cluster(qctx, "MERGE ZONE")
    from ..cluster.rpc import RpcError
    try:
        cluster.merge_zones(node.args["zones"], node.args["into"])
    except RpcError as ex:
        raise ExecError(str(ex)) from None
    return DataSet()


@executor("RenameZone")
def _rename_zone(node, qctx, ectx, space):
    cluster = _need_cluster(qctx, "RENAME ZONE")
    from ..cluster.rpc import RpcError
    try:
        cluster.rename_zone(node.args["old"], node.args["new"])
    except RpcError as ex:
        raise ExecError(str(ex)) from None
    return DataSet()


@executor("DivideZone")
def _divide_zone(node, qctx, ectx, space):
    cluster = _need_cluster(qctx, "DIVIDE ZONE")
    from ..cluster.rpc import RpcError
    try:
        cluster.divide_zone(node.args["zone"], node.args["parts"])
    except RpcError as ex:
        raise ExecError(str(ex)) from None
    return DataSet()


@executor("DescZone")
def _desc_zone(node, qctx, ectx, space):
    cluster = _need_cluster(qctx, "DESC ZONE")
    zones = cluster.list_zones()
    z = node.args["zone"]
    if z not in zones:
        raise ExecError(f"zone `{z}' not found")
    return DataSet(["Hosts"], [[h] for h in zones[z]])


@executor("ClearSpace")
def _clear_space(node, qctx, ectx, space):
    from ..graphstore.schema import SchemaError
    try:
        qctx.store.clear_space(node.args["name"],
                               if_exists=node.args["if_exists"])
    except SchemaError as ex:
        raise ExecError(str(ex)) from None
    return DataSet()


@executor("StopJob")
def _stop_job(node, qctx, ectx, space):
    from .jobs import stop_job
    try:
        return stop_job(node, qctx)
    except ValueError as ex:
        raise ExecError(str(ex)) from None


@executor("RecoverJob")
def _recover_job(node, qctx, ectx, space):
    from .jobs import recover_job
    try:
        return recover_job(node, qctx)
    except ValueError as ex:
        raise ExecError(str(ex)) from None


@executor("KillSession")
def _kill_session(node, qctx, ectx, space):
    sid = node.args["session_id"]
    cluster = getattr(qctx, "cluster", None)
    if cluster is not None:
        # metad's table names the OWNING graphd — the kill must reach it
        # so its live session registry drops the entry too (removing the
        # metad row alone would leave the session serving queries)
        sess = next((s for s in cluster.list_sessions()
                     if s["sid"] == sid), None)
        if sess is None:
            # Double-kill idempotency: metad keeps a bounded
            # tombstone list of removed sids.  A sid that existed and
            # was killed means the goal state already holds — quiet
            # success.  A sid that never existed still errors.
            if getattr(cluster, "session_gone", None) and \
                    cluster.session_gone(sid):
                return DataSet()
            raise ExecError(f"session {sid} not found")
        try:
            from ..cluster.rpc import RpcClient
            RpcClient.from_addr(sess["graphd"]).call(
                "graph.kill_session", session_id=sid)
        except Exception:  # noqa: BLE001 — owner down: still drop meta row
            cluster.remove_session(sid)
        return DataSet()
    eng = getattr(qctx, "engine", None)
    if eng is None or not eng.kill_session(sid):
        raise ExecError(f"session {sid} not found")
    return DataSet()


def _config_rows(qctx):
    """One row per flag + session param — the shared currency of SHOW
    CONFIGS and GET CONFIGS (they must never drift)."""
    from ..utils.config import get_config
    rows = [["graph", k, type(v).__name__, "MUTABLE", str(v)]
            for k, v in sorted(get_config().all_values().items())]
    rows += [["session", k, type(v).__name__, "MUTABLE", str(v)]
             for k, v in sorted(qctx.params.items())]
    return rows


@executor("GetConfigs")
def _get_configs(node, qctx, ectx, space):
    name = node.args.get("name")
    rows = _config_rows(qctx)
    if name is not None:
        rows = [r for r in rows if r[1] == name]
        if not rows:
            raise ExecError(f"unknown config `{name}'")
    return DataSet(["Module", "Name", "Type", "Mode", "Value"], rows)


@executor("SignInTextService")
def _sign_in_text_service(node, qctx, ectx, space):
    from ..graphstore.fulltext import text_services
    text_services(qctx.store).sign_in(
        node.args["endpoints"], node.args.get("user"),
        node.args.get("password"))
    return DataSet()


@executor("SignOutTextService")
def _sign_out_text_service(node, qctx, ectx, space):
    from ..graphstore.fulltext import text_services
    try:
        text_services(qctx.store).sign_out()
    except ValueError as ex:
        raise ExecError(str(ex)) from None
    return DataSet()


@executor("AlterSpace")
def _alter_space(node, qctx, ectx, space):
    """ALTER SPACE s ADD ZONE z: future replicas of s may also land in
    zone z's hosts.  The placement model here derives candidate hosts
    from ALL zones at CREATE/BALANCE time, so the zone set is validated
    and the statement acknowledged (a per-space zone whitelist is a
    placement-policy refinement the balancer does not yet enforce)."""
    cluster = _need_cluster(qctx, "ALTER SPACE ... ADD ZONE")
    qctx.catalog.get_space(node.args["name"])
    zones = cluster.list_zones()
    if node.args["zone"] not in zones:
        raise ExecError(f"zone `{node.args['zone']}' not found")
    return DataSet()


@executor("Download")
def _download(node, qctx, ectx, space):
    raise ExecError("DOWNLOAD HDFS needs an HDFS endpoint (none is "
                    "configured in this deployment; use the bulk "
                    "importer: nebula_tpu.tools.ldbc_import)")


@executor("DescribeUser")
def _describe_user(node, qctx, ectx, space):
    name = node.args["name"]
    u = qctx.catalog.users.get(name)
    if u is None:
        raise ExecError(f"user `{name}' not found")
    rows = [[r, sp] for sp, r in sorted(u.roles.items())]
    return DataSet(["role", "space"], rows)


@executor("CreateUser")
def _create_user(node, qctx, ectx, space):
    a = node.args
    qctx.catalog.create_user(a["name"], a["password"], a["if_not_exists"])
    return DataSet()


@executor("DropUser")
def _drop_user(node, qctx, ectx, space):
    a = node.args
    qctx.catalog.drop_user(a["name"], a["if_exists"])
    return DataSet()


@executor("AlterUser")
def _alter_user(node, qctx, ectx, space):
    a = node.args
    qctx.catalog.alter_user(a["name"], a["password"])
    return DataSet()


@executor("ChangePassword")
def _change_password(node, qctx, ectx, space):
    a = node.args
    qctx.catalog.change_password(a["name"], a["old"], a["new"])
    return DataSet()


@executor("GrantRole")
def _grant_role(node, qctx, ectx, space):
    a = node.args
    qctx.catalog.grant_role(a["user"], a["space"], a["role"])
    return DataSet()


@executor("RevokeRole")
def _revoke_role(node, qctx, ectx, space):
    a = node.args
    qctx.catalog.revoke_role(a["user"], a["space"], a["role"])
    return DataSet()


@executor("UpdateConfigs")
def _update_configs(node, qctx, ectx, space):
    from ..core.expr import DictContext
    from ..utils.config import ConfigError, get_config
    a = node.args
    updates = {name: vexpr.eval(DictContext())
               for name, vexpr in a["updates"]}
    try:
        # atomic multi-key: every key validates
        # before any applies — UPDATE CONFIGS max_running_queries = 8,
        # admission_queue_capacity = 128 either fully lands (and the
        # admission drain listener wakes the waiting queue) or fully
        # fails; no half-applied overload tuning
        get_config().set_dynamic_many(updates)
    except ConfigError as ex:
        raise ExecError(str(ex)) from None
    return DataSet()


@executor("SubmitJob")
def _submit_job(node, qctx, ectx, space):
    from .jobs import submit_job
    return submit_job(node, qctx)


@executor("ShowJobs")
def _show_jobs(node, qctx, ectx, space):
    from .jobs import show_jobs
    return show_jobs(node, qctx)


@executor("CreateSnapshot")
def _create_snapshot(node, qctx, ectx, space):
    from .jobs import create_snapshot
    return create_snapshot(qctx)


@executor("DropSnapshot")
def _drop_snapshot(node, qctx, ectx, space):
    from .jobs import drop_snapshot
    return drop_snapshot(qctx, node.args["name"])


@executor("CreateBackup")
def _create_backup(node, qctx, ectx, space):
    from .jobs import create_backup
    return create_backup(qctx, node.args.get("name"))


@executor("DropBackup")
def _drop_backup(node, qctx, ectx, space):
    from .jobs import drop_backup
    return drop_backup(qctx, node.args["name"])


@executor("RestoreBackup")
def _restore_backup(node, qctx, ectx, space):
    from .jobs import restore_backup
    return restore_backup(qctx, node.args["name"])


@executor("KillQuery")
def _kill_query(node, qctx, ectx, space):
    """KILL QUERY (session=sid, plan=qid): set the running query's kill
    event — its scheduler aborts before the next plan node.  In cluster
    mode the kill must reach the OWNING graphd (the session's engine
    registry lives there), routed via metad's session table."""
    eng = getattr(qctx, "engine", None)
    sid = node.args.get("session_id")
    qid = node.args.get("plan_id")
    cluster = getattr(qctx, "cluster", None)
    if cluster is not None:
        sessions = cluster.list_sessions()
        if sid is not None:
            addrs = [s["graphd"] for s in sessions if s["sid"] == sid]
            if not addrs:
                raise ExecError(f"session {sid} not found")
        else:
            addrs = sorted({s["graphd"] for s in sessions
                            if s.get("graphd")})
        hit = False
        owner_dead = False
        for addr in addrs:
            try:
                hit |= bool(_graphd_call(addr, "graph.kill_query",
                                         session_id=sid, plan_id=qid))
            except Exception:  # noqa: BLE001 — owner down: nothing runs
                owner_dead = True
                continue
        if not hit and owner_dead:
            # the race KILL exists to win, closed idempotently
            #: the owning graphd died between the session
            # lookup and the kill — its queries died with it, so the
            # kill's goal state already holds.  Quiet success, never
            # "no running query matches" for a provably-dead victim.
            from ..utils.stats import stats
            stats().inc("kill_owner_dead")
            return DataSet()
        if not hit and (sid is not None or qid is not None):
            raise ExecError(f"no running query matches "
                            f"(session={sid}, plan={qid})")
        return DataSet()
    if eng is None:
        return DataSet()
    if not eng.kill_running(sid, qid) and (sid is not None
                                           or qid is not None):
        raise ExecError(f"no running query matches "
                        f"(session={sid}, plan={qid})")
    return DataSet()


@executor("Explain")
def _explain(node, qctx, ectx, space):
    # handled by the engine (doesn't execute deps for plain EXPLAIN)
    return DataSet(["plan"], [[node.dep().describe()]])
