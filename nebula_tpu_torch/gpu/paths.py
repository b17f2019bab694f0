"""The port's copy of `nebula_tpu/tpu/paths.py`, whole.

FIND SHORTEST PATH on device: BFS kernels + host path reconstruction.

The device computes per-vertex BFS depth (`GpuRuntime.bfs`, one run a
source); the host then walks predecessors (dist[u] == dist[v]-1 along
the reversed direction) to enumerate ALL shortest paths — the exact path
set of the host oracle's multi-parent BFS
(exec/algorithms.py::find_path_host), which the parity tests assert
row-for-row.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from ..core.value import DataSet, Edge, hashable_key
from ..exec.algorithms import (_vids_from, make_path_fn, make_vertex_fn,
                               sort_path_rows)
from .exprjit import CannotCompile, compilable

_REVERSE = {"out": "in", "in": "out", "both": "both"}


def find_shortest_device(node, qctx, ectx) -> DataSet:
    a = node.args
    space = a["space"]
    etypes = a["edge_types"]
    direction = a["direction"]
    upto = a["upto"]
    filt = a.get("filter")
    if filt is not None and not compilable(filt, etypes):
        # the mask compiler resolves props against ONE block's schema;
        # multi-etype prop predicates (or non-vectorizable ones) take
        # the host path BEFORE any launch
        raise CannotCompile("shortest-path filter does not vectorize "
                            "over these edge types")
    rt = qctx.tpu_runtime
    store = qctx.store
    cat = store.catalog
    etype_ids = {e: cat.get_edge(space, e).edge_type for e in etypes}
    sd = store.space(space)

    def edge_ok(e: Edge) -> bool:
        """Host-side re-check during path reconstruction — the device
        mask pruned reachability, but predecessors are rediscovered by
        reverse scans which must apply the same filter."""
        if filt is None:
            return True
        from ..core.expr import to_bool3
        from ..exec.context import RowContext
        rc = RowContext(qctx, space,
                        {"_src": e.src, "_edge": e, "_dst": e.dst})
        return to_bool3(filt.eval(rc)) is True

    if node.input_vars:
        a = dict(a)
        a["__input_var"] = node.input_vars[0]
    srcs = _vids_from(a, "src_vids", "src_ref", ectx)
    dsts = _vids_from(a, "dst_vids", "dst_ref", ectx)

    mk_vertex = make_vertex_fn(qctx, space, bool(a.get("with_prop")))
    path_of = make_path_fn(mk_vertex)

    rev = _REVERSE[direction]
    col = node.col_names[0]
    rows: List[List[Any]] = []

    for s in srcs:
        dist, stats = rt.bfs(store, space, [s], etypes, direction, upto,
                             edge_filter=filt)
        qctx.last_tpu_stats = stats      # PROFILE breadcrumb
        P = dist.shape[0]

        def depth_of(vid) -> int:
            d = sd.dense_id(vid)
            if d < 0:
                return -1
            return int(dist[d % P, d // P])

        def preds(v, lv):
            """(u, Edge-as-forward) wherein dist[u] == lv-1."""
            for (vv, et, rank, u, props, sdir) in store.get_neighbors(
                    space, [v], etypes, rev):
                if depth_of(u) == lv - 1:
                    eid = etype_ids[et]
                    # the reverse scan's sign, flipped: the edge as the
                    # forward walk from u takes it
                    e = Edge(u, v, et, rank, dict(props),
                             etype=eid if sdir < 0 else -eid)
                    if edge_ok(e):
                        yield u, e

        memo: Dict[Any, List[Tuple[List[Any], List[Edge]]]] = {}

        def all_paths_to(v) -> List[Tuple[List[Any], List[Edge]]]:
            kv = hashable_key(v)
            if kv in memo:
                return memo[kv]
            lv = depth_of(v)
            if lv == 0:
                memo[kv] = [([v], [])]
                return memo[kv]
            out = []
            for (u, e) in preds(v, lv):
                for (vc, ec) in all_paths_to(u):
                    out.append((vc + [v], ec + [e]))
            memo[kv] = out
            return out

        ks = hashable_key(s)
        for d in dsts:
            if hashable_key(d) == ks:
                continue
            lv = depth_of(d)
            if 0 < lv <= upto:
                for (vc, ec) in all_paths_to(d):
                    rows.append([path_of(vc, ec)])

    sort_path_rows(rows)
    return DataSet([col], rows)
