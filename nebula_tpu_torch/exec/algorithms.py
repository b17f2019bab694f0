"""The port's copy of `nebula_tpu/exec/algorithms.py`, whole.

Host graph algorithms: FIND PATH (shortest/all/noloop) + GET SUBGRAPH.

Analog of the reference's algo executors (BFSShortestPathExecutor /
AllPathsExecutor / SubgraphExecutor; reference: src/graph/executor/algo).  These are the CPU oracles and, for
ALL/NOLOOP PATH and GET SUBGRAPH, their device halves: the same DFS or
BFS replayed over `GpuRuntime.traverse_hops` frames
(`find_path_device`, `subgraph_device`).  FIND SHORTEST PATH's device
half is gpu/paths.py.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Set, Tuple

from ..core.expr import DictContext, Expr, to_bool3
from ..core.value import DataSet, Edge, Path, Step, Vertex, hashable_key, is_null
from .context import ExecutionContext, QueryContext, RowContext


def _vids_from(a, key_vids, key_ref, ectx: ExecutionContext) -> List[Any]:
    out: List[Any] = []
    if a.get(key_ref):
        ref = a[key_ref]
        ds = None
        if ref.startswith("$"):
            var = ref[1:].split(".")[0]
            ds = ectx.get_result(f"${var}")
            ref = ref.split(".")[1]
        else:
            # piped input: stored under the plan's input var by the scheduler
            ds = ectx.get_result(a.get("__input_var", ""))
        if ds is None or not ds.column_names:
            return []
        ci = ds.col_index(ref)
        out = [r[ci] for r in ds.rows]
    else:
        for ve in a.get(key_vids) or []:
            out.append(ve.eval(DictContext()) if isinstance(ve, Expr) else ve)
    uniq, seen = [], set()
    for v in out:
        if isinstance(v, Vertex):
            v = v.vid
        if is_null(v):
            continue
        k = hashable_key(v)
        if k not in seen:
            seen.add(k)
            uniq.append(v)
    return uniq


def _neighbors(qctx: QueryContext, space: str, vid: Any, etypes: List[str],
               direction: str, etype_ids: Dict[str, int],
               edge_filter: Optional[Expr]):
    for (s, et, rank, other, props, sd) in qctx.store.get_neighbors(
            space, [vid], etypes, direction):
        e = Edge(s, other, et, rank, dict(props),
                 etype=etype_ids[et] if sd > 0 else -etype_ids[et])
        if edge_filter is not None:
            rc = RowContext(qctx, space, {"_src": s, "_edge": e, "_dst": other})
            if to_bool3(edge_filter.eval(rc)) is not True:
                continue
        yield e, other


def make_vertex_fn(qctx: QueryContext, space: str, with_prop: bool):
    """Path-endpoint vertex builder — SHARED with the device path
    (tpu/paths.py) so host/device rows stay byte-identical."""
    def mk_vertex(vid):
        if with_prop:
            v = qctx.build_vertex(space, vid)
            return v if v is not None else Vertex(vid)
        return Vertex(vid)
    return mk_vertex


def make_path_fn(mk_vertex):
    def path_of(vchain: List[Any], echain: List[Edge]) -> Path:
        p = Path(mk_vertex(vchain[0]))
        for v, e in zip(vchain[1:], echain):
            p.steps.append(Step(mk_vertex(v), e.name, e.ranking, e.props,
                                e.etype))
        return p
    return path_of


def sort_path_rows(rows: List[List[Any]]):
    """Canonical FIND PATH result order (row-parity contract)."""
    rows.sort(key=lambda r: (r[0].length(),
                             [str(v.vid) for v in r[0].nodes()]))


def find_path_host(node, qctx: QueryContext, ectx: ExecutionContext) -> DataSet:
    a = node.args
    space = a["space"]
    etypes = a["edge_types"]
    etype_ids = {e: qctx.store.catalog.get_edge(space, e).edge_type for e in etypes}
    direction = a["direction"]
    upto = a["upto"]
    kind = a["kind"]
    filt = a.get("filter")
    if node.input_vars:
        a = dict(a)
        a["__input_var"] = node.input_vars[0]
    srcs = _vids_from(a, "src_vids", "src_ref", ectx)
    dsts = _vids_from(a, "dst_vids", "dst_ref", ectx)
    dst_set = {hashable_key(d) for d in dsts}

    col = node.col_names[0]
    rows: List[List[Any]] = []
    mk_vertex = make_vertex_fn(qctx, space, bool(a.get("with_prop")))
    path_of = make_path_fn(mk_vertex)

    if kind == "shortest":
        # level-synchronous BFS per source with multi-parent tracking —
        # yields ALL shortest paths per (src, dst) pair.
        for s in srcs:
            parents: Dict[Any, List[Tuple[Any, Edge]]] = {}
            depth: Dict[Any, int] = {hashable_key(s): 0}
            frontier = [s]
            found_at: Dict[Any, int] = {}
            for level in range(1, upto + 1):
                nxt: List[Any] = []
                nxt_seen: Set = set()
                for u in frontier:
                    for e, w in _neighbors(qctx, space, u, etypes, direction,
                                           etype_ids, filt):
                        kw = hashable_key(w)
                        if kw in depth and depth[kw] < level:
                            continue
                        if kw not in depth:
                            depth[kw] = level
                        if depth[kw] == level:
                            parents.setdefault(kw, []).append((u, e))
                            if kw not in nxt_seen:
                                nxt_seen.add(kw)
                                nxt.append(w)
                        if kw in dst_set and kw not in found_at:
                            found_at[kw] = level
                frontier = nxt
                if not frontier:
                    break

            def all_paths_to(vid, kv) -> List[Tuple[List[Any], List[Edge]]]:
                if depth.get(kv, -1) == 0:
                    return [([vid], [])]
                out = []
                for (u, e) in parents.get(kv, []):
                    for (vc, ec) in all_paths_to(u, hashable_key(u)):
                        out.append((vc + [vid], ec + [e]))
                return out

            for d in dsts:
                kd = hashable_key(d)
                if hashable_key(s) == kd:
                    continue
                if kd in found_at:
                    for (vc, ec) in all_paths_to(d, kd):
                        rows.append([path_of(vc, ec)])
    else:
        def neighbors_of(cur, depth):
            for e, w in _neighbors(qctx, space, cur, etypes, direction,
                                   etype_ids, filt):
                yield e, w, w

        rows.extend(_path_dfs(
            srcs, lambda s: s, upto, neighbors_of, dst_set,
            kind == "noloop", path_of, getattr(ectx, "tracker", None)))
    sort_path_rows(rows)
    return DataSet([col], rows)


def _device_frames(qctx, space: str, starts, etypes, direction: str,
                   hops: int, filt: Optional[Expr]):
    """Shared device-side gate for frame-replay executors (subgraph /
    all-paths): runtime + flag checks, dense-store probe, compilable
    split, the batched `traverse_hops` expansion under the executors'
    error policy (`run_on_device`: only CannotCompile takes the host
    path, recorded), and the host re-check closure for non-compilable
    filters.  -> (frames, edge_ok, sd) or None (take the host path)."""
    rt = getattr(qctx, "tpu_runtime", None)
    if rt is None:
        return None
    from ..utils.config import get_config
    if not get_config().get("tpu_match_device"):
        return None
    store = qctx.store
    try:
        sd = store.space(space)
        sd.dense_id
    except AttributeError:
        return None
    from ..gpu.exprjit import compilable
    from ..gpu.traverse import run_on_device
    dev_pred = filt if (filt is not None
                        and compilable(filt, etypes)) else None
    got = run_on_device(qctx, lambda: rt.traverse_hops(
        store, space, starts, etypes, direction, hops,
        edge_filter=dev_pred))
    if got is None:
        return None
    frames, qctx.last_tpu_stats = got
    host_check = filt is not None and dev_pred is None

    def edge_ok(e: Edge) -> bool:
        if not host_check:
            return True
        rc = RowContext(qctx, space,
                        {"_src": e.src, "_edge": e, "_dst": e.dst})
        return to_bool3(filt.eval(rc)) is True

    return frames, edge_ok, sd


def _path_dfs(srcs, src_handle, upto, neighbors_of, dst_set, noloop,
              path_of, tracker) -> List[List[Any]]:
    """The ALL/NOLOOP PATH DFS, defined ONCE for both drivers (host
    `_neighbors` scans and device hop frames): stack order, per-path
    edge dedup, NOLOOP vertex check, dst-set row emission, and memory
    charging.  neighbors_of(handle, depth) yields (Edge, next_handle,
    w_vid) with any edge filter already applied."""
    rows: List[List[Any]] = []
    pending = 0
    for s in srcs:
        h0 = src_handle(s)
        if h0 is None:
            continue
        stack: List[Tuple[Any, List[Any], List[Edge], Set]] = [
            (h0, [s], [], set())]
        while stack:
            cur, vchain, echain, eseen = stack.pop()
            if len(echain) >= upto:
                continue
            for e, nh, w in neighbors_of(cur, len(echain)):
                ek = e.key()
                if ek in eseen:
                    continue
                if noloop and any(hashable_key(w) == hashable_key(v)
                                  for v in vchain):
                    continue
                nvc, nec = vchain + [w], echain + [e]
                if hashable_key(w) in dst_set:
                    rows.append([path_of(nvc, nec)])
                stack.append((nh, nvc, nec, eseen | {ek}))
                # ALL PATHS is the worst allocator in the engine:
                # charge the search state as it grows, not after
                pending += 96 * (len(nvc) + len(eseen))
                if tracker is not None and pending > (1 << 20):
                    tracker.charge(pending)
                    pending = 0
    if tracker is not None and pending:
        tracker.charge(pending)
    return rows


def find_path_device(node, qctx: QueryContext,
                     ectx: ExecutionContext) -> Optional[DataSet]:
    """FIND ALL/NOLOOP PATH on the device plane (SURVEY §2 row 23
    AllPathsExecutor).

    One batched `traverse_hops` to `upto` captures each depth's edge
    frame (the device frontier keeps walk-reachable vertices: no global
    visited set in capture mode, so frame d holds every edge a
    depth-d walk can take); _path_dfs then replays the shared DFS over
    the in-memory frames instead of per-vertex storage scans.  Returns
    None to take the host path."""
    a = node.args
    if a["kind"] == "shortest" or a["upto"] < 1:
        return None
    space = a["space"]
    if node.input_vars:
        a = dict(a)
        a["__input_var"] = node.input_vars[0]
    srcs = _vids_from(a, "src_vids", "src_ref", ectx)
    dsts = _vids_from(a, "dst_vids", "dst_ref", ectx)
    if not srcs or not dsts:
        return None
    got = _device_frames(qctx, space, srcs, a["edge_types"],
                         a["direction"], a["upto"], a.get("filter"))
    if got is None:
        return None
    frames, edge_ok, sd = got

    def neighbors_of(cur, depth):
        fr = frames[depth]
        for idx in fr.out_edges(cur):
            e = fr.edges[idx]
            if edge_ok(e):
                yield e, int(fr.dst[idx]), e.dst

    mk_vertex = make_vertex_fn(qctx, space, bool(a.get("with_prop")))
    rows = _path_dfs(
        srcs, lambda s: (sd.dense_id(s) if sd.dense_id(s) >= 0 else None),
        a["upto"], neighbors_of, {hashable_key(d) for d in dsts},
        a["kind"] == "noloop", make_path_fn(mk_vertex),
        getattr(ectx, "tracker", None))
    sort_path_rows(rows)
    return DataSet([node.col_names[0]], rows)


def _subgraph_specs(a) -> List[Tuple[str, str]]:
    """(etype, direction) pairs from the plan args — ONE decoder for
    both subgraph drivers so they can never disagree on the edge set."""
    specs: List[Tuple[str, str]] = []
    for e in a.get("out_edges") or []:
        specs.append((e, "out"))
    for e in a.get("in_edges") or []:
        specs.append((e, "in"))
    for e in a.get("both_edges") or []:
        specs.append((e, "both"))
    return specs


def _subgraph_assemble(node, starts_vertices, frontier0, steps,
                       edges_of, vertex_of, yield_spec) -> DataSet:
    """The GET SUBGRAPH BFS replay, defined ONCE for both drivers (host
    `_neighbors` scans and device hop frames) so their row-identity
    contract cannot drift: frontier discovery order, cross-level
    seen-edge dedup, the final round of edges from the last level back
    into the visited set, and per-level row assembly.

    edges_of(u, step) yields (Edge, w) with any edge filter already
    applied; u/w are hashable node handles (vids on the host driver,
    dense ids on the device driver); edges_of must be callable for
    step == steps (the final round)."""
    visited = set(frontier0)
    frontier = list(frontier0)
    level_vertices: List[List[Any]] = [starts_vertices]
    level_edges: List[List[Edge]] = []
    seen_edges: Set = set()

    for step in range(steps):
        nxt, nxt_seen, edges_here = [], set(), []
        for u in frontier:
            for e, w in edges_of(u, step):
                if e.key() in seen_edges:
                    continue
                seen_edges.add(e.key())
                edges_here.append(e)
                if w not in visited:
                    visited.add(w)
                    if w not in nxt_seen:
                        nxt_seen.add(w)
                        nxt.append(w)
        level_edges.append(edges_here)
        frontier = nxt
        level_vertices.append([vertex_of(w) for w in nxt])
        if not frontier:
            break

    # final round (reference behavior): edges from the last-level
    # vertices back into the subgraph
    edges_final: List[Edge] = []
    for u in frontier:
        for e, w in edges_of(u, steps):
            if e.key() in seen_edges:
                continue
            if w in visited:
                seen_edges.add(e.key())
                edges_final.append(e)
    if edges_final:
        if len(level_edges) >= steps:
            level_edges.append(edges_final)
        else:
            level_edges[-1].extend(edges_final)

    cols = node.col_names
    rows = []
    n_levels = max(len(level_vertices), len(level_edges))
    for i in range(n_levels):
        vs = level_vertices[i] if i < len(level_vertices) else []
        es = level_edges[i] if i < len(level_edges) else []
        if not vs and not es:
            continue
        rows.append([vs if spec == "vertices" else es
                     for spec in yield_spec])
    return DataSet(list(cols), rows)


def subgraph_device(node, qctx: QueryContext,
                    ectx: ExecutionContext) -> Optional[DataSet]:
    """GET SUBGRAPH on the device plane (SURVEY §2 row 23 SubgraphExecutor).

    One batched `traverse_hops` expansion to steps+1 captures every
    hop's edge frame; _subgraph_assemble then replays the shared BFS
    over the frames — per-source CSR edge order matches the host
    get_neighbors iteration (HopFrame contract), so rows are
    byte-identical to the host path.  Returns None to take the host
    path (no runtime / flag off / mixed per-etype directions /
    non-devicable store)."""
    a = node.args
    space = a["space"]
    if node.input_vars:
        a = dict(a)
        a["__input_var"] = node.input_vars[0]
    starts = _vids_from(a, "vids", "src_ref", ectx)
    steps = a["steps"]
    if not starts or steps < 1:
        return None
    filt = a.get("filter")

    specs = _subgraph_specs(a)
    dirs = {d for _, d in specs}
    if len(dirs) != 1:
        return None          # mixed per-etype directions: host path
    direction = dirs.pop()
    etypes = [e for e, _ in specs]

    got = _device_frames(qctx, space, starts, etypes, direction,
                         steps + 1, filt)
    if got is None:
        return None
    frames, edge_ok, sd = got
    mk_vertex = make_vertex_fn(qctx, space, a.get("with_prop"))
    dense0 = [sd.dense_id(v) for v in starts]

    def edges_of(u, step):
        fr = frames[step]
        for idx in fr.out_edges(u):
            e = fr.edges[idx]
            if edge_ok(e):
                yield e, int(fr.dst[idx])

    return _subgraph_assemble(
        node, [mk_vertex(s) for s in starts],
        [d for d in dense0 if d >= 0], steps, edges_of,
        lambda w: mk_vertex(sd.vid_of_dense(w)),
        a.get("yield") or ["vertices", "edges"])


def subgraph_host(node, qctx: QueryContext, ectx: ExecutionContext) -> DataSet:
    a = node.args
    space = a["space"]
    cat = qctx.store.catalog
    if node.input_vars:
        a = dict(a)
        a["__input_var"] = node.input_vars[0]
    starts = _vids_from(a, "vids", "src_ref", ectx)
    steps = a["steps"]
    filt = a.get("filter")

    specs = _subgraph_specs(a)
    etype_ids = {e: cat.get_edge(space, e).edge_type for e, _ in specs}

    mk_vertex = make_vertex_fn(qctx, space, a.get("with_prop"))

    def edges_of(u, step):
        for et, d in specs:
            yield from _neighbors(qctx, space, u, [et], d,
                                  {et: etype_ids[et]}, filt)

    return _subgraph_assemble(
        node, [mk_vertex(s) for s in starts], list(starts), steps,
        edges_of, mk_vertex, a.get("yield") or ["vertices", "edges"])
