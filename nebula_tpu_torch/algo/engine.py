"""`CALL algo.*` execution, the port of `nebula_tpu/algo/engine.py`.

One shared iterative vertex-program loop drives all three algorithms:
dense per-vertex state arrays on the runtime's device and one step
kernel per iteration (algo/kernels.py), with convergence / max-iteration
termination decided on the HOST between dispatches.  Between iterations
a `live` object (anything with `set_operator`) is stamped with the
progress string SHOW QUERIES renders,
`algo.pagerank[iter k/K active_frontier=N]`.

Execution modes (the `mode` parameter): `device` runs the step kernels
on the runtime's device and raises without a runtime; `host` runs the
numpy oracles; `auto` means device when a runtime is given and host when
it is None.  An error on the device path propagates: it is never
answered by the oracle.  Both paths share graph preparation
(algo/graph.py) and row assembly, so rows are identical up to PageRank's
float tolerance.

`run_algorithm` is the entry point.  The executor body `run_call_algo`
and its store snapshot `_host_snapshot` need the query context and the
store, which the nGQL slice brings; the cancel check, the `algo:iter`
failpoint, the `tpu:algo_iter` span and the `algo_*` metrics of the
reference's `_iterate` wait for the port's utils.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import ALGORITHMS, DEFAULT_MAX_ITER, REQUIRED, _DIRECTIONS, _MODES
from . import kernels
from ..gpu.device import GpuUnavailable
from .graph import AlgoGraph, blocks_for, build_algo_graph
from .oracles import BIG, pagerank_np, sssp_np, wcc_np


class AlgoError(Exception):
    """User-facing algo-plane error."""


# -- graph preparation (shared by both modes) -------------------------------

#: flat-edge LRU; key (id(snap), blocks, weight) → (snap ref, AlgoGraph)
_graph_cache: Dict[Tuple, Tuple[Any, AlgoGraph]] = {}
#: device-resident edge arrays; key (id(snap), blocks, weight, device) →
#: (snap ref, dict of tensors).  BOTH id(snap)-keyed caches hold the
#: snapshot itself: a key is only reachable while its snapshot is alive,
#: so a recycled object id can never serve another graph's arrays.
_dev_cache: Dict[Tuple, Tuple[Any, Dict[str, torch.Tensor]]] = {}


def _lru_put(cache: Dict, key, value, cap: int = 4):
    cache[key] = value
    while len(cache) > cap:
        cache.pop(next(iter(cache)))


def _lru_get(cache: Dict, key):
    """Dict-as-LRU read: re-insert on hit so eviction tracks RECENCY,
    not insertion order (a hot entry must survive a cold parade)."""
    ent = cache.pop(key, None)
    if ent is not None:
        cache[key] = ent
    return ent


def _algo_graph(snap, block_keys, weight_prop) -> AlgoGraph:
    key = (id(snap), tuple(block_keys), weight_prop)
    ent = _lru_get(_graph_cache, key)
    if ent is not None:
        return ent[1]
    g = build_algo_graph(snap, block_keys, weight_prop)
    _lru_put(_graph_cache, key, (snap, g))
    return g


def _put(rt, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(rt.device)


def _device_edges(rt, snap, block_keys, weight_prop,
                  g: AlgoGraph) -> Dict[str, torch.Tensor]:
    """Device-resident flat edge arrays, uploaded once per (snapshot,
    block set, weight, device) and reused by every iteration and run.

    Edges go up DST-SORTED (AlgoGraph.by_dst): PageRank's combine is a
    segment reduction over `starts`, and min is exactly
    order-independent, so the sort never changes WCC/SSSP results.
    esrc/edst int32, starts int64, vmask bool, weight float64."""
    key = (id(snap), tuple(block_keys), weight_prop, str(rt.device))
    ent = _lru_get(_dev_cache, key)
    if ent is not None:
        return ent[1]
    if g.n_slots >= 1 << 31:
        # dense ids are int32 on the device, as in the reference
        raise GpuUnavailable(f"n_slots = {g.n_slots} exceeds int32")
    order, esrc_s, edst_s, starts = g.by_dst()
    arrs = {
        "esrc": _put(rt, esrc_s.astype(np.int32)),
        "edst": _put(rt, edst_s.astype(np.int32)),
        "starts": _put(rt, starts.astype(np.int64)),
        "vmask": _put(rt, g.vmask),
    }
    if g.weight is not None:
        arrs["weight"] = _put(rt, g.weight[order])
    _lru_put(_dev_cache, key, (snap, arrs))
    return arrs


# -- parameter resolution ---------------------------------------------------


def resolve_params(func: str, given: Dict[str, Any]) -> Dict[str, Any]:
    """Defaults + type/range checks on the literal parameter values
    (the validator already vetted names/required/yields)."""
    spec = ALGORITHMS[func]
    p = {k: v for k, v in spec.params.items() if v is not REQUIRED}
    p.update(given)
    if p.get("mode") not in _MODES:
        raise AlgoError(f"mode must be one of {_MODES}")
    if "direction" in p and p["direction"] not in _DIRECTIONS:
        raise AlgoError(f"direction must be one of {_DIRECTIONS}")
    mi = p.get("max_iter")
    if not isinstance(mi, int) or isinstance(mi, bool) or mi < 0:
        raise AlgoError("max_iter must be a non-negative integer")
    if func == "pagerank":
        d = p["damping"]
        if not isinstance(d, (int, float)) or not 0.0 < float(d) < 1.0:
            raise AlgoError("damping must be in (0, 1)")
        t = p["tol"]
        if not isinstance(t, (int, float)) or float(t) < 0:
            raise AlgoError("tol must be non-negative")
    if func == "sssp":
        w = p.get("weight")
        if w is not None and not isinstance(w, str):
            raise AlgoError("weight must name an edge prop (string)")
    et = p.get("edge_types")
    if isinstance(et, str):
        p["edge_types"] = [et]
    elif et is not None and not (isinstance(et, list)
                                 and all(isinstance(x, str) for x in et)):
        raise AlgoError("edge_types must be a string or list of strings")
    return p


def _effective_max_iter(func: str, params: Dict[str, Any],
                        g: AlgoGraph) -> int:
    k = int(params.get("max_iter") or 0)
    if k > 0:
        return k
    dflt = DEFAULT_MAX_ITER[func]
    if func in ("wcc", "sssp"):
        # both converge within the graph diameter; n_vertices bounds it
        return max(min(dflt, max(g.n_vertices, 1)), 1)
    return dflt


# -- the shared iteration loop ----------------------------------------------


def _iterate(name: str, max_iter: int, live, body,
             iter_us: Optional[List[int]] = None) -> int:
    """Drive `body(it) -> (active, converged)`, stamping the live
    progress SHOW QUERIES renders after each iteration.  Returns the
    iterations actually run; `iter_us` (when given) collects
    per-iteration wall µs — the bench's probe."""
    iters = 0
    for it in range(1, max_iter + 1):
        t0 = time.perf_counter()
        active, converged = body(it)
        us = int((time.perf_counter() - t0) * 1e6)
        if iter_us is not None:
            iter_us.append(us)
        if live is not None:
            live.set_operator(f"algo.{name}[iter {it}/{max_iter} "
                              f"active_frontier={int(active)}]")
        iters = it
        if converged:
            break
    return iters


# -- device loops -----------------------------------------------------------
#
# Each returns (final state as a numpy array, iterations).  `step` is the
# iteration function: the kernel wrapper by default; its plain version
# drives the same loop on the same device as the kernel's yardstick.


def _device_pagerank(rt, snap, block_keys, g, params, live,
                     iter_us=None, step=None):
    step = step or kernels.pagerank_step
    dev = _device_edges(rt, snap, block_keys, None, g)
    damping, tol = float(params["damping"]), float(params["tol"])
    n = float(max(g.n_vertices, 1))
    outdeg = g.out_degree()
    out_inv = np.zeros(g.n_slots)
    nz = outdeg > 0
    out_inv[nz] = 1.0 / outdeg[nz]
    _order, esrc_s, _edst_s, _starts = g.by_dst()
    # per-edge 1/outdeg pre-gathered once (static within a run): the
    # iteration kernel then needs ONE gather per edge, not two
    out_inv_e = _put(rt, out_inv[esrc_s])
    dmask = _put(rt, g.vmask & ~nz)
    state = {"rank": _put(rt, np.where(g.vmask, 1.0 / n, 0.0))}
    K = _effective_max_iter("pagerank", params, g)

    def body(it):
        (rank, delta, active), _us = rt.algo_dispatch(
            "algo.pagerank", step, state["rank"], dev["esrc"],
            dev["starts"], out_inv_e, dmask, dev["vmask"], n, damping, tol)
        state["rank"] = rank
        return int(active), float(delta) < tol

    iters = _iterate("pagerank", K, live, body, iter_us)
    return state["rank"].cpu().numpy(), iters


def _device_wcc(rt, snap, block_keys, g, params, live, iter_us=None,
                step=None):
    step = step or kernels.wcc_step
    dev = _device_edges(rt, snap, block_keys, None, g)
    label0 = np.where(g.vmask, np.arange(g.n_slots, dtype=np.int64), BIG)
    state = {"label": _put(rt, label0), "active": dev["vmask"]}
    K = _effective_max_iter("wcc", params, g)

    def body(it):
        (label, active, changed), _us = rt.algo_dispatch(
            "algo.wcc", step, state["label"], state["active"],
            dev["esrc"], dev["edst"])
        state["label"], state["active"] = label, active
        c = int(changed)
        return c, c == 0

    iters = _iterate("wcc", K, live, body, iter_us)
    return state["label"].cpu().numpy(), iters


def _device_sssp(rt, snap, block_keys, g, params, live, src_dense,
                 iter_us=None, step=None):
    step = step or kernels.sssp_step
    weight_prop = params.get("weight")
    dev = _device_edges(rt, snap, block_keys, weight_prop, g)
    dist0 = np.full(g.n_slots, np.inf)
    dist0[src_dense] = 0.0
    front0 = np.zeros(g.n_slots, bool)
    front0[src_dense] = True
    state = {"dist": _put(rt, dist0), "front": _put(rt, front0)}
    K = _effective_max_iter("sssp", params, g)
    extra = (dev["weight"],) if weight_prop is not None else ()

    def body(it):
        (dist, front, changed), _us = rt.algo_dispatch(
            "algo.sssp", step, state["dist"], state["front"],
            dev["esrc"], dev["edst"], *extra)
        state["dist"], state["front"] = dist, front
        c = int(changed)
        return c, c == 0

    iters = _iterate("sssp", K, live, body, iter_us)
    return state["dist"].cpu().numpy(), iters


# -- row assembly (one code path for device AND host rows) ------------------


def assemble_rows(func: str, g: AlgoGraph,
                  state: np.ndarray) -> List[List[Any]]:
    """Final state array → full-width rows, ordered by vid (the
    documented deterministic order — identical for device and host
    because both sort the same vid domain the same way)."""
    d2v = g.dense_to_vid
    out: List[List[Any]] = []
    live = np.flatnonzero(g.vmask).tolist()
    if func == "pagerank":
        for d in live:
            out.append([d2v[d], float(state[d])])
    elif func == "wcc":
        for d in live:
            out.append([d2v[d], d2v[int(state[d])]])
    else:  # sssp: reached vertices only
        for d in live:
            v = float(state[d])
            if np.isfinite(v):
                out.append([d2v[d], v])
    try:
        out.sort(key=lambda r: r[0])
    except TypeError:        # heterogeneous vids: canonical repr order
        out.sort(key=lambda r: repr(r[0]))
    return out


# -- the entry point ----------------------------------------------------------


def prepare(func: str, params: Dict[str, Any], snap, sd):
    """Resolve one call against a host CsrSnapshot: -> (params, block
    keys, AlgoGraph, src_dense).  src_dense is None but for SSSP, and -1
    for an SSSP source the graph does not hold."""
    params = resolve_params(func, dict(params))
    direction = params.get("direction", "out")
    if func == "pagerank":
        direction = "out"
    elif func == "wcc":
        direction = "both"
    try:
        block_keys = blocks_for(snap, params.get("edge_types"),
                                direction)
    except KeyError as ex:
        raise AlgoError(str(ex)) from None
    weight_prop = params.get("weight") if func == "sssp" else None
    try:
        g = _algo_graph(snap, block_keys, weight_prop)
    except (KeyError, ValueError) as ex:
        raise AlgoError(str(ex)) from None
    if g.weight is not None and g.n_edges and g.weight.min() < 0:
        raise AlgoError(
            f"algo.sssp requires non-negative weights "
            f"(prop `{weight_prop}' has negative values)")
    src_dense = None
    if func == "sssp":
        try:
            src_dense = sd.dense_id(params["src"])
        except Exception:  # noqa: BLE001 — vid-type mismatch: unknown
            src_dense = -1
        if src_dense is None or src_dense < 0 \
                or not g.vmask[src_dense]:
            src_dense = -1
    return params, block_keys, g, src_dense


def run_algorithm(func: str, params: Dict[str, Any], snap, sd,
                  rt=None, live=None, iter_us: Optional[List[int]] = None):
    """Run one algorithm against a host CsrSnapshot: on the device of
    the GpuRuntime `rt` (mode device, or auto with a runtime), or by
    the numpy oracle (mode host, or auto without one).  `sd` maps a vid
    to its dense id (`sd.dense_id`), for SSSP's source.

    -> (rows, info) where rows are full-width [vid, value] rows in the
    canonical vid order and info = {'mode', 'iterations', 'n_edges',
    'n_vertices'}.  `iter_us` collects per-iteration wall µs on the
    device path (the bench's probe)."""
    params, block_keys, g, src_dense = prepare(func, params, snap, sd)
    if src_dense == -1:
        # unknown source: no reachable set — empty result, not an
        # error (FIND PATH's missing-vid contract)
        return [], {"mode": "none", "iterations": 0,
                    "n_edges": g.n_edges, "n_vertices": g.n_vertices}

    mode = params["mode"]
    if mode == "device" and rt is None:
        raise AlgoError("mode=device but no device runtime serves "
                        "this engine")
    if mode != "host" and rt is not None:
        ran_mode = "device"
        if func == "pagerank":
            state, iters = _device_pagerank(
                rt, snap, block_keys, g, params, live, iter_us)
        elif func == "wcc":
            state, iters = _device_wcc(
                rt, snap, block_keys, g, params, live, iter_us)
        else:
            state, iters = _device_sssp(
                rt, snap, block_keys, g, params, live, src_dense,
                iter_us)
    else:
        ran_mode = "host"
        if live is not None:
            live.set_operator(f"algo.{func}[host oracle]")
        if func == "pagerank":
            state, iters = pagerank_np(
                g, float(params["damping"]),
                _effective_max_iter(func, params, g),
                float(params["tol"]))
        elif func == "wcc":
            state, iters = wcc_np(g), 1
        else:
            state, iters = sssp_np(g, src_dense), 1
    return assemble_rows(func, g, state), \
        {"mode": ran_mode, "iterations": iters,
         "n_edges": g.n_edges, "n_vertices": g.n_vertices}
