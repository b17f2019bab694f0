"""Independent numpy host oracles for the algo plane — the parity
contract, and host mode.  A copy of `nebula_tpu/algo/oracles.py`.

Each oracle deliberately uses a DIFFERENT algorithm family than the
device kernels so parity tests compare two implementations that share
nothing but the graph:

  * pagerank_np — classic power iteration with np.add.at (the device
    kernel is a segment reduction over dst-sorted edges); same math,
    independent summation order, so equality is within float
    tolerance.
  * wcc_np      — union-find with path compression (the device kernel
    is min-label propagation); results are EXACT integers.
  * sssp_np     — Dijkstra over adjacency lists with a heap (the
    device kernel is Bellman-Ford-style frontier relaxation); exact
    for integer weights (float64 path sums below 2**53 are exact).

All three operate on the AlgoGraph flat form and return the same
state-array shapes the device loops produce, so row assembly is one
shared code path (engine.py) and host-mode execution IS the oracle.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .graph import AlgoGraph

BIG = np.iinfo(np.int64).max


def pagerank_np(g: AlgoGraph, damping: float, max_iter: int,
                tol: float, check=None) -> Tuple[np.ndarray, int]:
    """-> (rank (n_slots,) float64 — 0 on phantom slots, iterations).
    `check` (when given) is called before every iteration."""
    n = max(g.n_vertices, 1)
    rank = np.where(g.vmask, 1.0 / n, 0.0)
    outdeg = g.out_degree()
    out_inv = np.zeros(g.n_slots)
    nz = outdeg > 0
    out_inv[nz] = 1.0 / outdeg[nz]
    dangling = g.vmask & ~nz
    iters = 0
    for _ in range(max_iter):
        if check is not None:
            check()
        iters += 1
        contrib = rank * out_inv
        acc = np.zeros(g.n_slots)
        np.add.at(acc, g.edst, contrib[g.esrc])
        base = (1.0 - damping + damping * rank[dangling].sum()) / n
        new = np.where(g.vmask, base + damping * acc, 0.0)
        delta = np.abs(new - rank).sum()
        rank = new
        if delta < tol:
            break
    return rank, iters


def wcc_np(g: AlgoGraph) -> np.ndarray:
    """-> component (n_slots,) int64: each real vertex's component id =
    the smallest dense id in its component; BIG on phantom slots."""
    parent = np.arange(g.n_slots, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:        # path compression
            parent[x], x = root, parent[x]
        return root

    for u, v in zip(g.esrc.tolist(), g.edst.tolist()):
        ru, rv = find(u), find(v)
        if ru != rv:
            # union by MIN id — the root is the component id
            if ru < rv:
                parent[rv] = ru
            else:
                parent[ru] = rv
    comp = np.full(g.n_slots, BIG, np.int64)
    for d in np.flatnonzero(g.vmask).tolist():
        comp[d] = find(d)
    return comp


def sssp_np(g: AlgoGraph, src_dense: int) -> np.ndarray:
    """-> dist (n_slots,) float64 (inf unreached), Dijkstra."""
    import heapq
    dist = np.full(g.n_slots, np.inf)
    if not (0 <= src_dense < g.n_slots) or not g.vmask[src_dense]:
        return dist
    # adjacency lists from the flat edge form (one argsort, no Python
    # per-edge loop to build)
    order = np.argsort(g.esrc, kind="stable")
    s_sorted = g.esrc[order]
    starts = np.searchsorted(s_sorted, np.arange(g.n_slots + 1))
    dst_sorted = g.edst[order]
    w_sorted = (g.weight[order] if g.weight is not None
                else np.ones(order.size))
    dist[src_dense] = 0.0
    heap = [(0.0, src_dense)]
    done = np.zeros(g.n_slots, bool)
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        for i in range(int(starts[u]), int(starts[u + 1])):
            v = int(dst_sorted[i])
            nd = d + float(w_sorted[i])
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist
