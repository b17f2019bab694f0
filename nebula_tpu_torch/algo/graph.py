"""Flat edge-array form of a CsrSnapshot for whole-graph algorithms.

PageRank/WCC/SSSP touch EVERY edge every iteration, so the traversal
plane's budgeted frontier expansion (escalating EB buckets, overflow
retries) is the wrong shape — the right one is the dense SpMV /
segment-sum form of PAPERS.md (BLEST; Sparse GNNs on Dense Hardware):
one flat (E,) edge list with global dense endpoint ids, and per-vertex
state as one flat (P*vmax,) array indexed directly by dense id
(dense = local * P + part, so the id space is exactly [0, P*vmax)).

Built ONCE per (snapshot, block set, weight prop) from the HOST
CsrSnapshot with vectorized numpy (np.repeat over indptr diffs — no
per-edge Python), then uploaded once and reused by every iteration
kernel.  Degree-split hub rows map through `hub_dense` exactly like
the expansion kernels do.  A copy of `nebula_tpu/algo/graph.py`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..graphstore.csr import INT_NULL, CsrSnapshot


@dataclass
class AlgoGraph:
    """One algorithm run's graph view: flat edges + vertex-id space."""
    n_slots: int                      # P * vmax — state-array length
    n_vertices: int                   # real (non-phantom) vertices
    esrc: np.ndarray                  # (E,) int64 global dense src
    edst: np.ndarray                  # (E,) int64 global dense dst
    weight: Optional[np.ndarray]      # (E,) float64, or None (unweighted)
    vmask: np.ndarray                 # (n_slots,) bool — real vertices
    dense_to_vid: List                # dense id → vid (None = phantom)

    @property
    def n_edges(self) -> int:
        return int(self.esrc.size)

    def out_degree(self) -> np.ndarray:
        """(n_slots,) float64 out-degrees over the selected edge set."""
        return np.bincount(self.esrc, minlength=self.n_slots) \
            .astype(np.float64)

    def by_dst(self):
        """Destination-sorted edge view (computed once, cached):
        -> (order, esrc_sorted, edst_sorted, starts) where starts is
        the (n_slots+1,) CSC-style segment index into the sorted
        arrays.  The device kernels run on THIS order — PageRank's
        combine is a segment reduction over `starts`, and min is
        exactly order-independent, so sorting never changes WCC/SSSP
        results)."""
        cached = getattr(self, "_by_dst", None)
        if cached is None:
            order = np.argsort(self.edst, kind="stable")
            edst_s = self.edst[order]
            starts = np.searchsorted(
                edst_s, np.arange(self.n_slots + 1, dtype=np.int64))
            cached = (order, self.esrc[order], edst_s, starts)
            self._by_dst = cached
        return cached


def blocks_for(snap: CsrSnapshot, etypes: Optional[Sequence[str]],
               direction: str) -> List[Tuple[str, str]]:
    """(etype, direction) block keys for an algorithm's edge set.
    etypes=None selects every edge type present in the snapshot."""
    if etypes is None:
        names = sorted({et for et, _ in snap.blocks})
    else:
        names = [etypes] if isinstance(etypes, str) else list(etypes)
    keys: List[Tuple[str, str]] = []
    for et in names:
        if direction in ("out", "both"):
            keys.append((et, "out"))
        if direction in ("in", "both"):
            keys.append((et, "in"))
    missing = [k for k in keys if k not in snap.blocks]
    if missing:
        raise KeyError(f"snapshot has no CSR block(s) {missing}")
    return keys


def _decode_weight(raw: np.ndarray) -> np.ndarray:
    """Numeric edge-prop column → float64 weights; NULL weighs 1.0
    (documented lenient default — a missing weight must not silently
    poison a whole run with NaN/INT_NULL sentinels)."""
    if raw.dtype.kind == "f":
        w = raw.astype(np.float64, copy=True)
        w[np.isnan(w)] = 1.0
        return w
    w = raw.astype(np.float64)
    w[raw == INT_NULL] = 1.0
    return w


def build_algo_graph(snap: CsrSnapshot,
                     block_keys: Sequence[Tuple[str, str]],
                     weight_prop: Optional[str] = None) -> AlgoGraph:
    """Flatten the selected CSR blocks into one (E,) edge list."""
    P, vmax = snap.num_parts, snap.vmax
    hub_dense = np.asarray(
        getattr(snap, "hub_dense", None)
        if getattr(snap, "hub_dense", None) is not None else [],
        np.int64)
    srcs, dsts, ws = [], [], []
    for bk in block_keys:
        b = snap.blocks[bk]
        indptr = np.asarray(b.indptr, np.int64)       # (P, R+1)
        nbr = np.asarray(b.nbr)
        R = indptr.shape[1] - 1                       # vmax (+ hub rows)
        deg = indptr[:, 1:] - indptr[:, :-1]          # (P, R)
        rows_all = np.arange(R, dtype=np.int64)
        wcol = None
        if weight_prop is not None:
            if weight_prop not in b.props:
                raise KeyError(
                    f"edge type `{b.etype}' has no prop "
                    f"`{weight_prop}'")
            wcol = np.asarray(b.props[weight_prop])
            if wcol.dtype.kind not in "fiu":
                raise ValueError(
                    f"weight prop `{weight_prop}' is not numeric")
        for p in range(P):
            n_e = int(indptr[p, -1])
            if n_e == 0:
                continue
            rows = np.repeat(rows_all, deg[p])        # (n_e,)
            if hub_dense.size:
                src = np.where(
                    rows < vmax, rows * P + p,
                    hub_dense[np.clip(rows - vmax, 0,
                                      hub_dense.size - 1)])
            else:
                src = rows * P + p
            dst = nbr[p, :n_e].astype(np.int64)
            ok = dst >= 0
            srcs.append(src[ok] if not ok.all() else src)
            dsts.append(dst[ok] if not ok.all() else dst)
            if wcol is not None:
                w = _decode_weight(wcol[p, :n_e])
                ws.append(w[ok] if not ok.all() else w)

    def _cat(parts, dtype):
        if not parts:
            return np.empty(0, dtype)
        return np.concatenate(parts).astype(dtype, copy=False)

    esrc = _cat(srcs, np.int64)
    edst = _cat(dsts, np.int64)
    weight = _cat(ws, np.float64) if weight_prop is not None else None

    n_slots = max(P * vmax, 1)
    # a vertex EXISTS for the algo plane when it has a tag row or is
    # incident to a selected edge: a DELETE VERTEX leaves its dense
    # slot behind (dense ids are stable), so dense_to_vid alone would
    # resurrect deleted vertices; tag-presence ∪ edge-endpoints is the
    # contract both the device kernels and the oracles share
    present = np.zeros(n_slots, bool)
    for t in snap.tags.values():
        pres = np.asarray(t.present)                  # (P, vmax)
        present |= pres.T.reshape(-1)[:n_slots]       # [local*P + p]
    if esrc.size:
        present[esrc] = True
        present[edst] = True
    d2v = list(snap.dense_to_vid)
    named = np.zeros(n_slots, bool)
    live = [i for i, v in enumerate(d2v) if v is not None]
    if live:
        named[np.asarray(live, np.int64)] = True
    vmask = named & present
    return AlgoGraph(n_slots=n_slots, n_vertices=int(vmask.sum()),
                     esrc=esrc, edst=edst, weight=weight,
                     vmask=vmask, dense_to_vid=d2v)
