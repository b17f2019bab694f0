"""Synthetic LDBC-SNB-shaped Person/KNOWS graph at north-star scale.

A copy of `nebula_tpu/bench/datagen.py` short of its CSV writer:
`make_social_graph` fills the port's own `graphstore.store.GraphStore`
(Person vertices and KNOWS edges, one insert at a time, the store-backed
cells' graph) and `pick_seeds` picks traversal seeds from it;
`make_social_arrays` draws the edge arrays (uniform endpoints with Zipf
tails on both sides, so some sources are supernodes), and
`snapshot_from_arrays` lays them out as a CsrSnapshot with out and in
KNOWS blocks and w (INT64) / f (DOUBLE) / city (STRING) edge props.
`host_csr_traverse` is the numpy GO oracle the port's device path is
checked against (`host_final_hop` its walk, giving the final hop's
slots), `host_bfs` (a copy of the reference's, :282) the numpy
BFS oracle of bench.py config 5, `host_trail_paths` (a copy of the
reference's, :361) the trail-count oracle of bench.py config 4b's MATCH
and `host_hop_edges` its every-hop edge sets.  `unique_keys` keeps one
edge per (src, dst) key, as a store does.  `SnapshotStore` is the store
stand-in the runtime's `traverse`, `traverse_hops` and `bfs` read dense
ids and edge-type ids from, with a write side for the delta plane.
`north_star` sets up the repo's north-star GO once for every script that
runs it.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..core import expr as E
from ..graphstore.csr import CsrBlock, CsrSnapshot, StringPool
from ..graphstore.delta import DeltaLog
from ..graphstore.schema import PropDef, PropType
from ..graphstore.store import GraphStore

_NAMES = ["ada", "bob", "cid", "dee", "eve", "fay", "gus", "hal",
          "ivy", "joe", "kim", "lee", "mia", "ned", "oda", "pam"]


def make_social_graph(n_persons: int = 20_000, avg_degree: int = 25,
                      parts: int = 8, seed: int = 7, space: str = "snb",
                      store: GraphStore | None = None,
                      edge_props: bool = True) -> GraphStore:
    """Person vertices + KNOWS edges with a Zipf-ish degree tail.

    Vertex ids are ints 0..n-1.  Edge props: w INT64 (the benchmark's
    filter column), f DOUBLE, city STRING (dict-encodable).
    """
    rng = np.random.default_rng(seed)
    st = store if store is not None else GraphStore()
    st.create_space(space, partition_num=parts, vid_type="INT64")
    st.catalog.create_tag(space, "Person", [
        PropDef("age", PropType.INT64),
        PropDef("name", PropType.STRING)])
    eprops = [PropDef("w", PropType.INT64),
              PropDef("f", PropType.DOUBLE),
              PropDef("city", PropType.STRING)] if edge_props else []
    st.catalog.create_edge(space, "KNOWS", eprops)

    ages = rng.integers(13, 90, n_persons)
    name_ix = rng.integers(0, len(_NAMES), n_persons)
    for v in range(n_persons):
        st.insert_vertex(space, int(v), "Person",
                         {"age": int(ages[v]), "name": _NAMES[name_ix[v]]})

    n_edges = n_persons * avg_degree
    src = rng.integers(0, n_persons, n_edges)
    # dst mixture: mostly uniform (frontier growth under traversal) with a
    # Zipf tail (supernode destinations, like follower graphs)
    dst = rng.integers(0, n_persons, n_edges)
    hot = rng.random(n_edges) < 0.15
    dst[hot] = (rng.zipf(1.6, int(hot.sum())) - 1) % n_persons
    w = rng.integers(0, 100, n_edges)
    f = rng.random(n_edges)
    city_ix = rng.integers(0, len(_NAMES), n_edges)
    for i in range(n_edges):
        s, d = int(src[i]), int(dst[i])
        if s == d:
            continue
        props = ({"w": int(w[i]), "f": float(f[i]),
                  "city": _NAMES[city_ix[i]]} if edge_props else {})
        st.insert_edge(space, s, "KNOWS", d, 0, props)
    return st


def pick_seeds(store: GraphStore, space: str, k: int,
               min_degree: int = 1) -> list:
    """k vertex ids that actually have out-edges (traversal seeds)."""
    sd = store.space(space)
    seeds = []
    for p in sd.parts:
        for vid, per in p.out_edges.items():
            if sum(len(m) for m in per.values()) >= min_degree:
                seeds.append(vid)
                if len(seeds) >= k:
                    return seeds
    return seeds


def make_social_arrays(n_persons: int, avg_degree: int, seed: int = 7,
                       hot_frac: float = 0.15, src_hot_frac: float = 0.05):
    """Edge arrays: uniform endpoints, a Zipf tail on destinations
    (hot_frac of edges) and on sources (src_hot_frac), self-loops
    dropped.  The source tail is what puts supernodes on the frontier."""
    rng = np.random.default_rng(seed)
    n_edges = n_persons * avg_degree
    src = rng.integers(0, n_persons, n_edges, dtype=np.int64)
    dst = rng.integers(0, n_persons, n_edges, dtype=np.int64)
    hot = rng.random(n_edges) < hot_frac
    dst[hot] = (rng.zipf(1.6, int(hot.sum())) - 1) % n_persons
    shot = rng.random(n_edges) < src_hot_frac
    src[shot] = (rng.zipf(1.5, int(shot.sum())) - 1) % n_persons
    keep = src != dst
    src, dst = src[keep], dst[keep]
    n_edges = src.size
    return {
        "n": n_persons,
        "src": src,
        "dst": dst,
        "w": rng.integers(0, 100, n_edges, dtype=np.int64),
        "f": rng.random(n_edges),
        "city": rng.integers(0, len(_NAMES), n_edges, dtype=np.int64),
    }


def unique_keys(arrs) -> Dict[str, Any]:
    """The edge arrays with one edge per (src, dst) key, the LAST of each
    key's draws, in draw order: the graph a store holds after inserting
    the draws one by one (an insert of an existing key overwrites it).
    The generated arrays are a multigraph; a trail's edge identity is
    its key in the frames and its slot in `host_trail_paths`, which
    agree only when every key is unique."""
    key = arrs["src"] * int(arrs["n"]) + arrs["dst"]
    rev = key[::-1]
    _, first = np.unique(rev, return_index=True)
    keep = np.sort(key.size - 1 - first)
    return {k: (v[keep] if isinstance(v, np.ndarray) else v)
            for k, v in arrs.items()}


def _coo_to_padded_csr(owner, local, nbr_dense, vmax, P):
    """Vectorized COO → (P, ...) padded CSR.  Inputs must already be
    sorted by (owner, local, tiebreak).  Returns (indptr, nbr, order
    positions within part, emax)."""
    counts = np.bincount(owner, minlength=P)
    emax = max(int(counts.max()), 1)
    row_id = owner * vmax + np.minimum(local, vmax - 1)
    per_vertex = np.bincount(row_id, minlength=P * vmax).reshape(P, vmax)
    indptr = np.zeros((P, vmax + 1), np.int64)
    np.cumsum(per_vertex, axis=1, out=indptr[:, 1:])
    starts = np.zeros(P + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(owner.size, dtype=np.int64) - starts[owner]
    nbr = np.full((P, emax), -1, np.int32)
    nbr[owner, pos] = nbr_dense.astype(np.int32)
    return indptr.astype(np.int32), nbr, pos, emax


def snapshot_from_arrays(arrs, parts: int = 8,
                         space: str = "snb") -> CsrSnapshot:
    """Build a CsrSnapshot (out + in KNOWS blocks, w/f/city props)
    directly from edge arrays — the bulk-ingest path for benchmark-scale
    graphs.  dense id = vid, owner = vid % P."""
    n, P = int(arrs["n"]), parts
    src, dst = arrs["src"], arrs["dst"]
    pool = StringPool()
    city_codes = np.asarray([pool.encode(s) for s in _NAMES],
                            np.int64)[arrs["city"]]
    counts = np.bincount(np.arange(n, dtype=np.int64) % P, minlength=P)
    vmax = max(int(counts.max()), 1)
    snap = CsrSnapshot(space=space, epoch=0, num_parts=P, vmax=vmax,
                       num_vertices=counts.astype(np.int32), pool=pool,
                       dense_to_vid=list(range(n)))
    if P * vmax * max(n, 1) >= 1 << 62:
        raise ValueError(f"{n} vertices in {P} parts overflow the sort key")
    for direction in ("out", "in"):
        a, b = (src, dst) if direction == "out" else (dst, src)
        owner = a % P
        local = a // P
        # the (owner, local, b) order as one int64 key: a stable argsort
        # of it is lexsort's order, in about a third of lexsort's time
        order = np.argsort((owner * vmax + local) * n + b, kind="stable")
        ow, lo, nb = owner[order], local[order], b[order]
        indptr, nbr, pos, emax = _coo_to_padded_csr(ow, lo, nb, vmax, P)
        rank = np.zeros_like(nbr)
        props = {}
        for name, col, pt in (("w", arrs["w"], PropType.INT64),
                              ("f", arrs["f"], PropType.DOUBLE),
                              ("city", city_codes, PropType.STRING)):
            dt = np.float64 if pt == PropType.DOUBLE else np.int64
            padded = np.full((P, emax),
                             np.nan if dt == np.float64 else -2, dt)
            padded[ow, pos] = col[order].astype(dt)
            props[name] = padded
        snap.blocks[("KNOWS", direction)] = CsrBlock(
            etype="KNOWS", direction=direction, indptr=indptr, nbr=nbr,
            rank=rank, props=props,
            prop_types={"w": PropType.INT64, "f": PropType.DOUBLE,
                        "city": PropType.STRING})
    return snap


def host_final_hop(snap, seeds, steps: int, etypes=("KNOWS",)):
    """The walk of the numpy GO oracle: per hop, gather the frontier's
    neighbor ranges with repeat, then dedup with np.unique.  Returns
    (edges_traversed, final) where final lists, a block of `etypes`
    each, (block, owner, slot): the part and the slot in it of every
    final-hop edge, in the frontier's CSR order."""
    P = snap.num_parts
    blks = [snap.block(et, "out") for et in etypes]
    frontier = np.unique(np.asarray(seeds, np.int64))
    total = 0
    for hop in range(steps):
        owner = frontier % P
        local = frontier // P
        final = []
        for blk in blks:
            s = blk.indptr[owner, local].astype(np.int64)
            e = blk.indptr[owner, local + 1].astype(np.int64)
            deg = e - s
            total += int(deg.sum())
            rows = np.repeat(np.arange(frontier.size), deg)
            offs = np.arange(deg.sum(), dtype=np.int64) - \
                np.repeat(np.cumsum(deg) - deg, deg)
            final.append((blk, owner[rows], s[rows] + offs))
        if hop < steps - 1:
            frontier = np.unique(np.concatenate(
                [blk.nbr[o, i] for blk, o, i in final]).astype(np.int64))
    return total, final


def host_csr_traverse(snap, seeds, steps: int, w_gt=None,
                      materialize: bool = False, etypes=("KNOWS",)):
    """Numpy GO oracle over the same CSR (`host_final_hop`'s walk);
    `w_gt` filters the final hop on KNOWS.w > w_gt.  Returns
    (edges_traversed, final_kept_count) and, with materialize=True, also
    the final hop's (dst, w) arrays."""
    total, final = host_final_hop(snap, seeds, steps, etypes)
    nxt = np.concatenate([blk.nbr[o, i] for blk, o, i in final]
                         ).astype(np.int64)
    if nxt.size == 0:
        return (total, 0, None, None) if materialize else (total, 0)
    w = np.concatenate([blk.props["w"][o, i] for blk, o, i in final])
    if w_gt is not None:
        keep = w > w_gt
        nxt, w = nxt[keep], w[keep]
    if materialize:
        return total, int(nxt.size), nxt, w
    return total, int(nxt.size)


def _expand_paths(blk, P, fr):
    """One path-expansion hop over an out-CSR block: (parent, dst, eid)
    for EVERY edge out of fr's entries — no dedup; this is path currency,
    not frontier currency.  eid is a globally-unique physical edge id
    (part-major slot index), the trail-dedup key."""
    owner = fr % P
    local = fr // P
    s = blk.indptr[owner, local].astype(np.int64)
    e = blk.indptr[owner, local + 1].astype(np.int64)
    deg = e - s
    tot = int(deg.sum())
    if tot == 0:
        z = np.empty(0, np.int64)
        return z, z, z
    parent = np.repeat(np.arange(fr.size, dtype=np.int64), deg)
    offs = np.arange(tot, dtype=np.int64) \
        - np.repeat(np.cumsum(deg) - deg, deg)
    idx = s[parent] + offs
    emax = blk.nbr.shape[1]
    eid = owner[parent] * emax + idx
    dst = blk.nbr[owner[parent], idx].astype(np.int64)
    return parent, dst, eid


def host_trail_paths(snap, seeds_dense, max_hop):
    """Numpy comparator for config 4: count of variable-length *1..N
    trail paths (distinct edges within one path) from the seed set —
    level-joins with pairwise edge-id comparison, the same algorithm
    class the device frame assembly uses."""
    P = snap.num_parts
    blk = snap.block("KNOWS", "out")
    last = np.asarray(sorted(set(int(s) for s in seeds_dense)), np.int64)
    eids = []
    total = 0
    for _h in range(max_hop):
        if last.size == 0:
            break
        parent, dst, eid = _expand_paths(blk, P, last)
        if dst.size == 0:
            break
        keep = np.ones(dst.size, bool)
        for pe in eids:
            keep &= pe[parent] != eid
        total += int(keep.sum())
        sel = np.flatnonzero(keep)
        last = dst[sel]
        eids = [pe[parent[sel]] for pe in eids] + [eid[sel]]
    return total


def host_hop_edges(snap, seeds_dense, steps: int, w_gt=None):
    """Numpy oracle of MATCH's every-hop capture over the out-KNOWS
    block: per hop, the (src, dst, rank) int64 arrays of every edge out
    of that hop's frontier (with w_gt, only those with KNOWS.w > w_gt),
    the next frontier being the distinct dsts of those edges."""
    P = snap.num_parts
    blk = snap.block("KNOWS", "out")
    fr = np.unique(np.asarray(seeds_dense, np.int64))
    hops = []
    for _h in range(steps):
        parent, dst, eid = _expand_paths(blk, P, fr)
        src = fr[parent]
        rank = blk.rank.reshape(-1)[eid].astype(np.int64)
        if w_gt is not None:
            keep = blk.props["w"].reshape(-1)[eid] > w_gt
            src, dst, rank = src[keep], dst[keep], rank[keep]
        hops.append((src, dst, rank))
        fr = np.unique(dst)
    return hops


def host_bfs(snap, src_dense, steps: int, etype: str = "KNOWS"):
    """Numpy BFS comparator for bench.py config 5: level-synchronous BFS
    over the out-CSR, returning the full dense-id distance array (-1
    unreached, 0..steps otherwise).  The device BFS kernel's distance
    output must match element-for-element."""
    P = snap.num_parts
    blk = snap.block(etype, "out")
    n = len(snap.dense_to_vid)
    dist = np.full(n, -1, np.int32)
    fr = np.unique(np.asarray(src_dense, np.int64))
    dist[fr] = 0
    for hop in range(1, steps + 1):
        if fr.size == 0:
            break
        owner = fr % P
        local = fr // P
        s = blk.indptr[owner, local].astype(np.int64)
        e = blk.indptr[owner, local + 1].astype(np.int64)
        deg = e - s
        tot = int(deg.sum())
        if tot == 0:
            break
        rows = np.repeat(np.arange(fr.size), deg)
        offs = np.arange(tot, dtype=np.int64) - \
            np.repeat(np.cumsum(deg) - deg, deg)
        idx = s[rows] + offs
        nxt = np.unique(blk.nbr[owner[rows], idx].astype(np.int64))
        nxt = nxt[dist[nxt] < 0]
        dist[nxt] = hop
        fr = nxt
    return dist


class _KnowsSchema:
    """The KNOWS edge schema the delta reader hands out: no defaults."""
    props = [PropDef("w", PropType.INT64), PropDef("f", PropType.DOUBLE),
             PropDef("city", PropType.STRING)]


class SnapshotStore:
    """Store stand-in backed by a prebuilt CsrSnapshot — the surface
    GpuRuntime.traverse reads (dense_id, epoch, edge-type catalog).

    Given `arrs`, the `make_social_arrays` edge arrays the snapshot was
    built from, it also has the write side the delta-plane bench needs,
    with the reference store's delta protocol (graphstore/store.py:
    379-411): `insert_edge`, `delete_edge` and `update_edge` on KNOWS,
    each bumping the epoch and noting its key on the `DeltaLog` that
    `delta_watch` attached; `delta_records`, `delta_trim`, and
    `delta_reader`, a reader over the base arrays plus the write overlay.
    `mutated_arrays()` returns the written graph as
    `make_social_arrays`-shaped arrays, for the full-rebuild oracle.

    This is a bench stand-in, not a store: one space, one edge type, no
    vertices or tags, rank 0 only (the arrays have no rank), every
    insert carries all of w, f and city (and the `extra` columns, when
    the snapshot has more), and a key (src, dst, 0) shared by parallel
    base edges cannot be written (a store keeps one edge per key; the
    generated multigraph may hold several)."""

    class _SD:
        def __init__(self, n, epoch):
            self._n = n
            self.epoch = epoch

        def dense_id(self, v):
            v = int(v)
            return v if 0 <= v < self._n else -1

    class _Edge:
        edge_type = 1

    class _Catalog:
        def get_edge(self, space, et):
            return SnapshotStore._Edge()

    class _Reader:
        """The delta reader protocol (graphstore/delta.py) over the store."""

        def __init__(self, store):
            self.store = store

        def dense_of(self, vid) -> Optional[int]:
            d = self.store._sd.dense_id(vid)
            return None if d < 0 else d

        def edge_row(self, etype, src, dst, rank):
            if etype != "KNOWS":
                return None, None
            return self.store.edge_row(src, dst, rank), self.store._schema

        def vertex_rows(self, vid) -> Dict[str, Dict[str, Any]]:
            return {}

        def tag_schema(self, tag):
            return None

    def __init__(self, snap, arrs=None,
                 extra: Optional[Dict[str, PropType]] = None):
        self.snap = snap
        self._sd = SnapshotStore._SD(len(snap.dense_to_vid), snap.epoch)
        self.catalog = SnapshotStore._Catalog()
        self._arrs = arrs
        # KNOWS columns beyond w, f and city (name -> type): the arrays
        # hold no base values for them, so such a store writes new keys
        # only
        self._extra = dict(extra or {})
        self._schema = _KnowsSchema if not self._extra else \
            SimpleNamespace(props=_KnowsSchema.props + [
                PropDef(n, t) for n, t in self._extra.items()])
        self._overlay: Dict[Tuple[int, int, int], Optional[dict]] = {}
        self._log: Optional[DeltaLog] = None
        self._keys = None          # (sorted src*n + dst codes, their order)

    def space(self, name):
        return self._sd

    # -- write side ---------------------------------------------------------

    def _codes(self):
        if self._keys is None:
            if self._arrs is None:
                raise ValueError("this SnapshotStore has no edge arrays: "
                                 "pass arrs to write")
            n = int(self._arrs["n"])
            codes = self._arrs["src"] * n + self._arrs["dst"]
            order = np.argsort(codes, kind="stable")
            self._keys = (codes[order], order)
        return self._keys

    def _base_index(self, src: int, dst: int) -> Optional[int]:
        """The arrays' index of base edge (src, dst), None when absent;
        raises for a key parallel base edges share."""
        codes, order = self._codes()
        c = int(src) * int(self._arrs["n"]) + int(dst)
        lo = int(np.searchsorted(codes, c, "left"))
        hi = int(np.searchsorted(codes, c, "right"))
        if hi - lo > 1:
            raise ValueError(f"KNOWS ({src}, {dst}) names {hi - lo} "
                             f"parallel base edges")
        return int(order[lo]) if hi > lo else None

    def writable_edges(self) -> np.ndarray:
        """Ascending indices into the edge arrays of the base edges a
        write can address: those whose (src, dst) no parallel edge
        shares."""
        codes, order = self._codes()
        new = codes[1:] != codes[:-1]
        return np.sort(order[np.r_[True, new] & np.r_[new, True]])

    def base_has(self, src, dst) -> np.ndarray:
        """Whether each (src, dst) pair names a base edge (vectorized)."""
        codes, _ = self._codes()
        c = np.asarray(src, np.int64) * int(self._arrs["n"]) \
            + np.asarray(dst, np.int64)
        if codes.size == 0:
            return np.zeros(c.shape, bool)
        return codes[np.minimum(np.searchsorted(codes, c),
                                codes.size - 1)] == c

    def edge_row(self, src: int, dst: int, rank: int = 0) -> Optional[dict]:
        """The live KNOWS row of (src, dst, rank): the overlay's, else
        the base arrays'; None when absent."""
        key = (int(src), int(dst), int(rank))
        if key in self._overlay:
            return self._overlay[key]
        if rank != 0:
            return None
        i = self._base_index(src, dst)
        if i is None:
            return None
        a = self._arrs
        return {"w": int(a["w"][i]), "f": float(a["f"][i]),
                "city": _NAMES[int(a["city"][i])]}

    def _write(self, src: int, dst: int, rank: int,
               row: Optional[dict]) -> None:
        n = int(self._arrs["n"]) if self._arrs is not None else 0
        if rank != 0:
            raise ValueError("the bench's KNOWS edges carry rank 0 only")
        if not (0 <= src < n and 0 <= dst < n):
            raise ValueError(f"({src}, {dst}) is not a pair of persons")
        base = self._base_index(src, dst)   # refuses parallel-edge keys
        if base is not None and row is not None and self._extra:
            raise ValueError(f"KNOWS ({src}, {dst}) is a base edge: the "
                             f"arrays hold none of {sorted(self._extra)}")
        self._overlay[(int(src), int(dst), 0)] = row
        self._sd.epoch += 1
        if self._log is not None:
            self._log.note(("e", "KNOWS", int(src), int(dst), 0))

    def insert_edge(self, src: int, dst: int, props: Dict[str, Any],
                    rank: int = 0) -> None:
        """Insert KNOWS (src, dst, rank) — or overwrite it, as INSERT
        EDGE does — with all of w (int), f (float), city (a name) and the
        store's extra columns (values of their types)."""
        if set(props) != {"w", "f", "city"} | set(self._extra) \
                or props["city"] not in _NAMES:
            raise ValueError("an insert carries w, f, one of the bench's "
                             "city names and every extra column")
        self._write(src, dst, rank, {
            "w": int(props["w"]), "f": float(props["f"]),
            "city": props["city"], **{n: props[n] for n in self._extra}})

    def delete_edge(self, src: int, dst: int, rank: int = 0) -> None:
        self._write(src, dst, rank, None)

    def update_edge(self, src: int, dst: int, props: Dict[str, Any],
                    rank: int = 0) -> None:
        """Overwrite some props of a live KNOWS edge."""
        cur = self.edge_row(src, dst, rank)
        if cur is None:
            raise KeyError(f"no KNOWS ({src}, {dst}, {rank})")
        self.insert_edge(src, dst, {**cur, **props}, rank)

    # -- the reference store's delta protocol ---------------------------------

    def delta_watch(self, space: str, cap: int = 65536) -> int:
        if self._log is None or self._log.broken:
            self._log = DeltaLog(floor_epoch=self._sd.epoch, cap=cap)
        return self._sd.epoch

    def delta_records(self, space: str):
        """-> (dirty keys, target epoch, log floor epoch), or None when
        no log is watching or it broke."""
        if self._log is None or self._log.broken:
            return None
        return list(self._log.keys), self._sd.epoch, self._log.floor_epoch

    def delta_trim(self, space: str, keys) -> None:
        if self._log is not None:
            self._log.trim(keys)

    def delta_reader(self, space: str):
        return SnapshotStore._Reader(self)

    def mutated_arrays(self) -> Dict[str, Any]:
        """The written graph as `make_social_arrays`-shaped arrays: the
        base edges minus every written key, then the live written rows in
        write order.  `snapshot_from_arrays` of it is what a full rebuild
        pins.  A store with extra columns has none: the arrays cannot
        hold them."""
        if self._extra:
            raise ValueError("mutated_arrays holds w, f and city only")
        a = self._arrs
        keep = np.ones(a["src"].size, bool)
        for (s, d, _r) in self._overlay:
            i = self._base_index(s, d)
            if i is not None:
                keep[i] = False
        live = [(k, r) for k, r in self._overlay.items() if r is not None]
        city = {c: i for i, c in enumerate(_NAMES)}
        out = {"n": a["n"]}
        for name, new, dt in (
                ("src", [k[0] for k, _ in live], np.int64),
                ("dst", [k[1] for k, _ in live], np.int64),
                ("w", [r["w"] for _, r in live], np.int64),
                ("f", [r["f"] for _, r in live], np.float64),
                ("city", [city[r["city"]] for _, r in live], np.int64)):
            out[name] = np.concatenate([a[name][keep],
                                        np.asarray(new, dt)])
        return out


class NorthStar(NamedTuple):
    snap: CsrSnapshot
    store: SnapshotStore
    seeds: List[int]
    yields: List[Tuple[E.Expr, str]]
    w_filter: E.Expr           # WHERE KNOWS.w > w_gt
    w_gt: int
    n_edges: int
    split_threshold: int       # GpuRuntime(degree_split_threshold=...)
    arrs: Dict[str, Any]       # the edge arrays, for SnapshotStore's writes


def north_star(persons: int = 1_000_000,
               split_threshold: int = 0) -> NorthStar:
    """The north-star GO of bench.py config 6: make_social_arrays(persons,
    30, seed=7) in 8 parts (space "ns"), GO 3 STEPS FROM the 16 seeds
    np.unique(src[:64])[:16] OVER KNOWS YIELD dst(edge) AS d, KNOWS.w AS
    w, unfiltered or WHERE KNOWS.w > 50.  bench.py runs it with the
    supernode degree-split at threshold 2048 (bench.py:310-318): pass
    split_threshold and pin `snap` into
    GpuRuntime(degree_split_threshold=split_threshold), which splits it
    at pin time.  `snap` itself stays unsplit — the layout
    host_csr_traverse reads (in a split snapshot a hub's own row is
    empty), with the same edges, so it stays the oracle."""
    arrs = make_social_arrays(persons, 30, seed=7)
    snap = snapshot_from_arrays(arrs, parts=8, space="ns")
    seeds = np.unique(arrs["src"][:64])[:16].tolist()
    yields = [(E.FunctionCall("dst", [E.EdgeExpr()]), "d"),
              (E.EdgeProp("KNOWS", "w"), "w")]
    w_filter = E.Binary(">", E.EdgeProp("KNOWS", "w"), E.Literal(50))
    return NorthStar(snap, SnapshotStore(snap), seeds, yields, w_filter, 50,
                     int(arrs["src"].size), int(split_threshold), arrs)
