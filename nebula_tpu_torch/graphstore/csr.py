"""The CSR snapshot: each space's adjacency and edge-property columns as
padded numpy arrays, the state the device plane pins.

A copy of `nebula_tpu/graphstore/csr.py`: StringPool, the NULL
sentinels, the value encode and decode (`encode_prop`, `_encode_default`,
`decode_prop` and the batched `decode_prop_column`, temporal and
geography values included), CsrBlock, TagTable, CsrSnapshot, the
supernode `degree_split`, the export from a live store (`build_snapshot`,
`_build_block`, `_build_tag_table`) and the host oracles `neighbors_of`
and `expand_frontier_host`.  The reference's COO→CSR step runs a host
C++ library with a numpy twin; the port has the numpy twin only
(`build_coo_csr`, same slot order).  `snapshot_from_fields` builds a
snapshot from plain arrays (the fields another process or package
exported), and `bench.datagen.snapshot_from_arrays` from generated edge
arrays.

Layout (identical to the reference):
  * one CsrBlock per (edge type, direction), every part padded to the
    same (Vmax, Emax), so a block is one (P, ...) array stack;
  * dense vids encode their partition: owner(d) = d % P, local(d) = d // P;
  * strings are dictionary codes against the space's StringPool;
  * NULL sentinels inside columns: int → INT64_MIN, float → NaN.
Row order inside a block matches GraphStore.get_neighbors exactly (src
local index, then (rank, neighbor)).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.value import Date, DateTime, Time, is_null
from .schema import PropType

CODE_NULL = -1
INT_NULL = np.iinfo(np.int64).min


class StringPool:
    """Per-space string dictionary: str ↔ int32 code."""

    def __init__(self, strings: Optional[List[str]] = None):
        self.strings: List[str] = []
        self.codes: Dict[str, int] = {}
        for s in strings or ():
            self.encode(s)

    def encode(self, s: str) -> int:
        c = self.codes.get(s)
        if c is None:
            c = len(self.strings)
            self.strings.append(s)
            self.codes[s] = c
        return c

    def lookup(self, s: str) -> int:
        """Encode WITHOUT inserting (query-time constant); -2 if absent
        (matches nothing, unlike the null sentinel -1)."""
        return self.codes.get(s, -2)

    def obj_array(self) -> np.ndarray:
        """Cached object-dtype view of the dictionary for batched decode."""
        arr = getattr(self, "_obj_arr", None)
        if arr is None or len(arr) != len(self.strings):
            arr = np.asarray(self.strings, dtype=object)
            self._obj_arr = arr
        return arr

    def decode(self, c: int) -> Optional[str]:
        if 0 <= c < len(self.strings):
            return self.strings[c]
        return None

    def __len__(self):
        return len(self.strings)


def decode_prop_column(pt: PropType, raw: "np.ndarray",
                       pool: StringPool) -> List[Any]:
    """Batched decode of a whole property column (same semantics as
    decode_prop per element, ~20× faster than calling it in a loop —
    the TPU materialization path decodes hundreds of thousands of final
    edges per query)."""
    from ..core.value import NULL
    if pt in (PropType.FLOAT, PropType.DOUBLE):
        a = raw.astype(np.float64)
        if not np.isnan(a).any():       # no-null fast path: one C tolist
            return a.tolist()
        return [NULL if x != x else x for x in a.tolist()]
    av = raw.astype(np.int64)
    if pt in (PropType.STRING, PropType.FIXED_STRING):
        strings = pool.strings
        ns = len(strings)
        if av.size and ((av >= 0) & (av < ns)).all():
            return pool.obj_array()[av].tolist()
        vals = av.tolist()
        return [strings[r] if 0 <= r < ns else NULL for r in vals]
    vals = av.tolist()
    if pt == PropType.BOOL:
        return [NULL if r == INT_NULL else bool(r) for r in vals]
    if pt in (PropType.DATE, PropType.DATETIME, PropType.TIME,
              PropType.DURATION, PropType.GEOGRAPHY):
        return [decode_prop(pt, r, pool) for r in vals]
    if not (av == INT_NULL).any():      # no-null fast path
        return vals
    return [NULL if r == INT_NULL else r for r in vals]


def decode_prop_column_np(pt: PropType, raw: "np.ndarray",
                          pool: StringPool) -> "np.ndarray":
    """decode_prop_column, columnar: returns a numpy array — native
    numeric dtype on the null-free fast paths, object dtype otherwise —
    creating NO per-element Python objects on the fast paths.  Feeds the
    ColumnarDataSet result handle (device results stay columnar until
    the wire/print boundary)."""
    if pt in (PropType.FLOAT, PropType.DOUBLE):
        a = raw.astype(np.float64)
        if not np.isnan(a).any():
            return a
    elif pt in (PropType.STRING, PropType.FIXED_STRING):
        av = raw.astype(np.int64)
        ns = len(pool.strings)
        if av.size == 0 or ((av >= 0) & (av < ns)).all():
            return pool.obj_array()[av]
    elif pt not in (PropType.BOOL, PropType.DATE, PropType.DATETIME,
                    PropType.TIME, PropType.DURATION, PropType.GEOGRAPHY):
        av = raw.astype(np.int64)
        if not (av == INT_NULL).any():
            return av
    out = np.empty(len(raw), dtype=object)
    out[:] = decode_prop_column(pt, raw, pool)
    return out


def decode_prop(pt: PropType, raw: Any, pool: StringPool) -> Any:
    """Exact inverse of encode_prop (sentinels → NULL)."""
    import datetime as _dt

    from ..core.value import NULL
    if pt in (PropType.FLOAT, PropType.DOUBLE):
        f = float(raw)
        return NULL if np.isnan(f) else f
    r = int(raw)
    if r == INT_NULL:
        return NULL
    if pt in (PropType.STRING, PropType.FIXED_STRING):
        s = pool.decode(r)
        return NULL if s is None else s
    if pt == PropType.BOOL:
        return bool(r)
    if pt == PropType.DATE:
        d = _dt.date(1970, 1, 1) + _dt.timedelta(days=r)
        return Date(d.year, d.month, d.day)
    if pt == PropType.DATETIME:
        ts, us = divmod(r, 1_000_000)
        d = _dt.datetime.fromtimestamp(ts, _dt.timezone.utc)
        return DateTime(d.year, d.month, d.day, d.hour, d.minute, d.second, us)
    if pt == PropType.TIME:
        us = r % 1_000_000
        sec = r // 1_000_000
        return Time(sec // 3600, (sec // 60) % 60, sec % 60, us)
    if pt == PropType.GEOGRAPHY:
        from ..core.geo import from_wkt
        s = pool.decode(r)
        return NULL if s is None else from_wkt(s)
    return r


@dataclass
class CsrBlock:
    """One (edge-type, direction) adjacency across ALL parts, padded.

    indptr : (P, Vmax+H+1) int32 — per part, CSR row pointers over local
             idx, then H hub rows in a degree-split snapshot
    nbr    : (P, Emax) int32   — dense id of neighbor (dst for out, src for in)
    rank   : (P, Emax) int32
    props  : name → (P, Emax) int64/float64 — edge property columns
    """
    etype: str
    direction: str               # "out" | "in"
    indptr: np.ndarray
    nbr: np.ndarray
    rank: np.ndarray
    props: Dict[str, np.ndarray] = field(default_factory=dict)
    prop_types: Dict[str, PropType] = field(default_factory=dict)

    @property
    def num_parts(self) -> int:
        return self.indptr.shape[0]

    def edges_of_part(self, p: int) -> int:
        return int(self.indptr[p, -1])

    def total_edges(self) -> int:
        return int(self.indptr[:, -1].sum())


@dataclass
class TagTable:
    """Vertex property columns for one tag, aligned to local idx per part.

    present: (P, Vmax) bool; props: name → (P, Vmax).
    """
    tag: str
    present: np.ndarray
    props: Dict[str, np.ndarray] = field(default_factory=dict)
    prop_types: Dict[str, PropType] = field(default_factory=dict)


@dataclass
class CsrSnapshot:
    """Epoch-tagged, device-shippable snapshot of one space."""
    space: str
    epoch: int
    num_parts: int
    vmax: int                               # padded local-vertex count
    num_vertices: np.ndarray                # (P,) actual local counts
    blocks: Dict[Tuple[str, str], CsrBlock] = field(default_factory=dict)
    tags: Dict[str, TagTable] = field(default_factory=dict)
    pool: StringPool = field(default_factory=StringPool)
    dense_to_vid: List[Any] = field(default_factory=list)
    # dense ids of degree-split supernodes (None = unsplit): each block
    # then carries H hub rows after the vmax local rows (`degree_split`)
    hub_dense: Optional[np.ndarray] = None

    def block(self, etype: str, direction: str = "out") -> CsrBlock:
        return self.blocks[(etype, direction)]

    def owner(self, dense: int) -> int:
        return dense % self.num_parts

    def local(self, dense: int) -> int:
        return dense // self.num_parts

    def dense(self, local: int, part: int) -> int:
        return local * self.num_parts + part

    def hbm_bytes(self) -> int:
        total = self.num_vertices.nbytes
        for b in self.blocks.values():
            total += b.indptr.nbytes + b.nbr.nbytes + b.rank.nbytes
            total += sum(a.nbytes for a in b.props.values())
        for t in self.tags.values():
            total += t.present.nbytes + sum(a.nbytes for a in t.props.values())
        return total


def degree_split(snap: CsrSnapshot, threshold: int,
                 max_hubs: int = 1024) -> CsrSnapshot:
    """Split supernode adjacency across parts (the reference's
    `graphstore/csr.py:degree_split`, :490).

    A vertex whose degree exceeds `threshold` in ANY block becomes a
    hub (at most `max_hubs`, the highest degrees, kept in ascending id
    order): each block's edge arrays are rebuilt so the hub's adjacency
    is divided into P contiguous chunks, chunk k living in part k as one
    of H extra hub rows appended after the vmax local rows (the hub's
    own local row becomes empty).  Every part then expands ~1/P of a
    hub's edges per hop instead of the owner expanding all of them.

    A pure layout change: same edges, same properties, host mirror
    identical to the device copy, so eidx decode is unchanged.  Returns
    a NEW snapshot with hub_dense set (the input itself when no vertex
    exceeds the threshold); vertex ownership is untouched."""
    P, vmax = snap.num_parts, snap.vmax
    # deg[local*P + p] == deg.reshape(vmax, P)[local, p]
    deg2d = np.zeros((vmax, P), np.int64)
    for b in snap.blocks.values():
        lens = b.indptr[:, 1:] - b.indptr[:, :-1]        # (P, vmax)
        np.maximum(deg2d, lens.T, out=deg2d)
    deg = deg2d.reshape(-1)
    hubs = np.nonzero(deg > threshold)[0]
    if hubs.size == 0:
        return snap
    if hubs.size > max_hubs:
        hubs = hubs[np.argsort(deg[hubs])[::-1][:max_hubs]]
    hubs = np.sort(hubs).astype(np.int64)
    H = int(hubs.size)
    ho, hl = (hubs % P).astype(np.int64), (hubs // P).astype(np.int64)

    def split_block(b: CsrBlock) -> CsrBlock:
        lens = b.indptr[:, 1:] - b.indptr[:, :-1]
        # per-hub chunk bounds into the OWNER part's edge range
        bounds = []
        for i in range(H):
            s = int(b.indptr[ho[i], hl[i]])
            e = int(b.indptr[ho[i], hl[i] + 1])
            bounds.append(s + (e - s) * np.arange(P + 1) // P)
        new_lens, new_cols = [], {"nbr": [], "rank": []}
        for n in b.props:
            new_cols[("prop", n)] = []
        for p in range(P):
            ep = int(b.indptr[p, -1])
            keep = np.ones(ep, bool)
            base = lens[p].astype(np.int64).copy()
            for i in range(H):
                if ho[i] == p:
                    keep[int(b.indptr[p, hl[i]]):
                         int(b.indptr[p, hl[i] + 1])] = False
                    base[hl[i]] = 0
            hub_lens = np.asarray(
                [bounds[i][p + 1] - bounds[i][p] for i in range(H)],
                np.int64)
            new_lens.append(np.concatenate([base, hub_lens]))

            def build(src_arr, out_key):
                parts = [src_arr[p, :ep][keep]]
                for i in range(H):
                    parts.append(src_arr[ho[i],
                                         bounds[i][p]:bounds[i][p + 1]])
                new_cols[out_key].append(np.concatenate(parts))
            build(b.nbr, "nbr")
            build(b.rank, "rank")
            for n in b.props:
                build(b.props[n], ("prop", n))
        emax = max(int(x.size) for x in new_cols["nbr"])

        def pad(rows, fill=0):
            out = np.full((P, emax), fill, rows[0].dtype)
            for p, r in enumerate(rows):
                out[p, :r.size] = r
            return out
        indptr = np.zeros((P, vmax + H + 1), b.indptr.dtype)
        for p in range(P):
            indptr[p, 1:] = np.cumsum(new_lens[p])
        return CsrBlock(etype=b.etype, direction=b.direction,
                        indptr=indptr, nbr=pad(new_cols["nbr"]),
                        rank=pad(new_cols["rank"]),
                        props={n: pad(new_cols[("prop", n)])
                               for n in b.props},
                        prop_types=dict(b.prop_types))

    return CsrSnapshot(space=snap.space, epoch=snap.epoch, num_parts=P,
                       vmax=vmax, num_vertices=snap.num_vertices,
                       blocks={k: split_block(b)
                               for k, b in snap.blocks.items()},
                       tags=snap.tags, pool=snap.pool,
                       dense_to_vid=snap.dense_to_vid, hub_dense=hubs)


def _col_dtype(pt: PropType):
    return np.float64 if pt in (PropType.FLOAT, PropType.DOUBLE) else np.int64


def encode_prop(pt: PropType, v: Any, pool: StringPool) -> Any:
    if is_null(v):
        return np.nan if pt in (PropType.FLOAT, PropType.DOUBLE) else INT_NULL
    if pt in (PropType.STRING, PropType.FIXED_STRING):
        return pool.encode(v)
    if pt == PropType.GEOGRAPHY:
        return pool.encode(v.wkt())     # dictionary-encoded WKT
    if pt == PropType.BOOL:
        return int(v)
    if pt == PropType.DATE:
        return v.days_since_epoch()
    if pt == PropType.DATETIME:
        # epoch-microseconds computed from calendar fields: lossless AND
        # monotonic across the epoch (to_timestamp() truncates toward zero,
        # which mis-encodes pre-1970 values)
        import datetime as _dt
        delta = (_dt.datetime(v.year, v.month, v.day, v.hour, v.minute,
                              v.sec, v.microsec, tzinfo=_dt.timezone.utc)
                 - _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc))
        return ((delta.days * 86400 + delta.seconds) * 1_000_000
                + delta.microseconds)
    if pt == PropType.TIME:
        return ((v.hour * 60 + v.minute) * 60 + v.sec) * 1_000_000 + v.microsec
    if pt in (PropType.FLOAT, PropType.DOUBLE):
        return float(v)
    return int(v)


def _encode_default(pd, pool: StringPool):
    """Encoded, coerced schema default for pre-ALTER rows (fill_row
    parity), or None when there is no usable default — shared by the
    edge-block and tag-table builders."""
    if not pd.has_default:
        return None
    try:
        from .schema import coerce
        return encode_prop(pd.ptype, coerce(pd.ptype, pd.default), pool)
    except Exception:  # noqa: BLE001 — malformed default → NULL, same
        return None    # degradation as host fill_row


def snapshot_from_fields(fields: Dict[str, Any]) -> CsrSnapshot:
    """Build a CsrSnapshot from plain numpy arrays and lists.

    fields: space, epoch, num_parts, vmax, num_vertices, dense_to_vid,
    pool (the pool's strings in code order), hub_dense (None or an
    array of H hub ids; each indptr then has vmax + H + 1 columns),
    blocks: {(etype, direction): {indptr, nbr, rank, props: {name:
    array}, prop_types: {name: PropType name}}}, and optionally tags:
    {name: {present, props: {name: array}, prop_types: {name: PropType
    name}}}, each array (P, vmax).

    Shapes and dtypes are checked here: the arrays are the state every
    kernel reads, so a malformed field must fail at the boundary, not as
    an out-of-range read on the device."""
    P, vmax = int(fields["num_parts"]), int(fields["vmax"])
    snap = CsrSnapshot(
        space=str(fields["space"]), epoch=int(fields.get("epoch", 0)),
        num_parts=P, vmax=vmax,
        num_vertices=np.asarray(fields["num_vertices"], np.int32),
        pool=StringPool(list(fields["pool"])),
        dense_to_vid=list(fields["dense_to_vid"]),
        hub_dense=(None if fields.get("hub_dense") is None
                   else np.asarray(fields["hub_dense"], np.int64)))
    if snap.num_vertices.shape != (P,):
        raise ValueError(f"num_vertices must be ({P},)")
    H = 0
    if snap.hub_dense is not None:
        H = int(snap.hub_dense.size)
        if snap.hub_dense.shape != (H,) or (snap.hub_dense < 0).any() \
                or (snap.hub_dense >= P * vmax).any():
            raise ValueError("hub_dense must be dense ids in [0, P*vmax)")
    for (et, dirn), b in fields["blocks"].items():
        indptr = np.ascontiguousarray(b["indptr"], np.int32)
        nbr = np.ascontiguousarray(b["nbr"], np.int32)
        rank = np.ascontiguousarray(b["rank"], np.int32)
        if indptr.shape != (P, vmax + H + 1):
            raise ValueError(f"{et}/{dirn}: indptr must be "
                             f"({P}, {vmax + H + 1})")
        emax = nbr.shape[1] if nbr.ndim == 2 else -1
        if nbr.shape != (P, emax) or rank.shape != (P, emax):
            raise ValueError(f"{et}/{dirn}: nbr and rank must be (P, Emax)")
        if (np.diff(indptr, axis=1) < 0).any() or indptr[:, 0].any() \
                or (indptr[:, -1] > emax).any():
            raise ValueError(f"{et}/{dirn}: indptr is not a CSR row "
                             f"pointer into Emax={emax}")
        types = {n: PropType[t] for n, t in b["prop_types"].items()}
        props = {}
        for n, a in b["props"].items():
            props[n] = np.ascontiguousarray(a, _col_dtype(types[n]))
            if props[n].shape != (P, emax):
                raise ValueError(f"{et}/{dirn}: prop {n} must be (P, Emax)")
        snap.blocks[(et, dirn)] = CsrBlock(
            etype=et, direction=dirn, indptr=indptr, nbr=nbr, rank=rank,
            props=props, prop_types=types)
    for tg, t in (fields.get("tags") or {}).items():
        present = np.ascontiguousarray(t["present"], bool)
        if present.shape != (P, vmax):
            raise ValueError(f"tag {tg}: present must be ({P}, {vmax})")
        types = {n: PropType[ty] for n, ty in t["prop_types"].items()}
        props = {}
        for n, a in t["props"].items():
            props[n] = np.ascontiguousarray(a, _col_dtype(types[n]))
            if props[n].shape != (P, vmax):
                raise ValueError(f"tag {tg}: prop {n} must be ({P}, {vmax})")
        snap.tags[tg] = TagTable(tag=tg, present=present, props=props,
                                 prop_types=types)
    return snap


# --------------------------------------------------------------------------
# Export from a live store (the reference's csr.py:296-490)
# --------------------------------------------------------------------------


def build_coo_csr(src_dense: np.ndarray, dst_dense: np.ndarray,
                  rank: np.ndarray, dst_key: np.ndarray, P: int,
                  vmax: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray, int]:
    """COO edge arrays → (indptr (P, vmax+1) i32, nbr (P, emax) i32, rank
    (P, emax) i32, perm (P, emax) i64, emax).  perm[p, slot] is the COO
    index whose edge landed in that slot (for property-column gathers);
    -1 pad.

    The reference's `native/kernels.py:build_coo_csr` with its numpy twin
    `_numpy_coo_csr` (:57) as the only path, vectorized: the slot order
    is the same, part, local, rank, dst_key, COO index."""
    n = int(src_dense.shape[0])
    if n == 0:
        return (np.zeros((P, vmax + 1), np.int32),
                np.full((P, 1), -1, np.int32),
                np.zeros((P, 1), np.int32),
                np.full((P, 1), -1, np.int64), 1)
    src_dense = np.ascontiguousarray(src_dense, np.int64)
    dst_dense = np.ascontiguousarray(dst_dense, np.int64)
    rank = np.ascontiguousarray(rank, np.int64)
    dst_key = np.ascontiguousarray(dst_key, np.int64)
    part = src_dense % P
    local = src_dense // P
    counts = np.bincount(part, minlength=P)
    emax = max(1, int(counts.max()))
    order = np.lexsort((np.arange(n), dst_key, rank, local, part))
    sp = part[order]
    # the k-th edge of the sorted order sits at slot k - (edges of the
    # parts before its own)
    slot = np.arange(n) - (np.cumsum(counts) - counts)[sp]
    nbr = np.full((P, emax), -1, np.int32)
    rk = np.zeros((P, emax), np.int32)
    perm = np.full((P, emax), -1, np.int64)
    perm[sp, slot] = order
    nbr[sp, slot] = dst_dense[order]
    rk[sp, slot] = rank[order]
    rows = np.bincount(sp * (vmax + 1) + local[order] + 1,
                       minlength=P * (vmax + 1)).reshape(P, vmax + 1)
    indptr = np.cumsum(rows, axis=1).astype(np.int32)
    return indptr, nbr, rk, perm, emax


def dst_sort_key(dst_vids) -> np.ndarray:
    """int64 ordering key per neighbor: the vid itself for ints, the
    sorted-unique ordinal for strings (matches store._nbr_key)."""
    if not dst_vids:
        return np.zeros(0, np.int64)
    if isinstance(dst_vids[0], int):
        return np.asarray(dst_vids, np.int64)
    arr = np.asarray([str(v) for v in dst_vids], dtype=object)
    _, inv = np.unique(arr, return_inverse=True)
    return inv.astype(np.int64)


def build_snapshot(store, space: str,
                   edge_types: Optional[List[str]] = None,
                   tags: Optional[List[str]] = None,
                   directions: Tuple[str, ...] = ("out", "in"),
                   edge_props: Optional[Dict[str, List[str]]] = None,
                   tag_props: Optional[Dict[str, List[str]]] = None,
                   vmax_extra: int = 0) -> CsrSnapshot:
    """Export a space of a `graphstore.store.GraphStore` into a
    CsrSnapshot (numpy; the device put is gpu/'s).

    edge_props / tag_props restrict which property columns are exported
    (None = all): the device-memory budget knob.  vmax_extra reserves
    extra padded local rows: the delta plane places freshly inserted
    vertices into the slack instead of forcing a full re-pin.
    """
    sd = store.space(space)
    with sd.lock:
        P = sd.num_parts
        vmax = max(sd.part_counts) if sd.part_counts else 0
        vmax = max(vmax, 1) + max(int(vmax_extra), 0)
        snap = CsrSnapshot(space=space, epoch=sd.epoch, num_parts=P, vmax=vmax,
                           num_vertices=np.asarray(sd.part_counts, np.int32),
                           dense_to_vid=list(sd.dense_to_vid))
        etypes = edge_types
        if etypes is None:
            etypes = sorted(e.name for e in store.catalog.edges(space))
        tag_names = tags
        if tag_names is None:
            tag_names = sorted(t.name for t in store.catalog.tags(space))

        for et in etypes:
            sv = store.catalog.get_edge(space, et).latest
            want = None if edge_props is None else edge_props.get(et, [])
            for direction in directions:
                snap.blocks[(et, direction)] = _build_block(
                    sd, et, direction, sv, snap.pool, vmax, want)

        for tg in tag_names:
            sv = store.catalog.get_tag(space, tg).latest
            want = None if tag_props is None else tag_props.get(tg, [])
            snap.tags[tg] = _build_tag_table(sd, tg, sv, snap.pool, vmax, want)
        return snap


def _build_block(sd, etype: str, direction: str, sv, pool: StringPool,
                 vmax: int, want_props: Optional[List[str]]) -> CsrBlock:
    """COO collection (one pass over the plane dicts) + the COO→padded-CSR
    step (`build_coo_csr`) — sort order (local, rank, dst per
    store._nbr_key) matches get_neighbors."""
    import time as _time

    from .store import ttl_expired
    P = sd.num_parts
    plane_attr = "out_edges" if direction == "out" else "in_edges"
    prop_defs = [p for p in sv.props
                 if want_props is None or p.name in want_props]
    now = _time.time()
    has_ttl = bool(sv.ttl_col) and sv.ttl_duration > 0
    src_dense: List[int] = []
    dst_dense: List[int] = []
    ranks: List[int] = []
    dst_vids: List[Any] = []
    rows: List[Dict[str, Any]] = []
    for p in range(P):
        plane = getattr(sd.parts[p], plane_attr)
        for vid, per in plane.items():
            em = per.get(etype)
            if not em:
                continue
            sdense = sd.vid_to_dense[vid]
            for (rk, other), row in em.items():
                if has_ttl and ttl_expired(sv, row, now):
                    continue        # device parity with host read filter
                src_dense.append(sdense)
                dst_dense.append(sd.vid_to_dense.get(other, -1))
                ranks.append(rk)
                dst_vids.append(other)
                rows.append(row)

    indptr, nbr, rank, perm, emax = build_coo_csr(
        np.asarray(src_dense, np.int64), np.asarray(dst_dense, np.int64),
        np.asarray(ranks, np.int64), dst_sort_key(dst_vids), P, vmax)

    props: Dict[str, np.ndarray] = {}
    ptypes: Dict[str, PropType] = {}
    valid = perm >= 0
    safe_perm = np.where(valid, perm, 0)
    for pd in prop_defs:
        dt = _col_dtype(pd.ptype)
        fill = np.nan if dt == np.float64 else INT_NULL
        # rows written before ALTER ... ADD lack the new key: encode the
        # latest schema's default (read-side fill_row parity), coerced
        # like insert-time defaults (a geography default is WKT text)
        a = _encode_default(pd, pool)
        absent = fill if a is None else a
        if rows:
            coo = np.fromiter(
                (absent if (v := row.get(pd.name)) is None
                 else encode_prop(pd.ptype, v, pool) for row in rows),
                dtype=dt, count=len(rows))
            col = np.where(valid, coo[safe_perm], fill).astype(dt)
        else:
            col = np.full((P, emax), fill, dt)
        props[pd.name] = col
        ptypes[pd.name] = pd.ptype

    return CsrBlock(etype=etype, direction=direction,
                    indptr=indptr, nbr=nbr, rank=rank,
                    props=props, prop_types=ptypes)


def _build_tag_table(sd, tag: str, sv, pool: StringPool, vmax: int,
                     want_props: Optional[List[str]]) -> TagTable:
    import time as _time

    from .store import ttl_expired
    P = sd.num_parts
    prop_defs = [p for p in sv.props
                 if want_props is None or p.name in want_props]
    present = np.zeros((P, vmax), bool)
    props: Dict[str, np.ndarray] = {}
    ptypes: Dict[str, PropType] = {}
    absents: Dict[str, Any] = {}
    for pd in prop_defs:
        dt = _col_dtype(pd.ptype)
        fill = np.nan if dt == np.float64 else INT_NULL
        props[pd.name] = np.full((P, vmax), fill, dt)
        ptypes[pd.name] = pd.ptype
        # encoded default for pre-ALTER rows, hoisted out of the row
        # loop (identical for every row); None = leave the NULL fill
        absents[pd.name] = _encode_default(pd, pool)

    now = _time.time()
    for p in range(P):
        part = sd.parts[p]
        for li in range(sd.part_counts[p]):
            vid = sd.dense_to_vid[li * P + p]
            tv = part.vertices.get(vid)
            if not tv or tag not in tv:
                continue
            if ttl_expired(sv, tv[tag][1], now):
                continue
            present[p, li] = True
            _, row = tv[tag]
            for pd in prop_defs:
                v = row.get(pd.name)
                if v is None:
                    a = absents[pd.name]   # pre-ALTER row: serve default
                    if a is not None:
                        props[pd.name][p, li] = a
                    continue
                props[pd.name][p, li] = encode_prop(pd.ptype, v, pool)

    return TagTable(tag=tag, present=present, props=props, prop_types=ptypes)


# --------------------------------------------------------------------------
# Host-side reference ops over a snapshot (oracles for the device kernels)
# --------------------------------------------------------------------------


def neighbors_of(snap: CsrSnapshot, block: CsrBlock,
                 dense_src: int) -> np.ndarray:
    if snap.hub_dense is not None:
        hi_ = np.searchsorted(snap.hub_dense, dense_src)
        if hi_ < len(snap.hub_dense) and snap.hub_dense[hi_] == dense_src:
            # degree-split hub: its owner-local row is empty — the
            # adjacency lives as chunk rows vmax+hi_ across ALL parts
            row = snap.vmax + int(hi_)
            return np.concatenate(
                [block.nbr[p, int(block.indptr[p, row]):
                           int(block.indptr[p, row + 1])]
                 for p in range(snap.num_parts)])
    p = snap.owner(dense_src)
    li = snap.local(dense_src)
    lo, hi = int(block.indptr[p, li]), int(block.indptr[p, li + 1])
    return block.nbr[p, lo:hi]


def expand_frontier_host(snap: CsrSnapshot, block: CsrBlock,
                         frontier: np.ndarray) -> np.ndarray:
    """Reference one-hop expansion: all neighbors of `frontier` (dense ids),
    deduplicated + sorted."""
    outs = [neighbors_of(snap, block, int(d)) for d in frontier]
    if not outs:
        return np.zeros(0, np.int32)
    cat = np.concatenate(outs)
    cat = cat[cat >= 0]
    return np.unique(cat).astype(np.int32)
