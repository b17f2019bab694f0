"""The port's copy of `nebula_tpu/exec/frame.py`, whole.

ColumnarFrame: the device plane's intermediate-result currency.

A multi-clause MATCH pipeline (Traverse → WITH DISTINCT → second MATCH →
OPTIONAL MATCH → aggregate) executed by the row executors materializes a
Python list-of-lists between every pair of plan nodes — per-row Vertex
boxing dominates the tail even when the traversal itself ran on device.
The frame layer keeps those intermediates columnar: dense-id vertex
columns, numpy value columns and canonical-key edge columns, each with
an optional null mask (OPTIONAL MATCH misses), flowing between the
fused pipeline's segment executors (tpu/pipeline.py).  Python rows are
built exactly once, at the result boundary — and vertices/edges only
for the columns the boundary actually carries.

Column kinds:

  VidCol    dense int64 vertex ids (+ null mask).  `checked` records
            whether an AppendVertices/GetVertices existence check ran:
            the boundary materializes a full Vertex for checked columns
            and the same props-less shell Vertex the host plane carries
            for unchecked ones (parity over dangling edges).
  ValCol    plain numpy values (int64/float64/bool/object) + null mask;
            `vkind` tags the element type for the sort/join compilers.
  EdgeCol   canonical physical-edge key columns (et, s, d, rank) — the
            same currency HopFrame/trail_distinct_keep use — plus a
            (HopFrame, fidx) handle so Edge OBJECTS decode lazily at
            the boundary only for emitted rows.
  OpaqueCol a column the frame cannot represent (variable-length edge
            lists).  It occupies its name so plan col-sets stay aligned,
            but any op that READS it refuses to compile.

All nulls compare equal (NullValue semantics: dedup/group-by treat every
null kind as one value), so one bool mask is enough.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core.value import NULL, Vertex, hashable_key


class VidCol:
    kind = "vid"
    __slots__ = ("dense", "null", "checked")

    def __init__(self, dense: np.ndarray, null: Optional[np.ndarray] = None,
                 checked: bool = False):
        self.dense = dense
        self.null = null if null is not None and null.any() else None
        self.checked = checked

    def take(self, idx: np.ndarray) -> "VidCol":
        return VidCol(self.dense[idx],
                      None if self.null is None else self.null[idx],
                      self.checked)

    def null_mask(self, n: int) -> np.ndarray:
        return np.zeros(n, bool) if self.null is None else self.null


class ValCol:
    kind = "val"
    __slots__ = ("vals", "null", "vkind")

    def __init__(self, vals: np.ndarray, null: Optional[np.ndarray],
                 vkind: str):
        self.vals = vals
        self.null = null if null is not None and null.any() else None
        self.vkind = vkind               # int | float | bool | str | obj

    def take(self, idx: np.ndarray) -> "ValCol":
        return ValCol(self.vals[idx],
                      None if self.null is None else self.null[idx],
                      self.vkind)

    def null_mask(self, n: int) -> np.ndarray:
        return np.zeros(n, bool) if self.null is None else self.null


class EdgeCol:
    kind = "edge"
    __slots__ = ("et", "ks", "kd", "rank", "frame", "fidx", "null")

    def __init__(self, et, ks, kd, rank, frame, fidx,
                 null: Optional[np.ndarray] = None):
        self.et, self.ks, self.kd, self.rank = et, ks, kd, rank
        self.frame, self.fidx = frame, fidx
        self.null = null if null is not None and null.any() else None

    @classmethod
    def from_frame(cls, frame, fidx: np.ndarray) -> "EdgeCol":
        return cls(frame.key_et[fidx], frame.key_s[fidx],
                   frame.key_d[fidx], frame.rank[fidx], frame, fidx)

    def take(self, idx: np.ndarray) -> "EdgeCol":
        return EdgeCol(self.et[idx], self.ks[idx], self.kd[idx],
                       self.rank[idx], self.frame, self.fidx[idx],
                       None if self.null is None else self.null[idx])

    def null_mask(self, n: int) -> np.ndarray:
        return np.zeros(n, bool) if self.null is None else self.null


class OpaqueCol:
    """Name-holder for a column with no columnar representation."""
    kind = "opaque"
    __slots__ = ()

    def take(self, idx: np.ndarray) -> "OpaqueCol":
        return self

    def null_mask(self, n: int) -> np.ndarray:
        return np.zeros(n, bool)


class ColumnarFrame:
    """Named columns of equal length; the unit flowing between the fused
    pipeline's segment executors."""
    __slots__ = ("n", "names", "cols")

    def __init__(self, n: int, names: List[str], cols: Dict[str, Any]):
        self.n = n
        self.names = list(names)
        self.cols = cols

    def take(self, idx: np.ndarray) -> "ColumnarFrame":
        return ColumnarFrame(int(idx.size), self.names,
                             {nm: c.take(idx) for nm, c in self.cols.items()})

    def col(self, name: str):
        return self.cols[name]


# ---------------------------------------------------------------------------
# Factorization — shared by dedup / join / group-by / sort.  Codes are
# int64 with -1 for null (all nulls equal, NullValue semantics); equal
# codes ⟺ equal values under hashable_key for the column's kind
# (Vertex eq is by vid ⟺ dense id; Edge eq is the canonical key).
# ---------------------------------------------------------------------------


def _factorize_vals(vals: np.ndarray, ordered: bool) -> np.ndarray:
    """Codes for one value array (no nulls inside).  ordered=True makes
    code order follow value order (sort keys need it; identity keys
    don't care)."""
    if vals.size == 0:
        return np.empty(0, np.int64)
    if vals.dtype != object:
        u, inv = np.unique(vals, return_inverse=True)
        return inv.astype(np.int64)
    try:
        u, inv = np.unique(vals, return_inverse=True)
        return inv.astype(np.int64)
    except TypeError:
        if ordered:
            raise
        # unsortable python objects: dict-factorize on hashable_key
        codes = np.empty(vals.size, np.int64)
        seen: Dict[Any, int] = {}
        for i, v in enumerate(vals.tolist()):
            k = hashable_key(v)
            c = seen.get(k)
            if c is None:
                c = seen[k] = len(seen)
            codes[i] = c
        return codes


def col_codes(col, n: int, ordered: bool = False) -> List[np.ndarray]:
    """Identity codes for one column: a list of int64 arrays whose
    componentwise equality ⟺ row equality for dedup/group/join."""
    if col.kind == "vid":
        d = col.dense
        if col.null is not None:
            d = np.where(col.null, np.int64(-1), d)
        return [d]
    if col.kind == "val":
        codes = np.zeros(n, np.int64)
        if col.null is None:
            codes = _factorize_vals(col.vals, ordered)
        else:
            nn = ~col.null
            codes[nn] = _factorize_vals(col.vals[nn], ordered)
            codes[col.null] = -1
        return [codes]
    if col.kind == "edge":
        nullm = col.null
        def z(a):
            return np.where(nullm, np.int64(0), a) if nullm is not None else a
        et = np.where(nullm, np.int64(-1), col.et) if nullm is not None \
            else col.et
        return [et, z(col.ks), z(col.kd), z(col.rank)]
    raise TypeError(f"no codes for column kind {col.kind}")


def join_codes(lcol, rcol, nl: int, nr: int):
    """Joint identity codes across two frames' key columns (shared code
    space so equal values get equal codes on both sides)."""
    if lcol.kind == "vid" and rcol.kind == "vid":
        return col_codes(lcol, nl), col_codes(rcol, nr)
    if lcol.kind == "val" and rcol.kind == "val":
        both = ValCol(np.concatenate([_obj_ok(lcol.vals), _obj_ok(rcol.vals)]),
                      np.concatenate([lcol.null_mask(nl),
                                      rcol.null_mask(nr)]),
                      lcol.vkind)
        codes = col_codes(both, nl + nr)[0]
        return [codes[:nl]], [codes[nl:]]
    raise TypeError("join keys must be vertex or value columns of one kind")


def _obj_ok(a: np.ndarray) -> np.ndarray:
    return a


def group_ids(code_cols: List[np.ndarray], n: int):
    """(gid, reps): gid[i] = group of row i, groups numbered in FIRST
    OCCURRENCE order (host executors' group/dedup order); reps = first
    row index of each group."""
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    if not code_cols:
        return np.zeros(n, np.int64), np.zeros(1, np.int64)
    order = np.lexsort(code_cols[::-1])
    new = np.zeros(n, bool)
    new[0] = True
    for c in code_cols:
        cs = c[order]
        new[1:] |= cs[1:] != cs[:-1]
    sorted_gid = np.cumsum(new) - 1
    gid_tmp = np.empty(n, np.int64)
    gid_tmp[order] = sorted_gid
    # renumber groups by first-occurrence row index
    ng = int(sorted_gid[-1]) + 1
    first = np.full(ng, n, np.int64)
    np.minimum.at(first, gid_tmp, np.arange(n, dtype=np.int64))
    rank = np.empty(ng, np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(ng, dtype=np.int64)
    gid = rank[gid_tmp]
    reps = np.sort(first)
    return gid, reps


# ---------------------------------------------------------------------------
# Result-boundary materialization (lazy rows: vertices/edges are built
# only for the columns — and rows — the boundary actually carries).
# ---------------------------------------------------------------------------


def materialize_column(col, n: int, qctx, space: str, d2v) -> np.ndarray:
    """One frame column → an object/numeric numpy array of engine
    Values, exactly what the row executors would have produced."""
    if col.kind == "val":
        if col.null is None:
            return col.vals
        out = col.vals.astype(object) if col.vals.dtype != object \
            else col.vals.copy()
        out[col.null] = NULL
        return out
    if col.kind == "vid":
        out = np.empty(n, object)
        nn = ~col.null if col.null is not None else np.ones(n, bool)
        dense = col.dense[nn]
        if dense.size:
            uniq, inv = np.unique(dense, return_inverse=True)
            built = np.empty(uniq.size, object)
            # d2v holds numpy scalars — round-trip through .tolist() so
            # the vids handed to row executors are plain python values
            # (store hashing/typing rejects np.int64)
            vids = np.asarray(d2v)[uniq].tolist()
            for j, vid in enumerate(vids):
                if col.checked:
                    v = qctx.build_vertex(space, vid)
                    built[j] = v if v is not None else Vertex(vid)
                else:
                    # host parity: positions never existence-checked carry
                    # a props-less shell Vertex (prop reads answer NULL)
                    built[j] = Vertex(vid)
            out[nn] = built[inv]
        if col.null is not None:
            out[col.null] = NULL
        return out
    if col.kind == "edge":
        out = np.empty(n, object)
        nn = ~col.null if col.null is not None else np.ones(n, bool)
        fidx = col.fidx[nn]
        if fidx.size:
            out[nn] = col.frame.decode(fidx)
        if col.null is not None:
            out[col.null] = NULL
        return out
    raise TypeError(f"cannot materialize column kind {col.kind}")
