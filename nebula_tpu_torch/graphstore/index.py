"""The port's copy of `nebula_tpu/graphstore/index.py`, whole.

Secondary indexes — sorted per-part key lists with prefix/range scan.

Analog of the reference's index kv records + IndexScanNode family
(reference: src/storage/index + index keys in src/codec).  An index over
(f1..fn) keeps, per partition,
a sorted list of (normalized key tuple, entity) where entity is the vid
(tag index) or (src, rank, dst) (edge index).  Scans take an equality
prefix plus an optional range on the next column — exactly the column-
hint shape the reference's optimizer extracts from LOOKUP predicates.

Semantics match the reference: CREATE INDEX starts empty and indexes
only subsequent writes; REBUILD INDEX backfills existing rows.
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..core.value import total_order_key


class _Sentinel:
    """MIN sorts below everything, MAX above (via reflected compares:
    tuple elements fall back to these __gt__/__lt__ when their own
    __lt__ returns NotImplemented)."""

    __slots__ = ("lo",)

    def __init__(self, lo: bool):
        self.lo = lo

    def __lt__(self, o):
        return self.lo

    def __gt__(self, o):
        return not self.lo

    def __repr__(self):
        return "-inf" if self.lo else "+inf"


MIN, MAX = _Sentinel(True), _Sentinel(False)


def norm(v: Any):
    """Index column normalization: total order incl. NULL-last."""
    if isinstance(v, _Sentinel):
        return v
    return total_order_key(v)


class IndexData:
    """One index's entries across the parts of a space.

    Stored items are (key_norm_tuple, entity_norm, entity); list order is
    (key, entity_norm).  Probes are 1-tuples (partial_key,) so tuple
    comparison gives prefix-range semantics directly.
    """

    __slots__ = ("name", "fields", "is_edge", "index_id", "parts", "lock",
                 "field_lens")

    def __init__(self, name: str, fields: List[str], is_edge: bool,
                 num_parts: int, index_id: int = 0,
                 field_lens: Optional[List[int]] = None):
        self.name = name
        self.fields = list(fields)
        self.is_edge = is_edge
        self.index_id = index_id
        self.field_lens = list(field_lens) if field_lens \
            else [0] * len(self.fields)
        self.parts: List[List[Tuple]] = [[] for _ in range(num_parts)]
        from ..utils.racecheck import make_lock
        self.lock = make_lock("index_data")

    def key_of(self, row: Dict[str, Any]) -> Tuple:
        out = []
        for f, ln in zip(self.fields, self.field_lens):
            v = row.get(f)
            if ln and isinstance(v, str):
                # string prefix index (reference: name(10) truncates the
                # key); the LOOKUP planner keeps the full predicate as a
                # residual for truncated indexes, so a shared prefix can
                # never surface a wrong row
                v = v[:ln]
            out.append(norm(v))
        return tuple(out)

    def add(self, part: int, row: Dict[str, Any], entity: Any):
        k = self.key_of(row)
        en = norm(entity)
        with self.lock:
            lst = self.parts[part]
            i = bisect.bisect_left(lst, (k, en))
            if i < len(lst) and lst[i][0] == k and lst[i][1] == en:
                lst[i] = (k, en, entity)   # idempotent overwrite
            else:
                lst.insert(i, (k, en, entity))

    def remove(self, part: int, row: Dict[str, Any], entity: Any):
        k = self.key_of(row)
        en = norm(entity)
        with self.lock:
            lst = self.parts[part]
            i = bisect.bisect_left(lst, (k, en))
            if i < len(lst) and lst[i][0] == k and lst[i][1] == en:
                del lst[i]

    def clear(self):
        with self.lock:
            for lst in self.parts:
                lst.clear()

    def count(self) -> int:
        with self.lock:
            return sum(len(p) for p in self.parts)

    def scan(self, part: int, eq_prefix: List[Any],
             range_hint: Optional[Tuple[Any, Any, bool, bool]] = None
             ) -> List[Any]:
        """Entities with key[:k] == eq_prefix, optionally key[k] in the
        (lo, hi, lo_incl, hi_incl) range.  MIN/MAX mark open ends."""
        pre = tuple(norm(v) for v in eq_prefix)
        if range_hint is None:
            lo_probe = (pre,)
            hi_probe = (pre + (MAX,),)
        else:
            lo, hi, lo_inc, hi_inc = range_hint
            lo_n, hi_n = norm(lo), norm(hi)
            lo_probe = ((pre + (lo_n,)),) if lo_inc \
                else ((pre + (lo_n, MAX)),)
            hi_probe = ((pre + (hi_n, MAX)),) if hi_inc \
                else ((pre + (hi_n,)),)
        with self.lock:
            lst = self.parts[part]
            i = bisect.bisect_left(lst, lo_probe)
            j = bisect.bisect_left(lst, hi_probe)
            return [lst[t][2] for t in range(i, j)]


class GeoIndexData(IndexData):
    """Geo index over ONE geography column (reference: S2-cell-keyed geo
    index records).

    A point is keyed by its level-30 Morton cell token; a LINESTRING /
    POLYGON is keyed by EVERY cell of a capped covering of its bbox
    (one entry per cell, possibly coarse) — single-centroid keying would
    silently drop shapes whose centroid falls outside the query cover.
    scan_geo matches a query range two ways:
    entries whose base token lies inside the range (equal-or-finer
    cells), plus exact probes at each ANCESTOR base of the range's low
    end (coarser covering cells; at most 31 probes).  Both directions
    may over-match (shared base tokens across levels, bbox covers) —
    callers re-check the exact ST_ predicate as a residual, so a false
    positive costs a filter eval, never a wrong row.  NULL /
    non-geography values are keyed by the plain normalized value — they
    sort outside every token probe and are never produced by scan_geo."""

    __slots__ = ()

    def _cells_of(self, row) -> Optional[List[int]]:
        from ..core.geo import Geography, cell_token, covering_cells
        v = row.get(self.fields[0])
        if isinstance(v, str):
            # geography columns accept WKT text on write; index the
            # same shape reads serve
            from ..core.geo import from_wkt
            try:
                v = from_wkt(v)
            except Exception:  # noqa: BLE001 — malformed stays unkeyed
                return None
        if not isinstance(v, Geography):
            return None
        if v.kind == "point":
            return [cell_token(v)]
        return [base for base, _lvl in covering_cells(v, max_cells=16)]

    def key_of(self, row):
        cells = self._cells_of(row)
        if cells is None:
            return (norm(row.get(self.fields[0])),)
        return (norm(cells[0]),)

    def add(self, part: int, row, entity: Any):
        cells = self._cells_of(row)
        if cells is None:
            super().add(part, row, entity)
            return
        en = norm(entity)
        with self.lock:
            lst = self.parts[part]
            for c in cells:
                k = (norm(c),)
                i = bisect.bisect_left(lst, (k, en))
                if i < len(lst) and lst[i][0] == k and lst[i][1] == en:
                    lst[i] = (k, en, entity)
                else:
                    lst.insert(i, (k, en, entity))

    def remove(self, part: int, row, entity: Any):
        cells = self._cells_of(row)
        if cells is None:
            super().remove(part, row, entity)
            return
        en = norm(entity)
        with self.lock:
            lst = self.parts[part]
            for c in cells:
                k = (norm(c),)
                i = bisect.bisect_left(lst, (k, en))
                if i < len(lst) and lst[i][0] == k and lst[i][1] == en:
                    del lst[i]

    def scan_geo(self, part: int, ranges: List[Tuple[int, int]]) -> List[Any]:
        """Entities with an entry cell overlapping any INCLUSIVE
        (lo, hi) token range (covering_ranges output), deduplicated
        (multi-cell shapes would otherwise emit duplicate rows)."""
        out: List[Any] = []
        seen = set()

        def emit(t):
            _k, en, ent = t
            if en not in seen:
                seen.add(en)
                out.append(ent)

        with self.lock:
            lst = self.parts[part]
            for lo, hi in ranges:
                i = bisect.bisect_left(lst, ((norm(lo),),))
                j = bisect.bisect_left(lst, ((norm(hi), MAX),))
                for t in range(i, j):
                    emit(lst[t])
                # coarser covering cells: every ancestor-aligned base of
                # `lo` (zeroing the low 2s bits) may key a cell that
                # contains this range
                for s in range(1, 32):
                    a = lo & ~((1 << (2 * s)) - 1)
                    if a == lo:
                        continue         # already covered by the bisect
                    k = (norm(a),)
                    i = bisect.bisect_left(lst, (k,))
                    while i < len(lst) and lst[i][0] == k:
                        emit(lst[i])
                        i += 1
        return out
