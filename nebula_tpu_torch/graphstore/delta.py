"""Device delta-CSR: host-side dirty-key log + padded delta mirror.

A copy of `nebula_tpu/graphstore/delta.py`, the reference's delta plane:
the pinned base CSR stays immutable while writes land in a bounded,
padded delta buffer — inserts union into every kernel's frontier
expansion, tombstones mask base edges — so an epoch bump costs one small
upload instead of a graph-sized re-pin.

* ``DeltaLog`` — a bounded *dirty-key* log attached to a space.  Write
  paths record WHICH edge/vertex keys changed, never row payloads; the
  apply step re-reads authoritative store state per key, which makes
  application idempotent and order-free.  Structural changes mark the
  log broken.

* ``HostDelta`` — the numpy mirror of the device delta buffers for one
  pinned snapshot: per (block, part) insert rows + tombstoned base edge
  indices, an ``apply()`` that folds dirty keys in by re-reading the
  store, and ``block_arrays`` that emit the padded (P, Dcap)/(P, Tcap)
  arrays the merge kernel (gpu/kernels.py:merge_delta) consumes.  Row
  encoding mirrors the snapshot export (defaults, NULL sentinels, the
  shared string pool) so merged results equal a full rebuild.

The reader `apply` re-reads through is any object with:

  dense_of(vid) -> int or None     the vid's dense id in the snapshot
  edge_row(etype, src, dst, rank) -> (row, schema)
                                   row: {prop: value} or None when the
                                   edge is absent; schema: an object whose
                                   `props` are PropDefs (defaults), or None
  vertex_rows(vid) -> {tag: {prop: value}}
  tag_schema(tag) -> schema or None

Values are the port's (`core.value.NULL` for null).  `LocalStoreReader`
is the reader over the port's `graphstore.store.GraphStore` (what its
`delta_reader` hands out); `bench.datagen.SnapshotStore.delta_reader` is
the bench's reader.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from .csr import (INT_NULL, CsrSnapshot, _col_dtype, _encode_default,
                  encode_prop)

MAXI = np.iinfo(np.int32).max


def pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class DeltaUnsupported(Exception):
    """This change set cannot ride the delta (unknown dense id, broken
    log, hub-split snapshot)."""


class DeltaOverflow(Exception):
    """A (block, part) delta ran past its padded capacity (or a fresh
    vertex past the vmax slack)."""


class DeltaLog:
    """Bounded dirty-key log for one space.

    Keys are ``("e", etype, src_vid, dst_vid, rank)`` and
    ``("v", vid)`` — identity only, no payload.  ``note()`` is called
    by every write path while a device snapshot is watching; the store
    holds its own lock around calls, so the log needs none.
    """

    __slots__ = ("floor_epoch", "keys", "broken", "cap", "part_epochs")

    def __init__(self, floor_epoch: int = 0, cap: int = 65536):
        self.floor_epoch = int(floor_epoch)
        self.cap = int(cap)
        self.keys: Dict[tuple, None] = {}
        self.broken = False
        # cluster feed: highest store epoch seen in a write ack, per
        # part (the group-commit ack path carries it) — the coverage
        # check against live part stats at delta_records time
        self.part_epochs: Dict[int, int] = {}

    def note(self, key: tuple) -> None:
        if self.broken:
            return
        self.keys[key] = None
        if len(self.keys) > self.cap:
            self.broken = True

    def note_break(self) -> None:
        self.broken = True

    def note_epoch(self, pid: int, epoch: int) -> None:
        if epoch > self.part_epochs.get(pid, 0):
            self.part_epochs[pid] = epoch

    def trim(self, keys) -> None:
        """Drop keys a successful delta apply consumed."""
        for k in keys:
            self.keys.pop(k, None)


@dataclass
class DeltaChanges:
    """What one apply() touched — the runtime re-puts exactly this."""
    blocks: Set[Tuple[str, str]] = field(default_factory=set)
    tag_cols: Set[Tuple[str, str]] = field(default_factory=set)
    num_vertices: bool = False
    dense_to_vid: bool = False

    def any(self) -> bool:
        return bool(self.blocks or self.tag_cols or self.num_vertices
                    or self.dense_to_vid)


def _enc_eq(a: Any, b: Any) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (a != a and b != b)       # NaN == NaN here
    return a == b


def _rows_eq(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    if a.keys() != b.keys():
        return False
    return all(_enc_eq(v, b[k]) for k, v in a.items())


class HostDelta:
    """Host mirror of the device delta buffers for one snapshot."""

    def __init__(self, snap: CsrSnapshot, dcap: int, tcap: int = 0):
        self.snap = snap
        self.dcap = pow2(dcap)
        self.tcap = pow2(tcap or dcap)
        P = snap.num_parts
        # (etype, dir) → per-part OrderedDict
        #   (local_src, nbr_dense, rank) → {prop: encoded}
        self.ins: Dict[tuple, List[Dict[tuple, Dict[str, Any]]]] = {
            bk: [dict() for _ in range(P)] for bk in snap.blocks}
        # (etype, dir) → per-part set of tombstoned base edge indices
        self.tomb: Dict[tuple, List[Set[int]]] = {
            bk: [set() for _ in range(P)] for bk in snap.blocks}
        # per (etype,) cached encoded ALTER defaults keyed by prop name
        self._defaults: Dict[tuple, Dict[str, Any]] = {}

    # -- occupancy -------------------------------------------------------

    def edges_per_part(self) -> List[int]:
        P = self.snap.num_parts
        out = [0] * P
        for per in self.ins.values():
            for p in range(P):
                out[p] += len(per[p])
        return out

    def tombs_per_part(self) -> List[int]:
        P = self.snap.num_parts
        out = [0] * P
        for per in self.tomb.values():
            for p in range(P):
                out[p] += len(per[p])
        return out

    def total_edges(self) -> int:
        return sum(self.edges_per_part())

    def total_tombs(self) -> int:
        return sum(self.tombs_per_part())

    def fill_ratio(self) -> float:
        """Worst (block, part) occupancy against the padded caps —
        the compaction watermark input."""
        worst = 0.0
        for bk in self.ins:
            for p in range(self.snap.num_parts):
                worst = max(worst,
                            len(self.ins[bk][p]) / self.dcap,
                            len(self.tomb[bk][p]) / self.tcap)
        return worst

    # -- encoding (parity with csr._build_block) -------------------------

    def _block_defaults(self, bk, sv) -> Dict[str, Any]:
        d = self._defaults.get(bk)
        if d is None:
            d = {}
            if sv is not None:
                for pd in sv.props:
                    d[pd.name] = _encode_default(pd, self.snap.pool)
            self._defaults[bk] = d
        return d

    def _encode_edge_row(self, bk, sv, row: Dict[str, Any]) -> Dict[str, Any]:
        blk = self.snap.blocks[bk]
        defaults = self._block_defaults(bk, sv)
        enc: Dict[str, Any] = {}
        for name, pt in blk.prop_types.items():
            fill = (np.nan if _col_dtype(pt) == np.float64 else INT_NULL)
            v = row.get(name)
            if v is None:
                a = defaults.get(name)
                enc[name] = fill if a is None else a
            else:
                enc[name] = encode_prop(pt, v, self.snap.pool)
        return enc

    def _base_eidx(self, bk, p: int, li: int, nbr_dense: int,
                   rank: int) -> Optional[int]:
        blk = self.snap.blocks[bk]
        if li + 1 >= blk.indptr.shape[1]:
            return None
        lo, hi = int(blk.indptr[p, li]), int(blk.indptr[p, li + 1])
        seg_n = blk.nbr[p, lo:hi]
        seg_r = blk.rank[p, lo:hi]
        w = np.nonzero((seg_n == nbr_dense) & (seg_r == rank))[0]
        return None if w.size == 0 else lo + int(w[0])

    def _base_row_eq(self, bk, p: int, eidx: int,
                     enc: Dict[str, Any]) -> bool:
        blk = self.snap.blocks[bk]
        for name, col in blk.props.items():
            if not _enc_eq(col[p, eidx].item(), enc[name]):
                return False
        return True

    # -- apply -----------------------------------------------------------

    def apply(self, reader, keys, changes: Optional[DeltaChanges] = None
              ) -> DeltaChanges:
        """Fold dirty keys into the mirror by re-reading store state
        through `reader` (edge_row / vertex_rows / dense_of).  Raises
        DeltaOverflow / DeltaUnsupported, after which the mirror may be
        partly applied: the caller drops it."""
        ch = changes or DeltaChanges()
        if self.snap.hub_dense is not None:
            raise DeltaUnsupported("degree-split snapshot")
        for key in keys:
            if key[0] == "e":
                self._apply_edge(reader, key, ch)
            elif key[0] == "v":
                self._apply_vertex(reader, key[1], ch)
            else:
                raise DeltaUnsupported(f"unknown delta key {key[0]!r}")
        P = self.snap.num_parts
        for bk in self.ins:
            for p in range(P):
                if len(self.ins[bk][p]) > self.dcap or \
                        len(self.tomb[bk][p]) > self.tcap:
                    raise DeltaOverflow(f"{bk} part {p}")
        return ch

    def _apply_edge(self, reader, key, ch: DeltaChanges) -> None:
        _, etype, src, dst, rank = key
        row, sv = reader.edge_row(etype, src, dst, rank)
        sd_src = reader.dense_of(src)
        sd_dst = reader.dense_of(dst)
        if sd_src is None or sd_dst is None:
            if row is not None:
                raise DeltaUnsupported(f"no dense id for edge {key[1:]}")
            return                      # gone + never pinned: nothing to do
        P = self.snap.num_parts
        # an insert_edge can mint dense ids for endpoints that have no
        # vertex row (and thus no ("v",...) dirty key) — a rebuild would
        # still map them, so the mirror must too (materialize decodes
        # vids through snap.dense_to_vid)
        if row is not None:
            self._touch_dense(sd_src, src, ch)
            self._touch_dense(sd_dst, dst, ch)
        enc = None if row is None else \
            self._encode_edge_row((etype, "out"), sv, row)
        for (bk, p, li, nbr) in (
                ((etype, "out"), sd_src % P, sd_src // P, sd_dst),
                ((etype, "in"), sd_dst % P, sd_dst // P, sd_src)):
            if bk not in self.snap.blocks:
                continue                # edge type not exported: invisible
            if li >= self.snap.vmax:
                raise DeltaOverflow(f"local row {li} past vmax")
            if self._apply_half(bk, p, li, nbr, rank, enc):
                ch.blocks.add(bk)

    def _apply_half(self, bk, p: int, li: int, nbr: int, rank: int,
                    enc: Optional[Dict[str, Any]]) -> bool:
        ins = self.ins[bk][p]
        tomb = self.tomb[bk][p]
        k = (li, nbr, rank)
        base = self._base_eidx(bk, p, li, nbr, rank)
        changed = False
        if enc is None:                                     # edge absent
            if ins.pop(k, None) is not None:
                changed = True
            if base is not None and base not in tomb:
                tomb.add(base)
                changed = True
            return changed
        if base is not None and self._base_row_eq(bk, p, base, enc):
            # live base content already matches: drop any overrides
            # (covers tombstone-resurrect — delete then identical
            # re-insert unmask the base row instead of duplicating it)
            if ins.pop(k, None) is not None:
                changed = True
            if base in tomb:
                tomb.discard(base)
                changed = True
            return changed
        if base is not None and base not in tomb:
            tomb.add(base)
            changed = True
        cur = ins.get(k)
        if cur is None or not _rows_eq(cur, enc):
            ins[k] = enc
            changed = True
        return changed

    def _touch_dense(self, dense: int, vid, ch: DeltaChanges) -> None:
        """Make sure the snapshot maps `dense` → `vid` and the owning
        part's vertex count covers its local row (a rebuild would)."""
        snap = self.snap
        P = snap.num_parts
        p, li = dense % P, dense // P
        if li >= snap.vmax:
            raise DeltaOverflow(f"vertex local row {li} past vmax")
        changed = False
        if dense >= len(snap.dense_to_vid) or \
                snap.dense_to_vid[dense] is None:
            need = dense + 1 - len(snap.dense_to_vid)
            if need > 0:
                snap.dense_to_vid.extend([None] * need)
            snap.dense_to_vid[dense] = vid
            ch.dense_to_vid = True
            changed = True
        if li + 1 > int(snap.num_vertices[p]):
            snap.num_vertices[p] = li + 1
            ch.num_vertices = True
            changed = True
        if changed:
            self._kill_caches()

    def _kill_caches(self) -> None:
        # position/existence masks and the dense→vid decode array are
        # cached per snapshot object — a vertex change must kill them
        # (gpu/runtime._d2v can go stale WITHOUT a length change when a
        # None slot gains a vid)
        for attr in ("_exists_flat", "_d2v_arr"):
            if hasattr(self.snap, attr):
                try:
                    delattr(self.snap, attr)
                except AttributeError:
                    pass

    def _apply_vertex(self, reader, vid, ch: DeltaChanges) -> None:
        snap = self.snap
        dense = reader.dense_of(vid)
        if dense is None:
            raise DeltaUnsupported(f"no dense id for vertex {vid!r}")
        P = snap.num_parts
        p, li = dense % P, dense // P
        self._touch_dense(dense, vid, ch)
        rows = reader.vertex_rows(vid)
        for tag, tt in snap.tags.items():
            row = rows.get(tag)
            sv = reader.tag_schema(tag)
            if row is None:
                if tt.present[p, li]:
                    tt.present[p, li] = False
                    ch.tag_cols.add((tag, "present"))
                for name, pt in tt.prop_types.items():
                    fill = (np.nan
                            if _col_dtype(pt) == np.float64 else INT_NULL)
                    if not _enc_eq(tt.props[name][p, li].item(), fill):
                        tt.props[name][p, li] = fill
                        ch.tag_cols.add((tag, name))
                continue
            if not tt.present[p, li]:
                tt.present[p, li] = True
                ch.tag_cols.add((tag, "present"))
            defaults = self._block_defaults(("tag", tag), sv)
            for name, pt in tt.prop_types.items():
                fill = (np.nan
                        if _col_dtype(pt) == np.float64 else INT_NULL)
                v = row.get(name)
                if v is None:
                    a = defaults.get(name)
                    env = fill if a is None else a
                else:
                    env = encode_prop(pt, v, snap.pool)
                if not _enc_eq(tt.props[name][p, li].item(), env):
                    tt.props[name][p, li] = env
                    ch.tag_cols.add((tag, name))
        self._kill_caches()

    # -- padded arrays (host copies; the runtime device_puts them) -------

    def block_arrays(self, bk) -> Dict[str, Any]:
        snap = self.snap
        P = snap.num_parts
        blk = snap.blocks[bk]
        d_src = np.zeros((P, self.dcap), np.int32)
        d_dst = np.zeros((P, self.dcap), np.int32)
        d_rank = np.zeros((P, self.dcap), np.int32)
        d_valid = np.zeros((P, self.dcap), bool)
        d_props: Dict[str, np.ndarray] = {}
        for name, pt in blk.prop_types.items():
            dt = _col_dtype(pt)
            fill = np.nan if dt == np.float64 else INT_NULL
            d_props[name] = np.full((P, self.dcap), fill, dt)
        d_tomb = np.full((P, self.tcap), MAXI, np.int32)
        for p in range(P):
            for j, ((li, nbr, rank), enc) in \
                    enumerate(self.ins[bk][p].items()):
                d_src[p, j] = li
                d_dst[p, j] = nbr
                d_rank[p, j] = rank
                d_valid[p, j] = True
                for name in d_props:
                    d_props[name][p, j] = enc[name]
            ts = sorted(self.tomb[bk][p])
            if ts:
                d_tomb[p, :len(ts)] = np.asarray(ts, np.int32)
        return {"d_src": d_src, "d_dst": d_dst, "d_rank": d_rank,
                "d_valid": d_valid, "d_tomb": d_tomb, "d_props": d_props}

    def nbytes(self) -> int:
        total = 0
        for bk in self.snap.blocks:
            blk = self.snap.blocks[bk]
            per_row = 4 * 3 + 1 + sum(
                np.dtype(_col_dtype(pt)).itemsize
                for pt in blk.prop_types.values())
            total += self.snap.num_parts * (
                self.dcap * per_row + self.tcap * 4)
        return total


class LocalStoreReader:
    """Re-read adapter over a single-process GraphStore (under sd.lock
    at the call site: apply runs with the gate's write side held, so
    reads here see a consistent post-commit state)."""

    def __init__(self, store, space: str):
        self.store = store
        self.space = space
        self.sd = store.space(space)
        import time as _t
        self.now = _t.time()

    def dense_of(self, vid) -> Optional[int]:
        d = self.sd.vid_to_dense.get(vid)
        return None if d is None else int(d)

    def edge_row(self, etype, src, dst, rank):
        from .schema import SchemaError
        from .store import ttl_expired
        try:
            sv = self.store.catalog.get_edge(self.space, etype).latest
        except SchemaError:
            return None, None           # dropped edge type: invisible
        row = self.sd.parts[self.sd.part_of(src)].out_edges \
            .get(src, {}).get(etype, {}).get((rank, dst))
        if row is None:
            return None, sv
        if sv.ttl_col and sv.ttl_duration > 0 and \
                ttl_expired(sv, row, self.now):
            return None, sv
        return row, sv

    def vertex_rows(self, vid) -> Dict[str, Dict[str, Any]]:
        from .store import ttl_expired
        tv = self.sd.parts[self.sd.part_of(vid)].vertices.get(vid) or {}
        out = {}
        for tag, (_ver, row) in tv.items():
            sv = self.tag_schema(tag)
            if sv is None:
                continue
            if sv.ttl_col and sv.ttl_duration > 0 and \
                    ttl_expired(sv, row, self.now):
                continue
            out[tag] = row
        return out

    def tag_schema(self, tag):
        from .schema import SchemaError
        try:
            return self.store.catalog.get_tag(self.space, tag).latest
        except SchemaError:
            return None
