"""The port's copy of `nebula_tpu/graphstore/store.py`, whole.

Partitioned host graph store — the storaged data plane, in-process form.

Redesign of the reference's storage stack (NebulaStore/RocksEngine +
query/mutate processors; reference: src/kvstore + src/storage) for the
TPU-first architecture:

  * The graph is hash-partitioned by VID into ``partition_num`` parts
    (reference: part map in metad + NebulaKeyUtils key prefixes).
  * Each part keeps vertices and both edge directions in host dicts — the
    mutable, source-of-truth plane (the RocksDB analog; pluggable to a
    persistent KV in cluster mode).
  * Every vid gets a *dense id* encoding its partition: the i-th vid of
    part p gets ``dense = i * P + p`` so ``owner(dense) == dense % P`` is a
    single cheap op on device — this replaces the reference's
    hash-route-to-leader logic with arithmetic the TPU can do inline.
  * Mutations bump an epoch; device CSR snapshots are epoch-tagged derived
    data (see csr.py) — the serving copy the hot path reads.

Edge identity follows the reference: (src, edge_type, rank, dst); an edge is
written to the src part (out-direction) and dst part (in-direction), the
TOSS chain-write analog (single-process: both writes in one call).
"""
from __future__ import annotations

import hashlib
import itertools
import threading
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..core.value import NULL, is_null
from .schema import (Catalog, EdgeSchema, PropDef, SchemaError, SpaceDesc,
                     TagSchema, apply_defaults, fill_row)


def ttl_expired(sv, row: Dict[str, Any], now: float) -> bool:
    """TTL check (the reference's compaction-filter + read-filter
    semantics): a row whose ttl_col value + ttl_duration is in the past
    is invisible; missing/null ttl values never expire."""
    if not sv.ttl_col or sv.ttl_duration <= 0:
        return False
    v = row.get(sv.ttl_col)
    if v is None or is_null(v) or not isinstance(v, (int, float)):
        return False
    return v + sv.ttl_duration < now


def stable_vid_hash(vid: Any) -> int:
    """Process-independent hash used for partitioning (NOT Python hash())."""
    if isinstance(vid, int):
        return vid & 0x7FFFFFFFFFFFFFFF
    if isinstance(vid, str):
        return int.from_bytes(hashlib.md5(vid.encode()).digest()[:8], "little") & 0x7FFFFFFFFFFFFFFF
    raise TypeError(f"unsupported vid type {type(vid).__name__}")


#: per-part exactly-once dedup window size: (writer, seq)
#: records evicted in insertion order — DETERMINISTIC, because eviction
#: happens inside raft apply, so every replica evicts identically
DEDUP_WINDOW = 1024


class Partition:
    """One shard: vertices + out/in adjacency, dict-backed."""

    __slots__ = ("part_id", "vertices", "out_edges", "in_edges",
                 "pending_chains", "applied_writes")

    def __init__(self, part_id: int):
        self.part_id = part_id
        # vid → {tag_name: (schema_version, {prop: value})}
        self.vertices: Dict[Any, Dict[str, Tuple[int, Dict[str, Any]]]] = {}
        # src_vid → {etype_name: {(rank, dst): {prop: value}}}
        self.out_edges: Dict[Any, Dict[str, Dict[Tuple[int, Any], Dict[str, Any]]]] = {}
        # dst_vid → {etype_name: {(rank, src): {prop: value}}}
        self.in_edges: Dict[Any, Dict[str, Dict[Tuple[int, Any], Dict[str, Any]]]] = {}
        # TOSS resume journal: chain_id → {"cmd": [in-half cmd], "ts": t}
        # (the out-half part remembers the in-half it owes the dst part
        # until the chain is confirmed — SURVEY §2 row 14)
        self.pending_chains: Dict[str, Dict[str, Any]] = {}
        # exactly-once dedup window: (writer_id, seq) →
        # {"n": cmd count, "err": first apply error or None}.  Written
        # ONLY inside raft apply (dbatch), so it is replicated state —
        # a re-proposed request is recognized on every replica and on
        # any post-failover leader.  Part of the part-state snapshot.
        self.applied_writes: "OrderedDict[Tuple[str, int], Dict[str, Any]]" \
            = OrderedDict()

    def edge_count(self) -> int:
        return sum(len(m) for per in self.out_edges.values() for m in per.values())


class SpaceData:
    """All partitions + vid dictionary of one space."""

    _uid_counter = itertools.count(1)

    def __init__(self, desc: SpaceDesc):
        self.desc = desc
        self.parts = [Partition(p) for p in range(desc.partition_num)]
        self.vid_to_dense: Dict[Any, int] = {}
        self.dense_to_vid: List[Any] = []
        self.part_counts = [0] * desc.partition_num
        self.epoch = 0
        # process-unique id: distinguishes same-named spaces of DIFFERENT
        # stores (or a dropped+recreated space) in the TpuRuntime's
        # per-space snapshot cache, where (name, epoch) alone can collide
        self.uid = next(SpaceData._uid_counter)
        from ..utils.racecheck import make_lock
        self.lock = make_lock("space_data")
        self.index_data: Dict[str, Any] = {}   # index name → IndexData
        self.ft_data: Dict[str, Any] = {}      # name → FulltextIndexData

    @property
    def num_parts(self) -> int:
        return self.desc.partition_num

    def part_of(self, vid: Any) -> int:
        return stable_vid_hash(vid) % self.num_parts

    def part_for(self, vid: Any) -> "Partition":
        """Coherent lock-free part lookup: ONE read of the parts list,
        modulus from that snapshot's own length — a racing REPARTITION
        swap yields a stale-but-coherent partition (transient miss),
        never an IndexError.  Write paths under sd.lock (which the swap
        also holds) keep using part_of()."""
        parts = self.parts
        return parts[stable_vid_hash(vid) % len(parts)]

    def dense_id(self, vid: Any, create: bool = False) -> int:
        d = self.vid_to_dense.get(vid)
        if d is not None:
            return d
        if not create:
            return -1
        p = self.part_of(vid)
        d = self.part_counts[p] * self.num_parts + p
        self.part_counts[p] += 1
        self.vid_to_dense[vid] = d
        # dense ids are not contiguous globally; keep a map-backed list
        need = d + 1 - len(self.dense_to_vid)
        if need > 0:
            self.dense_to_vid.extend([None] * need)
        self.dense_to_vid[d] = vid
        return d

    def vid_of_dense(self, dense: int) -> Any:
        if 0 <= dense < len(self.dense_to_vid):
            return self.dense_to_vid[dense]
        return None

    def install_dense(self, mapping: Dict[Any, int]):
        """Merge a part's dense-id slice (part-state install / CSR
        export assembly — one merge loop for every consumer)."""
        for v, d in mapping.items():
            self.vid_to_dense[v] = d
            need = d + 1 - len(self.dense_to_vid)
            if need > 0:
                self.dense_to_vid.extend([None] * need)
            self.dense_to_vid[d] = v


def _dnote(sd: "SpaceData", key: tuple) -> None:
    """Record a dirty key on the space's device delta log, when one is
    watching.  Keys carry identity only — the apply step
    re-reads authoritative rows — so every write path's hook is one
    line beside its epoch bump, under the same sd.lock."""
    log = getattr(sd, "delta_log", None)
    if log is not None:
        log.note(key)


def _dbreak(sd: "SpaceData") -> None:
    """Mark the delta log broken: dense-id layout changed (REPARTITION,
    part install/clear) — the next device pin must full-rebuild."""
    log = getattr(sd, "delta_log", None)
    if log is not None:
        log.note_break()


class StoreError(Exception):
    pass


class GraphStore:
    """The single-process storage service: catalog + all spaces' data.

    Mirrors the operation set of storage.thrift (getNeighbors, getProps,
    scanVertex/scanEdge, addVertices/addEdges, delete/update) — SURVEY §2
    row 12/13 — as Python methods; the cluster storaged wraps this per-host.
    """

    def __init__(self, catalog: Optional[Catalog] = None,
                 data_dir: Optional[str] = None):
        self.catalog = catalog or Catalog()
        self.data: Dict[int, SpaceData] = {}
        self._engine = None
        self._ft_listener = None     # started on first fulltext index
        self._ft_reg_lock = threading.Lock()
        # (space_id, schema, is_edge) → (catalog_version, descs)
        self._ft_memo: Dict[Tuple[int, str, bool], Tuple[int, list]] = {}
        if data_dir is not None:
            # durable standalone engine (SURVEY §2 row 10): recover from
            # checkpoint + journal, then resume journaling every mutation
            from .engine import DurableEngine, JournalingCatalog
            eng = DurableEngine(data_dir)
            eng.recover_into(self)
            self._engine = eng
            self.catalog = JournalingCatalog(self.catalog, eng)

    def _log(self, *cmd):
        if self._engine is not None:
            self._engine.log(cmd)

    def compact_journal(self) -> int:
        """Checkpoint + journal truncation (SUBMIT JOB COMPACT's
        durability leg); no-op without an engine."""
        if self._engine is None:
            return 0
        # checkpoint() reads through the JournalingCatalog proxy — hand
        # it the raw catalog object for serialization
        return self._engine.compact(self)

    def close(self):
        if self._engine is not None:
            self._engine.close()
        if self._ft_listener is not None:
            self._ft_listener.stop()
            self._ft_listener = None

    @property
    def ft_listener(self):
        """The full-text replication sink (SURVEY §2 row 10 Listener),
        started lazily — stores with no fulltext index never pay for the
        thread."""
        if self._ft_listener is None:
            from .fulltext import FulltextListener
            self._ft_listener = FulltextListener()
        return self._ft_listener

    # ---- space lifecycle ----
    def create_space(self, name: str, **kw) -> SpaceDesc:
        sp = self.catalog.create_space(name, **kw)
        if sp.space_id not in self.data:
            self.data[sp.space_id] = SpaceData(sp)
        self._log("create_space", name, kw)
        return sp

    def drop_space(self, name: str, if_exists=False):
        sp = self.catalog.drop_space(name, if_exists=if_exists)
        if sp is not None:
            self.data.pop(sp.space_id, None)
        self._log("drop_space", name)

    def repartition(self, name: str, new_parts: int, cancel=None) -> int:
        """SUBMIT JOB REPARTITION <n>: rebuild the space's hash
        partitioning in place — the part split/merge analog for a
        hash-partitioned store (SURVEY §2 row 16: the reference's
        AdminTaskManager task family).  Every vertex row (raw
        version+row, so read-side schema upgrade semantics survive) and
        both edge planes re-home to vid_hash % new_parts; dense ids,
        secondary indexes and fulltext indexes are rebuilt; the epoch
        bump re-pins any device snapshot.

        Stop-the-world under the space lock (an admin job, like the
        reference's blocking leader tasks); `cancel` (threading.Event)
        is checked between source partitions and aborts BEFORE the
        swap — a cancelled repartition leaves the space untouched.
        Returns the number of vertices moved."""
        sd = self.space(name)
        with sd.lock:
            desc = sd.desc
            if new_parts == desc.partition_num:
                return 0
            if new_parts < 1:
                raise StoreError(f"bad partition count {new_parts}")
            if any(p.pending_chains for p in sd.parts):
                raise StoreError(
                    "repartition with pending TOSS chains; retry after "
                    "chain resume settles")
            old_parts = sd.parts
            # phase 1: build the new layout fully off to the side
            P2 = new_parts
            parts2 = [Partition(p) for p in range(P2)]
            counts2 = [0] * P2
            v2d: Dict[Any, int] = {}
            d2v: List[Any] = []

            def dense2(vid):
                d = v2d.get(vid)
                if d is None:
                    p = stable_vid_hash(vid) % P2
                    d = counts2[p] * P2 + p
                    counts2[p] += 1
                    v2d[vid] = d
                    need = d + 1 - len(d2v)
                    if need > 0:
                        d2v.extend([None] * need)
                    d2v[d] = vid
                return d

            moved = 0
            for p in old_parts:
                if cancel is not None and cancel.is_set():
                    return -1            # aborted; nothing swapped
                for vid, tv in p.vertices.items():
                    dense2(vid)
                    parts2[stable_vid_hash(vid) % P2].vertices[vid] = \
                        {t: (ver, dict(row)) for t, (ver, row) in tv.items()}
                    moved += 1
                for src, per in p.out_edges.items():
                    dense2(src)
                    tgt = parts2[stable_vid_hash(src) % P2].out_edges
                    tgt[src] = {et: dict(em) for et, em in per.items()}
                for dst, per in p.in_edges.items():
                    dense2(dst)
                    tgt = parts2[stable_vid_hash(dst) % P2].in_edges
                    tgt[dst] = {et: dict(em) for et, em in per.items()}
            # phase 2: the swap.  Writers are excluded by sd.lock, but
            # READ paths are lock-free — order the assignments so a
            # racing reader can transiently MISS but never index past a
            # list's end: growing, install the bigger parts list before
            # the partition count that routes into its tail; shrinking,
            # shrink the count first.
            if P2 >= desc.partition_num:
                sd.parts = parts2
                sd.part_counts = counts2
                sd.vid_to_dense = v2d
                sd.dense_to_vid = d2v
                desc.partition_num = P2
            else:
                desc.partition_num = P2
                sd.parts = parts2
                sd.part_counts = counts2
                sd.vid_to_dense = v2d
                sd.dense_to_vid = d2v
            sd.index_data = {}
            sd.ft_data = {}
            sd.epoch += 1
            _dbreak(sd)
        # derived state: rebuild every index against the new layout
        for d in self.catalog.indexes(name):
            self.rebuild_index(name, d.name)
        for d in self.catalog.fulltext_indexes(name):
            self.rebuild_fulltext_index(name, d.name)
        self._log("repartition", name, new_parts)
        return moved

    def clear_space(self, name: str, if_exists=False):
        """CLEAR SPACE: wipe every partition's data (vertices, edges,
        derived indexes, TOSS chains, the dense-id dictionary) while
        keeping the schema catalog — the reference's admin statement for
        re-ingesting a space without re-issuing DDL."""
        from .schema import SchemaError
        try:
            self.catalog.get_space(name)
        except SchemaError:
            if if_exists:
                return
            raise
        sd = self.space(name)
        for pid in range(sd.num_parts):
            self.clear_part(name, pid)
        self._log("clear_space", name)

    def space(self, name: str) -> SpaceData:
        sp = self.catalog.get_space(name)
        sd = self.data.get(sp.space_id)
        if sd is None:
            sd = self.data[sp.space_id] = SpaceData(sp)
        return sd

    # ---- device delta feed ----
    # The TpuRuntime attaches a dirty-key log BEFORE exporting a
    # snapshot; every write path notes its key under sd.lock, so a key
    # recorded after the watch but before the export is merely re-read
    # at apply time (idempotent) — no lost-write window.

    def delta_watch(self, space: str, cap: int = 65536) -> int:
        from .delta import DeltaLog
        sd = self.space(space)
        with sd.lock:
            log = getattr(sd, "delta_log", None)
            if log is None or log.broken:
                # an unbroken log keeps watching across re-watches: a
                # compaction build must not reset the floor (or drop
                # keys) out from under the still-serving snapshot —
                # stale keys are harmless, apply re-reads per key
                sd.delta_log = DeltaLog(floor_epoch=sd.epoch, cap=cap)
            return sd.epoch

    def delta_records(self, space: str):
        """-> (dirty keys, target epoch, log floor epoch), or None when
        no log is watching / the log broke (caller full-rebuilds)."""
        sd = self.space(space)
        with sd.lock:
            log = getattr(sd, "delta_log", None)
            if log is None or log.broken:
                return None
            return list(log.keys), sd.epoch, log.floor_epoch

    def delta_trim(self, space: str, keys) -> None:
        sd = self.space(space)
        with sd.lock:
            log = getattr(sd, "delta_log", None)
            if log is not None:
                log.trim(keys)

    def delta_reader(self, space: str):
        from .delta import LocalStoreReader
        return LocalStoreReader(self, space)

    # ---- secondary index maintenance (SURVEY §2 row 15) ----
    # Hooks called from every write path (rich and raw-apply) so cluster
    # replicas maintain identical index state; CREATE INDEX starts empty
    # (reference semantics) — rebuild_index() backfills.

    def _make_index_data(self, space: str, d, num_parts: int):
        """IndexData for a descriptor; a single-column index over a
        GEOGRAPHY prop is automatically cell-token-keyed (GeoIndexData) —
        the reference keys geo index records by S2 cell with no separate
        DDL spelling (SURVEY §2 row 15)."""
        from .index import GeoIndexData, IndexData
        from .schema import PropType
        cls = IndexData
        if len(d.fields) == 1:
            try:
                sv = (self.catalog.get_edge(space, d.schema_name).latest
                      if d.is_edge else
                      self.catalog.get_tag(space, d.schema_name).latest)
                p = sv.prop(d.fields[0])
                if p is not None and p.ptype == PropType.GEOGRAPHY:
                    cls = GeoIndexData
            except SchemaError:
                pass
        return cls(d.name, d.fields, d.is_edge, num_parts, d.index_id,
                   field_lens=getattr(d, "field_lens", None))

    def _index_list(self, sd: SpaceData, space: str, schema: str,
                    is_edge: bool):
        descs = self.catalog.indexes_for(space, schema, is_edge)
        out = []
        for d in descs:
            idx = sd.index_data.get(d.name)
            if idx is None or idx.fields != d.fields or \
                    idx.index_id != d.index_id:
                # new creation (possibly after a DROP of a same-named
                # index) — starts empty, never resurrects old entries
                idx = sd.index_data[d.name] = self._make_index_data(
                    space, d, sd.num_parts)
            out.append(idx)
        return out

    def _index_vertex(self, sd, space, vid, tag, old_row, new_row):
        part = sd.part_of(vid)
        idxs = self._index_list(sd, space, tag, False)
        if idxs:
            # index keys must match what READS serve: rows stored before
            # an ALTER ... ADD are keyed with the filled default, same
            # as fill_row'd scans/rebuilds (else remove() misses)
            sv = self.catalog.get_tag(space, tag).latest
            old_f = fill_row(sv, old_row) if old_row is not None else None
            new_f = fill_row(sv, new_row) if new_row is not None else None
            for idx in idxs:
                if old_f is not None:
                    idx.remove(part, old_f, vid)
                if new_f is not None:
                    idx.add(part, new_f, vid)
        self._ft_enqueue(sd, space, tag, False, part, vid, old_row,
                         new_row)

    def _index_edge(self, sd, space, src, etype, dst, rank, old_row,
                    new_row):
        part = sd.part_of(src)
        ent = (src, rank, dst)
        idxs = self._index_list(sd, space, etype, True)
        if idxs:
            sv = self.catalog.get_edge(space, etype).latest
            old_f = fill_row(sv, old_row) if old_row is not None else None
            new_f = fill_row(sv, new_row) if new_row is not None else None
            for idx in idxs:
                if old_f is not None:
                    idx.remove(part, old_f, ent)
                if new_f is not None:
                    idx.add(part, new_f, ent)
        self._ft_enqueue(sd, space, etype, True, part, ent, old_row,
                         new_row)

    # ---- full-text plane (SURVEY §2 row 10 Listener) ----

    def _ft_list(self, sd: SpaceData, space: str, schema: str,
                 is_edge: bool):
        from .fulltext import FulltextIndexData
        # per-write fast path: catalog lookups + drop-GC run only when
        # the catalog version moved, not on every mutation
        ver = self.catalog.version
        mkey = (sd.desc.space_id, schema, is_edge)
        memo = self._ft_memo.get(mkey)
        if memo is None or memo[0] != ver:
            with self._ft_reg_lock:
                if sd.ft_data:
                    # GC incarnations the catalog no longer lists (DROP
                    # FULLTEXT INDEX must release the corpus, not strand
                    # it until a same-name re-CREATE)
                    live = {d.name: d.index_id
                            for d in self.catalog.fulltext_indexes(space)}
                    for name in list(sd.ft_data):
                        if live.get(name) != sd.ft_data[name].index_id:
                            del sd.ft_data[name]
                            if self._ft_listener is not None:
                                self._ft_listener.unregister(space, name)
                descs = self.catalog.fulltext_indexes_for(space, schema,
                                                          is_edge)
            self._ft_memo[mkey] = memo = (ver, descs)
        descs = memo[1]
        if not descs:
            return ()
        out = []
        # registry mutation is serialized: a concurrent first touch from
        # a search thread and a write thread must agree on ONE
        # FulltextIndexData (a split brain here would send all listener
        # applies to an object searches never read)
        with self._ft_reg_lock:
            for d in descs:
                ft = sd.ft_data.get(d.name)
                if ft is None or ft.index_id != d.index_id:
                    ft = sd.ft_data[d.name] = FulltextIndexData(
                        d.name, d.schema_name, d.fields[0], d.is_edge,
                        sd.num_parts, d.index_id)
                    self.ft_listener.register(space, ft)
                out.append(ft)
        return out

    def _ft_enqueue(self, sd, space, schema, is_edge, part, entity,
                    old_row, new_row):
        """Replicate one committed mutation to the text sink — enqueue
        only; the listener thread applies (base writes never block on
        the text index, matching the reference's one-way Listener)."""
        for ft in self._ft_list(sd, space, schema, is_edge):
            lsn = self.ft_listener
            if old_row is not None:
                lsn.enqueue("remove", space, ft.name, part, entity=entity,
                            gen=ft.index_id)
            if new_row is not None:
                v = new_row.get(ft.field)
                if isinstance(v, str):
                    lsn.enqueue("add", space, ft.name, part, v, entity,
                                gen=ft.index_id)

    def rebuild_fulltext_index(self, space: str, index_name: str,
                               parts: Optional[List[int]] = None) -> int:
        """Clear + re-replicate one text index from base data."""
        sd = self.space(space)
        d = next((x for x in self.catalog.fulltext_indexes(space)
                  if x.name == index_name), None)
        if d is None:
            raise StoreError(f"fulltext index `{index_name}' not found")
        fts = self._ft_list(sd, space, d.schema_name, d.is_edge)
        ft = next(x for x in fts if x.name == index_name)
        lsn = self.ft_listener
        if parts is not None:
            lsn.drain()     # settle before reading values[] below
        with sd.lock:
            part_ids = list(parts) if parts is not None \
                else list(range(sd.num_parts))
            if parts is None:
                lsn.enqueue("clear", space, index_name, gen=ft.index_id)
            for pid in part_ids:
                if parts is not None:
                    with ft.lock:
                        ents = list(ft.values[pid])
                    for ent in ents:
                        lsn.enqueue("remove", space, index_name, pid,
                                    entity=ent, gen=ft.index_id)
                p = sd.parts[pid]
                if d.is_edge:
                    for src, per in p.out_edges.items():
                        em = per.get(d.schema_name)
                        if em:
                            for (rank, dst), row in em.items():
                                v = row.get(d.fields[0])
                                if isinstance(v, str):
                                    lsn.enqueue("add", space, index_name,
                                                pid, v, (src, rank, dst),
                                                gen=ft.index_id)
                else:
                    for vid, tv in p.vertices.items():
                        if d.schema_name in tv:
                            v = tv[d.schema_name][1].get(d.fields[0])
                            if isinstance(v, str):
                                lsn.enqueue("add", space, index_name,
                                            pid, v, vid,
                                            gen=ft.index_id)
        lsn.drain()
        return sum(len(ft.values[pid]) for pid in part_ids)

    def fulltext_search(self, space: str, index_name: str, op: str,
                        pattern: str,
                        parts: Optional[List[int]] = None) -> List[Any]:
        """Serve a LOOKUP text predicate.  Drains the listener first —
        read-your-writes instead of the reference's ES eventual
        consistency (documented deviation, keeps results deterministic)."""
        sd = self.space(space)
        d = next((x for x in self.catalog.fulltext_indexes(space)
                  if x.name == index_name), None)
        if d is None:
            raise StoreError(f"fulltext index `{index_name}' not found")
        fts = self._ft_list(sd, space, d.schema_name, d.is_edge)
        ft = next(x for x in fts if x.name == index_name)
        self.ft_listener.drain()
        return ft.search(op, pattern, parts)

    def rebuild_index(self, space: str, index_name: str,
                      parts: Optional[List[int]] = None) -> int:
        """Clear + backfill one index from the base data. Returns entry
        count (this process's parts)."""
        sd = self.space(space)
        descs = {d.name: d for d in self.catalog.indexes(space)}
        d = descs.get(index_name)
        if d is None:
            raise StoreError(f"index `{index_name}' not found")
        if parts is None:
            self._log("rebuild_index", space, index_name)
        idx = sd.index_data.get(index_name)
        if idx is None or idx.fields != d.fields or \
                idx.index_id != d.index_id:
            idx = sd.index_data[index_name] = self._make_index_data(
                space, d, sd.num_parts)
        sv = (self.catalog.get_edge(space, d.schema_name).latest
              if d.is_edge else
              self.catalog.get_tag(space, d.schema_name).latest)
        with sd.lock:
            part_ids = list(parts) if parts is not None \
                else list(range(sd.num_parts))
            for pid in part_ids:
                idx.parts[pid].clear()
                p = sd.parts[pid]
                if d.is_edge:
                    for src, per in p.out_edges.items():
                        em = per.get(d.schema_name)
                        if em:
                            for (rank, dst), row in em.items():
                                idx.add(pid, fill_row(sv, row),
                                        (src, rank, dst))
                else:
                    for vid, tv in p.vertices.items():
                        if d.schema_name in tv:
                            idx.add(pid,
                                    fill_row(sv, tv[d.schema_name][1]),
                                    vid)
            return sum(len(idx.parts[pid]) for pid in part_ids)

    def index_scan(self, space: str, index_name: str, eq_prefix: List[Any],
                   range_hint=None,
                   parts: Optional[List[int]] = None) -> List[Any]:
        """Entities (vids or (src, rank, dst)) matching the hints, in
        index order per part."""
        sd = self.space(space)
        idx = sd.index_data.get(index_name)
        d = next((x for x in self.catalog.indexes(space)
                  if x.name == index_name), None)
        if idx is None or d is None or idx.fields != d.fields or \
                idx.index_id != d.index_id:
            return []               # dropped/recreated → stale data is dead
        part_ids = list(parts) if parts is not None \
            else list(range(sd.num_parts))
        out: List[Any] = []
        for pid in part_ids:
            out.extend(idx.scan(pid, eq_prefix, range_hint))
        return out

    def index_scan_geo(self, space: str, index_name: str,
                       ranges: List[tuple],
                       parts: Optional[List[int]] = None) -> List[Any]:
        """Entities whose geography cell token falls in any of the
        inclusive (lo, hi) token ranges (covering_ranges output); the
        caller re-checks the exact ST_ predicate as a residual filter."""
        from .index import GeoIndexData
        sd = self.space(space)
        idx = sd.index_data.get(index_name)
        d = next((x for x in self.catalog.indexes(space)
                  if x.name == index_name), None)
        if idx is None or d is None or idx.fields != d.fields or \
                idx.index_id != d.index_id or \
                not isinstance(idx, GeoIndexData):
            return []               # dropped/recreated → stale data is dead
        part_ids = list(parts) if parts is not None \
            else list(range(sd.num_parts))
        out: List[Any] = []
        for pid in part_ids:
            out.extend(idx.scan_geo(pid, ranges))
        return out

    # ---- mutate ----
    def insert_vertex(self, space: str, vid: Any, tag: str,
                      props: Dict[str, Any], insert_names: Optional[List[str]] = None):
        sd = self.space(space)
        sd.desc.check_vid(vid)
        ts = self.catalog.get_tag(space, tag)
        sv = ts.latest
        row = apply_defaults(sv, props, insert_names)
        with sd.lock:
            p = sd.parts[sd.part_of(vid)]
            sd.dense_id(vid, create=True)
            old = p.vertices.get(vid, {}).get(tag)
            p.vertices.setdefault(vid, {})[tag] = (sv.version, row)
            self._index_vertex(sd, space, vid, tag,
                               old[1] if old else None, row)
            sd.epoch += 1
            _dnote(sd, ("v", vid))
            self._log("vertex", space, vid, tag, sv.version, row)

    def insert_edge(self, space: str, src: Any, etype: str, dst: Any,
                    rank: int, props: Dict[str, Any],
                    insert_names: Optional[List[str]] = None):
        sd = self.space(space)
        sd.desc.check_vid(src)
        sd.desc.check_vid(dst)
        es = self.catalog.get_edge(space, etype)
        sv = es.latest
        row = apply_defaults(sv, props, insert_names)
        with sd.lock:
            sd.dense_id(src, create=True)
            sd.dense_id(dst, create=True)
            # out-edge on src part, in-edge on dst part (TOSS chain analog)
            po = sd.parts[sd.part_of(src)]
            old = po.out_edges.get(src, {}).get(etype, {}).get((rank, dst))
            po.out_edges.setdefault(src, {}).setdefault(etype, {})[(rank, dst)] = row
            pi = sd.parts[sd.part_of(dst)]
            pi.in_edges.setdefault(dst, {}).setdefault(etype, {})[(rank, src)] = row
            self._index_edge(sd, space, src, etype, dst, rank, old, row)
            sd.epoch += 1
            _dnote(sd, ("e", etype, src, dst, rank))
            self._log("edge_pair", space, src, etype, dst, rank, row)

    def delete_vertex(self, space: str, vid: Any, with_edges: bool = True):
        sd = self.space(space)
        with sd.lock:
            p = sd.parts[sd.part_of(vid)]
            tv = p.vertices.pop(vid, None)
            if tv:
                for t, (_, row) in tv.items():
                    self._index_vertex(sd, space, vid, t, row, None)
            if with_edges:
                out = p.out_edges.pop(vid, {})
                for etype, em in out.items():
                    for (rank, dst), row in list(em.items()):
                        pd = sd.parts[sd.part_of(dst)]
                        pd.in_edges.get(dst, {}).get(etype, {}).pop((rank, vid), None)
                        self._index_edge(sd, space, vid, etype, dst, rank,
                                         row, None)
                        _dnote(sd, ("e", etype, vid, dst, rank))
                inn = p.in_edges.pop(vid, {})
                for etype, em in inn.items():
                    for (rank, src) in list(em):
                        ps = sd.parts[sd.part_of(src)]
                        row = ps.out_edges.get(src, {}).get(etype, {}) \
                            .pop((rank, vid), None)
                        if row is not None:
                            self._index_edge(sd, space, src, etype, vid,
                                             rank, row, None)
                        _dnote(sd, ("e", etype, src, vid, rank))
            sd.epoch += 1
            _dnote(sd, ("v", vid))
            self._log("del_vertex_rich", space, vid, with_edges)

    def delete_tag(self, space: str, vid: Any, tags: List[str]):
        sd = self.space(space)
        with sd.lock:
            p = sd.parts[sd.part_of(vid)]
            tv = p.vertices.get(vid)
            if tv:
                for t in tags:
                    old = tv.pop(t, None)
                    if old is not None:
                        self._index_vertex(sd, space, vid, t, old[1], None)
                if not tv:
                    p.vertices.pop(vid, None)
            sd.epoch += 1
            _dnote(sd, ("v", vid))
            self._log("del_tag", space, vid, tags)

    def delete_edge(self, space: str, src: Any, etype: str, dst: Any, rank: int):
        sd = self.space(space)
        with sd.lock:
            ps = sd.parts[sd.part_of(src)]
            old = ps.out_edges.get(src, {}).get(etype, {}).pop((rank, dst), None)
            pd = sd.parts[sd.part_of(dst)]
            pd.in_edges.get(dst, {}).get(etype, {}).pop((rank, src), None)
            if old is not None:
                self._index_edge(sd, space, src, etype, dst, rank, old, None)
            sd.epoch += 1
            _dnote(sd, ("e", etype, src, dst, rank))
            self._log("del_edge", space, src, etype, dst, rank)

    def update_vertex(self, space: str, vid: Any, tag: str,
                      updates: Dict[str, Any]) -> bool:
        sd = self.space(space)
        with sd.lock:
            p = sd.parts[sd.part_of(vid)]
            tv = p.vertices.get(vid, {}).get(tag)
            if tv is None:
                return False
            ver, row = tv
            sv = self.catalog.get_tag(space, tag).latest
            for k in updates:       # validate BEFORE mutating anything
                if sv.prop(k) is None:
                    raise SchemaError(f"unknown prop `{k}'")
            old = dict(row)
            row.update(updates)
            self._index_vertex(sd, space, vid, tag, old, row)
            sd.epoch += 1
            _dnote(sd, ("v", vid))
            self._log("upd_vertex", space, vid, tag, updates)
            return True

    def update_edge(self, space: str, src: Any, etype: str, dst: Any,
                    rank: int, updates: Dict[str, Any]) -> bool:
        sd = self.space(space)
        with sd.lock:
            ps = sd.parts[sd.part_of(src)]
            row = ps.out_edges.get(src, {}).get(etype, {}).get((rank, dst))
            if row is None:
                return False
            sv = self.catalog.get_edge(space, etype).latest
            for k in updates:       # validate BEFORE mutating anything
                if sv.prop(k) is None:
                    raise SchemaError(f"unknown prop `{k}'")
            old = dict(row)
            row.update(updates)
            self._index_edge(sd, space, src, etype, dst, rank, old, row)
            pd = sd.parts[sd.part_of(dst)]
            irow = pd.in_edges.get(dst, {}).get(etype, {}).get((rank, src))
            if irow is not None:
                irow.update({k: row[k] for k in updates})
            sd.epoch += 1
            _dnote(sd, ("e", etype, src, dst, rank))
            self._log("upd_edge_pair", space, src, etype, dst, rank,
                      updates)
            return True

    # ---- raw part-local apply (cluster write path) ----
    # Schema defaults are resolved by the caller (graphd) before the op is
    # proposed to the part's raft group, so replica replay is
    # deterministic; each op touches exactly ONE part (edge writes are
    # split into out/in halves — the TOSS chain, SURVEY §2 row 14).

    def apply_vertex(self, space: str, vid: Any, tag: str, version: int,
                     row: Dict[str, Any]):
        sd = self.space(space)
        with sd.lock:
            p = sd.parts[sd.part_of(vid)]
            sd.dense_id(vid, create=True)
            old = p.vertices.get(vid, {}).get(tag)
            p.vertices.setdefault(vid, {})[tag] = (version, dict(row))
            self._index_vertex(sd, space, vid, tag,
                               old[1] if old else None, row)
            sd.epoch += 1
            _dnote(sd, ("v", vid))

    def apply_edge_half(self, space: str, src: Any, etype: str, dst: Any,
                        rank: int, row: Dict[str, Any], which: str):
        sd = self.space(space)
        with sd.lock:
            if which == "out":
                sd.dense_id(src, create=True)
                p = sd.parts[sd.part_of(src)]
                old = p.out_edges.get(src, {}).get(etype, {}).get((rank, dst))
                p.out_edges.setdefault(src, {}).setdefault(etype, {})[
                    (rank, dst)] = dict(row)
                self._index_edge(sd, space, src, etype, dst, rank, old, row)
            else:
                sd.dense_id(dst, create=True)
                p = sd.parts[sd.part_of(dst)]
                p.in_edges.setdefault(dst, {}).setdefault(etype, {})[
                    (rank, src)] = dict(row)
            sd.epoch += 1
            _dnote(sd, ("e", etype, src, dst, rank))

    def apply_delete_vertex(self, space: str, vid: Any):
        """Remove the vertex row + its own adjacency planes (the caller
        deletes the mirror halves on other parts)."""
        sd = self.space(space)
        with sd.lock:
            p = sd.parts[sd.part_of(vid)]
            tv = p.vertices.pop(vid, None)
            if tv:
                for t, (_, row) in tv.items():
                    self._index_vertex(sd, space, vid, t, row, None)
            out = p.out_edges.pop(vid, None)
            if out:
                for etype, em in out.items():
                    for (rank, dst), row in em.items():
                        self._index_edge(sd, space, vid, etype, dst, rank,
                                         row, None)
                        _dnote(sd, ("e", etype, vid, dst, rank))
            inn = p.in_edges.pop(vid, None)
            if inn:
                for etype, em in inn.items():
                    for (rank, src) in em:
                        _dnote(sd, ("e", etype, src, vid, rank))
            sd.epoch += 1
            _dnote(sd, ("v", vid))

    def apply_delete_edge_half(self, space: str, src: Any, etype: str,
                               dst: Any, rank: int, which: str):
        sd = self.space(space)
        with sd.lock:
            if which == "out":
                p = sd.parts[sd.part_of(src)]
                old = p.out_edges.get(src, {}).get(etype, {}) \
                    .pop((rank, dst), None)
                if old is not None:
                    self._index_edge(sd, space, src, etype, dst, rank,
                                     old, None)
            else:
                p = sd.parts[sd.part_of(dst)]
                p.in_edges.get(dst, {}).get(etype, {}).pop((rank, src), None)
            sd.epoch += 1
            _dnote(sd, ("e", etype, src, dst, rank))

    def apply_update_vertex(self, space: str, vid: Any, tag: str,
                            updates: Dict[str, Any]) -> bool:
        sd = self.space(space)
        with sd.lock:
            tv = sd.parts[sd.part_of(vid)].vertices.get(vid, {}).get(tag)
            if tv is None:
                return False
            old = dict(tv[1])
            tv[1].update(updates)
            self._index_vertex(sd, space, vid, tag, old, tv[1])
            sd.epoch += 1
            _dnote(sd, ("v", vid))
            return True

    def apply_update_edge_half(self, space: str, src: Any, etype: str,
                               dst: Any, rank: int,
                               updates: Dict[str, Any], which: str) -> bool:
        sd = self.space(space)
        with sd.lock:
            if which == "out":
                row = sd.parts[sd.part_of(src)].out_edges.get(src, {}) \
                    .get(etype, {}).get((rank, dst))
            else:
                row = sd.parts[sd.part_of(dst)].in_edges.get(dst, {}) \
                    .get(etype, {}).get((rank, src))
            if row is None:
                return False
            old = dict(row)
            row.update(updates)
            if which == "out":
                self._index_edge(sd, space, src, etype, dst, rank, old, row)
            sd.epoch += 1
            _dnote(sd, ("e", etype, src, dst, rank))
            return True

    def apply_chain_mark(self, space: str, pid: int, chain_id: str,
                         entry: Dict[str, Any]):
        """Record the in-half a TOSS chain still owes (replicated with
        the out-half's part so a graphd crash between the two halves is
        recoverable by the part leader's resume loop).  entry:
        {"part": dst_pid, "cmd": [in-half cmd], "ts": float}."""
        sd = self.space(space)
        with sd.lock:
            sd.parts[pid].pending_chains[chain_id] = dict(entry)

    def apply_chain_done(self, space: str, pid: int, chain_id: str):
        sd = self.space(space)
        with sd.lock:
            sd.parts[pid].pending_chains.pop(chain_id, None)

    def pending_chains(self, space: str, pid: int) -> Dict[str, Dict[str, Any]]:
        sd = self.space(space)
        with sd.lock:
            return dict(sd.parts[pid].pending_chains)

    # ---- exactly-once write dedup ----

    def dedup_seen(self, space: str, pid: int, writer: str,
                   seq: int) -> Optional[Dict[str, Any]]:
        """The recorded outcome of an already-applied (writer, seq)
        write request, or None.  Checked by the leader's rpc_write
        fast path AND by dbatch apply (the replicated, race-free
        gate)."""
        sd = self.space(space)
        with sd.lock:
            return sd.parts[pid].applied_writes.get((writer, int(seq)))

    def dedup_record(self, space: str, pid: int, writer: str, seq: int,
                     outcome: Dict[str, Any]):
        """Record a write request's outcome in the part's dedup window.
        Called ONLY from dbatch apply — replicas call it in identical
        commit order, so window contents and eviction are identical
        everywhere."""
        sd = self.space(space)
        with sd.lock:
            aw = sd.parts[pid].applied_writes
            aw[(writer, int(seq))] = outcome
            while len(aw) > DEDUP_WINDOW:
                aw.popitem(last=False)

    # ---- part state snapshot (raft snapshot + checkpoint payload) ----

    def part_state_payload(self, space: str, pid: int) -> Dict[str, Any]:
        """One partition's full state as a plain dict — THE part-state
        vocabulary, shared by the raft snapshot/checkpoint encoder
        (export_part_state) and the device-plane bulk CSR export RPC
        (storage_service.rpc_export_part): a field added here reaches
        both, so the formats cannot drift."""
        sd = self.space(space)
        with sd.lock:
            p = sd.parts[pid]
            return {
                "vertices": p.vertices,
                "out_edges": p.out_edges,
                "in_edges": p.in_edges,
                "part_count": sd.part_counts[pid],
                "dense": {v: d for v, d in sd.vid_to_dense.items()
                          if d % sd.num_parts == pid},
                "chains": p.pending_chains,
                # ordered list form: JSON keys must be strings, and the
                # WINDOW ORDER (eviction order) is itself state
                "writes": [[w, s, rec]
                           for (w, s), rec in p.applied_writes.items()],
            }

    def export_part_state(self, space: str, pid: int) -> bytes:
        """Serialize one partition's full state (raft snapshot_cb /
        checkpoint file payload).  Includes the part's slice of the
        dense-id dictionary so replay-free restore keeps device ids
        stable.  Wire-JSON encoded: the payload crosses RPC as a raft
        snapshot, so it must never be pickle."""
        from ..core import wire
        return wire.dumps(self.part_state_payload(space, pid))

    def install_part_state(self, space: str, pid: int, data: bytes):
        from ..core import wire
        st = wire.loads(data)
        sd = self.space(space)
        with sd.lock:
            p = sd.parts[pid]
            p.vertices = st["vertices"]
            p.out_edges = st["out_edges"]
            p.in_edges = st["in_edges"]
            p.pending_chains = st.get("chains", {})
            p.applied_writes = OrderedDict(
                ((w, int(s)), rec) for w, s, rec in st.get("writes", []))
            sd.part_counts[pid] = st["part_count"]
            sd.install_dense(st["dense"])
            sd.epoch += 1
            _dbreak(sd)
        # indexes are derived state: rebuild this part's slices
        for d in self.catalog.indexes(space):
            self.rebuild_index(space, d.name, parts=[pid])
        for d in self.catalog.fulltext_indexes(space):
            self.rebuild_fulltext_index(space, d.name, parts=[pid])

    def clear_part(self, space: str, pid: int):
        """Release one partition's state (the replica moved away under
        BALANCE DATA — this host no longer serves it).  The part's slice
        of the dense-id dictionary goes too: if the part later moves
        BACK, install_part_state installs the then-current map, and stale
        local entries would resurrect deleted vids in export/device
        snapshots."""
        sd = self.space(space)
        with sd.lock:
            p = sd.parts[pid]
            p.vertices = {}
            p.out_edges = {}
            p.in_edges = {}
            p.pending_chains = {}
            p.applied_writes = OrderedDict()
            sd.part_counts[pid] = 0
            for v, d in list(sd.vid_to_dense.items()):
                if d % sd.num_parts == pid:
                    del sd.vid_to_dense[v]
                    sd.dense_to_vid[d] = None
            sd.epoch += 1
            _dbreak(sd)
        for d in self.catalog.indexes(space):
            self.rebuild_index(space, d.name, parts=[pid])
        for d in self.catalog.fulltext_indexes(space):
            self.rebuild_fulltext_index(space, d.name, parts=[pid])

    # ---- checkpoint / restore (CREATE SNAPSHOT; SURVEY §5) ----

    def checkpoint(self, dirpath: str,
                   spaces: Optional[List[str]] = None) -> Dict[str, Any]:
        """Durable on-disk checkpoint: catalog + every part's state +
        manifest.  The reference hard-links RocksDB SSTs; here part
        states are written as files — same contract (point-in-time,
        restorable)."""
        import json
        import os

        from . import schema_wire
        os.makedirs(dirpath, exist_ok=True)
        names = spaces if spaces is not None else sorted(self.catalog.spaces)
        manifest: Dict[str, Any] = {"spaces": {}}
        raw_catalog = getattr(self.catalog, "_inner", self.catalog)
        with open(os.path.join(dirpath, "catalog.bin"), "wb") as f:
            f.write(schema_wire.dumps(raw_catalog))
        for name in names:
            sd = self.space(name)
            spdir = os.path.join(dirpath, f"space_{sd.desc.space_id}")
            os.makedirs(spdir, exist_ok=True)
            with sd.lock:
                for pid in range(sd.num_parts):
                    with open(os.path.join(spdir, f"part_{pid}.bin"),
                              "wb") as f:
                        f.write(self.export_part_state(name, pid))
                manifest["spaces"][name] = {
                    "space_id": sd.desc.space_id,
                    "partition_num": sd.num_parts,
                    "epoch": sd.epoch,
                }
        with open(os.path.join(dirpath, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        return manifest

    def restore_backup(self, dirpath: str) -> Dict[str, Any]:
        """RESTORE BACKUP: replace this store's catalog and every
        space's partition state with the backup's point-in-time state —
        the standalone analog of the reference's BR restore (which
        rewrites storaged/metad data dirs offline; here the swap is
        in-process: catalog replace, SpaceData cache reset, per-part
        install with derived-index rebuild).  On a durable store the
        restored state immediately becomes the on-disk checkpoint
        (journal truncated) so a restart boots the restored world, not
        a pre-restore journal replay.

        Every backup file is read and decoded BEFORE the live state is
        touched, and a failure mid-install rolls the catalog and space
        cache back — a corrupt backup must not destroy the store.
        Queries racing the swap itself see either
        world per space (the reference's br requires stopped services;
        the statement form trades that for a brief per-space cut).
        Epochs stay monotonic across the swap so pinned device
        snapshots from the pre-restore world can never be mistaken for
        current."""
        import json
        import os

        from . import schema_wire
        with open(os.path.join(dirpath, "manifest.json")) as f:
            manifest = json.load(f)
        with open(os.path.join(dirpath, "catalog.bin"), "rb") as f:
            newcat = schema_wire.loads(f.read())
        parts: List[Tuple[str, int, bytes]] = []
        for name, info in manifest["spaces"].items():
            spdir = os.path.join(dirpath, f"space_{info['space_id']}")
            for pid in range(info["partition_num"]):
                with open(os.path.join(spdir, f"part_{pid}.bin"),
                          "rb") as f:
                    blob = f.read()
                from ..core import wire
                wire.loads(blob)     # decode check up front
                parts.append((name, pid, blob))

        old_cat, old_data = self.catalog, self.data
        # device-snapshot cache keys on (space NAME, epoch): the
        # restored world must start ABOVE every epoch the old world
        # ever pinned
        epoch_floor = {sd.desc.name: sd.epoch for sd in old_data.values()}
        if self._engine is not None:
            from .engine import JournalingCatalog
            self.catalog = JournalingCatalog(newcat, self._engine)
        else:
            self.catalog = newcat
        self.data = {}               # SpaceData rebuilds from the catalog
        self._ft_memo.clear()
        try:
            for name, pid, blob in parts:
                sd = self.space(name)
                floor = epoch_floor.get(name)
                if floor is not None and sd.epoch <= floor:
                    sd.epoch = floor + 1
                self.install_part_state(name, pid, blob)
        except Exception:
            self.catalog, self.data = old_cat, old_data
            self._ft_memo.clear()
            raise
        if self._engine is not None:
            self.compact_journal()
        return {"spaces": sorted(manifest["spaces"])}

    @classmethod
    def from_checkpoint(cls, dirpath: str) -> "GraphStore":
        import json
        import os

        from . import schema_wire
        with open(os.path.join(dirpath, "catalog.bin"), "rb") as f:
            catalog = schema_wire.loads(f.read())
        store = cls(catalog=catalog)
        with open(os.path.join(dirpath, "manifest.json")) as f:
            manifest = json.load(f)
        for name, info in manifest["spaces"].items():
            spdir = os.path.join(dirpath, f"space_{info['space_id']}")
            for pid in range(info["partition_num"]):
                with open(os.path.join(spdir, f"part_{pid}.bin"),
                          "rb") as f:
                    store.install_part_state(name, pid, f.read())
        return store

    # ---- read: point / scan ----
    def get_vertex(self, space: str, vid: Any) -> Optional[Dict[str, Dict[str, Any]]]:
        """vid → {tag: props} or None (TTL-expired tags invisible)."""
        import time as _t
        sd = self.space(space)
        tv = sd.part_for(vid).vertices.get(vid)
        if tv is None:
            return None
        now = _t.time()
        out = {}
        for t, (_, row) in tv.items():
            try:
                sv = self.catalog.get_tag(space, t).latest
            except SchemaError:
                continue            # tag dropped: its rows are invisible
            if not ttl_expired(sv, row, now):
                out[t] = dict(fill_row(sv, row))
        return out if out else None

    def get_edge(self, space: str, src: Any, etype: str, dst: Any,
                 rank: int = 0) -> Optional[Dict[str, Any]]:
        import time as _t
        sd = self.space(space)
        row = sd.part_for(src).out_edges.get(src, {}).get(etype, {}) \
            .get((rank, dst))
        if row is None:
            return None
        sv = self.catalog.get_edge(space, etype).latest
        if ttl_expired(sv, row, _t.time()):
            return None
        return dict(fill_row(sv, row))

    def scan_vertices(self, space: str, tag: Optional[str] = None,
                      parts: Optional[Iterable[int]] = None):
        """Yields (vid, tag, props)."""
        import time as _t
        sd = self.space(space)
        plist = sd.parts                 # one snapshot: repartition-safe
        part_ids = range(len(plist)) if parts is None else parts
        svs = {t.name: t.latest for t in self.catalog.tags(space)}
        now = _t.time()
        for pid in part_ids:
            if pid >= len(plist):
                continue
            for vid, tv in plist[pid].vertices.items():
                for t, (_, row) in tv.items():
                    if t not in svs:
                        continue    # tag dropped: rows invisible
                    if (tag is None or t == tag) and \
                            not ttl_expired(svs[t], row, now):
                        yield vid, t, fill_row(svs[t], row)

    def scan_edges(self, space: str, etype: Optional[str] = None,
                   parts: Optional[Iterable[int]] = None):
        """Yields (src, etype, rank, dst, props) from the out-plane."""
        import time as _t
        sd = self.space(space)
        plist = sd.parts                 # one snapshot: repartition-safe
        part_ids = range(len(plist)) if parts is None else parts
        svs = {e.name: e.latest for e in self.catalog.edges(space)}
        now = _t.time()
        for pid in part_ids:
            if pid >= len(plist):
                continue
            for src, per in plist[pid].out_edges.items():
                for et, em in per.items():
                    if etype is not None and et != etype:
                        continue
                    sv = svs.get(et)
                    if sv is None:
                        continue    # edge type dropped: rows invisible
                    for (rank, dst), row in em.items():
                        if not ttl_expired(sv, row, now):
                            yield src, et, rank, dst, fill_row(sv, row)

    # ---- read: getNeighbors (the hot-path op, host oracle form) ----
    def get_neighbors(self, space: str, vids: List[Any],
                      edge_types: Optional[List[str]] = None,
                      direction: str = "out",
                      edge_filter=None, limit_per_src: Optional[int] = None):
        """Yields (src, etype_name, rank, dst, props, signed_dir).

        signed_dir is +1 for out-edges, -1 for in-edges (matching the
        reference's negative-EdgeType convention for reversed traversal).
        Row order is deterministic: input vid order, then etype name, then
        (rank, neighbor) — the CSR sort order (csr.py) matches this.

        edge_filter / limit_per_src are the storage-side pushdown stage
        (cluster mode runs them inside storaged; applying them here keeps
        standalone semantics identical).
        """
        if edge_filter is not None or limit_per_src is not None:
            from ..cluster.pushdown import apply_edge_filter
            etypes_f = edge_types or sorted(
                e.name for e in self.catalog.edges(space))
            etype_ids = {et: self.catalog.get_edge(space, et).edge_type
                         for et in etypes_f}
            yield from apply_edge_filter(
                self.get_neighbors(space, vids, edge_types, direction),
                space, edge_filter, etype_ids, limit_per_src)
            return
        import time as _t
        sd = self.space(space)
        etypes = edge_types
        if etypes is None:
            etypes = sorted(e.name for e in self.catalog.edges(space))
        svs = {et: self.catalog.get_edge(space, et).latest for et in etypes}
        now = _t.time()
        for vid in vids:
            p = sd.part_for(vid)
            if direction in ("out", "both"):
                per = p.out_edges.get(vid, {})
                for et in etypes:
                    em = per.get(et)
                    if em:
                        sv = svs[et]
                        for (rank, dst) in sorted(em, key=_nbr_key):
                            row = em[(rank, dst)]
                            if not ttl_expired(sv, row, now):
                                yield (vid, et, rank, dst,
                                       fill_row(sv, row), 1)
            if direction in ("in", "both"):
                per = p.in_edges.get(vid, {})
                for et in etypes:
                    em = per.get(et)
                    if em:
                        sv = svs[et]
                        for (rank, src) in sorted(em, key=_nbr_key):
                            row = em[(rank, src)]
                            if not ttl_expired(sv, row, now):
                                yield (vid, et, rank, src,
                                       fill_row(sv, row), -1)

    def compact(self, space: str) -> int:
        """Physically purge TTL-expired rows (the compaction-filter GC of
        the reference).  Returns rows removed."""
        import time as _t
        now = _t.time()
        removed = 0
        # collect first (can't mutate while scanning)
        dead_tags: List[Tuple[Any, str]] = []
        sd = self.space(space)
        for t in self.catalog.tags(space):
            sv = t.latest
            if not sv.ttl_col:
                continue
            for p in sd.parts:
                for vid, tv in p.vertices.items():
                    if t.name in tv and ttl_expired(sv, tv[t.name][1], now):
                        dead_tags.append((vid, t.name))
        dead_edges: List[Tuple[Any, str, Any, int]] = []
        for e in self.catalog.edges(space):
            sv = e.latest
            if not sv.ttl_col:
                continue
            for p in sd.parts:
                for src, per in p.out_edges.items():
                    em = per.get(e.name)
                    if em:
                        for (rank, dst), row in em.items():
                            if ttl_expired(sv, row, now):
                                dead_edges.append((src, e.name, dst, rank))
        for vid, tag in dead_tags:
            self.delete_tag(space, vid, [tag])
            removed += 1
        for src, et, dst, rank in dead_edges:
            self.delete_edge(space, src, et, dst, rank)
            removed += 1
        return removed

    def stats(self, space: str) -> Dict[str, Any]:
        sd = self.space(space)
        return {
            "space": space,
            "partition_num": sd.num_parts,
            "vertices": sum(len(p.vertices) for p in sd.parts),
            "edges": sum(p.edge_count() for p in sd.parts),
            "epoch": sd.epoch,
            "per_part_edges": [p.edge_count() for p in sd.parts],
        }

    def stats_detail(self, space: str,
                     parts: Optional[Iterable[int]] = None
                     ) -> Dict[str, Dict[str, int]]:
        """Per-tag / per-edge-type counts (reference: the STATS job's
        per-schema rows surfaced by SHOW STATS)."""
        sd = self.space(space)
        part_ids = range(sd.num_parts) if parts is None else parts
        tags: Dict[str, int] = {}
        edges: Dict[str, int] = {}
        vertices = 0
        with sd.lock:
            for pid in part_ids:
                p = sd.parts[pid]
                vertices += len(p.vertices)
                for tv in p.vertices.values():
                    for t in tv:
                        tags[t] = tags.get(t, 0) + 1
                for per in p.out_edges.values():
                    for et, em in per.items():
                        edges[et] = edges.get(et, 0) + len(em)
        # totals ride along so SHOW STATS is ONE scan/fan-out and the
        # per-schema rows agree with the Space totals (same snapshot)
        return {"tags": tags, "edges": edges, "vertices": vertices,
                "total_edges": sum(edges.values())}


def _nbr_key(k: Tuple[int, Any]):
    """Neighbor iteration order within one (vid, etype): rank, then
    neighbor — numerically for INT64 vid spaces, lexicographically for
    string spaces.  get_neighbors and the CSR builder both use this key;
    it IS the host/device row-order contract."""
    rank, other = k
    if isinstance(other, int):
        return (rank, 0, other, "")
    return (rank, 1, 0, str(other))
