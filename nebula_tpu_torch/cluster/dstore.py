"""The port's copy of `nebula_tpu/cluster/dstore.py`, whole.

DistributedStore — the GraphStore interface over cluster RPC.

graphd's executors run unchanged against this adapter: it implements the
store surface they use (get_neighbors / point reads / scans / mutations
/ DDL / stats) by routing through MetaClient + StorageClient.  This is
the seam that makes single-process and cluster mode share one executor
stack — the reference gets the same effect from StorageAccessExecutor
always speaking StorageClient (reference: src/graph/executor).

Write semantics: schema defaults are resolved HERE (so part raft logs
replay deterministically), then edge writes run as a TOSS chain — the
out-half to src's part, then the in-half to dst's part (SURVEY §2
row 14).
"""
from __future__ import annotations

import itertools
import uuid
from typing import Any, Dict, Iterable, List, Optional

from ..core.wire import from_wire, to_wire
from ..graphstore.schema import (SchemaError, apply_defaults,
                                  fill_row)
from ..graphstore.store import stable_vid_hash
from ..utils import consistency as _consistency
from ..utils.failpoints import fail
from .meta_client import MetaClient
from .storage_client import StorageClient, StorageError


def _decode_neighbors_columnar(r, edge_svs):
    """Decode a columnar get_neighbors reply (storage_service
    `_neighbors_columnar`) into the (src, et, rank, other, props, sd)
    row tuples the executor contract expects.  Schema-upgrade fill
    (fill_row) hoists out of the row loop: the reply's prop-key set is
    uniform, so the missing-prop defaults are per-reply constants."""
    et = r["et"]
    sv = edge_svs.get(et)
    if sv is None:
        return                        # edge type dropped: rows invisible
    from ..core.wire import decode_column
    srcs = decode_column(r["src"]).tolist()
    ranks = decode_column(r["rank"]).tolist()
    dsts = decode_column(r["dst"]).tolist()
    sds = decode_column(r["sd"]).tolist()
    pnames = list(r["props"])
    plists = []
    for c in r["props"].values():
        if c.get("b") is not None:
            plists.append(decode_column(c).tolist())
        else:
            plists.append([from_wire(x) for x in c["v"]])
    fill = fill_row(sv, dict.fromkeys(pnames, None))
    extra = [(k, v) for k, v in fill.items() if k not in r["props"]]
    if plists:
        for src, rank, dst, sd, *pv in zip(srcs, ranks, dsts, sds,
                                           *plists):
            props = dict(zip(pnames, pv))
            if extra:
                props.update(extra)
            yield (src, et, rank, dst, props, sd)
    else:
        props0 = dict(extra)
        for src, rank, dst, sd in zip(srcs, ranks, dsts, sds):
            yield (src, et, rank, dst, dict(props0) if extra else {},
                   sd)


class CatalogProxy:
    """Reads hit the local catalog replica; DDL mutations route to metad
    (so `qctx.catalog.create_tag(...)` in a DDL executor works unchanged
    in cluster mode)."""

    # create_user/alter_user/change_password do NOT route here — the
    # credential branch in __getattr__ rewrites them to hashed forms
    _MUTATORS = frozenset({
        "create_tag", "create_edge", "alter_tag", "alter_edge",
        "drop_tag", "drop_edge", "create_index", "drop_index",
        "create_fulltext_index", "drop_fulltext_index",
        "add_listener", "remove_listener",
        "drop_user", "grant_role", "revoke_role"})

    def __init__(self, meta: MetaClient):
        object.__setattr__(self, "_meta", meta)

    def __getattr__(self, name):
        meta = object.__getattribute__(self, "_meta")
        if name in ("create_user", "alter_user", "change_password"):
            # hash HERE: the metad raft WAL is a durable log and must
            # never carry plaintext credentials
            from ..graphstore.schema import hash_password

            def cred(*a, _name=name, **kw):
                if _name == "create_user":
                    meta.ddl("create_user_hashed", a[0],
                             hash_password(a[1]),
                             if_not_exists=(kw.get("if_not_exists")
                                            or (len(a) > 2 and a[2])))
                    return
                if _name == "change_password":
                    # atomic check-and-set inside the metad state
                    # machine (a cached-catalog check here would let a
                    # stale credential authorize the rotation)
                    meta.ddl("change_password_hashed", a[0],
                             hash_password(a[1]), hash_password(a[2]))
                    return
                meta.ddl("set_password_hash", a[0], hash_password(a[1]))
            return cred
        if name in CatalogProxy._MUTATORS:
            return lambda *a, **kw: meta.ddl(name, *a, **kw)
        return getattr(meta.catalog, name)


class DistributedStore:
    def __init__(self, meta: MetaClient, sc: Optional[StorageClient] = None):
        self.meta = meta
        self.sc = sc or StorageClient(meta)
        self._catalog_proxy = CatalogProxy(meta)
        # space → (epoch, vid_to_dense, dense_to_vid) from the last CSR
        # export; serves _SpaceView.dense_id for the device plane
        self._dense_cache: Dict[str, Any] = {}
        # exactly-once write identity: every storage.write
        # request carries (writer_id, seq); storaged's raft-replicated
        # dedup window recognizes a re-sent request and returns its
        # recorded outcome instead of double-applying
        self.writer_id = uuid.uuid4().hex[:16]
        self._wseq = itertools.count(1)
        # read-your-writes floors: per-(space, part) highest
        # raft index any write THROUGH THIS STORE was acked at (the ack
        # carries it — including dedup-retry acks, so the floor is
        # right even when the reply that carried the original index was
        # lost).  Follower/bounded_stale reads ship the floor as
        # `min_applied`; a replica may only serve once its apply covers
        # it.  Process-wide (all sessions of this graphd share the
        # store) — a superset of per-session tracking, never weaker.
        self._applied_floor: Dict[tuple, int] = {}
        import threading
        self._floor_lock = threading.Lock()
        # cluster cache epochs: set by GraphService to fold
        # write-ack store epochs into the engine's ClusterEpochs —
        # (space, epoch) -> None
        self.on_epoch_ack = None
        # device delta feed: dirty-key log per watched space.
        # Keys are noted BEFORE the writes ship (a crash mid-send leaves
        # a superset — harmless, apply re-reads per key); coverage
        # against OTHER writers is proven at delta_records time by the
        # storaged write census (writes_total vs writes_from this
        # writer_id since the watch baseline)
        self._delta_logs: Dict[str, Any] = {}
        self._delta_baseline: Dict[str, Dict[int, tuple]] = {}
        self._delta_lock = threading.Lock()

    def _token(self) -> List[Any]:
        return [self.writer_id, next(self._wseq)]

    def _dnote(self, space: str, *keys) -> None:
        """Record dirty identity keys on the space's delta log (no-op
        unless a device snapshot is watching)."""
        log = self._delta_logs.get(space)
        if log is None:
            return
        with self._delta_lock:
            for k in keys:
                log.note(k)

    def _dbreak(self, space: str) -> None:
        log = self._delta_logs.get(space)
        if log is not None:
            log.note_break()

    def _note_applied(self, space: str, pid: int, reply: Any):
        """Record a write ack's applied index as the part's
        read-your-writes floor (and its post-apply store epoch on the
        delta log, when one is watching — the group-commit ack path
        that keeps the device delta plane's freshness accounting
        current without extra RPCs)."""
        if not isinstance(reply, dict):
            return
        log = self._delta_logs.get(space)
        if log is not None and reply.get("epoch"):
            with self._delta_lock:
                log.note_epoch(pid, int(reply["epoch"]))
        if self.on_epoch_ack is not None and reply.get("epoch"):
            # cluster cache epochs: the ack's store epoch
            # folds into the engine's epoch vector immediately — the
            # WRITING coordinator's caches turn over at ack latency,
            # not heartbeat latency
            self.on_epoch_ack(space, reply["epoch"])
        idx = int(reply.get("applied") or 0)
        if idx <= 0:
            return
        key = (space, pid)
        with self._floor_lock:
            if idx > self._applied_floor.get(key, 0):
                self._applied_floor[key] = idx

    def _read_params(self, space: str, pid: int) -> Dict[str, Any]:
        """Per-part consistency params for one read call: the effective
        level (thread-local override, else the read_consistency flag)
        plus this part's read-your-writes floor for the non-leader
        levels.  Empty for `leader` — byte-identical wire frames to the
        client without consistency levels on the default path."""
        lvl = _consistency.effective_consistency()
        if lvl == _consistency.LEADER:
            return {}
        p: Dict[str, Any] = {"consistency": lvl}
        with self._floor_lock:
            floor = self._applied_floor.get((space, pid), 0)
        if floor:
            p["min_applied"] = floor
        return p

    @property
    def catalog(self):
        return self._catalog_proxy

    # ---- space lifecycle (DDL via metad) ----
    def create_space(self, name: str, **kw):
        self.meta.create_space(name, **kw)
        return self.catalog.get_space(name)

    def drop_space(self, name: str, if_exists=False):
        self._dbreak(name)
        self.meta.drop_space(name, if_exists=if_exists)
        # floors are keyed by space NAME: a dropped-and-recreated space
        # starts a fresh raft log, so stale floors would make its first
        # follower/bounded_stale reads wait for (or reject against) an
        # applied index the new group won't reach for a long time
        with self._floor_lock:
            for key in [k for k in self._applied_floor if k[0] == name]:
                del self._applied_floor[key]

    def clear_space(self, name: str, if_exists=False):
        """CLEAR SPACE across the cluster: one raft-replicated
        clear_part per partition (data gone on every replica), schema
        untouched."""
        from ..graphstore.schema import SchemaError
        try:
            self.catalog.get_space(name)
        except SchemaError:
            if if_exists:
                return
            raise
        self._dbreak(name)
        for pid in range(len(self.meta.parts_of(name))):
            self._write(name, pid, ("clear_part", pid))

    def space(self, name: str):
        """Minimal space info for executors (partition count, epoch)."""
        return _SpaceView(self, name)

    # ---- mutate ----
    def _write(self, space: str, pid: int, *cmds):
        # cat_ver: the issuer's catalog version rides along so a
        # storaged whose heartbeat-refreshed cache lags a just-issued
        # DDL refreshes BEFORE applying — otherwise a write landing in
        # the lag window applies without the new index/fulltext/TTL
        # schema state (silently missing derived entries)
        # the token is minted ONCE per logical request: replica-walk
        # retries re-send the same (writer_id, seq), which is what the
        # dedup window keys on
        r = self.sc._call_part(space, pid, "storage.write",
                               {"cmds": [to_wire(list(c)) for c in cmds],
                                "cat_ver": self.meta.version,
                                "token": self._token()})
        self._note_applied(space, pid, r)

    def _write_many(self, space: str, by_part: Dict[int, List[tuple]]):
        """One rpc_write per part — each part's command list becomes ONE
        batched raft proposal (group commit) — with parts fanned out in
        parallel over the StorageClient pool."""
        if not by_part:
            return
        if len(by_part) == 1:
            pid, cmds = next(iter(by_part.items()))
            self._write(space, pid, *cmds)
            return
        for pid, r in self.sc.fanout(
                space,
                {pid: {"cmds": [to_wire(list(c)) for c in cmds],
                       "cat_ver": self.meta.version,
                       "token": self._token()}
                 for pid, cmds in by_part.items()},
                "storage.write"):
            self._note_applied(space, pid, r)

    def insert_vertex(self, space: str, vid: Any, tag: str,
                      props: Dict[str, Any],
                      insert_names: Optional[List[str]] = None):
        self.insert_vertices(space, [(vid, tag, props, insert_names)])

    def insert_vertices(self, space: str,
                        rows: List[tuple]):
        """Batched INSERT VERTEX: rows is
        [(vid, tag, props, insert_names)].  The statement's writes are
        buffered per partition and shipped as ONE rpc_write per part
        (one batched raft proposal each), parts in parallel — instead
        of one RPC + one consensus round per row.  Per-vid write order
        is preserved: a vid always hashes to the same part, and order
        within a part's command list is the input order."""
        by_part: Dict[int, List[tuple]] = {}
        desc = self.catalog.get_space(space)
        for vid, tag, props, insert_names in rows:
            desc.check_vid(vid)
            sv = self.catalog.get_tag(space, tag).latest
            row = apply_defaults(sv, props, insert_names)
            by_part.setdefault(self.sc.part_of(space, vid), []).append(
                ("vertex", vid, tag, sv.version, row))
        self._dnote(space, *(("v", r[0]) for r in rows))
        self._write_many(space, by_part)

    def _chain_write(self, space: str, src: Any, dst: Any,
                     out_cmd: tuple, in_cmd: list):
        """TOSS chain with resume bookkeeping: the out-half part logs the
        in-half it owes before anything is applied; if this graphd dies
        mid-chain, the out-half leader's resume loop re-drives the
        in-half (storage_service._resume_chains).  In-half apply is
        idempotent, so the happy path completing the chain itself races
        safely with the janitor."""
        import time as _t
        import uuid
        cid = uuid.uuid4().hex
        src_pid = self.sc.part_of(space, src)
        dst_pid = self.sc.part_of(space, dst)
        # mark + out-half ride ONE raft entry: the journal must never
        # commit without the out-half it promises to mirror
        mark = ["chain_mark", src_pid, cid, dst_pid, in_cmd, _t.time()]
        fail.hit("toss:pre_out")
        self._write(space, src_pid, ("batch", [mark, list(out_cmd)]))
        # the torn-chain window: a crash here leaves the journal + out-
        # half committed with the in-half owed — the resume janitor's job
        fail.hit("toss:pre_in")
        self._write(space, dst_pid, tuple(in_cmd))
        fail.hit("toss:pre_done")
        self._write(space, src_pid, ("chain_done", src_pid, cid))

    def insert_edge(self, space: str, src: Any, etype: str, dst: Any,
                    rank: int, props: Dict[str, Any],
                    insert_names: Optional[List[str]] = None):
        self.insert_edges(space, etype, [(src, dst, rank, props)],
                          insert_names)

    def insert_edges(self, space: str, etype: str, rows: List[tuple],
                     insert_names: Optional[List[str]] = None):
        """Batched INSERT EDGE with coalesced TOSS chains:
        rows is [(src, dst, rank, props)].  Edges are grouped by
        (src_pid, dst_pid); each pair pays ONE chain — one raft entry
        with the chain mark + every out-half of the pair, one batched
        in-half command to the dst part, one chain_done — instead of a
        3-write chain per edge.  Each phase fans its parts out in
        parallel, and every per-part command list rides one batched
        proposal (group commit at the raft layer).

        Invariants preserved: the journal (chain_mark) commits in the
        SAME raft entry as the out-halves it promises to mirror; the
        in-half batch is idempotent per edge (same-row overwrite), so
        the resume janitor re-driving it converges; per-(src,dst)
        write order is input order (same pair → same group, ordered)."""
        import time as _t
        import uuid
        desc = self.catalog.get_space(space)
        sv = self.catalog.get_edge(space, etype).latest
        # (src_pid, dst_pid) → ([out-half cmds], [in-half cmds])
        groups: Dict[tuple, tuple] = {}
        n = 0
        for src, dst, rank, props in rows:
            desc.check_vid(src)
            desc.check_vid(dst)
            row = apply_defaults(sv, props, insert_names)
            key = (self.sc.part_of(space, src), self.sc.part_of(space, dst))
            outs, ins = groups.setdefault(key, ([], []))
            outs.append(["edge_half", src, etype, dst, rank, row, "out"])
            ins.append(["edge_half", src, etype, dst, rank, row, "in"])
            n += 1
        if not groups:
            return
        if n > len(groups):
            from ..utils.stats import stats as _stats
            _stats().inc("toss_chains_coalesced", n - len(groups))
        ts = _t.time()
        by_src: Dict[int, List[tuple]] = {}
        by_dst: Dict[int, List[tuple]] = {}
        dones: Dict[int, List[tuple]] = {}
        for (src_pid, dst_pid), (outs, ins) in groups.items():
            cid = uuid.uuid4().hex
            in_cmd = ["batch", ins] if len(ins) > 1 else ins[0]
            mark = ["chain_mark", src_pid, cid, dst_pid, in_cmd, ts]
            # mark + ALL the pair's out-halves ride ONE raft entry: the
            # journal must never commit without the out-halves it
            # promises to mirror (and vice versa)
            by_src.setdefault(src_pid, []).append(("batch", [mark] + outs))
            by_dst.setdefault(dst_pid, []).append(tuple(in_cmd))
            dones.setdefault(src_pid, []).append(
                ("chain_done", src_pid, cid))
        self._dnote(space, *(("e", etype, src, dst, rank)
                             for src, dst, rank, _props in rows))
        # out-halves (with journals) first — the source of truth — then
        # the in-halves, then the retirements.  The failpoints bracket
        # the two crash windows a batched TOSS chain has: after the
        # journaled out-halves (janitor re-drives the in-halves) and
        # after the in-halves (janitor retires stale journals)
        fail.hit("toss:pre_out")
        self._write_many(space, by_src)
        fail.hit("toss:pre_in")
        self._write_many(space, by_dst)
        fail.hit("toss:pre_done")
        self._write_many(space, dones)

    def delete_vertex(self, space: str, vid: Any, with_edges: bool = True):
        if with_edges:
            # collect both planes, then delete mirror halves on peer parts
            for (s, et, rank, other, _props, sd) in self.get_neighbors(
                    space, [vid], None, "both"):
                if sd > 0:      # out-edge vid→other; mirror in-half at other
                    self._dnote(space, ("e", et, vid, other, rank))
                    self._write(space, self.sc.part_of(space, other),
                                ("del_edge_half", vid, et, other, rank, "in"))
                else:           # in-edge other→vid; mirror out-half at other
                    self._dnote(space, ("e", et, other, vid, rank))
                    self._write(space, self.sc.part_of(space, other),
                                ("del_edge_half", other, et, vid, rank,
                                 "out"))
        self._dnote(space, ("v", vid))
        self._write(space, self.sc.part_of(space, vid), ("del_vertex", vid))

    def delete_tag(self, space: str, vid: Any, tags: List[str]):
        self._dnote(space, ("v", vid))
        self._write(space, self.sc.part_of(space, vid),
                    ("del_tag", vid, tags))

    def delete_edge(self, space: str, src: Any, etype: str, dst: Any,
                    rank: int):
        self._dnote(space, ("e", etype, src, dst, rank))
        self._chain_write(space, src, dst,
                          ("del_edge_half", src, etype, dst, rank, "out"),
                          ["del_edge_half", src, etype, dst, rank, "in"])

    def update_vertex(self, space: str, vid: Any, tag: str,
                      updates: Dict[str, Any]) -> bool:
        sv = self.catalog.get_tag(space, tag).latest
        for k in updates:
            if sv.prop(k) is None:
                raise SchemaError(f"unknown prop `{k}'")
        tv = self.get_vertex(space, vid)
        if tv is None or tag not in tv:
            return False
        self._dnote(space, ("v", vid))
        self._write(space, self.sc.part_of(space, vid),
                    ("upd_vertex", vid, tag, updates))
        return True

    def update_edge(self, space: str, src: Any, etype: str, dst: Any,
                    rank: int, updates: Dict[str, Any]) -> bool:
        sv = self.catalog.get_edge(space, etype).latest
        for k in updates:
            if sv.prop(k) is None:
                raise SchemaError(f"unknown prop `{k}'")
        if self.get_edge(space, src, etype, dst, rank) is None:
            return False
        self._dnote(space, ("e", etype, src, dst, rank))
        self._chain_write(
            space, src, dst,
            ("upd_edge_half", src, etype, dst, rank, updates, "out"),
            ["upd_edge_half", src, etype, dst, rank, updates, "in"])
        return True

    # ---- read ----
    # Rows are fill_row'd against THIS client's catalog too: the serving
    # storaged's cache may predate an ALTER ... ADD by one heartbeat,
    # while the DDL issuer's catalog is refreshed synchronously — the
    # reader's schema wins (read-side versioned-row upgrade, SURVEY §2
    # row 9).  Schema versions resolve ONCE per call (_sv_maps), and a
    # tag/edge the reader's catalog no longer lists is INVISIBLE — the
    # host path's dropped-schema semantics.

    def _sv_maps(self, space):
        """-> ({tag: latest}, {etype: latest}) for one read call."""
        tags = {t.name: t.latest for t in self.catalog.tags(space)}
        edges = {e.name: e.latest for e in self.catalog.edges(space)}
        return tags, edges

    def get_vertex(self, space: str, vid: Any):
        pid = self.sc.part_of(space, vid)
        r = self.sc._call_part(space, pid, "storage.get_vertex",
                               {"vid": to_wire(vid),
                                **self._read_params(space, pid)})
        if r is None:
            return None
        tag_svs, _ = self._sv_maps(space)
        out = {t: fill_row(tag_svs[t],
                           {k: from_wire(v) for k, v in row.items()})
               for t, row in r.items() if t in tag_svs}
        return out or None

    def get_edge(self, space: str, src: Any, etype: str, dst: Any,
                 rank: int = 0):
        pid = self.sc.part_of(space, src)
        r = self.sc._call_part(space, pid, "storage.get_edge",
                               {"src": to_wire(src), "etype": etype,
                                "dst": to_wire(dst), "rank": rank,
                                **self._read_params(space, pid)})
        if r is None:
            return None
        try:
            sv = self.catalog.get_edge(space, etype).latest
        except SchemaError:
            return None          # edge type dropped: rows invisible
        return fill_row(sv, {k: from_wire(v) for k, v in r.items()})

    def scan_vertices(self, space: str, tag: Optional[str] = None,
                      parts: Optional[Iterable[int]] = None):
        pids = list(parts) if parts is not None else self.sc.all_parts(space)
        tag_svs, _ = self._sv_maps(space)
        for pid, rows in self.sc.fanout(
                space, {p: {"tag": tag, **self._read_params(space, p)}
                        for p in pids},
                "storage.scan_vertices"):
            for vid, t, row in rows:
                sv = tag_svs.get(t)
                if sv is None:
                    continue     # tag dropped: rows invisible
                yield from_wire(vid), t, fill_row(
                    sv, {k: from_wire(v) for k, v in row.items()})

    def scan_edges(self, space: str, etype: Optional[str] = None,
                   parts: Optional[Iterable[int]] = None):
        pids = list(parts) if parts is not None else self.sc.all_parts(space)
        _, edge_svs = self._sv_maps(space)
        for pid, rows in self.sc.fanout(
                space, {p: {"etype": etype, **self._read_params(space, p)}
                        for p in pids},
                "storage.scan_edges"):
            for src, et, rank, dst, row in rows:
                sv = edge_svs.get(et)
                if sv is None:
                    continue     # edge type dropped: rows invisible
                yield from_wire(src), et, rank, from_wire(dst), \
                    fill_row(sv, {k: from_wire(v) for k, v in row.items()})

    def get_neighbors(self, space: str, vids: List[Any],
                      edge_types: Optional[List[str]] = None,
                      direction: str = "out",
                      edge_filter=None, limit_per_src: Optional[int] = None):
        """Same contract as GraphStore.get_neighbors, including row order
        (input vid order, etype name, then (rank, neighbor)).  A pushed
        edge_filter / limit ships to storaged as nGQL text and executes
        there — only surviving rows cross the RPC (SURVEY §2 row 12)."""
        from .pushdown import filter_to_wire
        _, edge_svs = self._sv_maps(space)
        ftext = filter_to_wire(edge_filter)
        by_part = self.sc.split_by_part(space, vids)
        results = dict(self.sc.fanout(
            space,
            {pid: {"vids": to_wire(pvids), "edge_types": edge_types,
                   "direction": direction, "filter": ftext,
                   "limit_per_src": limit_per_src,
                   **self._read_params(space, pid)}
             for pid, pvids in by_part.items()},
            "storage.get_neighbors"))
        # merge preserving input vid order: index rows per (vid, dir)
        from ..utils.stats import current_work
        wc = current_work()
        if wc is not None:
            # edges shipped over the wire = edges this hop examined
            # post-pushdown: the cluster host path's deterministic
            # edges-traversed work count
            n_rows = sum(rows["n"] if isinstance(rows, dict)
                         else len(rows) for rows in results.values())
            wc.add("edges_traversed", n_rows)
            wc.add("storage_rows", n_rows)
        per_vid: Dict[Any, List] = {}
        for pid, rows in results.items():
            if isinstance(rows, dict):
                # columnar reply: typed blobs decode straight
                # to numpy and materialize with C-level tolist()s — no
                # per-cell from_wire, no per-row fill_row
                for row in _decode_neighbors_columnar(rows, edge_svs):
                    per_vid.setdefault(repr(row[0]), []).append(row)
                continue
            for (src, et, rank, other, props, sd) in rows:
                src_v = from_wire(src)
                sv = edge_svs.get(et)
                if sv is None:
                    continue     # edge type dropped: rows invisible
                per_vid.setdefault(repr(src_v), []).append(
                    (src_v, et, rank, from_wire(other),
                     fill_row(sv, {k: from_wire(v)
                                   for k, v in props.items()}), sd))
        for vid in vids:
            for row in per_vid.get(repr(vid), []):
                yield row

    def index_scan(self, space: str, index_name: str, eq_prefix: List[Any],
                   range_hint=None, parts: Optional[List[int]] = None):
        from ..graphstore.index import _Sentinel
        rng = None
        if range_hint is not None:
            # open bounds ride as JSON null — a real bound can't be None
            # (null predicates are rejected at hint extraction)
            lo, hi, li, hi_inc = range_hint
            lo = None if isinstance(lo, _Sentinel) else to_wire(lo)
            hi = None if isinstance(hi, _Sentinel) else to_wire(hi)
            rng = [lo, hi, li, hi_inc]
        pids = list(parts) if parts is not None else self.sc.all_parts(space)
        out: List[Any] = []
        for pid, ents in self.sc.fanout(
                space, {p: {"index": index_name, "eq": to_wire(eq_prefix),
                            "range": rng,
                            **self._read_params(space, p)} for p in pids},
                "storage.index_scan"):
            for e in ents:
                v = from_wire(e)
                out.append(tuple(v) if isinstance(v, list) else v)
        return out

    def index_scan_geo(self, space: str, index_name: str,
                       ranges: List[tuple],
                       parts: Optional[List[int]] = None):
        """Geo token-range scan fan-out; ranges are plain int pairs
        (wire-safe as JSON lists)."""
        pids = list(parts) if parts is not None else self.sc.all_parts(space)
        out: List[Any] = []
        for pid, ents in self.sc.fanout(
                space, {p: {"index": index_name,
                            "ranges": [list(r) for r in ranges],
                            **self._read_params(space, p)}
                        for p in pids},
                "storage.index_scan_geo"):
            for e in ents:
                v = from_wire(e)
                out.append(tuple(v) if isinstance(v, list) else v)
        return out

    def rebuild_index(self, space: str, index_name: str,
                      parts: Optional[List[int]] = None) -> int:
        pids = list(parts) if parts is not None else self.sc.all_parts(space)
        total = 0
        # cat_ver: the issuer validated the index against ITS catalog —
        # a storaged with an older cache must refresh before the rebuild
        # or apply fails "index not found" (same contract as writes)
        for pid, n in self.sc.fanout(
                space, {p: {"index": index_name,
                            "cat_ver": self.meta.version} for p in pids},
                "storage.rebuild_index"):
            total += n
        return total

    def _ft_want_id(self, space: str, index_name: str) -> int:
        """This client's (DDL-fresh) view of the index generation —
        shipped with the RPC so a storaged whose catalog cache predates a
        DROP+re-CREATE refreshes instead of serving the old incarnation."""
        d = next((x for x in self.catalog.fulltext_indexes(space)
                  if x.name == index_name), None)
        return d.index_id if d is not None else -1

    def fulltext_search(self, space: str, index_name: str, op: str,
                        pattern: str,
                        parts: Optional[List[int]] = None) -> List[Any]:
        pids = list(parts) if parts is not None else self.sc.all_parts(space)
        want = self._ft_want_id(space, index_name)
        out: List[Any] = []
        for pid, ents in self.sc.fanout(
                space, {p: {"index": index_name, "op": op,
                            "pattern": pattern, "want_id": want,
                            **self._read_params(space, p)}
                        for p in pids},
                "storage.fulltext_search"):
            for e in ents:
                v = from_wire(e)
                out.append(tuple(v) if isinstance(v, list) else v)
        return out

    def rebuild_fulltext_index(self, space: str, index_name: str,
                               parts: Optional[List[int]] = None) -> int:
        pids = list(parts) if parts is not None else self.sc.all_parts(space)
        want = self._ft_want_id(space, index_name)
        return sum(n for _, n in self.sc.fanout(
            space, {p: {"index": index_name, "want_id": want}
                    for p in pids},
            "storage.rebuild_fulltext"))

    # ---- device delta feed: dirty-key log over the write
    # census.  The log alone can only vouch for writes THROUGH THIS
    # STORE; coverage against other writers is proven per part by the
    # storaged census — (writes_total − baseline) must equal
    # (writes_from_me − baseline), else the keys are incomplete and
    # the runtime full-rebuilds. ----

    def _census_probe(self, space: str) -> Dict[int, tuple]:
        """Per-part (epoch, writes_total, writes_from_me) fan-out."""
        pids = self.sc.all_parts(space)
        per = dict(self.sc.fanout(
            space, {p: {"writer": self.writer_id} for p in pids},
            "storage.part_stats"))
        return {pid: (int(r.get("epoch", 0)),
                      int(r.get("writes_total", 0)),
                      int(r.get("writes_from", 0)))
                for pid, r in per.items()}

    def delta_watch(self, space: str, cap: int = 65536) -> int:
        from ..graphstore.delta import DeltaLog
        probe = self._census_probe(space)
        epoch = max((e for e, _t, _m in probe.values()), default=0)
        with self._delta_lock:
            log = self._delta_logs.get(space)
            if log is None or log.broken:
                # an unbroken log keeps watching across re-watches
                # (compaction rebuilds must not reset the floor or the
                # census baseline out from under the serving snapshot)
                self._delta_logs[space] = DeltaLog(floor_epoch=epoch,
                                                  cap=cap)
                self._delta_baseline[space] = {
                    pid: (t, m) for pid, (_e, t, m) in probe.items()}
        return epoch

    def delta_records(self, space: str):
        """-> (keys, target_epoch, floor_epoch), or None when the log
        cannot vouch for completeness (never watched / broken / census
        shows a foreign writer) — the caller full-rebuilds."""
        log = self._delta_logs.get(space)
        if log is None:
            return None
        try:
            probe = self._census_probe(space)
        except Exception:  # noqa: BLE001 — RPC trouble: rebuild decides
            return None
        base = self._delta_baseline.get(space) or {}
        covered = set(probe) == set(base)
        if covered:
            for pid, (_e, t, m) in probe.items():
                t0, m0 = base[pid]
                if t < t0 or m < m0 or (t - t0) != (m - m0):
                    covered = False     # foreign writes (or failover
                    break               # census reset): keys incomplete
        with self._delta_lock:
            if log.broken:
                return None
            if not covered:
                log.note_break()
                return None
            # keys snapshot AFTER the census probe: a write of ours
            # landing in between adds a key (superset-safe) but not its
            # epoch — applied_epoch lands below sd.epoch and the next
            # pin probe catches up; a FOREIGN write in the window bumps
            # the epoch past target, so the next probe re-runs this
            # census and breaks.  Either way no stale read is served.
            keys = list(log.keys)
            floor = log.floor_epoch
        target = max((e for e, _t, _m in probe.values()), default=0)
        return keys, target, floor

    def delta_trim(self, space: str, keys) -> None:
        with self._delta_lock:
            log = self._delta_logs.get(space)
            if log is not None:
                log.trim(keys)

    def delta_reader(self, space: str):
        return _ClusterDeltaReader(self, space)

    # ---- device plane: bulk CSR export (the north-star storage
    # addition; SURVEY §2 row 12 + BASELINE.json) ----

    def build_csr_snapshot(self, space: str, vmax_extra: int = 0):
        """Assemble a CsrSnapshot for the WHOLE space from per-part
        `storage.export_part` bulk exports — the cluster analog of
        build_snapshot over a local SpaceData.  The graphd's GpuRuntime
        pins the result, and passes the vmax slack its own delta plane
        needs as `vmax_extra` (the reference reads it from the flags
        `tpu_delta_max_edges` and `tpu_delta_vmax_slack`, which the
        port's runtime takes as constructor arguments instead); writes
        bump part epochs, and the runtime's epoch probe folds them in or
        re-exports (epoch-based re-pin, SURVEY §5).

        Per-part exports are taken under each leader's lock but NOT
        atomically across parts — the same read consistency as the
        reference's per-partition storage reads."""
        from ..graphstore.csr import build_snapshot
        from ..graphstore.store import SpaceData

        desc = self.catalog.get_space(space)
        sd = SpaceData(desc)
        # epoch BEFORE the export: a write racing the per-part fan-out
        # bumps some leader's epoch past this value, so the runtime's
        # next probe re-exports (stamping the post-export epoch instead
        # would let a snapshot claim data it missed, forever)
        epoch_before = self.stats(space)["epoch"]
        pids = self.sc.all_parts(space)
        for pid, payload in self.sc.fanout(
                space, {p: {} for p in pids}, "storage.export_part"):
            st = from_wire(payload)
            p = sd.parts[pid]
            p.vertices = st["vertices"]
            p.out_edges = st["out_edges"]
            p.in_edges = st["in_edges"]
            sd.part_counts[pid] = st["part_count"]
            sd.install_dense(st["dense"])
        sd.epoch = epoch_before

        class _Shim:
            """Duck-typed store for build_snapshot: catalog + one space."""

            def __init__(self, catalog, sdata):
                self.catalog = catalog
                self._sd = sdata

            def space(self, _name):
                return self._sd

        snap = build_snapshot(_Shim(self.meta.catalog, sd), space,
                              vmax_extra=vmax_extra)
        # the space view serves dense-id lookups from this export (the
        # device data plane's vid dictionary); part_counts ride along so
        # the delta reader can mint dense ids for post-export vids
        self._dense_cache[space] = (sd.epoch, sd.vid_to_dense,
                                    sd.dense_to_vid, sd.part_counts)
        return snap

    def stats_detail(self, space: str) -> Dict[str, Dict[str, int]]:
        """Per-tag / per-edge-type counts aggregated over part leaders
        (SHOW STATS per-schema rows)."""
        pids = self.sc.all_parts(space)
        tags: Dict[str, int] = {}
        edges: Dict[str, int] = {}
        vertices = 0
        for pid, r in self.sc.fanout(
                space, {p: {"detail": True} for p in pids},
                "storage.part_stats"):
            d = r.get("detail") or {}
            vertices += d.get("vertices", 0)
            for t, n in (d.get("tags") or {}).items():
                tags[t] = tags.get(t, 0) + n
            for et, n in (d.get("edges") or {}).items():
                edges[et] = edges.get(et, 0) + n
        return {"tags": tags, "edges": edges, "vertices": vertices,
                "total_edges": sum(edges.values())}

    def stats(self, space: str) -> Dict[str, Any]:
        pids = self.sc.all_parts(space)
        per = dict(self.sc.fanout(space, {p: {} for p in pids},
                                  "storage.part_stats"))
        return {
            "space": space,
            "partition_num": len(pids),
            "vertices": sum(r["vertices"] for r in per.values()),
            "edges": sum(r["edges"] for r in per.values()),
            "epoch": max((r["epoch"] for r in per.values()), default=0),
            "per_part_edges": [per[p]["edges"] for p in pids],
        }


class _SpaceView:
    """Duck-typed SpaceData stand-in for the few executor uses."""

    def __init__(self, ds: DistributedStore, name: str):
        self._ds = ds
        self.name = name
        self.desc = ds.catalog.get_space(name)

    @property
    def num_parts(self) -> int:
        return len(self._ds.meta.parts_of(self.name))

    def part_of(self, vid: Any) -> int:
        return stable_vid_hash(vid) % self.num_parts

    @property
    def epoch(self) -> int:
        return self._ds.stats(self.name)["epoch"]

    @property
    def uid(self):
        """The space's identity for the device plane's pin cache: this
        store and the metad's space id, which a space dropped and created
        again under the same name does not share (its epochs may repeat
        the old one's, so the epoch alone would serve the old pin)."""
        return (id(self._ds), self.desc.space_id)

    # -- device-plane vid dictionary (filled by build_csr_snapshot; the
    # runtime always pins BEFORE resolving seeds, so queries see the
    # mapping of the snapshot they execute against) --

    def dense_id(self, vid: Any, create: bool = False) -> int:
        cache = self._ds._dense_cache.get(self.name)
        if cache is None:
            return -1
        return cache[1].get(vid, -1)

    def vid_of_dense(self, dense: int) -> Any:
        cache = self._ds._dense_cache.get(self.name)
        if cache is None:
            return None
        d2v = cache[2]
        if 0 <= dense < len(d2v):
            return d2v[dense]
        return None


class _ClusterDeltaReader:
    """Re-read adapter over the cluster for HostDelta.apply: identity
    keys resolve through leader-consistency point reads (get_vertex /
    get_edge RPCs), so the mirror folds in exactly the committed state.

    Dense ids come from the last CSR export's dictionary; a vid minted
    since then gets the next local row of its part — self-consistent
    within the pinned snapshot, which is all the mirror needs (the next
    full rebuild re-derives the authoritative mapping).  A mint for a
    phantom key (edge inserted and deleted between applies) wastes one
    vmax-slack row at worst; overflow degrades to a rebuild."""

    def __init__(self, ds: DistributedStore, space: str):
        cache = ds._dense_cache.get(space)
        if cache is None or len(cache) < 4:
            from ..graphstore.delta import DeltaUnsupported
            raise DeltaUnsupported("no CSR export to map dense ids from")
        self.ds = ds
        self.space = space
        self._v2d = cache[1]
        self._d2v = cache[2]
        self._counts = cache[3]
        self._P = len(ds.meta.parts_of(space))

    def dense_of(self, vid) -> Optional[int]:
        d = self._v2d.get(vid)
        if d is not None:
            return int(d)
        p = stable_vid_hash(vid) % self._P
        d = self._counts[p] * self._P + p
        self._counts[p] += 1
        self._v2d[vid] = d
        need = d + 1 - len(self._d2v)
        if need > 0:
            self._d2v.extend([None] * need)
        self._d2v[d] = vid
        return d

    def edge_row(self, etype, src, dst, rank):
        try:
            sv = self.ds.catalog.get_edge(self.space, etype).latest
        except SchemaError:
            return None, None           # dropped edge type: invisible
        row = self.ds.get_edge(self.space, src, etype, dst, rank)
        return row, sv

    def vertex_rows(self, vid) -> Dict[str, Dict[str, Any]]:
        return self.ds.get_vertex(self.space, vid) or {}

    def tag_schema(self, tag):
        try:
            return self.ds.catalog.get_tag(self.space, tag).latest
        except SchemaError:
            return None
