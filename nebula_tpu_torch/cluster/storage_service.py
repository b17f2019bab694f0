"""The port's copy of `nebula_tpu/cluster/storage_service.py`, whole.

Storage service — one storaged host.

Owns the partitions the meta part map assigns to it, replicates writes
through one Raft group per (space, part), serves reads at the caller's
requested consistency level — lease-gated leader reads by default,
read-index follower reads and bounded-staleness local reads on request
(`_read_part`; the raftex lease/read-index lineage).  Analog
of the reference's StorageServer + processors over
NebulaStore/RaftPart (reference: src/storage + src/kvstore); the
storage op set mirrors storage.thrift
(SURVEY §2 rows 6, 12, 13).

Ops are part-local: graphd resolves schema defaults and splits edge
writes into out/in halves (TOSS chain) before routing, so the raft
command stream of a part replays deterministically on its replicas.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..core import wire
from ..core.wire import from_wire, to_wire
from ..graphstore.store import GraphStore
from ..utils import cancel as _cancel
from ..utils import consistency as _consistency
from ..utils import trace as _trace
from ..utils.config import get_config
from ..utils.failpoints import fail
from .meta_client import MetaClient
from .raft import RaftPart
from .rpc import RpcError, RpcRaftTransport, RpcServer

_STORAGE_OPS = frozenset({
    "vertex", "edge_half", "del_vertex", "del_edge_half", "upd_vertex",
    "upd_edge_half", "del_tag", "rebuild_index", "rebuild_fulltext",
    "chain_mark", "chain_done", "batch", "clear_part"})


class BoundedErrorMap:
    """(group, idx) → apply-error string, bounded with insertion-order
    eviction.

    The consumer contract is pop-on-ack (rpc_write claims its indices'
    errors after propose returns), but a propose that TIMES OUT returns
    None while its entry can still commit and fail apply later — that
    error is never claimed.  An unbounded dict therefore leaks one
    entry per timed-out-then-failed write for the life of the process
   ; this map evicts the oldest records past `cap`
    instead."""

    def __init__(self, cap: int = 1024):
        from collections import OrderedDict
        self.cap = cap
        self._d: "OrderedDict[Tuple[str, int], str]" = OrderedDict()
        self._lock = threading.Lock()

    def record(self, key: Tuple[str, int], err: str):
        with self._lock:
            self._d.pop(key, None)
            self._d[key] = err
            while len(self._d) > self.cap:
                self._d.popitem(last=False)

    def pop(self, key: Tuple[str, int], default=None):
        with self._lock:
            return self._d.pop(key, default)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d


def _validate_cmd(cmd) -> tuple:
    """Decode-check a client write command BEFORE it reaches consensus —
    a malformed entry must be rejected at the RPC boundary, never
    committed where replay would poison every replica's apply loop."""
    decoded = tuple(from_wire(cmd))
    if not decoded or decoded[0] not in _STORAGE_OPS:
        raise RpcError(f"unknown storage op {decoded[0] if decoded else None!r}")
    if decoded[0] == "batch":
        for sub in decoded[1]:
            sub = tuple(sub)
            if not sub or sub[0] not in _STORAGE_OPS or sub[0] == "batch":
                raise RpcError(f"bad batch sub-op {sub[:1]!r}")
    return decoded


class _ReadBucket:
    """Token bucket behind `storage_read_capacity_qps`: a
    per-storaged read admission rate.  Over-rate reads shed with the
    structured E_OVERLOAD + a retry-after priced at the bucket's
    refill — so a follower-readable client walks to a replica with
    spare capacity NOW instead of waiting this one out."""

    __slots__ = ("_tokens", "_t", "_mu")

    def __init__(self):
        self._tokens = 0.0
        self._t = 0.0
        self._mu = threading.Lock()

    def take(self, rate: float) -> Optional[float]:
        """None = admitted; else seconds until a token frees up."""
        import time as _t
        now = _t.monotonic()
        burst = max(rate / 10.0, 8.0)
        with self._mu:
            if self._t == 0.0:
                self._tokens, self._t = burst, now
            else:
                self._tokens = min(self._tokens
                                   + (now - self._t) * rate, burst)
                self._t = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return None
            return max((1.0 - self._tokens) / rate, 0.001)


def _neighbors_columnar(raw) -> Optional[Dict[str, Any]]:
    """Columnar wire form of a get_neighbors reply: when the
    scan is single-edge-type with int vids and schema-uniform prop rows
    — the GO/MATCH bulk shape — ship src/rank/dst/sd and each prop as
    ONE typed blob instead of one JSON row per edge.  Row order is
    preserved column-wise.  Returns None for small or mixed replies
    (legacy row encoding)."""
    n = len(raw)
    if n < 64:
        return None
    from ..core.wire import encode_column
    et0 = raw[0][1]
    keys0 = tuple(raw[0][4])
    for (_, et, _, _, props, _) in raw:
        if et is not et0 and et != et0:
            return None
        if tuple(props) != keys0:
            return None                   # mixed schema versions: rows
    src = encode_column([r[0] for r in raw])
    dst = encode_column([r[3] for r in raw])
    if src is None or dst is None or src["dt"] != "<i8" \
            or dst["dt"] != "<i8":
        return None                       # string vids: legacy rows
    rank = encode_column([r[2] for r in raw])
    sd = encode_column([r[5] for r in raw])
    if rank is None or sd is None:
        return None
    pcols: Dict[str, Any] = {}
    for i, k in enumerate(keys0):
        col = [r[4][k] for r in raw]
        enc = encode_column(col)
        pcols[k] = enc if enc is not None \
            else {"v": [to_wire(x) for x in col]}
    return {"cols": True, "n": n, "et": et0, "src": src, "rank": rank,
            "dst": dst, "sd": sd, "props": pcols}


class StorageService:
    def __init__(self, my_addr: str, meta: MetaClient, data_dir: str,
                 server: RpcServer):
        self.my_addr = my_addr
        self.meta = meta
        self.data_dir = data_dir
        self.store = GraphStore(catalog=meta.catalog)
        self.parts: Dict[Tuple[int, int], RaftPart] = {}   # (space_id, pid)
        from ..utils.racecheck import make_lock
        self.parts_lock = make_lock("storage_parts")
        self._resume_alive = False
        self._resume_thread: Optional[threading.Thread] = None
        # (group, idx) → error string for entries whose apply failed;
        # checked by rpc_write so a client is never acked for a write
        # that did not actually land.  Bounded: a timed-out propose
        # never claims its error (see BoundedErrorMap).
        self._apply_errors = BoundedErrorMap()
        # per-part write census (device delta feed): applied raft
        # entries counted per writer token.  A graphd's delta log can
        # only trust its dirty keys if EVERY write since its watch came
        # through it — rpc_part_stats ships (total, from-you) counts so
        # the client proves exactly that before skipping a re-pin.
        # Counts are apply-side (replayed on restart, replica-local);
        # a snapshot-install or failover skews them only toward
        # MISmatch, which degrades to a full rebuild — never staleness.
        self._write_census: Dict[Tuple[str, int], Dict[Any, int]] = {}
        self._census_lock = threading.Lock()
        self._read_bucket = _ReadBucket()
        # per-partition heat map: read/write QPS + latency
        # EWMAs per (space, part), snapshotted onto the heartbeat so
        # metad can rank hotspots cluster-wide (SHOW HOTSPOTS) and the
        # replica router / BALANCE planner can consult heat_of()
        from ..utils.insights import PartHeatTable
        self.part_heat = PartHeatTable()
        # cluster-coherent cache epochs: per-space store
        # epochs ride the heartbeat as (boot, epoch, bump_ts).  boot_id
        # distinguishes this process incarnation — store epochs reset on
        # restart, and the graphd-side fold must treat a restarted
        # host's low epoch as news, not as a regression.
        import uuid
        self.boot_id = uuid.uuid4().hex[:12]
        from ..utils.epochs import EpochClock
        self._epoch_clock = EpochClock()
        self.transport = RpcRaftTransport()
        self.server = server
        server.service_role = "storaged"
        server.register_service(self, prefix="storage.")
        # raft traffic for all my part groups rides the same server
        from .rpc import serve_raft_parts

        class _Groups(dict):
            def get(inner, key, default=None):  # noqa: N805
                return self._group_by_name(key)
        serve_raft_parts(server, _Groups())
        meta._hb_parts_fn = self.owned_parts
        meta.on_refresh = self.reconcile_parts

    # -- part lifecycle ---------------------------------------------------

    def _group_name(self, space_id: int, pid: int) -> str:
        return f"s{space_id}p{pid}"

    def _group_by_name(self, name: str) -> Optional[RaftPart]:
        with self.parts_lock:
            for (sid, pid), part in self.parts.items():
                if self._group_name(sid, pid) == name:
                    return part
        # raft message for a part we should own but haven't created yet
        self.reconcile_parts()
        with self.parts_lock:
            for (sid, pid), part in self.parts.items():
                if self._group_name(sid, pid) == name:
                    return part
        return None

    def owned_parts(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        with self.parts_lock:
            for (sid, pid) in self.parts:
                name = next((n for n, sp in self.meta.catalog.spaces.items()
                             if sp.space_id == sid), str(sid))
                out.setdefault(name, []).append(pid)
        return out

    def reconcile_parts(self):
        """Create/update/drop raft groups to match the meta part map.

        BALANCE DATA changes the map; this reconciliation is what makes
        the change real on each storaged: new replicas spin up a raft
        member (and catch up via leader snapshot install), existing
        members adopt the new peer set, and replicas no longer in the
        map stop serving and release the part's state."""
        self.store.catalog = self.meta.catalog
        with self.meta.lock:
            pm = dict(self.meta.part_map)
            lm = {sp: [list(ls) for ls in lss]
                  for sp, lss in self.meta.learner_map.items()}
        sid_to_name = {sp.space_id: n
                       for n, sp in self.meta.catalog.spaces.items()}
        for space_name, parts in pm.items():
            sp = self.meta.catalog.spaces.get(space_name)
            if sp is None:
                continue
            sp_learners = lm.get(space_name, [])
            for pid, replicas in enumerate(parts):
                learners = list(sp_learners[pid]) \
                    if pid < len(sp_learners) else []
                if self.my_addr not in replicas \
                        and self.my_addr not in learners:
                    continue
                key = (sp.space_id, pid)
                with self.parts_lock:
                    existing = self.parts.get(key)
                    if existing is not None:
                        # adopting the new config may PROMOTE a learner
                        #: from here its acks count toward
                        # quorum and it may vote
                        existing.update_peers(list(replicas), learners)
                        continue
                    gname = self._group_name(sp.space_id, pid)
                    part = RaftPart(
                        gname, self.my_addr, list(replicas), self.transport,
                        os.path.join(self.data_dir, "wal"),
                        apply_cb=self._make_apply(space_name, pid, gname),
                        # part state IS the raft snapshot: bounds WAL
                        # replay on restart + serves laggard catch-up
                        snapshot_cb=self._make_snapshot(space_name, pid),
                        restore_cb=self._make_restore(space_name, pid),
                        snapshot_threshold=2000,
                        learners=learners)
                    self.parts[key] = part
                part.start()
        # drop parts this host no longer replicates — pop under the lock,
        # stop/clear OUTSIDE it (stop joins threads for up to 2s and
        # clear rebuilds indexes; holding parts_lock across that would
        # stall every concurrent write/raft-route on this host)
        dropped = []
        with self.parts_lock:
            for key in list(self.parts):
                sid, pid = key
                name = sid_to_name.get(sid)
                space_parts = pm.get(name, []) if name else []
                replicas = space_parts[pid] if pid < len(space_parts) \
                    else None
                sp_l = lm.get(name, []) if name else []
                learners = sp_l[pid] if pid < len(sp_l) else []
                if replicas is None or (self.my_addr not in replicas
                                        and self.my_addr not in learners):
                    dropped.append((self.parts.pop(key), name, pid))
        for part, name, pid in dropped:
            part.stop()
            if name is not None:
                try:
                    self.store.clear_part(name, pid)
                except Exception:  # noqa: BLE001 — space dropped
                    pass

    def _make_snapshot(self, space_name: str, pid: int):
        def snap() -> bytes:
            return self.store.export_part_state(space_name, pid)
        return snap

    def _make_restore(self, space_name: str, pid: int):
        def restore(data: bytes):
            if data:
                self.store.install_part_state(space_name, pid, data)
        return restore

    def _make_apply(self, space_name: str, pid: int, group: str):
        def apply(idx: int, data: bytes):
            # entries are wire-JSON (peers can inject raft traffic; an
            # unpickler here would be remote code execution).  A bad
            # entry must never kill the raft thread (it would re-crash
            # on every restart replay); the failure is recorded so the
            # leader's rpc_write can refuse to ack it.  Commands are
            # deterministic, so replicas fail identically — no
            # divergence from skipping.
            writer = None
            try:
                cmd = tuple(wire.loads(data))
                if cmd and cmd[0] == "v":
                    # version-stamped entry: best-effort catalog sync
                    # before apply (a failed refresh degrades to the
                    # old stale-cache behavior, never stalls the log)
                    if cmd[1] > self.meta.version:
                        try:
                            self.meta.refresh(force=True)
                        except Exception:  # noqa: BLE001
                            pass
                    cmd = tuple(cmd[2])
                if cmd and cmd[0] == "dbatch":
                    writer = cmd[2]
                self._apply_cmd(space_name, cmd)
            except Exception as ex:      # noqa: BLE001
                from ..utils.stats import stats
                stats().inc("storage_apply_errors")
                self._apply_errors.record((group, idx), str(ex))
            finally:
                # epoch bump-timestamp: every applied entry
                # may have advanced the space epoch — stamp the advance
                # so the heartbeat can ship a true bump ts and graphds
                # measure propagation lag, not heartbeat cadence.
                # Apply-side, so followers stamp their own applies too.
                try:
                    self._epoch_clock.note(
                        space_name, self.store.space(space_name).epoch)
                except Exception:  # noqa: BLE001 — space dropped mid-apply
                    pass
                # census counts EVERY entry, applied or failed, dedup-
                # skipped or not — symmetry is what matters: the client
                # compares (total - baseline) against (mine - baseline),
                # so any uniform counting rule works, and over-breaking
                # only costs a rebuild
                with self._census_lock:
                    c = self._write_census.setdefault(
                        (space_name, pid), {"total": 0})
                    c["total"] += 1
                    if writer is not None:
                        c[writer] = c.get(writer, 0) + 1
        return apply

    def _apply_cmd(self, space: str, cmd: Tuple):
        op = cmd[0]
        st = self.store
        if op == "batch":
            # one raft entry, several ops: TOSS chain_mark + out-half
            # must commit atomically or the journal could promise an
            # in-half whose out-half never landed
            for sub in cmd[1]:
                self._apply_cmd(space, tuple(sub))
        elif op == "dbatch":
            # exactly-once apply gate: a tokened write request
            # rides the log as ONE entry; a duplicate proposal of the
            # same (writer, seq) — client re-send after a lost reply,
            # racing the original's commit under a new leader — is
            # recognized HERE, deterministically on every replica, and
            # skipped.  This is what makes the mid-call-abort →
            # replica-walk-retry flip safe.
            _, pid, writer, seq, cmds = cmd
            self._apply_dbatch(space, pid, writer, seq, cmds)
        elif op == "vertex":
            _, vid, tag, ver, row = cmd
            st.apply_vertex(space, vid, tag, ver, row)
        elif op == "edge_half":
            _, src, etype, dst, rank, row, which = cmd
            st.apply_edge_half(space, src, etype, dst, rank, row, which)
        elif op == "del_vertex":
            st.apply_delete_vertex(space, cmd[1])
        elif op == "del_edge_half":
            _, src, etype, dst, rank, which = cmd
            st.apply_delete_edge_half(space, src, etype, dst, rank, which)
        elif op == "upd_vertex":
            _, vid, tag, updates = cmd
            st.apply_update_vertex(space, vid, tag, updates)
        elif op == "upd_edge_half":
            _, src, etype, dst, rank, updates, which = cmd
            st.apply_update_edge_half(space, src, etype, dst, rank,
                                      updates, which)
        elif op == "del_tag":
            st.delete_tag(space, cmd[1], cmd[2])
        elif op == "clear_part":
            st.clear_part(space, cmd[1])
        elif op == "rebuild_index":
            st.rebuild_index(space, cmd[1], parts=[cmd[2]])
        elif op == "rebuild_fulltext":
            st.rebuild_fulltext_index(space, cmd[1], parts=[cmd[2]])
        elif op == "chain_mark":
            _, pid, cid, in_pid, in_cmd, ts = cmd
            st.apply_chain_mark(space, pid, cid,
                                {"part": in_pid, "cmd": list(in_cmd),
                                 "ts": ts})
        elif op == "chain_done":
            st.apply_chain_done(space, cmd[1], cmd[2])
        else:
            raise ValueError(f"unknown storage op {op!r}")

    def _apply_dbatch(self, space: str, pid: int, writer: str, seq: int,
                      cmds):
        from ..utils.stats import stats
        rec = self.store.dedup_seen(space, pid, writer, seq)
        if rec is not None:
            # already applied (the original proposal committed despite
            # the client's lost reply): exact-once means NO re-apply —
            # and the skip must report the SAME outcome the original
            # recorded, including its failure (silently succeeding here
            # would ack the retry of a write whose apply FAILED)
            stats().inc("storage_write_dedup_apply_skips")
            if rec.get("err"):
                raise ValueError(rec["err"])
            return
        errs = []
        for sub in cmds:
            try:
                self._apply_cmd(space, tuple(sub))
            except Exception as ex:      # noqa: BLE001
                errs.append(str(ex))
        # the outcome (including a per-command apply failure) is part of
        # the record: a deduped retry must report the SAME result the
        # original would have
        self.store.dedup_record(space, pid, writer, seq,
                                {"n": len(cmds),
                                 "err": errs[0] if errs else None})
        if errs:
            raise ValueError(errs[0] + (f" (+{len(errs) - 1} more)"
                                        if len(errs) > 1 else ""))

    def epochs_for_heartbeat(self) -> Dict[str, list]:
        """{space: [boot_id, epoch, bump_ts]} for every space with local
        data — the per-host leg of the cluster epoch vector.
        bump_ts is None for an epoch that advanced outside the apply
        path's clock (no lag sample for it, never a wrong one)."""
        out: Dict[str, list] = {}
        for sd in list(self.store.data.values()):
            ep = sd.epoch
            if ep <= 0:
                continue
            name = sd.desc.name
            out[name] = [self.boot_id, ep, self._epoch_clock.ts_for(name, ep)]
        return out

    def start(self):
        self.meta.start_heartbeat(parts_fn=self.owned_parts,
                                  heat_fn=self.part_heat.snapshot,
                                  epochs_fn=self.epochs_for_heartbeat)
        self._resume_alive = True
        self._resume_thread = threading.Thread(
            target=self._chain_resume_loop, daemon=True,
            name=f"toss-resume-{self.my_addr}")
        self._resume_thread.start()

    def stop(self):
        self._resume_alive = False
        self.meta.stop_heartbeat()
        with self.parts_lock:
            for p in self.parts.values():
                p.stop()

    # -- TOSS chain resume (SURVEY §2 row 14) ----------------------------

    CHAIN_GRACE_S = 2.0      # graphd normally finishes the chain itself

    def _chain_resume_loop(self):
        import time as _t
        while self._resume_alive:
            _t.sleep(0.5)
            try:
                self._resume_chains()
            except Exception:    # noqa: BLE001 — keep the janitor alive
                pass

    def _resume_chains(self):
        """Finish TOSS chains whose graphd died between the two halves:
        the out-half part leader re-drives the recorded in-half to the
        dst part, then retires the journal entry through its own log.

        Batched chains (dstore coalesces one chain per
        (src_pid, dst_pid) pair) journal their in-half as a single
        `batch` command covering every edge of the pair — re-driving it
        is idempotent per edge (same-row overwrite), so a chain the
        graphd actually finished, or a janitor pass that raced another
        replica's, converges to the same state.  The chain_done
        retirements for one part ride ONE batched proposal."""
        import time as _t
        from .storage_client import StorageClient
        with self.parts_lock:
            items = list(self.parts.items())
        now = _t.time()
        sc = None
        for (sid, pid), part in items:
            if not part.is_leader():
                continue
            space = next((n for n, sp in self.meta.catalog.spaces.items()
                          if sp.space_id == sid), None)
            if space is None:
                continue
            done = []
            for cid, entry in self.store.pending_chains(space, pid).items():
                if now - entry.get("ts", 0.0) < self.CHAIN_GRACE_S:
                    continue
                if sc is None:
                    sc = StorageClient(self.meta)
                # in-half apply is idempotent (same row overwrite), so
                # re-driving a chain the graphd actually finished is safe
                sc._call_part(space, entry["part"], "storage.write",
                              {"cmds": [to_wire(list(entry["cmd"]))],
                               "cat_ver": self.meta.version})
                done.append(wire.dumps(("chain_done", pid, cid)))
            if done:
                part.propose_batch(done)
                from ..utils.stats import stats
                stats().inc("toss_chains_resumed", len(done))

    # -- helpers ----------------------------------------------------------

    def _local_part(self, space: str, pid: int) -> RaftPart:
        sp = self.meta.catalog.spaces.get(space)
        if sp is None:
            self.meta.refresh(force=True)
            sp = self.meta.catalog.spaces.get(space)
            if sp is None:
                raise RpcError(f"space `{space}' not found")
        part = self.parts.get((sp.space_id, pid))
        if part is None:
            self.reconcile_parts()
            part = self.parts.get((sp.space_id, pid))
        if part is None:
            raise RpcError(f"part {pid} of `{space}' not hosted here")
        return part

    def _leader_part(self, space: str, pid: int,
                     lease: bool = True) -> RaftPart:
        part = self._local_part(space, pid)
        if not part.is_leader():
            raise RpcError(f"part_leader_changed: {part.leader_id or ''}")
        if lease and not part.has_lease():
            # deposed-but-unaware leader (minority side of a partition)
            # must not serve stale reads; client retries elsewhere
            # (writes skip this: propose itself fails safely without quorum)
            raise RpcError(f"part_leader_changed: {part.leader_id or ''}")
        return part

    def _read_part(self, space: str, pid: int, p) -> RaftPart:
        """Serve-or-reject gate for a read RPC at its requested
        consistency level.

          leader        — today's lease-gated leader read (default).
          follower      — read-index: obtain a read barrier from the
                          leader (lease fast path / quorum confirm /
                          follower forward) and wait for LOCAL apply to
                          reach it, so the reply observes everything
                          committed before the read started.
          bounded_stale — serve purely locally while this replica heard
                          from a live leader within read_max_stale_ms
                          AND its applied index covers the caller's
                          read-your-writes floor (`min_applied`); else
                          reject with a structured E_STALE + lag hint
                          and the client walks to a fresher replica.

        Successful non-leader-consistency serves stamp the serving
        replica + applied index into the statement's trace (the
        `storage:follower_read` phase rides the reply envelope) and
        count into the reply cost record (`follower_reads`)."""
        from ..utils.stats import current_cost, stats
        try:
            cap = float(get_config().get("storage_read_capacity_qps"))
        except Exception:  # noqa: BLE001 — config not initialized
            cap = 0.0
        if cap > 0:
            retry = self._read_bucket.take(cap)
            if retry is not None:
                from ..utils.admission import overload_error
                stats().inc_labeled("overload_server_rejections",
                                    {"op": "storage.read_capacity",
                                     "role": "storaged"})
                raise RpcError(overload_error(
                    retry, "storaged:read_capacity",
                    f"read capacity {cap:g}/s exhausted"))
        lvl = p.get("consistency") or _consistency.LEADER
        if lvl == _consistency.LEADER:
            part = self._leader_part(space, pid)
            self._heat_read(space, pid)
            return part
        if lvl not in _consistency.LEVELS:
            raise RpcError(f"unknown consistency level {lvl!r}")
        part = self._local_part(space, pid)
        if part.node_id in part.learners:
            # a catching-up learner serves NOTHING — not even
            # bounded_stale: its applied index is mid-install and the
            # part map never routes here, so any arrival is a stale map
            raise RpcError(f"part_leader_changed: {part.leader_id or ''}")
        fail.hit("storage:follower_read", key=f"{part.group}|{lvl}")
        min_applied = int(p.get("min_applied") or 0)
        if lvl == _consistency.BOUNDED_STALE:
            part._apply_committed()       # drain locally-known commits
            lag_s = part.leader_contact_age()
            try:
                bound_ms = float(get_config().get("read_max_stale_ms"))
            except Exception:  # noqa: BLE001 — config not initialized
                bound_ms = 5000.0
            lag_ms = int(min(lag_s * 1e3, 10 ** 9))
            applied = part.applied_index()
            if lag_ms > bound_ms or applied < min_applied:
                stats().inc("stale_read_rejects")
                raise RpcError(
                    f"E_STALE: replica lag {lag_ms}ms over bound "
                    f"{int(bound_ms)}ms (applied={applied}, "
                    f"min_applied={min_applied}); lag_ms={lag_ms}")
        else:                             # follower: read-index
            idx = part.read_index()
            if idx is None:
                # no leader reachable/confirmed: same walk contract as
                # a leader change — the client tries the next replica
                raise RpcError(
                    f"part_leader_changed: {part.leader_id or ''}")
            target = max(idx, min_applied)
            if part.applied_index() < target:
                stats().inc("read_index_waits")
                rem = _cancel.remaining()
                timeout = min(rem, 5.0) if rem is not None else 5.0
                if not part.wait_applied(target,
                                         timeout=max(timeout, 0.001)):
                    raise RpcError(
                        f"part_leader_changed: {part.leader_id or ''}")
        stats().inc_labeled("follower_read_total", {"consistency": lvl})
        _trace.record_phase("storage:follower_read", 0.0, part=pid,
                            addr=self.my_addr, consistency=lvl,
                            applied=part.applied_index())
        cc = current_cost()
        if cc is not None:
            cc.add("follower_reads", 1)
        self._heat_read(space, pid)
        return part

    def _heat_read(self, space: str, pid: int):
        """Heat is SERVED load: bumped only when the gate admits — a
        client walking replicas for the leader must not triple-count
        one logical read across the part's hosts."""
        from ..utils.insights import StatementRegistry
        if StatementRegistry.enabled():
            self.part_heat.record_read(space, pid)

    # -- write RPCs: {"space", "part", "cmds": [wire-encoded tuples]} -----

    def rpc_write(self, p):
        space, pid = p["space"], p["part"]
        cat_ver = p.get("cat_ver", -1)
        if cat_ver > self.meta.version:
            # the write issuer has seen newer DDL than our cache:
            # refresh first so derived state (indexes/fulltext/TTL)
            # is maintained against the schema the writer validated on
            self.meta.refresh(force=True)
        part = self._leader_part(space, pid, lease=False)
        # cmds arrive wire-encoded; decode-validate ALL of them BEFORE
        # propose (a malformed command must fail the whole request up
        # front, not poison the log or land after committed siblings),
        # then the raft entries store the canonical wire form —
        # version-stamped so FOLLOWERS apply against a catalog at
        # least as new as the issuer's (the leader-only RPC check
        # would leave replica index state stale until failover)
        ver = max(cat_ver, self.meta.version)
        tok = p.get("token")
        if tok is not None:
            # exactly-once: the request's (writer_id, seq)
            # token gates a fast-path ack — if the ORIGINAL send already
            # applied (reply lost, client walked to us), return its
            # recorded outcome instead of re-proposing.  The window is
            # replicated state (written in dbatch apply), so this check
            # is correct on a freshly-failed-over leader too; the
            # _apply_committed() brings the window up to this leader's
            # commit index first.  Even a miss here is safe: the dbatch
            # apply gate skips duplicates deterministically.
            writer, seq = tok[0], int(tok[1])
            part._apply_committed()
            rec = self.store.dedup_seen(space, pid, writer, seq)
            if rec is not None:
                from ..utils.stats import current_cost, stats
                stats().inc("storage_write_dedup_hits")
                # trace + cost coverage: the fast-
                # path hit is a zero-duration leaf in the statement's
                # trace (shipped back in the reply spans) and a
                # `dedup_hits` field in the reply cost record
                _trace.record_phase("storage:dedup_hit", 0.0, part=pid,
                                    writer=writer, seq=seq)
                cc = current_cost()
                if cc is not None:
                    cc.add("dedup_hits", 1)
                if rec.get("err"):
                    raise RpcError(f"write apply failed: {rec['err']}")
                # applied index rides the ack: the original
                # proposal is applied locally (_apply_committed above),
                # so last_applied covers it — the caller's per-part
                # read-your-writes floor even on the dedup-retry path
                return {"n": rec.get("n", len(p["cmds"])),
                        "applied": part.applied_index(),
                        "epoch": self.store.space(space).epoch}
            stamped = [wire.dumps(
                ("v", ver, ["dbatch", pid, writer, seq,
                            [list(_validate_cmd(c)) for c in p["cmds"]]]))]
        else:
            stamped = [wire.dumps(("v", ver, list(_validate_cmd(cmd))))
                       for cmd in p["cmds"]]
        # chaos hook: the leader-kill-mid-batch schedule arms a crash
        # callable here — the request is validated but not yet proposed
        fail.hit("storage:pre_propose", key=part.group)
        # ONE batched proposal for the request: one WAL sync + one
        # replication wake for N commands (group commit)
        import time as _t
        t0 = _t.monotonic()
        with _trace.span("raft:propose_batch", group=part.group,
                         entries=len(stamped)):
            idxs = part.propose_batch(stamped)
        if idxs is None:
            raise RpcError("part_leader_changed: write not committed")
        from ..utils.insights import StatementRegistry
        if StatementRegistry.enabled():
            self.part_heat.record_write(
                space, pid, rows=len(p["cmds"]),
                latency_us=(_t.monotonic() - t0) * 1e6)
        # per-entry apply semantics are unchanged: any command whose
        # apply failed fails the request — a client is never acked for
        # a write that did not actually land
        errs = [e for e in (self._apply_errors.pop((part.group, i))
                            for i in idxs) if e is not None]
        if errs:
            raise RpcError(f"write apply failed: {errs[0]}"
                           + (f" (+{len(errs) - 1} more)"
                              if len(errs) > 1 else ""))
        # the ack carries the write's raft index (propose_batch applies
        # before returning): clients record it as the part's
        # read-your-writes floor for follower/bounded_stale reads —
        # plus the post-apply store epoch, the group-commit ack path
        # that feeds the device delta plane's freshness accounting
        return {"n": len(p["cmds"]), "applied": idxs[-1],
                "epoch": self.store.space(space).epoch}

    # -- read RPCs (consistency-gated via _read_part) --------------------

    def rpc_get_neighbors(self, p):
        """The storage exec DAG's scan stage + pushed-down filter/limit
        (SURVEY §2 row 12): a WHERE the graphd marked pushable arrives as
        nGQL text, parses once, and drops rows BEFORE they reach the
        wire — the candidate set never ships."""
        from .pushdown import apply_edge_filter, filter_from_wire
        space, pid = p["space"], p["part"]
        self._read_part(space, pid, p)
        vids = from_wire(p["vids"])
        edge_filter = filter_from_wire(p.get("filter"))
        limit = p.get("limit_per_src")
        with _trace.span("store:get_neighbors", space=space, part=pid,
                         vids=len(vids)) as sp_rec:
            it = self.store.get_neighbors(
                space, vids, p.get("edge_types"),
                p.get("direction", "out"))
            if edge_filter is not None or limit is not None:
                etypes = p.get("edge_types") or sorted(
                    e.name for e in self.store.catalog.edges(space))
                etype_ids = {et: self.store.catalog.get_edge(space,
                                                             et).edge_type
                             for et in etypes}
                it = apply_edge_filter(it, space, edge_filter, etype_ids,
                                       limit,
                                       stats_prefix="storage_pushdown")
            raw = list(it)
            # per-hop cost record: the reply envelope tells
            # the coordinator how many rows this part produced — the
            # remote half of PROFILE's per-node attribution
            self._cost_rows(len(raw))
            cols = _neighbors_columnar(raw)
            if cols is not None:
                if sp_rec is not None:
                    sp_rec.setdefault("attrs", {})["rows"] = cols["n"]
                return cols
            rows = []
            for (src, et, rank, other, props, sd) in raw:
                rows.append([to_wire(src), et, rank, to_wire(other),
                             {k: to_wire(v) for k, v in props.items()},
                             sd])
            if sp_rec is not None:
                sp_rec.setdefault("attrs", {})["rows"] = len(rows)
        return rows

    def rpc_get_vertex(self, p):
        self._read_part(p["space"], p["part"], p)
        tv = self.store.get_vertex(p["space"], from_wire(p["vid"]))
        if tv is None:
            return None
        return {t: {k: to_wire(v) for k, v in row.items()}
                for t, row in tv.items()}

    def rpc_get_edge(self, p):
        self._read_part(p["space"], p["part"], p)
        row = self.store.get_edge(p["space"], from_wire(p["src"]),
                                  p["etype"], from_wire(p["dst"]),
                                  p.get("rank", 0))
        if row is None:
            return None
        return {k: to_wire(v) for k, v in row.items()}

    @staticmethod
    def _cost_rows(n: int):
        from ..utils.stats import current_cost
        cc = current_cost()
        if cc is not None:
            cc.add("rows", n)

    def rpc_scan_vertices(self, p):
        self._read_part(p["space"], p["part"], p)
        out = []
        for vid, tag, row in self.store.scan_vertices(
                p["space"], p.get("tag"), parts=[p["part"]]):
            out.append([to_wire(vid), tag,
                        {k: to_wire(v) for k, v in row.items()}])
        self._cost_rows(len(out))
        return out

    def rpc_scan_edges(self, p):
        self._read_part(p["space"], p["part"], p)
        out = []
        for src, et, rank, dst, row in self.store.scan_edges(
                p["space"], p.get("etype"), parts=[p["part"]]):
            out.append([to_wire(src), et, rank, to_wire(dst),
                        {k: to_wire(v) for k, v in row.items()}])
        self._cost_rows(len(out))
        return out

    def rpc_index_scan(self, p):
        self._read_part(p["space"], p["part"], p)
        rng = p.get("range")
        if rng is not None:
            from ..graphstore.index import MAX, MIN
            lo, hi, li, hi_inc = rng
            lo = MIN if lo is None else from_wire(lo)
            hi = MAX if hi is None else from_wire(hi)
            rng = (lo, hi, li, hi_inc)
        ents = self.store.index_scan(p["space"], p["index"],
                                     from_wire(p["eq"]), rng,
                                     parts=[p["part"]])
        self._cost_rows(len(ents))
        return [to_wire(list(e) if isinstance(e, tuple) else e)
                for e in ents]

    def rpc_index_scan_geo(self, p):
        self._read_part(p["space"], p["part"], p)
        ents = self.store.index_scan_geo(
            p["space"], p["index"], [tuple(r) for r in p["ranges"]],
            parts=[p["part"]])
        return [to_wire(list(e) if isinstance(e, tuple) else e)
                for e in ents]

    def rpc_rebuild_index(self, p):
        # rebuild rides the part's raft log so replicas backfill too —
        # followers must serve identical index state after failover.
        # Version-stamped like rpc_write: the issuer has just seen the
        # CREATE INDEX DDL, so a storaged whose catalog cache predates
        # it must refresh BEFORE applying or the rebuild raises "index
        # not found" inside apply (swallowed) and the job reports
        # FINISHED over an empty index.
        cat_ver = p.get("cat_ver", -1)
        if cat_ver > self.meta.version:
            self.meta.refresh(force=True)
        part = self._leader_part(p["space"], p["part"])
        data = wire.dumps(("v", max(cat_ver, self.meta.version),
                           ["rebuild_index", p["index"], p["part"]]))
        if part.propose(data) is None:
            raise RpcError("part_leader_changed: rebuild not committed")
        sd = self.store.space(p["space"])
        idx = sd.index_data.get(p["index"])
        return len(idx.parts[p["part"]]) if idx is not None else 0

    def _ft_catalog_sync(self, p):
        """Force-refresh the catalog cache when the caller's view of the
        index generation (want_id) is newer — a search right after
        DROP + re-CREATE must not serve the old incarnation."""
        want = p.get("want_id")
        if want is None:
            return
        try:
            d = next((x for x in self.store.catalog.fulltext_indexes(
                p["space"]) if x.name == p["index"]), None)
        except Exception:  # noqa: BLE001 — space unknown to stale cache
            d = None
        if d is None or d.index_id != want:
            self.meta.refresh(force=True)

    def rpc_fulltext_search(self, p):
        """Text-search one part's slice of the full-text sink (SURVEY
        §2 row 10 Listener; the ES-query hop of the reference)."""
        self._read_part(p["space"], p["part"], p)
        self._ft_catalog_sync(p)
        ents = self.store.fulltext_search(p["space"], p["index"],
                                          p["op"], p["pattern"],
                                          parts=[p["part"]])
        return [to_wire(list(e) if isinstance(e, tuple) else e)
                for e in ents]

    def rpc_rebuild_fulltext(self, p):
        part = self._leader_part(p["space"], p["part"])
        self._ft_catalog_sync(p)
        # version-stamped for the same follower-staleness reason as
        # rpc_rebuild_index (the _ft_catalog_sync above only fixes the
        # leader's cache)
        data = wire.dumps(("v", self.meta.version,
                           ["rebuild_fulltext", p["index"], p["part"]]))
        if part.propose(data) is None:
            raise RpcError("part_leader_changed: rebuild not committed")
        sd = self.store.space(p["space"])
        ft = sd.ft_data.get(p["index"])
        return len(ft.values[p["part"]]) if ft is not None else 0

    def rpc_part_stats(self, p):
        if p.get("detail"):
            # per-schema counts are served authoritatively by the
            # leader by default (a lagging follower would under-count)
            # but honor an explicit weaker consistency; the plain
            # totals/epoch probe stays replica-readable so device
            # epoch checks survive a failover window
            self._read_part(p["space"], p["part"], p)
        sd = self.store.space(p["space"])
        pid = p["part"]
        part = sd.parts[pid]
        out = {"vertices": len(part.vertices),
               "edges": part.edge_count(), "epoch": sd.epoch}
        if "writer" in p:
            # delta-feed coverage probe: how many raft entries has this
            # part applied in total, and how many carried the asking
            # writer's token — equality of the two deltas since a
            # baseline proves no foreign writes slipped past the
            # asker's dirty-key log
            with self._census_lock:
                c = self._write_census.get((p["space"], pid)) or {}
                out["writes_total"] = c.get("total", 0)
                out["writes_from"] = c.get(p["writer"], 0)
        if p.get("detail"):
            out["detail"] = self.store.stats_detail(p["space"],
                                                    parts=[pid])
        return out

    def rpc_part_raft_info(self, p):
        """Raft progress of one local part replica — the BALANCE
        orchestrator polls this to decide a new replica has caught up
        before removing the old one."""
        sp = self.meta.catalog.spaces.get(p["space"])
        part = self.parts.get((sp.space_id, p["part"])) if sp else None
        if part is None or not part.alive:
            # a STOPPED part must answer like a missing one: its state
            # fields freeze at stop time (`state` can still read
            # "leader"), and a membership engine that believed a
            # zombie's leadership would anchor catch-up on a commit
            # index nobody serves anymore
            raise RpcError(f"part {p['space']}/{p['part']} not here")
        with part.lock:
            return {"is_leader": part.state == "leader",
                    "is_learner": part.node_id in part.learners,
                    "learners": list(part.learners),
                    "term": part.current_term,
                    "commit_index": part.commit_index,
                    "last_applied": part.last_applied,
                    "last_index": part.wal.last_index(),
                    "snap_index": part.snap_index}

    def rpc_transfer_part_leader(self, p):
        """BALANCE LEADER: step aside for the named replica."""
        sp = self.meta.catalog.spaces.get(p["space"])
        part = self.parts.get((sp.space_id, p["part"])) if sp else None
        if part is None:
            raise RpcError(f"part {p['space']}/{p['part']} not here")
        if not part.is_leader():
            return {"ok": False, "reason": "not leader"}
        return {"ok": part.transfer_leadership(p["to"])}

    def rpc_reconcile(self, p):
        """Meta part-map changed (balance) — re-align local raft groups
        now instead of waiting for the next heartbeat."""
        self.meta.refresh(force=True)
        self.reconcile_parts()
        return True

    def rpc_export_part(self, p):
        """Bulk CSR export of one part — the north-star storage addition
        (the device plane pins partitions from these; BASELINE.json).
        Same payload vocabulary as the raft snapshot/checkpoint
        (GraphStore.part_state_payload) so the formats cannot drift."""
        self._leader_part(p["space"], p["part"])
        return to_wire(self.store.part_state_payload(p["space"],
                                                     p["part"]))
