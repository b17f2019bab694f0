"""The port's copy of `nebula_tpu/cluster/raft.py`, whole.

Raft consensus — the replication layer of the host (control) plane.

Analog of the reference's raftex (RaftPart / Host / leader election /
log replication / snapshot transfer; reference: src/kvstore/raftex).
Correctness-grade Python per SURVEY §2c: replication is not on the
device hot path — metad catalog and
the storage write path ride it, reads are served from leader state.

One RaftPart per (space, partition) — or one for the whole meta store.
Pluggable transport: LoopbackTransport for in-proc multi-node tests
(with fault-injection hooks: drop/partition/delay, SURVEY §5), RPC
transport for real deployments.
"""
from __future__ import annotations

import base64
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import trace as _trace
from ..utils.config import define_flag, get_config
from ..utils.failpoints import FailpointError, fail
from .wal import Wal

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"

define_flag("raft_max_batch", 64,
            "max entries per append_entries round (also the per-round "
            "unit of transfer_leadership catch-up); the group-commit "
            "replication batch ceiling")

define_flag("raft_lease_margin_ms", 25.0,
            "clock-skew safety margin subtracted from the minimum "
            "election timeout when judging the leader lease: a lease "
            "read is only served while a majority acked within "
            "(min_election_timeout - margin).  A margin >= the "
            "election timeout disables the lease fast path entirely "
            "(every read-index falls back to a quorum round)")

define_flag("raft_election_timeout_ms", 150.0,
            "lower end of a member's randomized election timeout (the "
            "upper end is twice it) when the constructor names none; "
            "also the leader lease's window.  Raft stays live only while "
            "a heartbeat round trip is well under it: a cluster whose "
            "daemons share one interpreter under load needs seconds")

define_flag("raft_heartbeat_interval_ms", 50.0,
            "leader heartbeat period when the constructor names none")

# raft_commit_latency_ms buckets (milliseconds — consensus rounds, not
# the µs RPC scale of LATENCY_BUCKETS_US)
COMMIT_LATENCY_BUCKETS_MS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                             100.0, 250.0, 500.0, 1_000.0, 5_000.0)
# raft_replication_batch_size buckets (entries per append_entries round)
REPL_BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                      256.0, 512.0, 1_024.0)


class RaftTransport:
    """send() returns the peer's reply dict, or None on failure."""

    def send(self, peer: str, group: str, method: str,
             payload: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        raise NotImplementedError


class LoopbackTransport(RaftTransport):
    """In-process transport — multi-'node' raft in one process, with
    fault injection (the reference tests raft the same way: multiple
    RaftPart instances over local thrift)."""

    def __init__(self):
        self.parts: Dict[Tuple[str, str], "RaftPart"] = {}
        self.dropped: set = set()        # (src, dst) pairs that drop
        self.delay_s = 0.0
        self.lock = threading.Lock()

    def register(self, part: "RaftPart"):
        with self.lock:
            self.parts[(part.node_id, part.group)] = part

    def partition(self, a: str, b: str):
        """Cut both directions between nodes a and b."""
        self.dropped.add((a, b))
        self.dropped.add((b, a))

    def heal(self, a: Optional[str] = None, b: Optional[str] = None):
        if a is None:
            self.dropped.clear()
        else:
            self.dropped.discard((a, b))
            self.dropped.discard((b, a))

    def send(self, peer, group, method, payload):
        src = payload.get("_from", "")
        if (src, peer) in self.dropped:
            return None
        if self.delay_s:
            time.sleep(self.delay_s)
        with self.lock:
            part = self.parts.get((peer, group))
        if part is None or not part.alive:
            return None
        return part.handle(method, payload)


def _flag_s(name: str, default: float) -> float:
    """A millisecond flag in seconds; `default` before config is up."""
    try:
        return float(get_config().get(name)) / 1e3
    except Exception:  # noqa: BLE001 — config not initialized
        return default


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


class RaftPart:
    """One consensus group member.

    apply_cb(index, data: bytes) is invoked in commit order exactly once
    per entry per process lifetime (replays from WAL on restart unless a
    snapshot covers them).
    snapshot_cb() -> bytes / restore_cb(bytes) enable log compaction and
    laggard catch-up.
    """

    def __init__(self, group: str, node_id: str, peers: List[str],
                 transport: RaftTransport, wal_dir: str,
                 apply_cb: Callable[[int, bytes], None],
                 snapshot_cb: Optional[Callable[[], bytes]] = None,
                 restore_cb: Optional[Callable[[bytes], None]] = None,
                 election_timeout: Optional[Tuple[float, float]] = None,
                 heartbeat_interval: Optional[float] = None,
                 snapshot_threshold: int = 10_000,
                 wal_sync: bool = True,
                 learners: Optional[List[str]] = None):
        self.group = group
        self.node_id = node_id
        # voting members ONLY — quorum math (elections, commit advance,
        # lease) runs over `peers`; learners ride replication but never
        # count (repair can never wedge a live group)
        self.peers = [p for p in peers if p != node_id]
        # learner (non-voting) replicas: receive append_entries and
        # snapshot install like followers, but are invisible to every
        # quorum computation and never campaign or grant votes until
        # promoted (update_peers moves them into the voter set)
        self.learners = [l for l in (learners or []) if l not in self.peers]
        self.transport = transport
        self.apply_cb = apply_cb
        self.snapshot_cb = snapshot_cb
        self.restore_cb = restore_cb
        if election_timeout is None:
            lo = _flag_s("raft_election_timeout_ms", 0.15)
            election_timeout = (lo, 2 * lo)
        self.eto = election_timeout
        self.hb = heartbeat_interval if heartbeat_interval is not None \
            else _flag_s("raft_heartbeat_interval_ms", 0.05)
        self.snapshot_threshold = snapshot_threshold

        os.makedirs(wal_dir, exist_ok=True)
        # sync=True: an acked append must survive power loss — commit
        # durability depends on a majority of fsynced logs
        self.wal = Wal(os.path.join(wal_dir, f"{group}.wal"),
                       sync=wal_sync)
        self._meta_path = os.path.join(wal_dir, f"{group}.meta")
        self.current_term = 0
        self.voted_for: Optional[str] = None
        self.snap_index = 0
        self.snap_term = 0
        self._load_meta()
        if self.snap_index and self.wal.last_index() < self.snap_index:
            # snapshot compaction emptied the WAL before this restart —
            # re-anchor it past the snapshot or a new leadership here
            # would append at index 1 and never commit
            self.wal.reset(self.snap_index + 1)

        self.state = FOLLOWER
        self.leader_id: Optional[str] = None
        self.commit_index = self.snap_index
        self.last_applied = self.snap_index
        # when this replica last heard from a live leader (append_entries
        # / snapshot install) — the staleness clock bounded_stale reads
        # are judged against; 0.0 = never
        self._leader_contact = 0.0
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}

        self.lock = threading.RLock()
        self.commit_cv = threading.Condition(self.lock)
        self._repl_cv = threading.Condition(self.lock)
        self._repl_threads: Dict[str, threading.Thread] = {}
        self._last_ack: Dict[str, float] = {}   # peer → send time of the
        #   last request that got a reply (lease freshness is measured
        #   from SEND: the follower's no-vote promise starts no later)
        # serializes apply_cb across the three callers (run loop, propose,
        # append_entries handler) so entries apply in commit order and a
        # propose's result is recorded before propose returns
        self._apply_mu = threading.Lock()
        self.alive = False
        self._deadline = 0.0
        self._last_hb = 0.0
        self._thread: Optional[threading.Thread] = None

        if isinstance(transport, LoopbackTransport):
            transport.register(self)

    # -- persistence of (term, vote, snapshot meta) -----------------------

    def _load_meta(self):
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                parts = f.read().split("\n")
            self.current_term = int(parts[0])
            self.voted_for = parts[1] or None
            if len(parts) > 3:
                self.snap_index, self.snap_term = int(parts[2]), int(parts[3])
        snap_file = self._meta_path + ".snap"
        if self.snap_index and self.restore_cb and os.path.exists(snap_file):
            with open(snap_file, "rb") as f:
                self.restore_cb(f.read())

    def _save_meta(self):
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{self.current_term}\n{self.voted_for or ''}\n"
                    f"{self.snap_index}\n{self.snap_term}")
        os.replace(tmp, self._meta_path)

    # -- lifecycle --------------------------------------------------------

    def start(self):
        with self.lock:
            if self.alive:
                return
            self.alive = True
            self._reset_election_deadline()
            # replay unapplied committed entries is not needed: commit
            # index is volatile; entries re-commit via the leader
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=f"raft-{self.group}-{self.node_id}")
            self._thread.start()

    def stop(self):
        with self.lock:
            self.alive = False
            self.leader_id = None       # don't hint callers at ourselves
        if self._thread:
            self._thread.join(timeout=2)
        self.wal.close()

    def _reset_election_deadline(self):
        self._deadline = time.monotonic() + random.uniform(*self.eto)

    # -- main loop --------------------------------------------------------

    def _run(self):
        while True:
            with self.lock:
                if not self.alive:
                    return
                state = self.state
                now = time.monotonic()
                want_election = state != LEADER and now >= self._deadline
                want_hb = state == LEADER and now - self._last_hb >= self.hb
            if want_election:
                self._start_election()
            elif want_hb:
                self._replicate_all()
            self._apply_committed()
            time.sleep(0.01)

    # -- election ---------------------------------------------------------

    def _start_election(self):
        with self.lock:
            if self.node_id in self.learners:
                # a learner NEVER campaigns: it holds no vote, and a
                # catching-up replica's (complete-looking) log must not
                # be able to take leadership from the live voters
                self._reset_election_deadline()
                return
            if len(self.peers) == 0:
                # single-node group: become leader immediately
                self.current_term += 1
                self.voted_for = self.node_id
                self._save_meta()
                self._become_leader()
                return
            self.state = CANDIDATE
            self.current_term += 1
            self.voted_for = self.node_id
            self._save_meta()
            term = self.current_term
            lli, llt = self._last_log()
            self._reset_election_deadline()
        # ask all peers concurrently: one unreachable peer (transport
        # timeout ≫ election timeout) must not stall the votes of the
        # healthy majority; leadership is taken as soon as a quorum grants
        votes = [1]
        votes_mu = threading.Lock()

        def ask(p):
            r = self.transport.send(p, self.group, "request_vote", {
                "_from": self.node_id, "term": term,
                "candidate": self.node_id,
                "last_log_index": lli, "last_log_term": llt})
            if r is None:
                return
            with self.lock:
                if r["term"] > self.current_term:
                    self._step_down(r["term"])
                    return
                if self.state != CANDIDATE or self.current_term != term:
                    return
                if r.get("granted"):
                    with votes_mu:
                        votes[0] += 1
                        n = votes[0]
                    if n * 2 > len(self.peers) + 1:
                        self._become_leader()

        # fire-and-forget: the ask threads tally votes and take
        # leadership themselves on quorum; joining here would stall the
        # run loop (and the new leader's first heartbeats) behind the
        # slowest/deadest peer's transport timeout
        for p in self.peers:
            threading.Thread(target=ask, args=(p,), daemon=True,
                             name=f"raft-vote-{self.node_id}").start()

    def _become_leader(self):
        self.state = LEADER
        self.leader_id = self.node_id
        # no-op entry in the new term: replicating it is what lets
        # _advance_commit (current-term-only, §5.4.2) re-commit the
        # previous terms' entries after a full-group restart
        self.wal.append(self.wal.last_index() + 1, self.current_term, b"")
        nxt = self.wal.last_index() + 1
        self.next_index = {p: nxt - 1 for p in self._repl_targets()}
        self.match_index = {p: 0 for p in self._repl_targets()}
        self._last_hb = 0.0
        if not self.peers:
            self.commit_index = self.wal.last_index()
            self.commit_cv.notify_all()

    def _step_down(self, term: int):
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self._save_meta()
        self.state = FOLLOWER
        self._reset_election_deadline()

    def _last_log(self) -> Tuple[int, int]:
        lli = self.wal.last_index()
        if lli <= self.snap_index:
            return self.snap_index, self.snap_term
        return lli, self.wal.last_term()

    # -- replication ------------------------------------------------------

    def _repl_targets(self) -> List[str]:
        """Everything the leader ships entries to: voting peers plus
        learner replicas (which receive appends/snapshot install but
        never count toward the quorum _advance_commit computes)."""
        return self.peers + [l for l in self.learners
                             if l != self.node_id and l not in self.peers]

    def _replicate_all(self):
        """Kick the per-peer replicator threads.

        A slow or dead peer (transport timeout ≫ heartbeat interval) must
        never delay heartbeats to healthy followers — each peer has its
        own persistent replicator thread (no per-tick thread churn), and
        requests to a stuck peer can't stack up: the loop serializes
        sends per peer.
        """
        with self.lock:
            if self.state != LEADER:
                return
            self._last_hb = time.monotonic()
            for p in self._repl_targets():
                t = self._repl_threads.get(p)
                if t is None or not t.is_alive():
                    t = threading.Thread(
                        target=self._peer_loop, args=(p,), daemon=True,
                        name=f"raft-repl-{self.node_id}-{p}")
                    self._repl_threads[p] = t
                    t.start()
            self._repl_cv.notify_all()
        self._advance_commit()

    def _peer_loop(self, peer: str):
        """Persistent replicator for one follower; exits on step-down or
        when the peer leaves the configuration (update_peers)."""
        while True:
            with self.lock:
                if not self.alive or self.state != LEADER \
                        or peer not in self._repl_targets():
                    return
            ok = self._replicate_one(peer)
            self._advance_commit()
            with self._repl_cv:
                # a propose() notify that landed while we were mid-send
                # must not cost a full heartbeat of commit latency: skip
                # the wait when unreplicated entries are pending — but
                # ONLY if the peer answered the last send (otherwise a
                # dead peer + pending entries = a busy-spin hammering
                # the transport at full speed)
                if ok and self.alive and self.state == LEADER and \
                        self.next_index.get(peer, 1 << 62) <= \
                        self.wal.synced_index():
                    continue
                self._repl_cv.wait(self.hb)

    def _replicate_one(self, peer: str) -> bool:
        """One append_entries round; returns True iff the peer replied."""
        with self.lock:
            if self.state != LEADER:
                return False
            term = self.current_term
            nxt = self.next_index.get(peer, self.wal.last_index() + 1)
            if nxt <= self.snap_index:
                return self._send_snapshot(peer)
            prev_idx = nxt - 1
            if prev_idx == self.snap_index:
                prev_term = self.snap_term
            else:
                prev_term = self.wal.term_of(prev_idx) or 0
            max_batch = max(1, int(get_config().get("raft_max_batch")))
            # clamp to the durable index: a follower must never hold an
            # entry this leader could still lose to a crash (group
            # commit defers the leader's fsync; see Wal.sync_to)
            end = min(nxt + max_batch - 1, self.wal.synced_index())
            entries = [(i, t, _b64(d)) for (i, t, d)
                       in self.wal.read_range(nxt, end)]
            commit = self.commit_index
        if entries:
            from ..utils.stats import stats as _metrics
            _metrics().observe("raft_replication_batch_size",
                               len(entries), buckets=REPL_BATCH_BUCKETS)
        try:
            # armed raise == this append_entries round lost to the
            # network (peer partitioned); the caller treats it exactly
            # like a transport no-reply
            fail.hit("raft:replicate", key=self.group)
        except FailpointError:
            return False
        t_send = time.monotonic()
        r = self.transport.send(peer, self.group, "append_entries", {
            "_from": self.node_id, "term": term, "leader": self.node_id,
            "prev_index": prev_idx, "prev_term": prev_term,
            "entries": entries, "leader_commit": commit})
        if r is None:
            return False
        with self.lock:
            self._last_ack[peer] = t_send
            if r["term"] > self.current_term:
                self._step_down(r["term"])
                return True
            if self.state != LEADER:
                return True
            if r.get("ok"):
                if entries:
                    self.match_index[peer] = entries[-1][0]
                    self.next_index[peer] = entries[-1][0] + 1
            else:
                # back off; follower tells us its last index when known
                hint = r.get("hint")
                self.next_index[peer] = max(
                    1, hint + 1 if hint is not None else nxt - 1)
        return True

    def _send_snapshot(self, peer: str):
        if self.snapshot_cb is None:
            return
        snap_file = self._meta_path + ".snap"
        data = b""
        if os.path.exists(snap_file):
            with open(snap_file, "rb") as f:
                data = f.read()
        payload = {
            "_from": self.node_id, "term": self.current_term,
            "leader": self.node_id, "last_index": self.snap_index,
            "last_term": self.snap_term, "data": _b64(data)}
        self.lock.release()
        try:
            r = self.transport.send(peer, self.group, "install_snapshot",
                                    payload)
        finally:
            self.lock.acquire()
        if r and r.get("ok"):
            self.next_index[peer] = self.snap_index + 1
            self.match_index[peer] = self.snap_index

    def _advance_commit(self):
        with self.lock:
            if self.state != LEADER:
                return
            # never past the DURABLE index: the leader's own vote only
            # counts for fsynced entries (with peers the match_index
            # cap enforces this implicitly — replication is clamped to
            # synced_index — but a no-peers group has no such cap, and
            # a sibling proposer's flushed-but-unsynced tail must not
            # commit off the heartbeat tick)
            top = min(self.wal.last_index(), self.wal.synced_index())
            for n in range(top, self.commit_index, -1):
                if self.wal.term_of(n) != self.current_term:
                    break               # §5.4.2: only current-term entries
                cnt = 1 + sum(1 for p in self.peers
                              if self.match_index.get(p, 0) >= n)
                if cnt * 2 > len(self.peers) + 1:
                    self.commit_index = n
                    self.commit_cv.notify_all()
                    break

    def _apply_committed(self):
        with self._apply_mu:
            while True:
                with self.lock:
                    if self.last_applied >= self.commit_index:
                        return
                    idx = self.last_applied + 1
                    r = self.wal.read(idx)
                    self.last_applied = idx
                # r is None for snapshot-covered gaps; empty payloads are
                # leader-election no-ops — neither reaches the state machine
                if r is not None and r[1]:
                    self.apply_cb(idx, r[1])
                self._maybe_snapshot()

    def _maybe_snapshot(self):
        if self.snapshot_cb is None:
            return
        with self.lock:
            if (self.last_applied - self.snap_index) < self.snapshot_threshold:
                return
            data = self.snapshot_cb()
            self.snap_index = self.last_applied
            self.snap_term = self.wal.term_of(self.snap_index) or self.snap_term
            with open(self._meta_path + ".snap", "wb") as f:
                f.write(data)
            self._save_meta()
            self.wal.compact_to(self.snap_index)

    # -- membership / leadership (BALANCE DATA / BALANCE LEADER) ----------

    def update_peers(self, replicas: List[str],
                     learners: Optional[List[str]] = None):
        """Adopt a new replica configuration (the balance/repair plan's
        membership change; reference raftex addPeer/removePeer).
        `learners=None` keeps the current learner set (legacy callers).

        Not joint consensus: the change is instantaneous on each member.
        Safety comes from the orchestration protocol — the part map is
        itself serialized through the metad raft group, and the shared
        membership engine (cluster/repair.py) applies changes with one
        side per step (add XOR remove; a learner→voter promotion only
        GROWS the voter set by an already-caught-up member), so any two
        consecutive configurations share a quorum."""
        promoted: List[str] = []
        with self.lock:
            new = [p for p in replicas if p != self.node_id]
            # a node named in `replicas` is a voter, full stop — it can
            # never linger in the learner set (promotion removes it)
            new_learners = [l for l in (self.learners if learners is None
                                        else learners)
                            if l not in replicas]
            if new == self.peers and new_learners == self.learners:
                return
            was_learner = set(self.learners)
            promoted = [p for p in replicas
                        if p in was_learner and p not in new_learners]
            self.peers = new
            self.learners = new_learners
            if self.state == LEADER:
                nxt = self.wal.last_index() + 1
                targets = self._repl_targets()
                for p in targets:
                    self.next_index.setdefault(p, max(1, nxt - 1))
                    self.match_index.setdefault(p, 0)
                for p in list(self.next_index):
                    if p not in targets:
                        self.next_index.pop(p, None)
                        self.match_index.pop(p, None)
            self._repl_cv.notify_all()
        if promoted:
            # a caught-up learner became a voter: from here its acks
            # count toward quorum and it may campaign / grant votes
            fail.hit("raft:promote_learner", key=self.group)
            _trace.record_phase("raft:promote_learner", 0.0,
                                group=self.group, peers=promoted)
        if self.is_leader():
            self._replicate_all()   # new follower gets snapshot/catch-up

    def transfer_leadership(self, target: str) -> bool:
        """Leader steps aside for `target` (raft §3.10 TimeoutNow): bring
        the target fully up to date (bounded rounds — concurrent writes
        may outrun a single 64-entry batch), tell it to start an election
        NOW, and step down immediately.  Stepping down on send is what
        keeps has_lease() honest: the target elects itself INSIDE the old
        leader's lease window (TimeoutNow bypasses the election timeout
        the lease bound is derived from), so the old leader must not
        serve lease reads past this point."""
        with self.lock:
            if self.state != LEADER or target not in self.peers:
                return False
            term = self.current_term
        # bounded catch-up with a CONSTANT entry budget (~4096, the
        # pre-knob 64×64): rounds scale inversely with raft_max_batch
        # so tuning the batch size down doesn't quietly shrink how far
        # behind a transfer target may be
        mb = max(1, int(get_config().get("raft_max_batch")))
        for _ in range(max(8, (4096 + mb - 1) // mb)):
            self._replicate_one(target)
            with self.lock:
                if self.state != LEADER or self.current_term != term:
                    return False
                if self.match_index.get(target, 0) >= self.wal.last_index():
                    break
        else:
            return False            # target can't catch up; abort
        r = self.transport.send(target, self.group, "timeout_now",
                                {"_from": self.node_id, "term": term})
        if not (r and r.get("ok")):
            return False
        with self.lock:
            if self.state == LEADER and self.current_term == term:
                self.state = FOLLOWER
                self._last_ack.clear()
                self._reset_election_deadline()
        return True

    # -- client API -------------------------------------------------------

    def is_leader(self) -> bool:
        with self.lock:
            return self.alive and self.state == LEADER

    @staticmethod
    def _lease_margin_s() -> float:
        try:
            return max(float(get_config().get("raft_lease_margin_ms")),
                       0.0) / 1e3
        except Exception:  # noqa: BLE001 — config not initialized
            return 0.025

    def has_lease(self) -> bool:
        """Heartbeat-majority leader lease for linearizable-ish reads.

        A deposed leader on the minority side of a partition keeps
        believing it leads until it learns the higher term; serving reads
        only while a majority acked within the minimum election timeout
        bounds that stale window: no new leader can have been elected
        during an interval in which this leader held a quorum's
        heartbeat acks.  A clock-skew margin (`raft_lease_margin_ms`)
        is subtracted from that bound: a follower
        whose clock runs slightly fast starts its election timer early,
        so the raw minimum election timeout overstates how long the
        no-vote promise is good for.  margin >= the election timeout
        disables the lease fast path (window <= 0 → always False)."""
        with self.lock:
            if not (self.alive and self.state == LEADER):
                return False
            if not self.peers:
                return True
            window = self.eto[0] - self._lease_margin_s()
            if window <= 0:
                return False
            horizon = time.monotonic() - window
            acked = sum(1 for p in self.peers
                        if self._last_ack.get(p, 0.0) >= horizon)
            return (acked + 1) * 2 > len(self.peers) + 1

    # -- read path: read-index / lease reads -------------------

    def applied_index(self) -> int:
        with self.lock:
            return self.last_applied

    def leader_contact_age(self) -> float:
        """Seconds since this replica provably tracked a live leader —
        the staleness clock for bounded_stale reads.  For a follower:
        age of the last append_entries/snapshot from a leader.  For a
        leader: age of the freshest heartbeat round a MAJORITY acked (a
        deposed-but-unaware leader on the minority side goes stale here
        exactly like a cut-off follower).  inf when never in contact."""
        now = time.monotonic()
        with self.lock:
            if not self.alive:
                return float("inf")
            if self.state == LEADER:
                if not self.peers:
                    return 0.0
                # VOTER acks only: learner replication also lands in
                # _last_ack, but a learner's ack proves nothing about
                # quorum freshness (a deposed leader kept fresh by its
                # learner must still go stale here)
                acks = sorted((v for p, v in self._last_ack.items()
                               if p in self.peers), reverse=True)
                need = (len(self.peers) + 1) // 2   # peers for a quorum
                if len(acks) < need:
                    return float("inf")
                return max(now - acks[need - 1], 0.0)
            if self._leader_contact <= 0.0:
                return float("inf")
            return max(now - self._leader_contact, 0.0)

    def read_index(self, timeout: float = 1.0) -> Optional[int]:
        """Linearizable read barrier (raft §6.4): an index such that a
        read observing every entry applied up to it sees everything
        committed before this call started.  On the leader the lease
        fast path answers from `commit_index` for free; a leader whose
        lease lapsed confirms its leadership with one live quorum round
        first (a deposed-but-unaware leader fails that round and
        returns None).  On a follower the call forwards to the known
        leader.  None = no leader reachable/confirmed — the caller
        walks replicas like any leader-change."""
        try:
            fail.hit("raft:read_index", key=self.group)
        except FailpointError:
            return None
        from ..utils.stats import stats as _metrics
        with self.lock:
            if not self.alive:
                return None
            leading = self.state == LEADER
            target = self.leader_id
            commit = self.commit_index
        if leading:
            if self.has_lease():
                _metrics().inc_labeled("raft_read_index",
                                       {"path": "lease"})
                return commit
            idx = self._quorum_confirm(timeout)
            if idx is not None:
                _metrics().inc_labeled("raft_read_index",
                                       {"path": "quorum"})
            return idx
        if not target or target == self.node_id:
            return None
        r = self.transport.send(target, self.group, "read_index",
                                {"_from": self.node_id})
        if not r or not r.get("ok"):
            return None
        _metrics().inc_labeled("raft_read_index", {"path": "forward"})
        return int(r["index"])

    def _quorum_confirm(self, timeout: float) -> Optional[int]:
        """Leadership confirmation for a lease-less read_index: one live
        append_entries round to every peer; success = a majority
        replied while our term survived.  Returns the commit index the
        confirmation covers (taken BEFORE the round — any entry
        committed before the call is <= it), or None."""
        with self.lock:
            if not (self.alive and self.state == LEADER):
                return None
            term = self.current_term
            commit = self.commit_index
            peers = list(self.peers)
        if not peers:
            return commit
        acks = [1]
        mu = threading.Lock()
        done = threading.Event()

        def ping(p):
            if not self._replicate_one(p):
                return
            with self.lock:
                if not (self.alive and self.state == LEADER
                        and self.current_term == term):
                    done.set()
                    return
            with mu:
                acks[0] += 1
                if acks[0] * 2 > len(peers) + 1:
                    done.set()

        for p in peers:
            threading.Thread(target=ping, args=(p,), daemon=True,
                             name=f"raft-readidx-{self.node_id}").start()
        done.wait(timeout)
        with self.lock:
            if not (self.alive and self.state == LEADER
                    and self.current_term == term):
                return None
        with mu:
            if acks[0] * 2 > len(peers) + 1:
                return commit
        return None

    def wait_applied(self, index: int, timeout: float = 5.0) -> bool:
        """Block until the local state machine has applied `index`
        (the follower half of a read-index read).  Drives apply itself
        when commits are already known locally; otherwise waits for the
        leader's next append_entries to advance commit_index."""
        dl = time.monotonic() + timeout
        while True:
            self._apply_committed()
            with self.lock:
                if self.last_applied >= index:
                    return True
                if not self.alive:
                    return False
                left = dl - time.monotonic()
                if left <= 0:
                    return False
                self.commit_cv.wait(min(left, 0.05))

    def propose(self, data: bytes, timeout: float = 5.0) -> Optional[int]:
        """Append + replicate + wait for commit.  Returns the entry's log
        index (truthy) on commit; None if not leader or timed out (caller
        retries against the current leader)."""
        idxs = self.propose_batch([data], timeout=timeout)
        return idxs[-1] if idxs else None

    def propose_batch(self, datas: List[bytes],
                      timeout: float = 5.0) -> Optional[List[int]]:
        """Group commit: append ALL entries under one lock hold, pay one
        (coalesced) WAL sync and one replication wake for the whole
        batch, and wait for the last entry's commit.  Returns the log
        indices on commit; None if not leader or timed out (caller
        retries against the current leader — per-entry apply outcomes
        are the state machine's business, see storage_service).

        Concurrent callers coalesce twice: the WAL group sync
        (Wal.sync_to — one fsync covers every batch flushed before it
        started) and the replication round (followers receive all
        pending entries of all callers in one append_entries, capped by
        raft_max_batch).  Commit waiters wake by index off commit_cv."""
        from ..utils.stats import stats as _metrics
        if not datas:
            return []
        t0 = time.monotonic()
        with self.lock:
            if not self.alive or self.state != LEADER:
                return None
            term = self.current_term
            idx0 = self.wal.last_index() + 1
            entries = [(idx0 + j, term, d) for j, d in enumerate(datas)]
            # buffered write only — the fsync happens OUTSIDE the part
            # lock so sibling proposers can stage entries meanwhile
            self.wal.append_batch(entries, sync=False)
            last = entries[-1][0]
        # pre/post bracket the durability point: a crash armed BEFORE
        # loses the batch, one armed AFTER loses only the ack
        fail.hit("raft:pre_fsync", key=self.group)
        self.wal.sync_to(last)          # group fsync (shared with siblings)
        fail.hit("raft:post_fsync", key=self.group)
        with self.lock:
            if not self.peers and self.state == LEADER:
                # single-node group: durable == committed — advance to
                # the SYNCED index only (a sibling's flushed-but-not-
                # fsynced tail must not commit off our fsync)
                durable = self.wal.synced_index()
                if self.commit_index < durable:
                    self.commit_index = durable
                    self.commit_cv.notify_all()
        _metrics().inc("raft_appends", len(entries))
        _metrics().inc("raft_propose_batches")
        self._replicate_all()
        fail.hit("raft:pre_commit", key=self.group)
        deadline = time.monotonic() + timeout
        with self.lock:
            while self.commit_index < last:
                left = deadline - time.monotonic()
                if left <= 0 or not self.alive or self.state != LEADER:
                    return None
                self.commit_cv.wait(left)
            # a deposal + truncation + foreign recommit can land while
            # waiting (the loop tolerates losing-then-regaining
            # leadership — the entry survives in OUR log across that):
            # ack only if the tail index still holds OUR term's entry
            t_last = self.wal.term_of(last)
            if t_last is not None and t_last != term:
                return None
        # serve-after-commit: apply before returning so leader reads see it
        self._apply_committed()
        _metrics().inc("raft_commits", len(entries))
        _metrics().observe("raft_commit_latency_ms",
                           (time.monotonic() - t0) * 1e3,
                           buckets=COMMIT_LATENCY_BUCKETS_MS)
        return [i for (i, _, _) in entries]

    # -- RPC handlers -----------------------------------------------------

    def handle(self, method: str, p: Dict[str, Any]) -> Dict[str, Any]:
        if not self.alive:
            raise RuntimeError(f"raft part {self.group} is stopped")
        if method == "request_vote":
            return self._on_request_vote(p)
        if method == "append_entries":
            return self._on_append_entries(p)
        if method == "install_snapshot":
            return self._on_install_snapshot(p)
        if method == "timeout_now":
            return self._on_timeout_now(p)
        if method == "read_index":
            return self._on_read_index(p)
        raise ValueError(f"unknown raft method {method}")

    def _on_read_index(self, p):
        """A follower asked us (its view of the leader) for a read
        barrier.  Only answered while actually leading — a fellow
        follower must NOT forward onward (two stale leader_id hints
        could otherwise chase each other in a cycle)."""
        with self.lock:
            if self.state != LEADER:
                return {"term": self.current_term, "ok": False}
        idx = self.read_index()
        return {"term": self.current_term, "ok": idx is not None,
                "index": idx}

    def _on_timeout_now(self, p):
        with self.lock:
            if p["term"] != self.current_term:
                return {"term": self.current_term, "ok": False}
        self._start_election()
        return {"term": self.current_term, "ok": True}

    def _on_request_vote(self, p):
        with self.lock:
            if p["term"] > self.current_term:
                self._step_down(p["term"])
            if self.node_id in self.learners:
                # a learner holds NO vote: even a candidate with a stale
                # config that asks must not be able to count us toward
                # its majority (unit-asserted)
                return {"term": self.current_term, "granted": False}
            granted = False
            if p["term"] == self.current_term and \
                    self.voted_for in (None, p["candidate"]):
                lli, llt = self._last_log()
                up_to_date = (p["last_log_term"], p["last_log_index"]) >= (llt, lli)
                if up_to_date:
                    granted = True
                    self.voted_for = p["candidate"]
                    self._save_meta()
                    self._reset_election_deadline()
            return {"term": self.current_term, "granted": granted}

    def _on_append_entries(self, p):
        with self.lock:
            if p["term"] < self.current_term:
                return {"term": self.current_term, "ok": False}
            if p["term"] > self.current_term or self.state != FOLLOWER:
                self._step_down(p["term"])
            self.leader_id = p["leader"]
            self._leader_contact = time.monotonic()
            self._reset_election_deadline()

            prev_idx, prev_term = p["prev_index"], p["prev_term"]
            if prev_idx > 0 and prev_idx > self.snap_index:
                t = self.wal.term_of(prev_idx)
                if t is None:
                    return {"term": self.current_term, "ok": False,
                            "hint": self.wal.last_index()}
                if t != prev_term:
                    self.wal.truncate_from(prev_idx)
                    return {"term": self.current_term, "ok": False,
                            "hint": max(self.snap_index, prev_idx - 1)}
            # collect the suffix to append, then write it as ONE batch
            # (one buffered write + one fsync — the follower half of
            # group commit; `append` per entry was one fsync each).
            # Entries are contiguous ascending, so once the first new
            # index is found nothing after it can already exist.
            to_append: List[Tuple[int, int, bytes]] = []
            for (idx, term, d64) in p["entries"]:
                if to_append:
                    to_append.append((idx, term, _unb64(d64)))
                    continue
                have = self.wal.term_of(idx)
                if have is not None:
                    if have != term:
                        self.wal.truncate_from(idx)
                    else:
                        continue
                if idx <= self.snap_index:
                    continue
                to_append.append((idx, term, _unb64(d64)))
            if to_append:
                self.wal.append_batch(to_append)
                from ..utils.stats import stats as _metrics
                _metrics().inc("raft_appends", len(to_append))
            if p["leader_commit"] > self.commit_index:
                self.commit_index = min(p["leader_commit"],
                                        self.wal.last_index())
                self.commit_cv.notify_all()
        self._apply_committed()
        return {"term": self.current_term, "ok": True}

    def _on_install_snapshot(self, p):
        with self.lock:
            if p["term"] < self.current_term:
                return {"term": self.current_term, "ok": False}
            self._step_down(p["term"])
            self.leader_id = p["leader"]
            self._leader_contact = time.monotonic()
            self._reset_election_deadline()
            data = _unb64(p["data"])
            if self.restore_cb:
                self.restore_cb(data)
            with open(self._meta_path + ".snap", "wb") as f:
                f.write(data)
            self.snap_index = p["last_index"]
            self.snap_term = p["last_term"]
            self.commit_index = max(self.commit_index, self.snap_index)
            self.last_applied = max(self.last_applied, self.snap_index)
            self.wal.reset(self.snap_index + 1)  # snapshot replaces the log
            self._save_meta()
            return {"term": self.current_term, "ok": True}
