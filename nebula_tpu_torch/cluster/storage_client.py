"""The port's copy of `nebula_tpu/cluster/storage_client.py`, whole.

StorageClient — per-partition request routing + fan-out + retry.

Analog of the reference's src/clients/storage StorageClientBase: splits every request by the
partition of its vids (stable hash, same function the store uses),
sends each shard to a replica chosen per the request's consistency
level, retries on leader-change / connection errors after re-pulling
the map, and merges responses.  Fan-out is a thread pool (the
folly-futures analog) over PIPELINED per-peer clients:
partitions hosted on the same storaged multiplex over the pooled
connection by request id, so N-partition fan-out to one host is
wall-time ≈ max(partition), not sum.  Per-hop data-plane traffic does
NOT ride this in device mode (SURVEY §5 two-plane rule).

Replica routing: `leader`-consistency calls keep
the leader-first walk (the cached part map front-loads the last known
leader — see MetaClient.note_part_leader).  Follower-readable calls
(`follower` / `bounded_stale` reads) rank the replica set by a
per-peer health score combining the circuit-breaker state, the
E_OVERLOAD retry-after penalty window, and a latency EWMA — so
reads steer toward the best live replica instead of piling onto a
sick or overloaded one.  An E_OVERLOAD or E_STALE reply walks ON to
the next replica (another replica can serve NOW) instead of backing
off against the one that just shed us.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..graphstore.store import stable_vid_hash
from ..utils import cancel as _cancel
from ..utils import trace as _trace
from ..utils.admission import is_overload, parse_retry_after
from ..utils.consistency import FOLLOWER, BOUNDED_STALE  # noqa: F401
from ..utils.stats import (current_cost, current_work, stats as _stats,
                           use_cost, use_work)
from .meta_client import MetaClient
from .rpc import (RpcClient, RpcConnError, RpcError, RpcNeverSentError,
                  breaker_for, deadline_sleep, is_idempotent,
                  retry_backoff)


class StorageError(Exception):
    pass


# -- per-peer routing scores --------------------------------------

#: replica_route_score histogram buckets — scores are seconds-shaped
#: (EWMA latency + penalty-window remainders + breaker constants)
_SCORE_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.0, 5.0,
                  10.0, 20.0)


class _PeerStat:
    __slots__ = ("ewma_s", "penalty_until")

    def __init__(self):
        self.ewma_s = 0.0
        self.penalty_until = 0.0


_peer_stats: Dict[str, _PeerStat] = {}
_peer_lock = threading.Lock()


def _peer_stat(addr: str) -> _PeerStat:
    with _peer_lock:
        st = _peer_stats.get(addr)
        if st is None:
            st = _peer_stats[addr] = _PeerStat()
        return st


def note_peer_latency(addr: str, seconds: float):
    """Fold one successful call's latency into the peer's EWMA (the
    slow-but-alive signal breakers can't see)."""
    st = _peer_stat(addr)
    st.ewma_s = seconds if st.ewma_s == 0.0 \
        else 0.8 * st.ewma_s + 0.2 * seconds


def note_peer_overload(addr: str, retry_after_s: Optional[float]):
    """An E_OVERLOAD from this peer: treat it as loaded for the hinted
    window — follower-readable routing avoids it until then."""
    st = _peer_stat(addr)
    until = time.monotonic() + (retry_after_s
                                if retry_after_s is not None else 0.5)
    if until > st.penalty_until:
        st.penalty_until = until


def peer_score(addr: str) -> float:
    """Routing cost of sending the next follower-readable read to
    `addr` — lower is better.  Seconds-shaped: latency EWMA, plus the
    remaining E_OVERLOAD penalty window, plus a large constant for an
    open circuit breaker (peer recently unreachable) and a small one
    for half-open (unproven).

    Per-PART load is deliberately not folded in here (this score is
    per-peer); the documented part-granular signal is
    `utils.insights.PartHeatTable.heat_of(space, part)` —
    each storaged's heat rides its heartbeat, so a heat-aware router
    or BALANCE planner reads it from metad's merged hotspot view."""
    st = _peer_stat(addr)
    score = st.ewma_s
    rem = st.penalty_until - time.monotonic()
    if rem > 0:
        score += rem + 0.5
    br = breaker_for(addr)
    if br.state == "open":
        score += 10.0
    elif br.state == "half_open":
        score += 1.0
    return score


def reset_peer_stats():
    """Drop all routing state (test isolation)."""
    with _peer_lock:
        _peer_stats.clear()


class StorageClient:
    def __init__(self, meta: MetaClient, max_fanout: int = 16):
        self.meta = meta
        self._clients: Dict[str, RpcClient] = {}
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=max_fanout,
                                        thread_name_prefix="storage-fanout")

    def _client(self, addr: str) -> RpcClient:
        # retries=0: _call_part owns retry (replica walk + map refresh);
        # the pooled client multiplexes concurrent per-part calls to
        # this peer over its connections by request id
        with self._lock:
            c = self._clients.get(addr)
            if c is None:
                c = self._clients[addr] = RpcClient.from_addr(
                    addr, timeout=60.0, retries=0)
            return c

    def close(self):
        self._pool.shutdown(wait=False)
        for c in self._clients.values():
            c.close()

    # -- routing ----------------------------------------------------------

    def part_of(self, space: str, vid: Any) -> int:
        pm = self.meta.parts_of(space)
        return stable_vid_hash(vid) % len(pm)

    def split_by_part(self, space: str, vids: List[Any]
                      ) -> Dict[int, List[Any]]:
        pm = self.meta.parts_of(space)
        n = len(pm)
        out: Dict[int, List[Any]] = {}
        for v in vids:
            out.setdefault(stable_vid_hash(v) % n, []).append(v)
        return out

    def _route(self, replicas: List[str], follower_ok: bool) -> List[str]:
        """Replica try-order for one attempt.  `leader` consistency
        keeps the cached map order (leader-first — the hint write-back
        below keeps that front slot fresh across failovers); follower-
        readable calls rank by per-peer health score so reads land on
        the best live replica first (stable sort: the map order breaks
        score ties, so healthy clusters fan reads out per the map)."""
        if not follower_ok or len(replicas) <= 1:
            return list(replicas)
        return sorted(replicas, key=peer_score)

    def _call_part(self, space: str, pid: int, method: str,
                   params: Dict[str, Any], retries: int = 6) -> Any:
        last: Optional[Exception] = None
        # a (writer_id, seq) idempotency token makes re-sending safe for
        # ANY method: storaged's raft-replicated dedup window returns the
        # recorded outcome instead of double-applying — the mid-call
        # abort below flips into a replica-walk retry
        resendable = is_idempotent(method) or \
            (isinstance(params, dict) and params.get("token") is not None)
        # follower-readable calls carry their consistency in
        # the params — ANY replica may serve them, so routing ranks the
        # replica set by health score instead of walking leader-first
        follower_ok = isinstance(params, dict) and \
            params.get("consistency") in (FOLLOWER, BOUNDED_STALE)
        for attempt in range(retries):
            # between attempts the statement's deadline/kill budget is
            # the authority — a killed query must not keep walking
            _cancel.check()
            pm = self.meta.parts_of(space)
            # leader first, then the rest (covers stale maps); a
            # "part_leader_changed: <addr>" hint extends the walk — a
            # fresh post-failover leader is reachable THIS attempt, long
            # before the heartbeat → metad → refresh pipeline reorders
            # the part map (the upstream storage client's leader walk)
            queue = self._route(pm[pid], follower_ok)
            tried = set()
            qi = 0
            while qi < len(queue):
                addr = queue[qi]
                qi += 1
                if addr in tried:
                    continue
                tried.add(addr)
                t_call = time.monotonic()
                try:
                    r = self._client(addr).call(
                        method, space=space, part=pid, **params)
                except RpcError as ex:
                    last = ex
                    msg = str(ex)
                    if "part_leader_changed" in msg or \
                            "not hosted here" in msg:
                        hint = msg.rsplit(": ", 1)[-1].strip()
                        if ":" in hint:
                            if hint not in tried:
                                queue.append(hint)
                            # leader-hint write-back: remember the hinted leader in
                            # the cached part map so the NEXT statement
                            # goes straight there — one walk total per
                            # failover, not one per call until the
                            # heartbeat→metad→refresh pipeline catches
                            # up
                            self.meta.note_part_leader(space, pid, hint)
                        _stats().inc_labeled("storage_replica_walk_retries",
                                             {"op": method})
                        continue
                    if msg.startswith("E_STALE"):
                        # bounded_stale reject: THIS replica is too far
                        # behind — a fresher one (the leader serves
                        # unconditionally) can answer right now
                        _stats().inc_labeled("storage_replica_walk_retries",
                                             {"op": method})
                        continue
                    if is_overload(msg):
                        # the peer shed the request before its handler
                        # ran (its bounded inbox): remember the load
                        # signal for routing and — when re-sending is
                        # safe — walk ON to a sibling replica instead
                        # of backing off against the loaded one
                        note_peer_overload(addr, parse_retry_after(msg))
                        if resendable:
                            _stats().inc_labeled(
                                "storage_replica_walk_retries",
                                {"op": method})
                            continue
                    raise StorageError(msg) from None
                except RpcNeverSentError as ex:
                    last = ex           # never reached the peer: walk on
                    _stats().inc_labeled("storage_replica_walk_retries",
                                         {"op": method})
                    continue
                except RpcConnError as ex:
                    last = ex
                    # the request MAY have applied before the connection
                    # died — walking replicas / retrying would re-send
                    # it, so only idempotent methods and tokened
                    # (dedup-protected) writes keep going; everything
                    # else surfaces the at-least-once hazard to the
                    # caller (same gate RpcClient.call applies, one
                    # layer up where the replica walk lives)
                    if resendable:
                        _stats().inc_labeled("storage_replica_walk_retries",
                                             {"op": method})
                        continue
                    raise StorageError(
                        f"{method} to part {pid} of `{space}' failed "
                        f"mid-call; not retried (non-idempotent): {ex}"
                    ) from None
                # success: feed the routing signals — latency EWMA, and
                # the score this serve was chosen at (observability for
                # the steering decision)
                dt = time.monotonic() - t_call
                note_peer_latency(addr, dt)
                if follower_ok:
                    _stats().observe("replica_route_score",
                                     peer_score(addr), {"peer": addr},
                                     buckets=_SCORE_BUCKETS)
                return r
            # election / part creation may be in flight — jittered
            # exponential backoff, clamped to the remaining deadline
            # budget (a herd of retriers after a leader crash must not
            # resynchronize on fixed sleeps)
            deadline_sleep(retry_backoff(attempt, base=0.1))
            self.meta.refresh(force=True)
        raise StorageError(f"part {pid} of `{space}' unreachable: {last}")

    def fanout(self, space: str, by_part: Dict[int, Dict[str, Any]],
               method: str) -> List[Tuple[int, Any]]:
        """Concurrent per-part calls; returns [(pid, result)] sorted.

        The submitting thread's trace context and work-counter target
        are re-established on each pool thread, so per-part spans and
        RPC/wire-byte counts attribute to the query that fanned out."""
        tctx = _trace.current_ctx()
        wc = current_work()
        cc = current_cost()
        kill = _cancel.current_kill()
        dl = _cancel.current_deadline()

        def run(pid, params):
            # cancel context rides to the pool thread like trace/work/
            # cost do: the per-part call clamps its RPC timeouts and
            # backoff to the statement budget, stops walking when
            # killed, and attributes reply-envelope cost records to the
            # plan node that fanned out
            with _trace.use_ctx(tctx), use_work(wc), use_cost(cc), \
                    _cancel.use_cancel(kill=kill, deadline=dl), \
                    _trace.span(f"storage:{method}", part=pid,
                                space=space):
                return self._call_part(space, pid, method, params)

        futs = {pid: self._pool.submit(run, pid, params)
                for pid, params in by_part.items()}
        # kill-aware wait: KILL QUERY during the
        # fan-out must not block on a stalled partition until its RPC
        # timeout — poll the cancel context while waiting.  Context-
        # free callers (admin/balance paths) keep the single cheap
        # blocking collect instead of a 20Hz poll loop
        if kill is None and dl is None:
            return [(pid, f.result()) for pid, f in sorted(futs.items())]
        pending = set(futs.values())
        try:
            while pending:
                done, pending = wait(pending, timeout=0.05,
                                     return_when=FIRST_COMPLETED)
                if pending:
                    _cancel.check()
        except (_cancel.QueryKilled, _cancel.DeadlineExceeded):
            for f in pending:
                f.cancel()          # unstarted parts never dispatch
            raise
        return [(pid, f.result()) for pid, f in sorted(futs.items())]

    def all_parts(self, space: str) -> List[int]:
        return list(range(len(self.meta.parts_of(space))))
