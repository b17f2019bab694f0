"""The port's copy of `nebula_tpu/utils/admission.py`, whole.

Admission control + overload survival.

Nothing used to stand between a thundering herd and the engine: every
statement grabbed a scheduler slot, charged memory and dispatched to
the device unconditionally, so saturation meant collapse (unbounded
queues, OOM kills, deadline blowouts) instead of bounded degradation.
This module is the graphd-side half of the overload plane:

  * `AdmissionController` — a bounded set of concurrency slots
    (`max_running_queries`; 0 = the disabled sentinel, byte-identical
    to the pre-admission engine) in front of `scheduler.run`, with a
    capped wait queue drained by DEFICIT-WEIGHTED round-robin across
    sessions (`admission_session_weights`) so no session can starve
    another, and a memory watermark
    (`admission_memory_watermark_bytes`) gating new admissions against
    the process-wide total of per-statement MemoryTracker charges.

  * a PRIORITY LANE: control-plane statements (KILL QUERY/SESSION,
    SHOW *, UPDATE CONFIGS, admin introspection) bypass the queue
    entirely — the cluster stays operable at saturation, which is the
    whole point of shedding load instead of timing out uniformly.

  * structured SHEDDING: a full queue fails the statement immediately
    with `E_OVERLOAD` carrying a `retry_after_ms` hint derived from
    the observed drain rate (`DrainEstimator`), instead of letting it
    queue toward a guaranteed deadline blowout.  Deadline-aware queue
    EVICTION: a statement whose deadline budget expires while queued is
    failed with E_QUERY_TIMEOUT without ever taking a slot, and a
    KILL QUERY / KILL SESSION of a queued statement removes it from
    the queue immediately (slot never consumed).

The cluster-wide halves live elsewhere and share this module's
`overload_error` / `parse_retry_after` contract: the RPC server's
bounded inbox (`rpc_server_inbox_capacity`, cluster/rpc.py) rejects
overflow with E_OVERLOAD + retry-after instead of queuing unboundedly,
the RPC client honors the hint inside the deadline-budgeted
backoff (overload is breaker-neutral — the reply proves the peer
alive), and the device dispatch gate caps queue depth
(`tpu_dispatch_queue_cap`, tpu/pipeline.py) beyond which fused
pipelines degrade to their stashed host subplan — never wrong, only
slower.  Semantics matrix: docs/ROBUSTNESS.md §7.
"""
from __future__ import annotations

import re
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple

from . import cancel as _cancel
from .config import define_flag, get_config

define_flag("max_running_queries", 0,
            "admission-control concurrency slots per process; 0 is the "
            "DISABLED sentinel (no queueing, no shedding — byte-"
            "identical to the pre-admission engine, keeping the wire/"
            "work-counter regression probes deterministic)")
define_flag("admission_queue_capacity", 64,
            "statements allowed to WAIT for a slot before new arrivals "
            "are shed with E_OVERLOAD + retry-after")
define_flag("admission_memory_watermark_bytes", 0,
            "process-wide memory watermark: while the summed "
            "MemoryTracker charge of RUNNING statements is at or above "
            "this, new admissions wait in the queue (0 disables; one "
            "statement is always admitted when nothing runs, so the "
            "gate can never deadlock the drain)")
define_flag("admission_session_weights", "",
            "per-session DWRR weights as `sid:weight[,sid:weight...]` "
            "(unlisted sessions weigh 1); runtime-updatable via "
            "UPDATE CONFIGS so an operator can deprioritize a noisy "
            "tenant without a restart")
define_flag("admission_tenant_weights", "",
            "per-tenant (user) DWRR quotas as `user:weight[,...]` "
            "(unlisted tenants weigh 1): the OUTER rotation of the "
            "two-level drain — tenants split slots by these weights, "
            "each tenant's sessions split its share by the session "
            "weights.  Enforced at every graphd, so an aggressor "
            "tenant cannot starve others anywhere in the fleet "
            "; runtime-updatable via UPDATE CONFIGS")
define_flag("rpc_server_inbox_capacity", 0,
            "bounded RPC-server dispatch inbox: pipelined requests "
            "beyond this many in flight per server are rejected with "
            "E_OVERLOAD + retry-after instead of queuing unboundedly "
            "(0 = unbounded, today's behavior); raft, meta.* and graph "
            "control methods are exempt so cluster health never sheds")
define_flag("tpu_dispatch_queue_cap", 0,
            "device dispatch-queue depth beyond which fused MATCH "
            "pipelines degrade to their stashed host subplan instead "
            "of piling onto the device (0 = off); never wrong, only "
            "slower")

#: wire prefix of every shed/overload error — the one string clients,
#: the RPC client retry loop and the flight recorder key off
OVERLOAD_PREFIX = "E_OVERLOAD"

_RETRY_AFTER_RE = re.compile(r"retry_after_ms=(\d+)")


def overload_error(retry_after_s: float, where: str, detail: str) -> str:
    """The one E_OVERLOAD wire shape: prefix, human detail, shedding
    site, machine-parseable retry-after hint (milliseconds)."""
    ms = max(int(retry_after_s * 1000), 1)
    return (f"{OVERLOAD_PREFIX}: {detail} [{where}]; "
            f"retry_after_ms={ms}")


def is_overload(err: Optional[str]) -> bool:
    return isinstance(err, str) and err.startswith(OVERLOAD_PREFIX)


def parse_retry_after(err: Optional[str]) -> Optional[float]:
    """retry-after hint in SECONDS from an E_OVERLOAD error string, or
    None when absent/malformed (callers fall back to their backoff)."""
    if not isinstance(err, str):
        return None
    m = _RETRY_AFTER_RE.search(err)
    if m is None:
        return None
    return int(m.group(1)) / 1000.0


class OverloadError(Exception):
    """Shed at admission: the statement never took a slot.  str() is
    the full E_OVERLOAD wire error (retry_after_ms included)."""

    def __init__(self, retry_after_s: float, where: str, detail: str):
        super().__init__(overload_error(retry_after_s, where, detail))
        self.retry_after_s = retry_after_s
        self.where = where


class DrainEstimator:
    """Observed drain rate → retry-after hints.

    A sliding window of completion timestamps prices how long a queue
    of depth N will take to drain; the hint is that estimate clamped to
    [50ms, 5s] so a cold estimator can neither hammer (0) nor park a
    client forever.  With no completions observed yet the hint is a
    flat 500ms — the "come back soon, we just started" default."""

    __slots__ = ("_done", "_mu")

    def __init__(self):
        self._done: "deque[float]" = deque(maxlen=64)
        self._mu = threading.Lock()

    def note_done(self):
        with self._mu:
            self._done.append(time.monotonic())

    def rate(self) -> float:
        """Completions per second over the window (0 when unknown)."""
        with self._mu:
            if len(self._done) < 2:
                return 0.0
            span = self._done[-1] - self._done[0]
            n = len(self._done)
        if span <= 0:
            return 0.0
        return (n - 1) / span

    def retry_after_s(self, depth: int) -> float:
        r = self.rate()
        if r <= 0:
            return 0.5
        return min(max(max(depth, 1) / r, 0.05), 5.0)


# -- control-plane lane ------------------------------------------------------

#: statement kinds that bypass the admission queue: the operator's way
#: back into a saturated cluster.  SHOW/KILL/DESCRIBE are pure
#: introspection or cancellation; USE/UPDATE CONFIGS/GET CONFIGS are
#: the levers that relieve the overload (a capacity bump must not
#: itself queue behind the traffic it exists to drain).
_CONTROL_PREFIXES = ("Show", "Kill", "Desc")
_CONTROL_KINDS = frozenset({
    "Use", "UpdateConfigs", "GetConfigs", "StopJob"})


def is_control_stmt(kind: str) -> bool:
    return kind.startswith(_CONTROL_PREFIXES) or kind in _CONTROL_KINDS


# -- analytics lane ----------------------------------------------

#: statement kinds that run BELOW interactive traffic: long-running
#: whole-graph analytics (`CALL algo.*`).  They queue in a separate
#: FIFO band that drains only when no interactive statement is
#: waiting — strict priority, so a burst of PageRank runs can never
#: add queueing delay to point reads.  Deadline eviction, KILL
#: eviction and the capacity bound apply to the band exactly as to
#: the DWRR queues (an analytic statement whose budget expires while
#: parked fails E_QUERY_TIMEOUT without ever taking a slot).
_ANALYTIC_KINDS = frozenset({"CallAlgo"})


def is_analytic_stmt(kind: str) -> bool:
    return kind in _ANALYTIC_KINDS


# -- the controller ----------------------------------------------------------


class _Waiter:
    __slots__ = ("qid", "session", "kind", "event", "admitted",
                 "cancelled", "t_enq", "tracker", "live", "analytic",
                 "user")

    def __init__(self, qid: int, session: int, kind: str, live, tracker,
                 user: str = ""):
        self.qid = qid
        self.session = session
        self.kind = kind
        self.event = threading.Event()
        self.admitted = False
        self.cancelled = False
        self.t_enq = time.monotonic()
        self.tracker = tracker
        self.live = live
        self.analytic = is_analytic_stmt(kind)
        self.user = user


class Ticket:
    """What acquire() hands back; release() exactly once (engine's
    finally).  mode: 'admitted' holds a slot, 'bypass' (control lane)
    and 'off' (admission disabled) hold nothing."""

    __slots__ = ("_ctl", "mode", "qid", "queue_wait_us", "_released")

    def __init__(self, ctl: "AdmissionController", mode: str, qid: int,
                 queue_wait_us: int = 0):
        self._ctl = ctl
        self.mode = mode
        self.qid = qid
        self.queue_wait_us = queue_wait_us
        self._released = False

    def release(self):
        if self._released:
            return
        self._released = True
        if self.mode == "admitted":
            self._ctl._release_slot(self.qid)


class AdmissionController:
    """Process-wide admission queue in front of every engine's
    scheduler (graphd and standalone share it, like the live workload
    registry — the slots bound the PROCESS, which is what the memory
    watermark and the device plane care about)."""

    #: waiter poll slice: the KILL/deadline/watermark re-check cadence
    #: while queued.  20ms keeps "KILL QUERY removes it immediately"
    #: honest without measurable idle cost.
    POLL_S = 0.02

    def __init__(self):
        self._mu = threading.Lock()
        self._running: Dict[int, _Waiter] = {}      # qid → admitted
        # two-level DWRR: the OUTER rotation is per tenant
        # (user), weighted by `admission_tenant_weights`; each tenant
        # holds its own session rotation weighted by
        # `admission_session_weights`.  Single-tenant workloads (every
        # pre-fleet test and default deployment) collapse to the old
        # per-session DWRR exactly — one tenant, inner rotation only.
        # tenant → {"queues": OrderedDict[sid, deque],
        #           "rr": deque[sid], "deficit": {sid: float}}
        self._tenants: "OrderedDict[str, dict]" = OrderedDict()
        self._trr: "deque[str]" = deque()           # tenant rotation
        self._tdeficit: Dict[str, float] = {}
        # lifetime per-tenant admissions (SHOW TENANTS + the
        # tenant_dwrr_share gauge): under sustained contention the
        # shares converge to the configured weights
        self._tenant_admits: Dict[str, int] = {}
        self._admit_total = 0
        # below-interactive band: analytics FIFO, drained
        # only when every DWRR session queue is empty
        self._analytic: "deque[_Waiter]" = deque()
        self._queued_n = 0
        self._drain_est = DrainEstimator()
        self._weights_raw = ""
        self._weights: Dict[int, int] = {}
        self._tweights_raw = ""
        self._tweights: Dict[str, int] = {}
        self._listener_installed = False
        # last multi-statement drain burst (size, monotonic ts): the
        # admission→batch-former hand-off — a drain that
        # releases K statements at once is exactly the moment a
        # multi-lane device launch is worth forming
        self._last_burst: Tuple[int, float] = (0, 0.0)

    # -- flags ------------------------------------------------------------

    @staticmethod
    def _flag_int(name: str, dflt: int) -> int:
        try:
            return int(get_config().get(name))
        except Exception:  # noqa: BLE001 — config not initialized
            return dflt

    def slots(self) -> int:
        return self._flag_int("max_running_queries", 0)

    def enabled(self) -> bool:
        return self.slots() > 0

    def capacity(self) -> int:
        return self._flag_int("admission_queue_capacity", 64)

    def watermark(self) -> int:
        return self._flag_int("admission_memory_watermark_bytes", 0)

    def _weight(self, sid: int) -> int:
        try:
            raw = str(get_config().get("admission_session_weights"))
        except Exception:  # noqa: BLE001
            raw = ""
        if raw != self._weights_raw:
            # parse once per distinct flag value; garbage entries are
            # dropped (a half-typed UPDATE CONFIGS must not zero the
            # whole map)
            parsed: Dict[int, int] = {}
            for part in raw.split(","):
                part = part.strip()
                if not part or ":" not in part:
                    continue
                k, _, v = part.partition(":")
                try:
                    parsed[int(k)] = max(int(v), 1)
                except ValueError:
                    continue
            self._weights_raw, self._weights = raw, parsed
        return self._weights.get(sid, 1)

    def _tenant_weight(self, user: str) -> int:
        try:
            raw = str(get_config().get("admission_tenant_weights"))
        except Exception:  # noqa: BLE001
            raw = ""
        if raw != self._tweights_raw:
            parsed: Dict[str, int] = {}
            for part in raw.split(","):
                part = part.strip()
                if not part or ":" not in part:
                    continue
                k, _, v = part.partition(":")
                try:
                    parsed[k.strip()] = max(int(v), 1)
                except ValueError:
                    continue
            self._tweights_raw, self._tweights = raw, parsed
        return self._tweights.get(user, 1)

    def _ensure_listener(self):
        """A capacity/watermark/weight bump via UPDATE CONFIGS or
        PUT /flags must drain a waiting queue WITHOUT a restart — the
        config layer's listener hook is exactly that kick."""
        if self._listener_installed:
            return
        self._listener_installed = True

        def on_flag(name, _value):
            if name in ("max_running_queries", "admission_queue_capacity",
                        "admission_memory_watermark_bytes",
                        "admission_session_weights",
                        "admission_tenant_weights"):
                self.kick()
        get_config().listeners.append(on_flag)

    # -- memory gate ------------------------------------------------------

    def _mem_total_locked(self) -> int:
        return sum(int(getattr(w.tracker, "used", 0) or 0)
                   for w in self._running.values())

    def _mem_ok_locked(self, wm: int) -> bool:
        if wm <= 0:
            return True
        if not self._running:
            return True      # always admit one: the gate must not wedge
        return self._mem_total_locked() < wm

    # -- metrics ----------------------------------------------------------

    def _gauges_locked(self):
        from .stats import stats
        stats().gauge("admission_running", float(len(self._running)))
        stats().gauge("admission_queue_depth", float(self._queued_n))

    def _note_admit_locked(self, w: _Waiter):
        """Per-tenant admission accounting: the `tenant_dwrr_share`
        gauge is this tenant's lifetime share of admissions — under
        sustained contention it converges to the weight ratio (the
        fleet QoS proof reads it)."""
        u = w.user or "-"
        self._tenant_admits[u] = self._tenant_admits.get(u, 0) + 1
        self._admit_total += 1
        from .stats import stats
        stats().gauge_labeled(
            "tenant_dwrr_share", {"tenant": u},
            round(self._tenant_admits[u] / self._admit_total, 4))

    # -- acquire / release ------------------------------------------------

    def acquire(self, qid: int, session: int, kind: str, live=None,
                tracker=None, user: str = "") -> Optional[Ticket]:
        """Block until the statement may run.  Returns a Ticket (or
        None when admission is disabled — the zero-cost sentinel path).
        Raises OverloadError (shed, queue full), DeadlineExceeded
        (budget expired while queued — no slot consumed) or
        QueryKilled (killed while queued).  `user` is the tenant
        identity for the outer DWRR rotation."""
        slots = self.slots()
        if slots <= 0:
            return None
        self._ensure_listener()
        from .stats import stats
        if is_control_stmt(kind):
            # priority lane: the cluster stays operable at saturation
            stats().inc_labeled("admission_bypass", {"kind": kind})
            return Ticket(self, "bypass", qid)
        w = _Waiter(qid, session, kind, live, tracker, user=user)
        with self._mu:
            # the fast path requires an EMPTY queue (total, both
            # bands): an analytic arrival must not jump a queued
            # interactive statement, and vice versa FIFO order holds
            if self._queued_n == 0 and len(self._running) < slots \
                    and self._mem_ok_locked(self.watermark()):
                # fast path: empty queue, free slot, memory headroom
                self._running[qid] = w
                w.admitted = True
                self._note_admit_locked(w)
                self._gauges_locked()
                return Ticket(self, "admitted", qid)
            if self._queued_n >= max(self.capacity(), 0):
                depth = self._queued_n
                retry = self._drain_est.retry_after_s(depth)
                stats().inc("admission_shed")
                raise OverloadError(
                    retry, "graphd:admission",
                    f"admission queue full (depth={depth}, "
                    f"capacity={self.capacity()}, "
                    f"running={len(self._running)})")
        # enqueue (outside the lock: the failpoint may sleep or raise —
        # `admission:enqueue` armed with delay() holds a statement at
        # the enqueue boundary, raise() rejects it)
        from .failpoints import fail
        fail.hit("admission:enqueue", key=kind)
        with self._mu:
            if self._queued_n >= max(self.capacity(), 0):
                # re-check after the unlocked failpoint window: the
                # capacity bound stays honest under concurrent arrivals
                depth = self._queued_n
                retry = self._drain_est.retry_after_s(depth)
                stats().inc("admission_shed")
                raise OverloadError(
                    retry, "graphd:admission",
                    f"admission queue full (depth={depth}, "
                    f"capacity={self.capacity()}, "
                    f"running={len(self._running)})")
            if w.analytic:
                # below-interactive band: FIFO, drained only when the
                # DWRR rotation is empty
                self._analytic.append(w)
            else:
                t = self._tenants.get(user)
                if t is None:
                    t = self._tenants[user] = {
                        "queues": OrderedDict(), "rr": deque(),
                        "deficit": {}}
                    self._trr.append(user)
                q = t["queues"].get(session)
                if q is None:
                    q = t["queues"][session] = deque()
                    t["rr"].append(session)
                q.append(w)
            self._queued_n += 1
            if live is not None:
                live.queued = True
            stats().inc("admission_enqueued")
            self._gauges_locked()
        # the enqueue raced a release: a drain may already owe us a slot
        self._drain()
        return self._wait(w)

    def _wait(self, w: _Waiter) -> Ticket:
        from .stats import stats
        while True:
            if w.event.wait(self.POLL_S):
                break
            kill = _cancel.current_kill()
            if kill is not None and kill.is_set():
                if self._evict(w):
                    stats().inc("admission_kill_evictions")
                    raise _cancel.QueryKilled(
                        "query was killed while queued for admission")
                break      # admitted in the race — scheduler kills it
            rem = _cancel.remaining()
            if rem is not None and rem <= 0:
                if self._evict(w):
                    # the ISSUE's contract: budget spent while QUEUED →
                    # E_QUERY_TIMEOUT without ever consuming a slot
                    stats().inc("admission_deadline_evictions")
                    raise _cancel.DeadlineExceeded(
                        "deadline exhausted while queued for admission")
                break
            # watermark may have dropped / flags may have changed with
            # no release to kick the drain — re-check on the poll beat
            self._drain()
        waited_us = int((time.monotonic() - w.t_enq) * 1e6)
        if w.live is not None:
            w.live.queued = False
            w.live.add("queue_us", waited_us)
        stats().observe("admission_queue_wait_us", waited_us)
        return Ticket(self, "admitted", w.qid, queue_wait_us=waited_us)

    def _evict(self, w: _Waiter) -> bool:
        """Remove a queued waiter (kill/deadline).  False when the
        waiter won admission in the race — the caller then proceeds
        with the slot and lets the scheduler's own cancel check fire."""
        with self._mu:
            if w.admitted:
                return False
            w.cancelled = True
            if w.analytic:
                q = self._analytic
            else:
                t = self._tenants.get(w.user)
                q = t["queues"].get(w.session) if t else None
            if q is not None:
                try:
                    q.remove(w)
                except ValueError:
                    pass
            self._queued_n = max(self._queued_n - 1, 0)
            self._gauges_locked()
            return True

    def _release_slot(self, qid: int):
        with self._mu:
            if self._running.pop(qid, None) is None:
                return
            self._gauges_locked()
        self._drain_est.note_done()
        self._drain()

    def kick(self):
        """Re-drain on external state changes (config listener)."""
        self._drain()

    # -- the DWRR drain ---------------------------------------------------

    def _session_next_locked(self, t: dict) -> Optional[_Waiter]:
        """Inner rotation: next waiter of ONE tenant by session-weighted
        DWRR (the pre-fleet algorithm, verbatim, scoped to the
        tenant)."""
        rr, queues, deficit = t["rr"], t["queues"], t["deficit"]
        guard = 2 * len(rr) + 2
        for _ in range(guard):
            if not rr:
                return None
            sid = rr[0]
            q = queues.get(sid)
            if not q:
                rr.popleft()
                queues.pop(sid, None)
                deficit.pop(sid, None)
                continue
            if deficit.get(sid, 0.0) >= 1.0:
                deficit[sid] -= 1.0
                return q.popleft()
            deficit[sid] = deficit.get(sid, 0.0) + self._weight(sid)
            rr.rotate(-1)
        return None

    def _drr_next_locked(self) -> Optional[_Waiter]:
        """Next waiter by TWO-LEVEL deficit-weighted round-robin: the outer rotation credits each backlogged tenant
        its `admission_tenant_weights` weight per visit, one admission
        costs one credit — so tenants split admissions in proportion
        to their quotas no matter how many sessions an aggressor
        opens; within a tenant the session rotation splits its share
        by the session weights.  An emptied tenant's deficit dies with
        its queues (no banked bursts)."""
        tguard = 2 * len(self._trr) + 2
        for _ in range(tguard):
            if not self._trr:
                return None
            u = self._trr[0]
            t = self._tenants.get(u)
            if t is None or not any(t["queues"].values()):
                self._trr.popleft()
                self._tenants.pop(u, None)
                self._tdeficit.pop(u, None)
                continue
            if self._tdeficit.get(u, 0.0) >= 1.0:
                w = self._session_next_locked(t)
                if w is None:
                    # queues raced empty between the check and the pick
                    self._trr.rotate(-1)
                    continue
                self._tdeficit[u] -= 1.0
                self._queued_n = max(self._queued_n - 1, 0)
                return w
            self._tdeficit[u] = self._tdeficit.get(u, 0.0) \
                + self._tenant_weight(u)
            self._trr.rotate(-1)
        return None

    def _next_locked(self) -> Optional[_Waiter]:
        """DWRR first; the analytics band drains ONLY when no
        interactive statement waits (strict below-interactive
        priority)."""
        w = self._drr_next_locked()
        if w is None and self._analytic:
            w = self._analytic.popleft()
            self._queued_n = max(self._queued_n - 1, 0)
        return w

    def _drain(self):
        admitted = []
        with self._mu:
            slots = self.slots()
            wm = self.watermark()
            while self._queued_n > 0:
                if slots > 0 and len(self._running) >= slots:
                    break
                if slots > 0 and not self._mem_ok_locked(wm):
                    break
                w = self._next_locked()
                if w is None:
                    break
                # slots<=0 → admission was disabled live: everyone goes
                self._running[w.qid] = w
                w.admitted = True
                self._note_admit_locked(w)
                admitted.append(w)
            if admitted:
                self._gauges_locked()
            if len(admitted) > 1:
                # hand the burst to the device batch former:
                # K statements released together are K candidate lanes
                self._last_burst = (len(admitted), time.monotonic())
        for w in admitted:
            w.event.set()

    def concurrency_hint(self) -> bool:
        """Is concurrent statement traffic in evidence right now?  The
        device batch former (tpu/batch.py) consults this before paying
        the forming window: queued or multiply-running statements, or a
        drain burst within the last quarter second, mean batchmates are
        plausibly en route.  Plain int reads — GIL-atomic, no lock."""
        if self._queued_n > 0 or len(self._running) > 1:
            return True
        n, ts = self._last_burst
        return n >= 2 and (time.monotonic() - ts) < 0.25

    # -- introspection ----------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        with self._mu:
            return {
                "slots": self.slots(),
                "running": len(self._running),
                "queued": self._queued_n,
                "queued_by_session": {
                    sid: len(q)
                    for t in self._tenants.values()
                    for sid, q in t["queues"].items() if q},
                "queued_by_tenant": {
                    u or "-": sum(len(q) for q in t["queues"].values())
                    for u, t in self._tenants.items()
                    if any(t["queues"].values())},
                "analytic_queued": len(self._analytic),
                "memory_bytes": self._mem_total_locked(),
                "drain_rate_per_s": round(self._drain_est.rate(), 3),
            }

    def tenant_snapshot(self) -> list:
        """Per-tenant admission rows (SHOW TENANTS / GET /tenants):
        weight, live running/queued counts, lifetime admissions and
        admission share on THIS graphd — the cluster view sums rows
        across the fleet."""
        with self._mu:
            users = set(self._tenant_admits)
            users.update(u or "-" for u in self._tenants)
            users.update((w.user or "-") for w in self._running.values())
            tot = max(self._admit_total, 1)
            rows = []
            for u in sorted(users):
                t = self._tenants.get("" if u == "-" else u)
                rows.append({
                    "tenant": u,
                    "weight": self._tenant_weight("" if u == "-" else u),
                    "running": sum(1 for w in self._running.values()
                                   if (w.user or "-") == u),
                    "queued": sum(len(q) for q in t["queues"].values())
                    if t else 0,
                    "admitted": self._tenant_admits.get(u, 0),
                    "share": round(
                        self._tenant_admits.get(u, 0) / tot, 4),
                })
            return rows

    def reset(self):
        """Test isolation: wake every waiter and drop all state."""
        with self._mu:
            waiters = [w for t in self._tenants.values()
                       for q in t["queues"].values() for w in q]
            waiters.extend(self._analytic)
            self._tenants.clear()
            self._trr.clear()
            self._tdeficit.clear()
            self._tenant_admits.clear()
            self._admit_total = 0
            self._analytic.clear()
            self._queued_n = 0
            self._running.clear()
        for w in waiters:
            w.admitted = True
            w.event.set()


_controller = AdmissionController()


def admission() -> AdmissionController:
    """The process-wide controller (engines acquire around
    scheduler.run; GET /admission and the bench read snapshot())."""
    return _controller
