"""The port's copy of `nebula_tpu/utils/workload.py`, whole.

Live workload plane: who is running WHAT, right now.

PROFILE and the flight recorder only report statements after
they complete; admission control needs to see
the cluster's in-flight state — and a wedged statement (a device
dispatch stuck behind a re-pin, a stuck RPC) needs to leave evidence while
it is still wedged, not after its budget burned.  Three pieces:

  * `WorkloadRegistry` — every executing statement registers a
    `LiveQuery` carrying live progress: the plan node currently
    running, rows produced so far, queue-wait vs device vs host µs,
    memory charged.  The scheduler updates it per plan node (a handful
    of attribute writes — the ≤2 % overhead budget), the device
    runtime adds queue/dispatch time through the `current_live()`
    thread-local.  Served by `SHOW QUERIES` / `SHOW SESSIONS`,
    `GET /queries` on every daemon, and metad's federated
    `GET /cluster_queries`.

  * `DispatchTable` — the device dispatch queue's live state: each
    kernel dispatch registers queued→running→done transitions, so the
    queue depth gauge and the stall watchdog see a dispatch that never
    came back.  Kept here (not in the gpu package) so the webservice
    and watchdog never import torch.

  * `StallWatchdog` — a daemon thread that scans both tables every
    `stall_watchdog_interval_secs`.  Any statement exceeding its
    deadline-derived stall threshold (or any dispatch stuck past
    `stall_default_secs`) gets ONE capture: all thread stacks, the
    in-flight dispatch table, the kernel-ledger tail and the live
    registry snapshot, appended to a bounded ring (`GET /stalls`,
    `SHOW STALLS`) plus a forced flight-recorder entry — purely
    observational, the stalled statement is never touched.
"""
from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from .config import define_flag, get_config

define_flag("workload_plane_enabled", True,
            "maintain the live per-statement registry behind "
            "SHOW QUERIES / GET /queries (off = register nothing; "
            "the A/B lever for the bench overhead probe)")
define_flag("stall_watchdog_interval_secs", 1.0,
            "how often the stall watchdog scans in-flight statements "
            "and device dispatches (0 disables the thread; scan_once() "
            "still works for tests)")
define_flag("stall_threshold_secs", 0.0,
            "flat stall threshold; 0 derives it per statement from the "
            "deadline budget (stall_deadline_fraction) or falls back "
            "to stall_default_secs when unbudgeted")
define_flag("stall_deadline_fraction", 0.5,
            "deadline-derived threshold: a statement is stalled once "
            "it has burned this fraction of its query_timeout_secs "
            "budget without finishing")
define_flag("stall_default_secs", 20.0,
            "stall threshold for unbudgeted statements and for device "
            "dispatches (which carry no deadline of their own)")
define_flag("stall_ring_capacity", 64,
            "stall captures retained in the ring behind GET /stalls")


# -- live statement registry ------------------------------------------------


class LiveQuery:
    """One in-flight statement's live progress.  Hot-path writers touch
    single attributes (GIL-atomic); the small lock only guards the
    read-modify-write accumulators."""

    __slots__ = ("qid", "session", "user", "stmt", "kind", "t0", "m0",
                 "deadline", "node_kind", "node_id", "nodes_done",
                 "rows", "queue_us", "device_us", "dispatches",
                 "tracker", "killed", "queued", "consistency",
                 "batch_id", "lane", "batch_lanes", "fingerprint",
                 "_lock")

    def __init__(self, qid: int, session: int, user: str, stmt: str,
                 kind: str, deadline: Optional[float] = None,
                 tracker=None, consistency: str = "leader",
                 fingerprint: Optional[str] = None):
        self.qid = qid
        self.session = session
        self.user = user
        self.stmt = stmt
        self.kind = kind
        self.t0 = time.time()
        self.m0 = time.monotonic()
        self.deadline = deadline          # absolute time.monotonic()
        self.node_kind = ""               # current plan node
        self.node_id = -1
        self.nodes_done = 0
        self.rows = 0                     # rows produced by DONE nodes
        self.queue_us = 0                 # device dispatch-queue wait
        self.device_us = 0                # device run time
        self.dispatches = 0
        self.tracker = tracker            # MemoryTracker (bytes charged)
        self.killed = False
        self.queued = False               # waiting in the admission queue
        # the statement's effective read-consistency level:
        # surfaced in SHOW QUERIES so an operator can see which reads
        # are leader-bound vs replica-spread at a glance
        self.consistency = consistency
        # multi-lane batched dispatch: while this statement
        # is enrolled in a forming/in-flight device batch, the group id
        # and this statement's lane — SHOW QUERIES renders "bid/lane"
        self.batch_id: Optional[int] = None
        self.lane: Optional[int] = None
        # lanes the statement actually shared a launch with (the
        # insights registry's batching-share column reads this at
        # completion; stays 0 for solo dispatches)
        self.batch_lanes: int = 0
        # statement fingerprint: joins this in-flight row
        # against the aggregate SHOW STATEMENTS table
        self.fingerprint = fingerprint or ""
        self._lock = threading.Lock()

    # -- scheduler hooks (one per plan node) -----------------------------

    def node_start(self, kind: str, node_id: int):
        self.node_kind = kind
        self.node_id = node_id

    def node_done(self, rows: int):
        with self._lock:
            self.nodes_done += 1
            self.rows += int(rows)

    def set_operator(self, label: str):
        """Finer-than-node progress (fused pipeline segments)."""
        self.node_kind = label

    # -- runtime hooks ---------------------------------------------------

    def add(self, field: str, n: int):
        with self._lock:
            setattr(self, field, getattr(self, field) + int(n))

    # -- reading ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        elapsed_us = int((time.monotonic() - self.m0) * 1e6)
        queue_us, device_us = self.queue_us, self.device_us
        host_us = max(elapsed_us - queue_us - device_us, 0)
        return {
            "qid": self.qid, "session": self.session, "user": self.user,
            "stmt": self.stmt[:500], "kind": self.kind,
            "status": ("KILLED" if self.killed
                       else "QUEUED" if self.queued else "RUNNING"),
            "start_ts": self.t0,
            "duration_us": elapsed_us,
            "operator": (f"{self.node_kind}#{self.node_id}"
                         if self.node_kind else ""),
            "nodes_done": self.nodes_done,
            "rows": self.rows,
            "queue_us": queue_us,
            "device_us": device_us,
            "host_us": host_us,
            "dispatches": self.dispatches,
            "memory_bytes": int(getattr(self.tracker, "used", 0) or 0),
            "consistency": self.consistency,
            "batch": (f"{self.batch_id}/{self.lane}"
                      if self.batch_id is not None else ""),
            "fingerprint": self.fingerprint,
        }


class WorkloadRegistry:
    """Process-wide map of in-flight statements (all engines)."""

    def __init__(self):
        self._live: Dict[int, LiveQuery] = {}
        self._lock = threading.Lock()

    @staticmethod
    def enabled() -> bool:
        try:
            return bool(get_config().get("workload_plane_enabled"))
        except Exception:  # noqa: BLE001 — config not initialized
            return True

    def register(self, **kw) -> Optional[LiveQuery]:
        if not self.enabled():
            return None
        lq = LiveQuery(**kw)
        with self._lock:
            self._live[lq.qid] = lq
            n = len(self._live)
        from .stats import stats
        stats().gauge("live_queries", float(n))
        return lq

    def deregister(self, qid: int):
        with self._lock:
            if self._live.pop(qid, None) is None:
                return
            n = len(self._live)
        from .stats import stats
        stats().gauge("live_queries", float(n))

    def get(self, qid: int) -> Optional[LiveQuery]:
        with self._lock:
            return self._live.get(qid)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            entries = list(self._live.values())
        return [e.snapshot() for e in sorted(entries,
                                             key=lambda x: x.qid)]

    def __len__(self):
        with self._lock:
            return len(self._live)


_registry = WorkloadRegistry()


def live_registry() -> WorkloadRegistry:
    """The process-wide registry (served at /queries, SHOW QUERIES)."""
    return _registry


_live_tls = threading.local()


def current_live() -> Optional[LiveQuery]:
    return getattr(_live_tls, "live", None)


class _LiveGuard:
    __slots__ = ("_lq", "_prev")

    def __init__(self, lq: Optional[LiveQuery]):
        self._lq = lq

    def __enter__(self):
        self._prev = getattr(_live_tls, "live", None)
        _live_tls.live = self._lq
        return self._lq

    def __exit__(self, *exc):
        _live_tls.live = self._prev
        return False


def use_live(lq: Optional[LiveQuery]) -> _LiveGuard:
    """Install `lq` as this thread's live-progress target (mirrors
    use_work/use_cost: the scheduler re-installs it on fan-out pool
    threads so device queue/dispatch time attributes to the right
    statement)."""
    return _LiveGuard(lq)


# -- device dispatch table --------------------------------------------------


class _DispatchToken:
    __slots__ = ("seq", "kernel", "qid", "t_queued", "t_run", "thread")

    def __init__(self, seq: int, kernel: str, qid: Optional[int]):
        self.seq = seq
        self.kernel = kernel
        self.qid = qid
        self.t_queued = time.monotonic()
        self.t_run: Optional[float] = None
        self.thread = threading.get_ident()

    def snapshot(self) -> Dict[str, Any]:
        now = time.monotonic()
        running = self.t_run is not None
        return {
            "seq": self.seq, "kernel": self.kernel, "qid": self.qid,
            "state": "running" if running else "queued",
            "wait_us": int(((self.t_run if running else now)
                            - self.t_queued) * 1e6),
            "run_us": int((now - self.t_run) * 1e6) if running else 0,
            "thread": self.thread,
        }


class DispatchTable:
    """Live device dispatches: queued (waiting on the dispatch gate) or
    running (inside the jitted call).  The runtime drives transitions;
    the watchdog and GET /queries read."""

    def __init__(self):
        self._inflight: Dict[int, _DispatchToken] = {}
        self._lock = threading.Lock()
        self._seq = 0

    def enter(self, kernel: str) -> _DispatchToken:
        lv = current_live()
        with self._lock:
            self._seq += 1
            tok = _DispatchToken(self._seq, kernel,
                                 lv.qid if lv is not None else None)
            self._inflight[tok.seq] = tok
        self._gauge()
        return tok

    def mark_running(self, tok: _DispatchToken) -> int:
        """Gate acquired → running.  Returns the queue wait in µs."""
        tok.t_run = time.monotonic()
        self._gauge()
        return int((tok.t_run - tok.t_queued) * 1e6)

    def exit(self, tok: _DispatchToken):
        with self._lock:
            self._inflight.pop(tok.seq, None)
        self._gauge()

    def _gauge(self):
        with self._lock:
            queued = sum(1 for t in self._inflight.values()
                         if t.t_run is None)
        from .stats import stats
        stats().gauge("tpu_dispatch_queue_depth", float(queued))

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            toks = list(self._inflight.values())
        return [t.snapshot() for t in sorted(toks, key=lambda x: x.seq)]

    def queued_depth(self) -> int:
        """Dispatches waiting on the gate right now — the overload
        signal `tpu_dispatch_queue_cap` (utils/admission.py) judges."""
        with self._lock:
            return sum(1 for t in self._inflight.values()
                       if t.t_run is None)

    def __len__(self):
        with self._lock:
            return len(self._inflight)


_dispatches = DispatchTable()


def dispatch_table() -> DispatchTable:
    return _dispatches


# -- stall watchdog ---------------------------------------------------------


def _thread_stacks() -> Dict[str, List[str]]:
    """Formatted stack of every live thread, keyed `name (ident)` —
    the post-mortem a wedged device dispatch otherwise denies us."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for ident, frame in sys._current_frames().items():
        key = f"{names.get(ident, '?')} ({ident})"
        out[key] = [ln.rstrip("\n") for ln in
                    traceback.format_stack(frame)]
    return out


class StallWatchdog:
    """Scans the live registry + dispatch table; captures each stalled
    entity exactly once into a bounded ring."""

    def __init__(self):
        self._ring: "deque[dict]" = deque()
        self._lock = threading.Lock()
        self._seq = 0
        self._seen_q: set = set()         # qids already captured
        self._seen_d: set = set()         # dispatch seqs already captured
        # serializes whole scans: the background thread and an on-
        # demand scan_once() caller (tests, tools) must not both pass
        # the seen-set check for one stalled entity — "captured
        # exactly once" is the documented contract
        self._scan_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- thresholds ------------------------------------------------------

    @staticmethod
    def _flags():
        cfg = get_config()

        def g(name, dflt):
            try:
                return float(cfg.get(name))
            except Exception:  # noqa: BLE001 — config not initialized
                return dflt
        return (g("stall_threshold_secs", 0.0),
                g("stall_deadline_fraction", 0.5),
                g("stall_default_secs", 20.0))

    @staticmethod
    def _stmt_threshold(lq: LiveQuery, flat: float, frac: float,
                        dflt: float) -> float:
        if flat > 0:
            return flat
        if lq.deadline is not None:
            budget = lq.deadline - lq.m0
            if budget > 0:
                return budget * frac
        return dflt

    @staticmethod
    def stmt_threshold_s(lq: LiveQuery) -> float:
        """Deadline-derived: a budgeted statement is stalled once it
        burned `stall_deadline_fraction` of its budget; an unbudgeted
        one after `stall_default_secs`.  `stall_threshold_secs` > 0
        overrides both (the test/ops lever)."""
        return StallWatchdog._stmt_threshold(lq, *StallWatchdog._flags())

    # -- scanning --------------------------------------------------------

    def scan_once(self) -> int:
        """One scan; returns the number of NEW stall captures THIS call
        made.  Scans serialize on _scan_lock, so the background thread
        and an on-demand caller can never double-capture one entity —
        whoever scans first wins, the other sees it in _seen_*."""
        with self._scan_lock:
            now = time.monotonic()
            captured = 0
            flat, frac, dflt = self._flags()
            for lq in list(live_registry()._live.values()):
                if lq.qid in self._seen_q:
                    continue
                elapsed = now - lq.m0
                thr = self._stmt_threshold(lq, flat, frac, dflt)
                if elapsed > thr:
                    self._seen_q.add(lq.qid)
                    self._capture("statement", lq.snapshot(), elapsed,
                                  thr)
                    self._flight_capture(lq, elapsed)
                    captured += 1
            d_thr = flat if flat > 0 else dflt
            for tok in list(dispatch_table()._inflight.values()):
                if tok.seq in self._seen_d:
                    continue
                elapsed = now - tok.t_queued
                if elapsed > d_thr:
                    self._seen_d.add(tok.seq)
                    self._capture("dispatch", tok.snapshot(), elapsed,
                                  d_thr)
                    captured += 1
            # forget finished entities so their ids can't leak the
            # sets (set(dict) is one C-level pass — atomic under the
            # GIL, unlike a comprehension racing register() inserts)
            self._seen_q &= set(live_registry()._live)
            self._seen_d &= set(dispatch_table()._inflight)
            return captured

    def _capture(self, kind: str, subject: Dict[str, Any],
                 elapsed: float, threshold: float):
        from .flight import kernel_ledger
        from .stats import stats
        entry = {
            "ts": time.time(),
            "kind": kind,
            "subject": subject,
            "elapsed_s": round(elapsed, 3),
            "threshold_s": round(threshold, 3),
            "stacks": _thread_stacks(),
            "dispatches": dispatch_table().snapshot(),
            "kernels": kernel_ledger().list(limit=16),
            "live": live_registry().snapshot(),
        }
        try:
            cap = int(get_config().get("stall_ring_capacity"))
        except Exception:  # noqa: BLE001
            cap = 64
        with self._lock:
            self._seq += 1
            entry["id"] = self._seq
            self._ring.append(entry)
            while len(self._ring) > max(cap, 1):
                self._ring.popleft()
        stats().inc_labeled("stall_events", {"kind": kind})

    @staticmethod
    def _flight_capture(lq: LiveQuery, elapsed: float):
        """Forced flight-recorder entry for the stalled statement — the
        incident evidence survives even if the statement never
        completes (its own completion record would then never land)."""
        from .flight import flight_recorder
        try:
            flight_recorder().record(
                stmt=lq.stmt, kind=lq.kind,
                latency_us=int(elapsed * 1e6), error=None,
                trace_id=None, session=lq.session,
                operators=[lq.snapshot()], force="stalled",
                fingerprint=lq.fingerprint)
        except Exception:  # noqa: BLE001 — watchdog must never throw
            pass

    # -- reading ---------------------------------------------------------

    def get(self, entry_id: int) -> Optional[dict]:
        with self._lock:
            for e in self._ring:
                if e["id"] == entry_id:
                    return e
        return None

    def list(self, limit: int = 20) -> List[dict]:
        """Newest-first summaries (no stack bodies)."""
        if limit <= 0:
            return []
        with self._lock:
            entries = list(self._ring)
        return [{"id": e["id"], "ts": e["ts"], "kind": e["kind"],
                 "elapsed_s": e["elapsed_s"],
                 "threshold_s": e["threshold_s"],
                 "subject": {k: v for k, v in e["subject"].items()
                             if k != "stmt"} | (
                     {"stmt": e["subject"]["stmt"][:120]}
                     if "stmt" in e["subject"] else {}),
                 "threads": len(e["stacks"])}
                for e in reversed(entries[-limit:])]

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._seen_q.clear()
            self._seen_d.clear()

    # -- lifecycle -------------------------------------------------------

    def ensure_started(self):
        """Idempotent: start the scan thread if the interval flag says
        so and it is not already running (engines call this at
        construction; tests drive scan_once() directly)."""
        if self._thread is not None and self._thread.is_alive():
            return
        try:
            interval = float(get_config().get(
                "stall_watchdog_interval_secs"))
        except Exception:  # noqa: BLE001
            interval = 1.0
        if interval <= 0:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.scan_once()
                except Exception:  # noqa: BLE001 — keep the loop alive
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="stall-watchdog")
        self._thread.start()

    def stop(self):
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=2)


_watchdog = StallWatchdog()


def stall_watchdog() -> StallWatchdog:
    """The process-wide watchdog (served at /stalls, SHOW STALLS)."""
    return _watchdog
