"""Live workload plane: who is running what, right now.

The port's copy of nebula_tpu/utils/workload.py:71-345:

  * `WorkloadRegistry` — every executing statement registers a
    `LiveQuery` carrying its live progress (queue-wait vs device µs,
    dispatches, and while it is enrolled in a device batch its batch id
    and lane).  The device runtime adds queue and dispatch time through
    the `current_live()` thread-local.  The batch former's concurrency
    hint reads its size (gpu/batch.py).

  * `DispatchTable` — the device dispatch queue's live state: each
    dispatch registers queued → running → done, so the queue depth
    gauge sees a dispatch waiting on the runtime's gate.

The stall watchdog and the flight recorder stay in the reference.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from .config import define_flag, get_config

define_flag("workload_plane_enabled", True,
            "maintain the live per-statement registry (off = register "
            "nothing)")


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
        # the statement's effective read-consistency level
        self.consistency = consistency
        # multi-lane batched dispatch: while this statement is enrolled
        # in a forming/in-flight device batch, the group id and this
        # statement's lane (snapshot() renders "bid/lane")
        self.batch_id: Optional[int] = None
        self.lane: Optional[int] = None
        # lanes the statement actually shared a launch with (stays 0
        # for solo dispatches)
        self.batch_lanes: int = 0
        # statement fingerprint
        self.fingerprint = fingerprint or ""
        self._lock = threading.Lock()

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
    """Process-wide map of in-flight statements."""

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
    """The process-wide registry."""
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
    running (its kernels launched).  The runtime drives transitions;
    `snapshot()` and the queue-depth gauge read."""

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

    def __len__(self):
        with self._lock:
            return len(self._inflight)


_dispatches = DispatchTable()


def dispatch_table() -> DispatchTable:
    return _dispatches
