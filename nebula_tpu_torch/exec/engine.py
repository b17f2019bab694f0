"""The port's copy of `nebula_tpu/exec/engine.py`, whole.

QueryEngine + Session: the statement lifecycle.

Analog of the reference's QueryInstance (parse → validate → plan →
optimize → schedule → respond; reference: src/graph/service), in-process form.  The cluster
graphd (nebula_tpu.cluster.graph) wraps this with auth/RPC/session
registry.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from ..core.value import DataSet
from ..graphstore.store import GraphStore
from ..query import ast as A
from ..query.optimizer import optimize
from ..query.parser import ParseError, parse
from ..query.planner import PlannerContext, QueryError, plan_statement
from .context import ExecutionContext, QueryContext, ResultSet
from .scheduler import ProfileStats, Scheduler

_session_ids = itertools.count(1)
_query_ids = itertools.count(1)

from ..utils.config import define_flag as _define_flag

_define_flag("plan_cache_size", 128,
             "parsed-plan LRU entries per engine (0 disables); keyed by "
             "(statement text, space, schema epoch) — DDL bumps the "
             "epoch, so stale plans can never hit")
_define_flag("slow_log_capacity", 256,
             "slow-log entries retained per engine (ring buffer; the "
             "old unbounded list leaked one dict per slow query for "
             "the life of the process)")
_define_flag("result_cache_size", 0,
             "result-cache LRU entries per engine (0 = disabled, the "
             "default — byte-identical to the pre-cache engine); "
             "read-only statements are keyed like the plan cache PLUS "
             "the engine's write epoch, so any DDL or mutating "
             "statement through this engine structurally invalidates "
             "every cached result.  Hot repeated reads then serve "
             "from graphd memory — surviving even total storage "
             "unavailability within an epoch")
_define_flag("result_cache_strict_epoch", False,
             "leader-consistency cached reads pull metad's merged "
             "cluster epoch table at admission (one RPC) before the "
             "cache key is formed — closes even the heartbeat window "
             "for cross-coordinator invalidation; weaker "
             "consistency levels keep the bounded heartbeat window")

# read-only statement kinds whose plans are reusable verbatim: planning
# depends only on (text, space, catalog) for these.  DML/DDL/admin
# statements are cheap to plan and carry side-effect nodes — never
# cached.
_CACHEABLE_KINDS = frozenset({
    "Go", "Match", "Lookup", "FetchVertices", "FetchEdges", "Yield",
    "FindPath", "GetSubgraph", "GroupBy", "Unwind"})

# statement kinds that can NOT change graph data: they never bump the
# engine's write epoch (the result cache).  Everything else —
# DML, DDL, jobs, balance, restore — bumps it once per successful
# statement; over-bumping is always safe (a lost cache hit, never a
# stale one), so the set is deliberately small and explicit.
_NON_MUTATING_KINDS = _CACHEABLE_KINDS | frozenset({
    "Use", "Explain", "Describe", "DescribeUser", "DescZone",
    "GetConfigs", "OrderBy", "Limit", "Sample",
    # CALL algo.* reads the graph; it is deliberately NOT result/plan
    # cacheable (long-running, parameterized) but must not bump the
    # write epoch either
    "CallAlgo"})


def _bumps_write_epoch(kind: str) -> bool:
    return kind not in _NON_MUTATING_KINDS \
        and not kind.startswith(("Show", "Kill"))


class PlanCache:
    """LRU of (statement text, space, schema epoch, device flag) →
    (parsed stmt, optimized plan).  Plans are reusable because nothing
    mutates PlanNodes after optimize() (executors read args; all
    per-run state lives in the ExecutionContext), and the schema epoch
    in the key makes DDL invalidation automatic — ALTER/CREATE TAG or
    index DDL bumps the catalog version, so every cached plan built
    against the old schema simply stops matching and ages out of the
    LRU.  `plan_cache_hits` / `plan_cache_misses` counters and the
    `plan_cache_entries` gauge land in /metrics (docs/OBSERVABILITY.md).
    """

    def __init__(self):
        self._map: "OrderedDict[Tuple, Tuple[Any, Any]]" = OrderedDict()
        self._lock = threading.Lock()

    @staticmethod
    def capacity() -> int:
        from ..utils.config import get_config
        try:
            return int(get_config().get("plan_cache_size"))
        except Exception:  # noqa: BLE001 — config not initialized
            return 0

    def get(self, key: Tuple):
        from ..utils.stats import stats
        with self._lock:
            ent = self._map.get(key)
            if ent is not None:
                self._map.move_to_end(key)
        if ent is not None:
            stats().inc("plan_cache_hits")
        return ent

    def put(self, key: Tuple, stmt, plan):
        cap = self.capacity()
        if cap <= 0:
            return
        from ..utils.stats import stats
        # a put IS the miss: counting at insert time keeps the miss
        # counter scoped to CACHEABLE statements — bulk INSERT/DDL
        # traffic (looked up, never inserted) must not read as a bad
        # hit rate in /metrics
        stats().inc("plan_cache_misses")
        with self._lock:
            self._map[key] = (stmt, plan)
            self._map.move_to_end(key)
            while len(self._map) > cap:
                self._map.popitem(last=False)
            n = len(self._map)
        stats().gauge("plan_cache_entries", n)

    def clear(self):
        with self._lock:
            self._map.clear()

    def __len__(self):
        with self._lock:
            return len(self._map)


class ResultCache:
    """LRU of (statement text, space, schema epoch, device flag, WRITE
    epoch) → the statement's wire-encoded result rows.

    Entries hold `to_wire(rs.data)` — the exact form that ships to a
    client — and hits decode it back with `from_wire`, so a cached
    reply is byte-identical to uncached execution and never aliases
    mutable row lists between consumers.  Invalidation is structural,
    exactly like the plan cache: DDL bumps the catalog version half of
    the key, and every mutating statement through this engine —
    including failed ones, whose non-atomic fan-out may have committed
    some parts — bumps the write epoch half
    (`QueryContext.write_epoch`), so
    a stale result can never be LOOKED UP — it just ages out of the
    LRU.  The payoff: a hot repeated read keeps answering from graphd
    memory even when every storage replica is unreachable, as long as
    no local write has bumped the epoch."""

    def __init__(self):
        self._map: "OrderedDict[Tuple, Tuple[Any, Optional[str]]]" = \
            OrderedDict()
        self._lock = threading.Lock()

    @staticmethod
    def capacity() -> int:
        from ..utils.config import get_config
        try:
            return int(get_config().get("result_cache_size"))
        except Exception:  # noqa: BLE001 — config not initialized
            return 0

    def get(self, key: Tuple):
        from ..utils.stats import stats
        with self._lock:
            ent = self._map.get(key)
            if ent is not None:
                self._map.move_to_end(key)
        if ent is not None:
            stats().inc("result_cache_hits")
        return ent

    def put(self, key: Tuple, wire_data: Any, space: Optional[str]):
        cap = self.capacity()
        if cap <= 0:
            return
        from ..utils.stats import stats
        # a put IS the miss (same scoping rationale as PlanCache.put:
        # only statements that COULD have hit count against the rate)
        stats().inc("result_cache_misses")
        with self._lock:
            self._map[key] = (wire_data, space)
            self._map.move_to_end(key)
            while len(self._map) > cap:
                self._map.popitem(last=False)
            n = len(self._map)
        stats().gauge("result_cache_entries", n)

    def note_invalidated(self):
        """A write-epoch bump made every current entry unreachable —
        count it (the `result_cache_invalidations` metric; a
        dedup-window-replayed write still acks as ONE statement, so it
        bumps — and counts — exactly once)."""
        from ..utils.stats import stats
        with self._lock:
            n = len(self._map)
        if n:
            stats().inc("result_cache_invalidations")

    def clear(self):
        with self._lock:
            self._map.clear()

    def __len__(self):
        with self._lock:
            return len(self._map)


class Session:
    def __init__(self, user: str = "root"):
        self.id = next(_session_ids)
        self.user = user
        self.space: Optional[str] = None
        self.ectx = ExecutionContext()       # persists $var results
        self.var_cols: Dict[str, list] = {}
        self.created = time.time()
        self.last_used = self.created
        self.queries: Dict[int, str] = {}    # qid → text (RUNNING)
        self.running_kill: Dict[int, Any] = {}   # qid → kill Event
        self.killed = False


class QueryEngine:
    """parse → plan → optimize → schedule, one call."""

    def __init__(self, store: Optional[GraphStore] = None,
                 params: Optional[Dict[str, Any]] = None,
                 enable_optimizer: bool = True,
                 tpu_runtime=None):
        self.store = store if store is not None else GraphStore()
        self.qctx = QueryContext(self.store, params)
        self.qctx.tpu_runtime = tpu_runtime
        self.qctx.engine = self          # session admin (KILL SESSION)
        self.scheduler = Scheduler(self.qctx)
        self.enable_optimizer = enable_optimizer
        self._slow_override = (params or {}).get("slow_query_threshold_us")
        # bounded ring: the capacity flag is read at
        # engine construction; a deque drops the oldest entry itself
        from collections import deque
        try:
            from ..utils.config import get_config as _gc
            _cap = int(_gc().get("slow_log_capacity"))
        except Exception:  # noqa: BLE001 — config not initialized
            _cap = 256
        self.slow_log: "deque" = deque(maxlen=max(_cap, 1))
        self.sessions: Dict[int, Session] = {}
        # recently-killed qids: double KILL QUERY is
        # idempotent — the second kill of a qid that already matched
        # (and may have since drained away) succeeds instead of raising
        # "no running query matches"
        self._recent_kills: "deque" = deque(maxlen=256)
        # parse/plan LRU: repeated statements skip
        # parse → validate → plan → optimize entirely
        self.plan_cache = PlanCache()
        # read-only result LRU: hot repeated reads skip
        # execution entirely, invalidated by the same schema epoch plus
        # the engine's write epoch (0-capacity default = disabled)
        self.result_cache = ResultCache()
        # cluster-coherent cache epochs: peers' per-space
        # write epochs, folded from metad heartbeat replies and from
        # this graphd's own storaged write acks.  gen(space) is part of
        # every cache key — a write through ANY coordinator retires
        # this engine's cached entries within the heartbeat window.
        # Standalone engines never fold, so gen stays 0 and keys are
        # byte-identical to the pre-fleet engine.
        from ..utils.epochs import ClusterEpochs
        self.cluster_epochs = ClusterEpochs()
        # strict-mode hook (set by GraphService): pull + fold metad's
        # merged epoch table on demand, for leader-consistency cached
        # reads under `result_cache_strict_epoch`
        self.epoch_sync = None
        # workload insights: per-fingerprint aggregates
        # behind SHOW STATEMENTS.  Per ENGINE, not process-wide: a
        # LocalCluster runs several graphds in one process and the
        # cluster fan-out sums per-graphd registries
        from ..utils.insights import StatementRegistry
        self.insights = StatementRegistry()
        # stall watchdog: idempotent start of the process-wide
        # scan thread; gated by stall_watchdog_interval_secs
        from ..utils.workload import stall_watchdog
        stall_watchdog().ensure_started()

    def new_session(self, user: str = "root") -> Session:
        # reap idle sessions so a long-lived embedded engine doesn't
        # accumulate them (the cluster graphd reaps via metad TTL; the
        # standalone registry uses the same idle-timeout flag)
        from ..utils.config import get_config
        ttl = float(get_config().get("session_idle_timeout_secs"))
        now = time.time()
        # list() snapshots atomically under the GIL — a comprehension
        # runs bytecode per item and races concurrent new_session
        # inserts ("dictionary changed size during iteration")
        for sid, ss in list(self.sessions.items()):
            if now - ss.last_used > ttl:
                self.sessions.pop(sid, None)
        s = Session(user)
        self.sessions[s.id] = s
        return s

    def kill_session(self, sid: int) -> bool:
        """KILL SESSION <id>: the session's next execute is rejected.
        Returns False when the id is unknown (standalone engine only —
        the cluster layer kills through metad)."""
        s = self.sessions.pop(sid, None)
        if s is None:
            return False
        s.killed = True
        # in-flight AND admission-queued statements of the session die
        # with it: the kill event is what the scheduler checks between
        # plan nodes and what the admission wait loop polls (a queued
        # statement leaves the queue without ever taking a slot)
        for ev in list(s.running_kill.values()):
            ev.set()
        return True

    def list_running_queries(self) -> list:
        """RUNNING-query rows with live progress — the one
        source for SHOW [LOCAL] QUERIES and the graphd fan-out RPC.
        Row shape: [sid, qid, user, text, status, operator, rows,
        duration_us, queue_us, device_us, host_us, memory_bytes,
        consistency, batch, fingerprint]."""
        from ..utils.workload import live_registry
        rows = []
        for s in list(self.sessions.values()):
            for qid, qtext in list(s.queries.items()):
                lq = live_registry().get(qid)
                if lq is not None:
                    p = lq.snapshot()
                    rows.append([s.id, qid, s.user, qtext, p["status"],
                                 p["operator"], p["rows"],
                                 p["duration_us"], p["queue_us"],
                                 p["device_us"], p["host_us"],
                                 p["memory_bytes"],
                                 p.get("consistency", ""),
                                 p.get("batch", ""),
                                 p.get("fingerprint", "")])
                else:
                    # workload plane disabled: identity columns only
                    rows.append([s.id, qid, s.user, qtext, "RUNNING",
                                 "", 0, 0, 0, 0, 0, 0, "", "", ""])
        return rows

    def kill_running(self, sid=None, qid=None) -> bool:
        """Set kill events of matching RUNNING queries; True if any
        matched (shared by KILL QUERY local path and the graphd RPC)."""
        from ..utils.workload import live_registry
        hit = False
        for s in list(self.sessions.values()):
            if sid is not None and s.id != sid:
                continue
            for q, ev in list(s.running_kill.items()):
                if qid is None or q == qid:
                    ev.set()
                    lq = live_registry().get(q)
                    if lq is not None:
                        # SHOW QUERIES reports KILLED while the victim
                        # drains toward its next cancellation check
                        lq.killed = True
                    hit = True
                    if q not in self._recent_kills:
                        self._recent_kills.append(q)
        if not hit and qid is not None and qid in self._recent_kills:
            # double-kill idempotency: the first kill
            # matched and the victim has since drained — killing an
            # already-killed query is a quiet no-op success
            hit = True
        return hit

    @property
    def slow_query_us(self) -> int:
        """Live: UPDATE CONFIGS / PUT /flags must take effect on a
        running engine."""
        if self._slow_override is not None:
            return int(self._slow_override)
        from ..utils.config import get_config
        return int(get_config().get("slow_query_threshold_us"))

    def _fingerprint(self, stmt: A.Sentence, text: str,
                     space: Optional[str],
                     memo: bool = True) -> Optional[str]:
        """Literal-normalized statement fingerprint, memoized
        by (text, space) alongside the plan-cache key so the steady-
        state cost is one bounded-LRU lookup.  None when the insights
        plane is off — every downstream consumer treats None as
        'record nothing'."""
        if not self.insights.enabled():
            return None
        sp = space or ""
        if memo:
            fp = self.insights.fingerprints.get(text, sp)
            if fp is not None:
                return fp
        from ..utils.insights import fingerprint_of
        try:
            fp = fingerprint_of(stmt, sp)
        except Exception:  # noqa: BLE001 — insights must never throw
            return None
        if memo:
            self.insights.fingerprints.put(text, sp, fp)
        return fp

    def _cache_key(self, session: Session, text: str) -> Optional[tuple]:
        """Plan-cache key for this statement in this session's context,
        or None when caching cannot apply: $var state makes planning
        session-dependent, and zero-capacity caches are disabled.  The
        schema epoch (catalog version — bumped by EVERY DDL, including
        ALTER/CREATE TAG and index DDL) and the live device flag are
        part of the key, so invalidation is structural, not evented.
        (Shared by the plan cache and, extended with the write epoch,
        the result cache — either being enabled keeps the key alive.)"""
        if (PlanCache.capacity() <= 0 and ResultCache.capacity() <= 0) \
                or session.var_cols:
            return None
        from ..utils.config import get_config
        tpu_on = self.qctx.tpu_runtime is not None and \
            bool(get_config().get("tpu_enable"))
        epoch = getattr(self.qctx.catalog, "version", 0)
        return (text, session.space, epoch, tpu_on)

    def _strict_epoch_check(self) -> bool:
        """True when this cached read must consult metad's merged epoch
        table first: `result_cache_strict_epoch` is on AND the read
        asked for leader consistency (weaker levels accepted bounded
        staleness by contract — the heartbeat window is within it)."""
        from ..utils.config import get_config
        try:
            if not bool(get_config().get("result_cache_strict_epoch")):
                return False
        except Exception:  # noqa: BLE001 — config not initialized
            return False
        from ..utils.consistency import LEADER, effective_consistency
        return effective_consistency() == LEADER

    def execute(self, session: Session, text: str,
                params: Optional[Dict[str, Any]] = None) -> ResultSet:
        t0 = time.perf_counter()
        if session.killed:
            rs = ResultSet()
            rs.error = "Session was killed"
            return rs
        session.last_used = time.time()
        from ..utils.stats import stats
        key = self._cache_key(session, text)
        # result cache first: a hit skips parse AND
        # execution — the write epoch in the key guarantees no local
        # write or DDL has landed since the entry was built.  The USER
        # is part of the key: a hit never runs the per-execute
        # permission check (there is no parsed stmt to check), so rows
        # cached by a privileged session must be unreachable to anyone
        # else; role changes are DDL, so the catalog-version half of
        # the key covers grants/revokes for the same user.
        rkey = None
        if key is not None and ResultCache.capacity() > 0:
            # strict check-at-admission: a leader-consistency
            # read under `result_cache_strict_epoch` pulls metad's
            # merged epoch table BEFORE the key is formed — a write
            # acked through any coordinator that reached metad retires
            # the entry before this read can hit it.  Best-effort: a
            # metad hiccup degrades to the heartbeat-bounded window,
            # never blocks the read.
            if self.epoch_sync is not None and self._strict_epoch_check():
                try:
                    self.epoch_sync()
                except Exception:  # noqa: BLE001
                    pass
            # the cluster generation joins the coordinator-local write
            # epoch in the key: local writes invalidate at statement
            # granularity, peers' writes at fold granularity
            rkey = key + (session.user, self.qctx.write_epoch,
                          self.cluster_epochs.gen(session.space))
            ent = self.result_cache.get(rkey)
            if ent is not None:
                return self._result_cache_hit(session, text, ent, t0)
        if key is not None:
            ent = self.plan_cache.get(key)
            if ent is not None:
                stmt, plan = ent
                return self._execute_parsed(session, stmt, text, t0,
                                            cached_plan=plan,
                                            result_key=rkey)
        try:
            stmt = parse(text)
        except ParseError as ex:
            stats().inc("num_queries")
            stats().inc("num_query_errors")
            err = f"SyntaxError: {ex}"
            us = int((time.perf_counter() - t0) * 1e6)
            # unparseable text still aggregates: repeated
            # garbage lands under one raw-text digest in SHOW STATEMENTS
            fp = None
            if self.insights.enabled():
                from ..utils.insights import parse_error_fingerprint
                fp = parse_error_fingerprint(text, session.space or "")
                self.insights.record(
                    fp=fp, text=text, kind="Parse",
                    space=session.space or "", latency_us=us, error=err)
            # forced capture covers parse errors too: a flood
            # of malformed statements burns SLO availability budget and
            # must leave flight-recorder evidence, not just counters
            from ..utils.flight import flight_recorder
            flight_recorder().record(
                stmt=text, kind="Parse", latency_us=us,
                error=err, trace_id=None, session=session.id,
                operators=[], slow_us=self.slow_query_us,
                fingerprint=fp)
            return ResultSet(error=err)
        if isinstance(stmt, A.SeqSentence):
            # `a; b; c` executes sequentially — each statement plans only
            # after the previous ran, so DDL/USE side effects are visible
            # to later statements; the result is the last statement's
            # (reference semantics for compound execute())
            res = ResultSet()
            for sub in stmt.stmts:
                # memo_fp off: the (text, space) memo key would alias
                # every sub-statement of the compound to one fingerprint
                res = self._execute_parsed(session, sub, text,
                                           time.perf_counter(),
                                           memo_fp=False)
                if not res.ok:
                    return res
            return res
        return self._execute_parsed(session, stmt, text, t0,
                                    cache_key=key, result_key=rkey)

    def _result_cache_hit(self, session: Session, text: str, ent,
                          t0: float) -> ResultSet:
        """Serve a statement from the result cache: decode the stored
        wire form (byte-identical to what uncached execution ships) and
        keep the statement-level accounting honest — it still counts in
        /stats and leaves a flight-recorder entry."""
        from ..core.wire import from_wire
        from ..utils.flight import flight_recorder
        from ..utils.stats import stats
        wire_data, space = ent
        data = from_wire(wire_data) if wire_data is not None else None
        us = int((time.perf_counter() - t0) * 1e6)
        stats().inc("num_queries")
        stats().add_value("query_latency_us", us)
        stats().observe("query_latency_us_hist", us,
                        {"kind": "CachedRead"})
        # the hit skipped parse, so the fingerprint is only available
        # from the memo — a miss there (evicted) just skips aggregation
        fp = None
        if self.insights.enabled():
            fp = self.insights.fingerprints.get(text, session.space or "")
            if fp is not None:
                self.insights.record(
                    fp=fp, text=text, kind="CachedRead",
                    space=session.space or "", latency_us=us,
                    rows=(len(data.rows) if data is not None else 0),
                    result_cache_hit=True)
        flight_recorder().record(
            stmt=text, kind="CachedRead", latency_us=us, error=None,
            trace_id=None, session=session.id, operators=[],
            slow_us=self.slow_query_us, fingerprint=fp)
        if space:
            session.space = space
        return ResultSet(data, space=space, latency_us=us,
                         comment="served from result cache")

    @staticmethod
    def _stmt_kind(stmt: A.Sentence) -> str:
        """Statement kind label for metrics/traces: `GoSentence` → `Go`
        (EXPLAIN/PROFILE report the INNER statement's kind)."""
        if isinstance(stmt, A.ExplainSentence):
            stmt = stmt.stmt
        name = type(stmt).__name__
        return name[:-len("Sentence")] if name.endswith("Sentence") \
            else name

    def _execute_parsed(self, session: Session, stmt: A.Sentence,
                        text: str, t0: float, cached_plan=None,
                        cache_key: Optional[tuple] = None,
                        result_key: Optional[tuple] = None,
                        memo_fp: bool = True) -> ResultSet:
        """Metrics + tracing wrapper: every statement outcome (incl.
        semantic and execution errors) is visible in /stats; every
        statement produces one trace in the trace store, queryable via
        /traces and SHOW TRACES — and a per-operator profile that the
        flight recorder retains for sampled/slow/failed statements."""
        from ..utils import trace
        from ..utils.config import get_config
        from ..utils.stats import stats
        kind = self._stmt_kind(stmt)
        # statement fingerprint: computed once here (memoized
        # next to the plan-cache key), stamped onto the live row, the
        # slow log and the flight entry, and aggregated on completion
        space0 = session.space or ""
        fp = self._fingerprint(stmt, text, space0, memo=memo_fp)
        tg = None
        if get_config().get("enable_query_tracing"):
            tg = trace.start_trace(f"query:{kind}", service="graphd",
                                   stmt=text[:200], session=session.id)
        # always-on observation: per-node timings/rows/remote
        # cost are collected for EVERY statement — PROFILE renders them,
        # the flight recorder retains them for the queries that matter
        obs = ProfileStats()
        if tg is not None:
            with tg:
                res = self._execute_inner(session, stmt, text, t0,
                                          cached_plan, cache_key, obs,
                                          fp=fp)
        else:
            res = self._execute_inner(session, stmt, text, t0,
                                      cached_plan, cache_key, obs,
                                      fp=fp)
        us = int((time.perf_counter() - t0) * 1e6)
        stats().inc("num_queries")
        stats().add_value("query_latency_us", us)
        stats().observe("query_latency_us_hist", us, {"kind": kind})
        if _bumps_write_epoch(kind):
            # one bump per mutating statement, SUCCESS OR FAILURE — a
            # failed multi-part write may still have committed some
            # parts (fan-out is not atomic), so only statements that
            # provably touched nothing may skip the bump.  A
            # dedup-replayed write still acks as one statement, so it
            # bumps (and invalidates the result cache) exactly once.
            self.qctx.bump_write_epoch()
            self.result_cache.note_invalidated()
        if res.ok and result_key is not None and res.plan_desc is None \
                and not isinstance(stmt, A.ExplainSentence) \
                and kind in _CACHEABLE_KINDS:
            from ..core.wire import to_wire
            self.result_cache.put(
                result_key,
                to_wire(res.data) if res.data is not None else None,
                res.space)
        slow_us = self.slow_query_us
        if not res.ok:
            stats().inc("num_query_errors")
        elif us > slow_us:
            stats().inc("num_slow_queries")
            self.slow_log.append({"stmt": text, "latency_us": us,
                                  "ts": time.time(),
                                  "trace_id": tg.trace_id
                                  if tg is not None else None,
                                  "fingerprint": fp or ""})
        if fp is not None:
            # the one aggregate update per statement: the
            # live row was deregistered in _execute_inner's finally but
            # stays readable — its queue/device/lane attribution folds
            # into the per-fingerprint totals here
            lv = getattr(obs, "live", None)
            self.insights.record(
                fp=fp, text=text, kind=kind, space=space0,
                latency_us=us, error=res.error,
                rows=(len(res.data.rows) if res.data is not None else 0),
                queue_us=(lv.queue_us if lv is not None else 0),
                device_us=(lv.device_us if lv is not None else 0),
                dispatches=(lv.dispatches if lv is not None else 0),
                plan_hash=getattr(obs, "plan_hash", None),
                plan_cache_hit=cached_plan is not None,
                lanes=(lv.batch_lanes if lv is not None else 0))
        from ..utils.flight import flight_recorder
        flight_recorder().record(
            stmt=text, kind=kind, latency_us=us, error=res.error,
            trace_id=tg.trace_id if tg is not None else None,
            session=session.id,
            operators=obs.operators,
            work=(obs.work.as_dict if obs.work is not None else None),
            slow_us=slow_us, fingerprint=fp)
        return res

    def _execute_inner(self, session: Session, stmt: A.Sentence,
                       text: str, t0: float, cached_plan=None,
                       cache_key: Optional[tuple] = None,
                       obs: Optional[ProfileStats] = None,
                       fp: Optional[str] = None) -> ResultSet:
        from ..utils.config import get_config
        if get_config().get("enable_authorize"):
            from .permissions import check as _perm_check
            msg = _perm_check(stmt, session.user, self.qctx.store.catalog,
                              session.space)
            if msg:
                return ResultSet(error=f"PermissionError: {msg}")
        # `obs` collects per-node stats for EVERY run (flight recorder
        # substrate); `want_profile` only controls whether the reply
        # renders them — profiled execution is otherwise identical to
        # the real run (same schedule, same result rows)
        profile_stats = obs if obs is not None else ProfileStats()
        want_profile = False
        explain_only = False
        plan_fmt = "row"
        if isinstance(stmt, A.ExplainSentence):
            plan_fmt = stmt.fmt or "row"
            if plan_fmt not in ("row", "dot"):
                return ResultSet(error=f"SemanticError: unknown plan "
                                       f"format `{stmt.fmt}' "
                                       f"(row | dot)")
            if stmt.profile:
                want_profile = True
            else:
                explain_only = True
            inner = stmt.stmt
        else:
            inner = stmt

        pctx = None
        if cached_plan is not None:
            # plan-cache hit: parse/validate/plan/optimize all skipped;
            # the plan is read-only at execution time (per-run state
            # lives in the statement's ExecutionContext), so reuse is
            # verbatim
            plan = cached_plan
        else:
            try:
                pctx = PlannerContext(self.qctx, session.space)
                pctx.var_cols.update(session.var_cols)
                from ..query.validator import ValidationError, validate
                try:
                    validate(inner, pctx)
                except ValidationError as ex:
                    return ResultSet(error=f"SemanticError: {ex}")
                from ..query.planner import _plan
                root = _plan(pctx, inner)
                from ..query.plan import ExecutionPlan
                plan = ExecutionPlan(root, pctx.space)
                from ..utils.config import get_config
                plan = optimize(plan, enable=self.enable_optimizer,
                                tpu=self.qctx.tpu_runtime is not None
                                and bool(get_config().get("tpu_enable")),
                                pctx=pctx)
            except QueryError as ex:
                return ResultSet(error=f"SemanticError: {ex}")
            if cache_key is not None and not explain_only \
                    and not want_profile and not pctx.var_cols \
                    and self._stmt_kind(stmt) in _CACHEABLE_KINDS:
                # the parsed stmt rides along for the per-execute
                # permission check and the metrics kind label
                self.plan_cache.put(cache_key, stmt, plan)

        if explain_only:
            us = int((time.perf_counter() - t0) * 1e6)
            desc = plan.describe(plan_fmt)
            return ResultSet(DataSet(["plan"], [[desc]]),
                             space=plan.space, latency_us=us,
                             plan_desc=desc)
        if fp is not None:
            # plan shape hash for the regression sentinel:
            # memoized on the (immutable post-optimize) plan object, so
            # a plan-cache hit pays one getattr
            ph = getattr(plan, "shape_hash", None)
            if ph is None:
                from ..utils.insights import plan_shape_hash
                ph = plan_shape_hash(plan)
                try:
                    plan.shape_hash = ph
                except Exception:  # noqa: BLE001 — slotted plan class
                    pass
            profile_stats.plan_hash = ph
        # Per-statement ExecutionContext seeded with the session's $vars —
        # intermediates die with the statement; only $var results persist.
        stmt_ectx = ExecutionContext()
        stmt_ectx.results.update({k: v for k, v in session.ectx.results.items()
                                  if k.startswith("$")})
        # register as a running query: SHOW QUERIES lists it, KILL QUERY
        # (session=sid, plan=qid) sets its kill event — the scheduler
        # checks it between plan nodes
        import threading as _threading
        qid = next(_query_ids)
        stmt_ectx.kill_event = _threading.Event()
        session.queries[qid] = text
        session.running_kill[qid] = stmt_ectx.kill_event
        # statement deadline budget: the timeout becomes an
        # absolute monotonic deadline in the thread-local cancel
        # context; the RPC client clamps every hop to the remaining
        # budget and ships it in the envelope, so graphd → storaged →
        # metad hops all run under ONE decremented budget
        from ..utils import cancel as _cancel
        timeout_s = 0.0
        try:
            timeout_s = float(get_config().get("query_timeout_secs"))
        except Exception:  # noqa: BLE001 — config not initialized
            pass
        dl = (time.monotonic() + timeout_s) if timeout_s > 0 else None
        # live workload registration: the statement is visible
        # in SHOW QUERIES / GET /queries with live per-operator progress
        # from HERE until the finally below; the deadline rides along so
        # the stall watchdog can derive this statement's stall threshold
        from ..utils.consistency import effective_consistency
        from ..utils.workload import live_registry
        live = live_registry().register(
            qid=qid, session=session.id, user=session.user, stmt=text,
            kind=self._stmt_kind(stmt), deadline=dl,
            tracker=stmt_ectx.tracker,
            consistency=effective_consistency(),
            fingerprint=fp)
        stmt_ectx.live = live
        # admission control: a bounded-slot gate in front of
        # the scheduler — control statements bypass (priority lane),
        # data statements may wait QUEUED (visible in SHOW QUERIES) or
        # be shed with E_OVERLOAD + retry-after when the queue is full.
        # max_running_queries=0 (the default sentinel) makes acquire()
        # a no-op, byte-identical to the pre-admission engine.
        from ..utils import admission as _adm
        ticket = None
        try:
            with _cancel.use_cancel(kill=stmt_ectx.kill_event,
                                    deadline=dl):
                ticket = _adm.admission().acquire(
                    qid=qid, session=session.id,
                    kind=self._stmt_kind(stmt), live=live,
                    tracker=stmt_ectx.tracker, user=session.user)
                if ticket is not None and ticket.queue_wait_us:
                    # pseudo-operator: the admission wait reaches the
                    # flight recorder next to the real plan nodes
                    # (node id -1 — PROFILE's plan walk never shows it)
                    profile_stats.per_node[-1] = {
                        "kind": "Admission",
                        "exec_us": ticket.queue_wait_us, "rows": 0}
                data = self.scheduler.run(plan, stmt_ectx, profile_stats)
        except _adm.OverloadError as ex:
            # shed: never took a slot; the flight recorder force-
            # captures it (classify → "shed") from the E_OVERLOAD error
            return ResultSet(error=str(ex), space=plan.space)
        except _cancel.DeadlineExceeded:
            from ..utils.stats import stats
            stats().inc("query_deadline_exceeded")
            return ResultSet(
                error=f"E_QUERY_TIMEOUT: statement exceeded "
                      f"query_timeout_secs={timeout_s:g}",
                space=plan.space)
        except _cancel.QueryKilled:
            return ResultSet(error="ExecutionError: query was killed",
                             space=plan.space)
        except Exception as ex:  # noqa: BLE001 — runtime errors go to client
            return ResultSet(error=f"ExecutionError: {ex}", space=plan.space)
        finally:
            if ticket is not None:
                ticket.release()
            session.queries.pop(qid, None)
            session.running_kill.pop(qid, None)
            if live is not None:
                live_registry().deregister(qid)
                # the deregistered row stays readable: _execute_parsed
                # folds its queue/device/lane attribution into the
                # insights registry
                profile_stats.live = live
            # the flight recorder reads the statement's work counts off
            # the observer (even for failed statements, which return
            # from the except arms above)
            profile_stats.work = stmt_ectx.work
            # fold the statement's deterministic work counts into a
            # caller-installed probe (bench / regression harnesses wrap
            # execute() in use_work; the scheduler re-targets counting
            # at stmt_ectx.work inside executors)
            from ..utils.stats import current_work
            outer_wc = current_work()
            if outer_wc is not None and outer_wc is not stmt_ectx.work:
                outer_wc.merge(stmt_ectx.work)
        session.ectx.results.update({k: v for k, v in stmt_ectx.results.items()
                                     if k.startswith("$")})

        session.space = plan.space
        if pctx is not None:
            session.var_cols.update(pctx.var_cols)
        us = int((time.perf_counter() - t0) * 1e6)
        plan_desc = None
        if want_profile:
            if plan_fmt == "dot":
                # DOT rendering carries the DAG shape; per-node timing
                # stays in the row format (reference-compatible subset)
                plan_desc = plan.describe_dot()
            else:
                plan_desc = profile_stats.describe(plan)
            # PROFILE parity: `data` stays the QUERY's rows —
            # byte-identical to the unprofiled run — and the per-node
            # breakdown rides separately in plan_desc
        return ResultSet(data, space=plan.space, latency_us=us,
                         plan_desc=plan_desc)


def quick_engine() -> "tuple[QueryEngine, Session]":
    eng = QueryEngine()
    return eng, eng.new_session()
