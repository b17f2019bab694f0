"""Multi-query batch former: concurrent compatible GO dispatches drain
into one multi-lane launch of the hop kernels.

The port's copy of nebula_tpu/tpu/batch.py.  When statements that would
run the SAME device program (snapshot, blocks, steps, WHERE and YIELD
program, fetched capture columns, delta view — the compatibility key
`GpuRuntime._try_batched` builds) reach the dispatch boundary together,
they enrol in a forming GROUP; after a bounded `batch_wait_us` window
(or as soon as the group fills to `batch_max_lanes`) ONE member launches
the lane-widened hop loop (`GpuRuntime._run`: one seed build, one
`run_hops` over an (L, P, vmax + H) frontier, one fetch) for everyone,
and each member takes its own lane back out (`_lane_attribution`), so
rows and WorkCounters stay exactly per statement.

Design points, as in the reference:

  * `batch_max_lanes` 0 or 1 (0 is the default) is the OFF switch — the
    former is never consulted and the dispatch path is the solo one.
  * No dedicated thread and no leader hand-off: every member waits on
    the group condition; whichever member's wait expires first CLAIMS
    the launch (group state FORMING → LAUNCHING → DONE).  A member
    killed or past its deadline while FORMING withdraws (its lane never
    launches); once LAUNCHING, a cancelled member's lane rides along
    and its result is discarded at de-mux — batchmates complete either
    way.
  * A statement only waits the forming window when there is evidence of
    concurrency: another forming group member, or more than one live
    statement in the workload registry.  A lone statement takes the solo
    path untouched.
  * One batched launch takes ONE dispatch-table slot and one read side
    of the runtime's dispatch gate.
  * A group whose window expires while a writer holds the gate (a pin
    or a delta apply) re-arms its window instead of launching.

One divergence from the reference: `_concurrency_hint` reads only the
live registry.  The reference also asks its admission controller for a
recent multi-statement drain burst; the port has no admission
controller yet (ROADMAP Queue C).

Metrics: `tpu_batches_formed`, `tpu_batch_lanes` and
`tpu_batch_gate_rearms` (a member's forming wait is in its statement's
queue time); failpoint
`tpu:batch_form` at the enrolment boundary (`raise` = this statement
dispatches solo, `delay` = held before forming).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..utils import cancel as _cancel
from ..utils.config import define_flag, get_config
from ..utils.failpoints import fail
from ..utils.stats import stats
from ..utils.workload import current_live, live_registry

define_flag("batch_max_lanes", 0,
            "max statements coalesced into one multi-lane device "
            "launch; 0/1 = batching OFF (byte-identical to the "
            "solo dispatch path); runtime-updatable")
define_flag("batch_wait_us", 1500,
            "bounded batch-forming window: a dispatch with concurrent "
            "compatible company waits at most this long for "
            "batchmates before launching (the group launches early "
            "the moment it fills to batch_max_lanes); runtime-"
            "updatable")

_FORMING, _LAUNCHING, _DONE = 0, 1, 2


class _Member:
    __slots__ = ("dense", "withdrawn", "lane", "t_enq", "live")

    def __init__(self, dense: Sequence[int], live):
        self.dense = list(dense)
        self.withdrawn = False
        self.lane: Optional[int] = None   # assigned at launch claim
        self.t_enq = time.monotonic()
        self.live = live


class _Group:
    __slots__ = ("key", "bid", "cond", "state", "deadline", "ready",
                 "members", "res", "info", "error", "t_launch")

    def __init__(self, key, bid: int, deadline: float):
        self.key = key
        self.bid = bid
        self.cond = threading.Condition()
        self.state = _FORMING
        self.deadline = deadline
        self.ready = False            # filled to batch_max_lanes
        self.members: List[_Member] = []
        self.res = None
        self.info: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None
        self.t_launch = deadline


class LaneResult:
    """One statement's slice of a shared launch: the lane index into
    the batched result arrays plus the launch-level info the runtime
    needs for per-lane attribution."""

    __slots__ = ("lane", "res", "info", "form_wait_us")

    def __init__(self, lane: int, res, info, form_wait_us: int):
        self.lane = lane
        self.res = res
        self.info = info
        self.form_wait_us = form_wait_us


class BatchFormer:
    """Process-wide: groups compatible in-flight dispatches per key and
    runs each group as one lane-batched launch."""

    #: waiter poll slice while forming/awaiting launch — the cadence of
    #: the KILL/deadline re-check ("detaches immediately" stays honest)
    POLL_S = 0.005

    def __init__(self):
        self._mu = threading.Lock()
        self._groups: Dict[Any, _Group] = {}
        self._bid = 0

    # -- flags ------------------------------------------------------------

    @staticmethod
    def _flag_int(name: str, dflt: int) -> int:
        try:
            return int(get_config().get(name))
        except Exception:  # noqa: BLE001 — config not initialized
            return dflt

    def max_lanes(self) -> int:
        return self._flag_int("batch_max_lanes", 0)

    def wait_s(self) -> float:
        return max(self._flag_int("batch_wait_us", 1500), 0) / 1e6

    def enabled(self) -> bool:
        # one lane cannot share anything: <=1 is the off sentinel
        return self.max_lanes() > 1

    # -- concurrency evidence ---------------------------------------------

    @staticmethod
    def _concurrency_hint() -> bool:
        """Is there evidence that batchmates may arrive?  Without any,
        the statement dispatches solo with ZERO added latency — the
        forming window only ever delays statements that provably have
        concurrent company.  The evidence is the live registry alone:
        the reference's admission-drain half waits for an admission
        controller in the port."""
        return len(live_registry()) > 1

    # -- enrollment --------------------------------------------------------

    def submit(self, key, dense: Sequence[int],
               launch: Callable[[List[List[int]]], Any],
               kernel: str = "traverse",
               gate_busy: Optional[Callable[[], bool]] = None
               ) -> Optional[LaneResult]:
        """Enroll one dispatch under `key`.  Returns the statement's
        LaneResult after the shared launch, or None when the caller
        should dispatch solo (batching off / no concurrency evidence /
        lost a forming race).  `launch(lane_dense)` runs the actual
        lane-batched launch and returns (res, info) — called by
        exactly ONE member per group.  Raises QueryKilled /
        DeadlineExceeded when THIS statement is cancelled (mid-form:
        its lane withdraws before launch; mid-flight: its lane's
        result is discarded) and re-raises the launch error to every
        member when the shared launch fails.

        `gate_busy` (optional) probes the runtime's dispatch gate: a
        group whose forming window expires while a writer holds the
        gate (re-pin / delta apply / compaction swap) RE-ARMS the
        window instead of launching — launching would only queue the
        fully-formed batch behind the hold with `batch_wait_us`
        already spent, while statements arriving during the hold piled
        into fresh groups."""
        max_lanes = self.max_lanes()
        if max_lanes <= 1:
            return None
        # failpoint at the enrollment boundary: `raise` rejects
        # batching for this statement (it dispatches solo — never
        # wrong, never host-fallback), `delay` holds it here
        fail.hit("tpu:batch_form", key=kernel)
        with self._mu:
            g = self._groups.get(key)
            join = (g is not None and g.state == _FORMING
                    and len(g.members) < max_lanes)
            if not join and not self._concurrency_hint():
                return None     # solo fast path: no company, no wait
            if not join:
                self._bid += 1
                g = _Group(key, self._bid,
                           time.monotonic() + self.wait_s())
                self._groups[key] = g
            lv = current_live()
            m = _Member(dense, lv)
            g.members.append(m)
            lane_provisional = len(g.members) - 1
            if len(g.members) >= max_lanes:
                g.ready = True
        if lv is not None:
            # the live row shows batch id and lane while enrolled; the
            # launch claim re-stamps the final lane
            lv.batch_id, lv.lane = g.bid, lane_provisional
        try:
            return self._wait_and_demux(key, g, m, launch, kernel,
                                        gate_busy)
        finally:
            if lv is not None:
                lv.batch_id, lv.lane = None, None

    def _wait_and_demux(self, key, g: _Group, m: _Member, launch,
                        kernel: str, gate_busy=None
                        ) -> Optional[LaneResult]:
        launcher = False
        with g.cond:
            while g.state != _DONE:
                if g.state == _FORMING and (
                        g.ready or time.monotonic() >= g.deadline):
                    if not g.ready and gate_busy is not None \
                            and gate_busy():
                        # window expired under a write-gate hold: re-arm
                        # so the group keeps forming through the hold
                        # and gets a FRESH window once the gate frees
                        # (a full group skips this — it cannot grow, so
                        # it may as well queue at the gate).  One waiter
                        # moves the deadline per expiry: the loop holds
                        # g.cond, so re-arms are serialized.
                        g.deadline = time.monotonic() + self.wait_s()
                        stats().inc("tpu_batch_gate_rearms")
                        continue
                    g.state = _LAUNCHING
                    launcher = True
                    break
                kill = _cancel.current_kill()
                if kill is not None and kill.is_set():
                    forming = g.state == _FORMING
                    self._withdraw(key, g, m)
                    raise _cancel.QueryKilled(
                        "query was killed while batch-forming"
                        if forming else
                        "query was killed awaiting a batched launch")
                rem = _cancel.remaining()
                if rem is not None and rem <= 0:
                    self._withdraw(key, g, m)
                    raise _cancel.DeadlineExceeded(
                        "deadline exhausted while batch-forming")
                timeout = self.POLL_S
                if g.state == _FORMING and not g.ready:
                    timeout = min(timeout, max(
                        g.deadline - time.monotonic(), 0.0) + 1e-4)
                g.cond.wait(timeout)
        if launcher:
            self._launch(key, g, launch, kernel)
        return self._demux(g, m)

    def _withdraw(self, key, g: _Group, m: _Member):
        """Mark a forming member withdrawn (caller holds g.cond and
        raises right after).  A group left with NO live members has no
        future launcher — remove it from the forming map so the next
        compatible statement opens a FRESH group instead of joining an
        expired husk (and so space/epoch-churned keys cannot leak
        all-withdrawn groups).  Taking self._mu under g.cond is safe:
        no thread ever blocks on g.cond while holding self._mu."""
        m.withdrawn = True
        if g.state == _FORMING and all(mm.withdrawn
                                       for mm in g.members):
            g.state = _DONE
            with self._mu:
                if self._groups.get(key) is g:
                    del self._groups[key]
            g.cond.notify_all()

    def _demux(self, g: _Group, m: _Member) -> Optional[LaneResult]:
        # -- DONE: de-mux ---------------------------------------------
        if g.error is not None:
            # shared failure (a retired snapshot, a device fault):
            # every member surfaces the same error; executors apply
            # their usual fallback contract to it
            raise g.error
        kill = _cancel.current_kill()
        if kill is not None and kill.is_set():
            # mid-flight cancel: the lane launched, its result is
            # discarded right here — batchmates are untouched
            raise _cancel.QueryKilled("query was killed")
        rem = _cancel.remaining()
        if rem is not None and rem <= 0:
            raise _cancel.DeadlineExceeded(
                "deadline exhausted during a batched launch")
        if m.lane is None:
            # joined in the claim race window after lanes were frozen:
            # not part of the launch — dispatch solo instead
            return None
        form_wait_us = int(max(g.t_launch - m.t_enq, 0.0) * 1e6)
        return LaneResult(m.lane, g.res, g.info, form_wait_us)

    def _launch(self, key, g: _Group, launch, kernel: str):
        """Run the shared launch for every non-withdrawn member.  The
        claiming member executes on its own thread; per-statement TLS
        attribution is suppressed inside (the runtime's lane
        launch), and each member attributes its own lane at
        de-mux."""
        with self._mu:
            if self._groups.get(key) is g:
                del self._groups[key]   # new arrivals form a new group
        with g.cond:
            lanes = [mm for mm in g.members if not mm.withdrawn]
            for i, mm in enumerate(lanes):
                mm.lane = i
                if mm.live is not None:
                    mm.live.lane = i
                    if len(lanes) > 1:
                        # how many statements this launch was
                        # amortized across
                        mm.live.batch_lanes = len(lanes)
        g.t_launch = time.monotonic()
        try:
            if len(lanes) > 1:
                stats().inc("tpu_batches_formed")
                stats().observe("tpu_batch_lanes", len(lanes))
                g.res, g.info = launch([mm.dense for mm in lanes])
            else:
                # a 1-lane "batch" shares nothing: leave res unset —
                # the lone member falls back to the SOLO dispatch path
                # (no lane program, no batch metrics),
                # so a too-short forming window costs only the window
                for mm in lanes:
                    mm.lane = None
        except BaseException as ex:  # noqa: BLE001 — fan the error out
            g.error = ex
        finally:
            with g.cond:
                g.state = _DONE
                g.cond.notify_all()

    # -- introspection / tests ---------------------------------------------

    def forming(self) -> Dict[Any, int]:
        """key → enrolled member count of currently-forming groups."""
        with self._mu:
            return {k: len(g.members) for k, g in self._groups.items()
                    if g.state == _FORMING}

    def reset(self):
        """Test isolation: abandon forming groups.  Enrolled members
        wake with no lane assigned and fall back to solo dispatch
        (submit returns None) — nothing blocks, nothing errors."""
        with self._mu:
            groups = list(self._groups.values())
            self._groups.clear()
        for g in groups:
            with g.cond:
                if g.state == _FORMING:
                    g.state = _DONE
                    g.cond.notify_all()


_former = BatchFormer()


def batch_former() -> BatchFormer:
    """The process-wide former (the runtime submits; tests introspect)."""
    return _former
