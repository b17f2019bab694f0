"""The port's copy of `nebula_tpu/cluster/client.py`, whole.

GraphClient — what client libraries and the console use to talk to a
graphd fleet.

The nebula-python analog: authenticate once, then execute statements,
receiving ResultSet-shaped replies (wire-decoded DataSet).

Fleet mode: construct with N graphd endpoints —
`GraphClient(["h:p", "h:p", ...])` — and the client ranks them with
the same per-peer score machinery the storage client uses for replica
routing (latency EWMA + retry-after penalty + breaker state), then
fails over transparently when a coordinator dies or drains:

  - `E_SESSION_MOVED` (graceful drain): the statement was refused
    BEFORE execution, so ANY statement — including writes — retries
    safely on the sibling named in the hint.
  - connection death mid-statement: the outcome is unknown.  Only
    read-shaped statements are retried on a sibling; a write comes
    back as a structured `E_COORDINATOR_LOST` result — the client
    NEVER silently re-sends a statement that may have executed.
  - every retry is clamped to the statement's deadline budget
   : failover never turns into an unbounded retry storm.

The session itself survives the owner: its row is metad-replicated,
and `graph.adopt_session` re-homes it (credentials re-checked; $var
state was owner-local and is lost — docs/ROBUSTNESS.md §10).

Bulk results arrive columnar: numeric result columns ride
the RPC frame as typed blobs and decode into a lazy ColumnarDataSet —
`rs.data.column_array(name)` is the numpy column straight off the
wire buffer; per-row Python lists are built only if `.rows` is
touched.  Int columns may arrive TRANSPORT-NARROWED (int8/16/32 when
the value range fits — value-exact, `.rows`/`column()` still yield
plain Python ints); cast with `np.asarray(col, np.int64)` before
doing overflow-prone numpy arithmetic on the raw column.
"""
from __future__ import annotations

import random
import re
import time
from typing import Dict, List, Optional, Sequence, Union

from ..core.wire import from_wire
from ..exec.context import ResultSet
from ..utils.config import get_config
from .rpc import RpcClient, RpcConnError, RpcError, RpcNeverSentError

#: how much longer the client waits than the server's statement budget:
#: graphd's own deadline (query_timeout_secs) should expire
#: FIRST and return a proper E_QUERY_TIMEOUT reply — the client-side
#: cutoff only catches a graphd that stopped answering entirely
CLIENT_TIMEOUT_GRACE_S = 10.0

SESSION_MOVED = "E_SESSION_MOVED"
_SIBLING_RE = re.compile(r"sibling=([^\s;,]+)")

#: leading keywords whose statements are safe to re-send when the
#: outcome of the first send is UNKNOWN (connection died mid-call):
#: pure reads / metadata — re-execution cannot double-apply anything.
#: Deliberately conservative: EXPLAIN/PROFILE run their statement.
_RETRYABLE_LEAD = frozenset({
    "GO", "MATCH", "FETCH", "LOOKUP", "FIND", "SHOW",
    "DESCRIBE", "DESC", "USE", "YIELD",
})


def _statement_timeout() -> float:
    """The configured statement timeout (0/unset → legacy 300s)."""
    try:
        t = float(get_config().get("query_timeout_secs"))
    except Exception:  # noqa: BLE001 — config not initialized
        t = 0.0
    return t if t > 0 else 300.0


def _stmt_retryable(stmt: str) -> bool:
    m = re.match(r"[\s(]*([A-Za-z]+)", stmt)
    return bool(m) and m.group(1).upper() in _RETRYABLE_LEAD


class GraphClient:
    def __init__(self, host: Union[str, Sequence[str]],
                 port: Optional[int] = None,
                 timeout: Optional[float] = None):
        # retries=0: a statement may be non-idempotent; re-sending after a
        # dropped reply could execute it twice (at-least-once hazard)
        if isinstance(host, (list, tuple)):
            endpoints = [str(h) for h in host]
        elif port is not None:
            endpoints = [f"{host}:{port}"]
        else:
            endpoints = [h.strip() for h in str(host).split(",") if h.strip()]
        if not endpoints:
            raise ValueError("no graphd endpoints")
        self.endpoints: List[str] = endpoints
        self.timeout = (timeout if timeout is not None
                        else _statement_timeout() + CLIENT_TIMEOUT_GRACE_S)
        self._rpcs: Dict[str, RpcClient] = {}
        self.addr = endpoints[0]
        self.session_id: Optional[int] = None
        self._user = "root"
        self._password = "nebula"
        # endpoints that have already adopted the CURRENT session — an
        # overload walk between them needs no adopt round-trip (the
        # session object survives on every coordinator that held it)
        self._adopted: set = set()

    # -- endpoint plumbing ------------------------------------------------

    def _rpc_for(self, addr: str) -> RpcClient:
        c = self._rpcs.get(addr)
        if c is None:
            host, port = addr.rsplit(":", 1)
            c = self._rpcs[addr] = RpcClient(host, int(port),
                                             timeout=self.timeout, retries=0)
        return c

    @property
    def rpc(self) -> RpcClient:
        """The current coordinator's RPC client (legacy single-endpoint
        attribute — code that pokes `client.rpc` keeps working)."""
        return self._rpc_for(self.addr)

    def _ranked(self, exclude=()) -> List[str]:
        """Sibling endpoints best-first by the shared per-peer score
        (latency EWMA + overload penalty + breaker state — the storage client's
        replica-routing machinery, reused verbatim)."""
        from .storage_client import peer_score
        cands = [e for e in self.endpoints
                 if e != self.addr and e not in exclude]
        cands.sort(key=peer_score)
        return cands

    def _failover(self, hint: Optional[str] = None, exclude=(),
                  count: bool = True) -> bool:
        """Re-home on a sibling: adopt the session there (credentials
        re-checked server-side), then make it the current coordinator.
        The drain hint goes first — the dying graphd knows who is
        alive; score order covers the hint-less crash case.
        `count=False` for capacity walks (an overload shed is not a
        coordinator failure — `coordinator_failovers` must keep meaning
        crashes and drains)."""
        order = self._ranked(exclude=exclude)
        if hint and hint != "-" and hint != self.addr:
            if hint in order:
                order.remove(hint)
            order.insert(0, hint)
        for ep in order:
            try:
                if self.session_id is not None \
                        and ep not in self._adopted:
                    self._rpc_for(ep).call(
                        "graph.adopt_session", session_id=self.session_id,
                        user=self._user, password=self._password)
                    self._adopted.add(ep)
                self.addr = ep
                if count:
                    from ..utils.stats import stats
                    stats().inc("coordinator_failovers")
                return True
            except (RpcError, RpcConnError):
                continue
        return False

    # -- session ----------------------------------------------------------

    def authenticate(self, user: str = "root", password: str = "nebula"):
        self._user, self._password = user, password
        last: Optional[Exception] = None
        for ep in [self.addr] + self._ranked():
            try:
                r = self._rpc_for(ep).call("graph.authenticate",
                                           user=user, password=password)
                self.addr = ep
                self.session_id = r["session_id"]
                self._adopted = {ep}
                return self.session_id
            except RpcConnError as ex:
                last = ex
            except RpcError as ex:
                # a draining graphd refuses new sessions — walk on;
                # anything else (bad password) is terminal
                if SESSION_MOVED not in str(ex):
                    raise
                last = ex
        raise last if last is not None else RpcError("no graphd reachable")

    # -- execute ----------------------------------------------------------

    def execute(self, stmt: str) -> ResultSet:
        """Execute one statement.  An E_OVERLOAD shed (graphd admission
        queue full, or the daemon's RPC inbox bounded out) is retried
        honoring its retry-after hint, but only within the statement's
        remaining deadline budget: the client
        never turns bounded shedding into an unbounded retry storm.
        When the budget is spent the overload comes back STRUCTURED —
        `rs.error` keeps the full E_OVERLOAD text and
        `rs.retry_after_ms` carries the parsed hint.

        Coordinator loss is handled per the fleet contract (module
        docstring): drain refusals retry anywhere, unknown-outcome
        losses retry only read-shaped statements, all inside the same
        deadline budget."""
        if self.session_id is None:
            raise RpcError("not authenticated")
        from ..utils.admission import is_overload, parse_retry_after
        from ..utils.stats import stats
        deadline = time.monotonic() + _statement_timeout()
        lost: set = set()
        while True:
            err: Optional[str] = None
            t0 = time.perf_counter()
            try:
                r = self._rpc_for(self.addr).call(
                    "graph.execute", session_id=self.session_id, stmt=stmt)
            except RpcError as ex:
                if SESSION_MOVED in str(ex):
                    # refused BEFORE execution (graceful drain): any
                    # statement retries safely on the named sibling
                    stats().inc("session_moves")
                    m = _SIBLING_RE.search(str(ex))
                    if time.monotonic() < deadline and self._failover(
                            hint=m.group(1) if m else None, exclude=lost):
                        continue
                    return ResultSet(error=str(ex))
                # the daemon's bounded RPC inbox shed the request (the
                # handler provably never ran) — same structured surface
                # as an admission-level shed, not a raw transport error
                if not is_overload(str(ex)):
                    raise
                err = str(ex)
            except RpcConnError as ex:
                if "rpc timeout" in str(ex):
                    # the statement outlived even the grace window
                    # (graphd wedged / unreachable mid-statement): a
                    # clean timeout result, not a raw transport
                    # traceback.  NOTE the
                    # statement may still be running — same contract
                    # as any client-side cancel.
                    return ResultSet(
                        error=f"E_QUERY_TIMEOUT: no reply within "
                              f"{self.timeout:g}s (statement budget "
                              f"{_statement_timeout():g}s + grace)")
                if len(self.endpoints) <= 1:
                    raise
                dead = self.addr
                lost.add(dead)
                # never-sent failures are provably side-effect free —
                # any statement may retry; otherwise only read-shaped
                # statements are safe to re-send
                safe = isinstance(ex, RpcNeverSentError) \
                    or _stmt_retryable(stmt)
                moved = time.monotonic() < deadline \
                    and self._failover(exclude=lost)
                if moved and safe:
                    continue
                if safe:
                    raise
                return ResultSet(
                    error=f"E_COORDINATOR_LOST: connection to {dead} "
                          f"died mid-statement; outcome unknown — not "
                          f"retried (non-idempotent statement)"
                          + ("" if moved else "; no sibling reachable"))
            if err is None:
                from .storage_client import note_peer_latency
                note_peer_latency(self.addr, time.perf_counter() - t0)
                if not is_overload(r["error"]):
                    data = from_wire(r["data"]) \
                        if r["data"] is not None else None
                    return ResultSet(data=data, space=r["space"],
                                     latency_us=r["latency_us"],
                                     plan_desc=r["plan_desc"],
                                     error=r["error"])
                err = r["error"]
            hint = parse_retry_after(err)
            from .storage_client import note_peer_overload
            note_peer_overload(self.addr, hint)
            # jittered hint: clients shed in the same burst get the
            # same retry_after_ms — sleeping it verbatim re-arrives
            # the herd in one pulse and re-sheds most of it
            hint_s = (hint if hint is not None else 0.25) \
                * random.uniform(0.5, 1.5)
            if len(self.endpoints) > 1 and time.monotonic() < deadline \
                    and self._failover(exclude=lost, count=False):
                # fleet capacity walk: the shed priced THIS
                # coordinator's bucket — a sibling may have spare
                # tokens RIGHT NOW (the coordinator analog of the
                # follower-read capacity walk; note_peer_overload
                # above already penalized the shedder's score).  The
                # short pause bounds the spin when EVERY coordinator
                # is saturated.  Single-endpoint behavior unchanged.
                time.sleep(min(hint_s, 0.02))
                continue
            if time.monotonic() + hint_s >= deadline:
                # budget exhausted: hand the structured overload back
                rs = ResultSet(error=err)
                if hint is not None:
                    rs.retry_after_ms = int(hint * 1000)
                return rs
            time.sleep(hint_s)

    def signout(self):
        if self.session_id is not None:
            self.rpc.call("graph.signout", session_id=self.session_id)
            self.session_id = None

    def close(self):
        try:
            self.signout()
        except (RpcError, RpcConnError):
            pass  # the coordinator may be gone — closing is best-effort
        finally:
            for c in self._rpcs.values():
                c.close()
