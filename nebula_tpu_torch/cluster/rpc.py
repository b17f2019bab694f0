"""The port's copy of `nebula_tpu/cluster/rpc.py`, whole.

JSON-over-TCP RPC — the wire layer of the control plane.

Replaces the reference's fbthrift services (graph.thrift / meta.thrift /
storage.thrift / raftex.thrift; reference: src/interface +
src/common/thrift) with a
dependency-free length-prefixed JSON protocol.  The OPERATION SET of
those IDLs is preserved by the services built on top (SURVEY §2 row 6);
only the encoding differs.  Data-plane traffic (frontier exchange) never
rides this — it's XLA collectives (SURVEY §5, two-plane rule).

Frame grammar (pipelined hot path):
  u32 length | body
  body = JSON                                  (plain request/reply)
       | 0x00 blob-layout                      (columnar payload)
       | 0x01 u32 rid (JSON | 0x00 blob-layout)  (pipelined)
  blob-layout = u32 nblobs | u32 lens[nblobs] | u32 jsonlen | json
              | blob bytes...
JSON text can never start with 0x00/0x01, so receivers distinguish the
three without version negotiation.  The request id is fixed-width and
OUTSIDE the JSON so wire-byte work counters stay deterministic across
runs (ids monotonically grow; their digit count must not leak into the
counted bytes).

Concurrency model: `RpcClient` is a small per-peer
POOL of connections, each multiplexing concurrent in-flight requests by
request id with one reader thread; the server dispatches pipelined
requests to a per-connection worker pool and writes replies as they
finish (out-of-order).  Concurrent calls to the same peer genuinely
overlap instead of serializing on one socket.

Retry safety: automatic re-send after a connection died mid-call is
gated on a per-method idempotency registry (`is_idempotent`) — reads
and raft messages retry, writes surface `RpcConnError` to the caller
(at-least-once double-apply hazard; the caller owns the decision).
`RpcNeverSentError` marks failures that provably never reached the
wire (connect refused, connection dead at entry) so higher-level
retry loops (StorageClient's replica walk) can keep retrying those
for ANY method without risking a double apply.

MAX_FRAME is enforced SYMMETRICALLY: oversized frames are rejected on
the send path with a clear `FrameTooLarge` before any byte hits the
socket, and the receive path sanity-checks the blob header (count /
lengths must tile the frame exactly) instead of feeding garbage offsets
downstream.

Observability: spans ride the envelope as before (`"trace"` in the
request JSON, `"spans"` in the reply); per-op latency histograms
(`rpc_client_latency_us` / `rpc_server_latency_us`), labeled error
counters, deterministic call/byte work counters, and the pool gauges
`rpc_pool_size` (open client connections, process-wide) and
`rpc_inflight` (requests currently awaiting a reply).
"""
from __future__ import annotations

import itertools
import json
import random
import socket
import socketserver
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

from ..utils import cancel as _cancel
from ..utils import trace as _trace
from ..utils.config import define_flag, get_config
from ..utils.failpoints import ConnectionKilled, FailpointError, fail
from ..utils.stats import (CostRecorder, current_cost, current_work,
                           stats as _stats, use_cost)

_LEN = struct.Struct("<I")
MAX_FRAME = 1 << 30

define_flag("rpc_pool_size", 2,
            "connections per peer in the pipelined client pool (each "
            "multiplexes concurrent requests; >1 adds parallel byte "
            "streams for large concurrent results)")
define_flag("rpc_server_workers", 8,
            "per-connection worker threads serving pipelined requests")
define_flag("breaker_failure_threshold", 5,
            "consecutive connection failures to one peer before its "
            "circuit breaker opens (calls then fail fast instead of "
            "re-timing-out against a dead host)")
define_flag("breaker_reset_secs", 2.0,
            "how long an open breaker waits before letting ONE "
            "half-open probe through")

# rpc_server_inbox_capacity is defined in utils/admission.py with the
# rest of the overload-survival flags
from ..utils.admission import (DrainEstimator, is_overload,  # noqa: E402
                               overload_error, parse_retry_after)

#: methods the bounded server inbox may NEVER shed: raft keeps the
#: cluster consistent, meta.* keeps it discoverable, and graph.* rides
#: the engine's AdmissionController instead — graph.execute carries
#: control statements (SHOW/KILL — the operator's way back into a
#: saturated cluster) that only the engine's priority lane can tell
#: apart from data statements; the inbox shedding them blind would
#: defeat the point of shedding everything else.  The inbox is the
#: STORAGED-shaped gate (uniform read/write RPCs, all sheddable).
_INBOX_EXEMPT_METHODS = frozenset({"raft"})
_INBOX_EXEMPT_PREFIXES = ("meta.", "graph.")


def _inbox_exempt(method) -> bool:
    return not isinstance(method, str) or \
        method in _INBOX_EXEMPT_METHODS or \
        method.startswith(_INBOX_EXEMPT_PREFIXES)


class RpcError(Exception):
    """Remote raised an application error."""


class RpcConnError(Exception):
    """Transport failure (connect/timeout/framing)."""


class FrameTooLarge(RpcConnError):
    """Send-path MAX_FRAME violation — raised before any byte is sent,
    so the connection stays usable."""


class RpcTimeoutError(RpcConnError):
    """Per-request timeout on a demonstrably-ALIVE connection (frames
    arrived recently; only this request is slow).  No transport verdict
    on the peer — the circuit breaker must not count it, or a slow-but-
    healthy follower gets cut out of quorum by its own fsync stalls."""


def _nbytes(b) -> int:
    return b.nbytes if isinstance(b, memoryview) else len(b)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly n bytes into ONE preallocated buffer (recv_into —
    no per-chunk bytes objects, no quadratic joins on 100MB results)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            raise RpcConnError("connection closed")
        got += r
    return buf


def _encode_body(obj: Any) -> Tuple[bytes, list]:
    """-> (header+json bytes, blobs).  Raw buffers (columnar result
    columns, SURVEY §2 row 25) are hoisted out of the JSON as blob
    references and shipped out-of-band, WITHOUT copying — memoryviews
    (numpy column buffers) ride to sendall as-is."""
    blobs: list = []

    def default(o):
        if isinstance(o, (bytes, bytearray, memoryview)):
            if isinstance(o, memoryview) and o.format != "B":
                o = o.cast("B")
            blobs.append(o)
            return {"@t": "blobref", "bi": len(blobs) - 1}
        raise TypeError(f"not JSON-serializable: {type(o).__name__}")

    data = json.dumps(obj, separators=(",", ":"), default=default).encode()
    if not blobs:
        return data, blobs
    header = b"\x00" + _LEN.pack(len(blobs)) + b"".join(
        _LEN.pack(_nbytes(b)) for b in blobs) + _LEN.pack(len(data))
    return header + data, blobs


def _send_frame(sock: socket.socket, obj: Any,
                rid: Optional[int] = None) -> int:
    """One frame: 4-byte length + body (+ fixed-width request id when
    pipelined).  Returns bytes written (wire-byte work counters).
    Callers sharing a socket must hold its send lock across the WHOLE
    call — the blob loop is several sendall()s."""
    head, blobs = _encode_body(obj)
    prefix = b"" if rid is None else b"\x01" + _LEN.pack(rid)
    total = len(prefix) + len(head) + sum(_nbytes(b) for b in blobs)
    if total > MAX_FRAME:
        raise FrameTooLarge(
            f"frame too large to send: {total} > MAX_FRAME={MAX_FRAME} "
            f"(split the result or raise MAX_FRAME)")
    # piecewise sendall: no 100MB+ join copy for big columnar results
    sock.sendall(_LEN.pack(total) + prefix + head)
    for b in blobs:
        sock.sendall(b)
    return _LEN.size + total


def _graft_blobs(j: Any, blobs: list) -> Any:
    """Replace {"@t":"blobref","bi":i} placeholders with the out-of-band
    buffers.  In blob mode the JSON part is small (bulk data IS the
    blobs), so the walk is cheap."""
    if isinstance(j, dict):
        if j.get("@t") == "blobref":
            return blobs[j["bi"]]
        return {k: _graft_blobs(v, blobs) for k, v in j.items()}
    if isinstance(j, list):
        return [_graft_blobs(x, blobs) for x in j]
    return j


def _decode_body(mv: memoryview) -> Any:
    if not mv or mv[0] != 0:
        return json.loads(bytes(mv))
    n = len(mv)
    off = 1
    if n < off + 4:
        raise RpcConnError("malformed blob frame: truncated header")
    (nb,) = _LEN.unpack(mv[off:off + 4]); off += 4
    # blob-count sanity BEFORE trusting it as a loop bound: the header
    # (counts + lengths) must fit inside the frame
    if nb < 0 or off + 4 * (nb + 1) > n:
        raise RpcConnError(f"malformed blob frame: {nb} blobs cannot "
                           f"fit a {n}-byte frame")
    lens = []
    for _ in range(nb):
        (ln,) = _LEN.unpack(mv[off:off + 4]); off += 4
        lens.append(ln)
    (jn,) = _LEN.unpack(mv[off:off + 4]); off += 4
    if off + jn + sum(lens) != n:
        raise RpcConnError(
            f"malformed blob frame: declared sizes (json={jn}, "
            f"blobs={sum(lens)}) do not tile the {n}-byte frame")
    j = json.loads(bytes(mv[off:off + jn])); off += jn
    blobs = []
    for ln in lens:
        blobs.append(mv[off:off + ln]); off += ln   # zero-copy views
    return _graft_blobs(j, blobs)


def _recv_frame(sock: socket.socket
                ) -> Tuple[Any, int, Optional[int]]:
    """-> (decoded frame, bytes read, request id | None)."""
    (n,) = _LEN.unpack(bytes(_recv_exact(sock, _LEN.size)))
    if n > MAX_FRAME:
        raise RpcConnError(f"frame too large: {n}")
    nbytes = _LEN.size + n
    payload = _recv_exact(sock, n)
    mv = memoryview(payload)
    rid = None
    if mv and mv[0] == 1:
        if n < 5:
            raise RpcConnError("malformed pipelined frame: no id")
        (rid,) = _LEN.unpack(mv[1:5])
        mv = mv[5:]
    return _decode_body(mv), nbytes, rid


# -- idempotency registry (satellite: retry-unsafe writes) ------------------

# Exact method names + prefixes whose handlers are safe to re-deliver:
# pure reads, overwrite-idempotent state pushes (heartbeat), and raft
# messages (the protocol itself dedups by term/index).  Everything else
# — writes, DDL, session/id allocation — must NOT be silently re-sent
# after a connection died mid-reply: the first send may have applied.
_IDEMPOTENT_METHODS = {
    "raft", "meta.ready", "meta.heartbeat", "meta.part_map",
    "storage.reconcile",
}
_IDEMPOTENT_PREFIXES = (
    "storage.get_", "storage.scan_", "storage.index_scan",
    "storage.fulltext_search", "storage.part_", "storage.export_",
    "storage.rebuild_",   # rebuilding an index twice = rebuilding once
    "meta.get_", "meta.list_", "graph.list_",
)


def mark_idempotent(*methods: str):
    """Register additional retry-safe methods (services owning custom
    read ops call this at registration time)."""
    _IDEMPOTENT_METHODS.update(methods)


def is_idempotent(method: str) -> bool:
    return method in _IDEMPOTENT_METHODS or \
        method.startswith(_IDEMPOTENT_PREFIXES)


# -- retry backoff + per-peer circuit breakers --------------------


def retry_backoff(attempt: int, base: float = 0.05, cap: float = 2.0,
                  rng=random) -> float:
    """Equal-jitter exponential backoff: d/2 + uniform(0, d/2) for
    d = min(cap, base·2^attempt).  The random half de-synchronizes the
    retry herd a leader crash creates; the deterministic half
    guarantees real wait time per attempt (full jitter can draw ~0
    repeatedly and burn every retry before an election settles).
    Callers clamp the sleep to their remaining deadline budget."""
    d = min(cap, base * (2.0 ** attempt))
    return d / 2.0 + rng.uniform(0.0, d / 2.0)


def deadline_sleep(delay: float):
    """Sleep `delay`, clamped so a budgeted caller never sleeps past
    its deadline; a KILL QUERY fired mid-sleep wakes it immediately
    (the caller's loop-top `_cancel.check()` turns it into QueryKilled
    instead of waiting out the full jittered backoff)."""
    rem = _cancel.remaining()
    if rem is not None:
        delay = min(delay, max(rem, 0.0))
    if delay <= 0:
        return
    ev = _cancel.current_kill()
    if ev is not None:
        ev.wait(delay)
    else:
        time.sleep(delay)


class CircuitBreaker:
    """Per-peer connection-failure breaker: closed → (K consecutive
    failures) → open → (reset_secs) → half-open, where ONE probe is
    admitted; probe success closes, failure re-opens.  Only transport
    failures count — an application error proves the peer alive."""

    def __init__(self, peer: str):
        self.peer = peer
        self.lock = threading.Lock()
        self.failures = 0
        self.state = "closed"
        self.opened_at = 0.0
        self._probing = False

    def allow(self) -> bool:
        with self.lock:
            if self.state == "closed":
                return True
            try:
                reset = float(get_config().get("breaker_reset_secs"))
            except Exception:  # noqa: BLE001 — config not initialized
                reset = 2.0
            if time.monotonic() - self.opened_at < reset:
                _stats().inc("rpc_breaker_short_circuits")
                return False
            if self._probing:
                _stats().inc("rpc_breaker_short_circuits")
                return False
            # half-open: admit exactly one probe
            self.state = "half_open"
            self._probing = True
            _stats().inc("rpc_breaker_probes")
        # trace coverage: breaker state changes land
        # in the statement's trace tree with the peer labeled
        _trace.record_phase("rpc:breaker", 0.0, peer=self.peer,
                            to="half_open")
        return True

    def record_success(self):
        with self.lock:
            reopened = self.state != "closed"
            if reopened:
                _stats().inc_labeled("rpc_breaker_transitions",
                                     {"to": "closed"})
            self.state = "closed"
            self.failures = 0
            self._probing = False
        if reopened:
            _trace.record_phase("rpc:breaker", 0.0, peer=self.peer,
                                to="closed")

    def release_probe(self):
        """Relinquish a half-open probe slot without a verdict: the
        admitted call exited via a non-transport path (killed/timed-out
        statement, oversized frame) and proved nothing about the peer.
        The breaker stays half-open, so the NEXT caller is admitted as
        a fresh probe — without this, an abandoned probe would leave
        `_probing` latched and short-circuit the peer forever."""
        with self.lock:
            if self.state == "half_open":
                self._probing = False

    def record_failure(self):
        tripped = False
        with self.lock:
            self.failures += 1
            self._probing = False
            try:
                k = int(get_config().get("breaker_failure_threshold"))
            except Exception:  # noqa: BLE001
                k = 5
            if self.state == "half_open" or \
                    (self.state == "closed" and self.failures >= k):
                if self.state != "open":
                    _stats().inc("rpc_breaker_trips")
                    _stats().inc_labeled("rpc_breaker_transitions",
                                         {"to": "open"})
                    tripped = True
                self.state = "open"
                self.opened_at = time.monotonic()
        if tripped:
            _trace.record_phase("rpc:breaker", 0.0, peer=self.peer,
                                to="open")


_breakers: Dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_for(peer: str) -> CircuitBreaker:
    with _breakers_lock:
        br = _breakers.get(peer)
        if br is None:
            br = _breakers[peer] = CircuitBreaker(peer)
        return br


def reset_breakers():
    """Drop all breaker state (test isolation)."""
    with _breakers_lock:
        _breakers.clear()


# -- pool gauges ------------------------------------------------------------

_gauge_lock = threading.Lock()
_open_conns = 0
_inflight = 0


def _gauge_delta(conns: int = 0, inflight: int = 0):
    global _open_conns, _inflight
    with _gauge_lock:
        _open_conns += conns
        _inflight += inflight
        c, i = _open_conns, _inflight
    st = _stats()
    if conns:
        st.gauge("rpc_pool_size", c)
    if inflight:
        st.gauge("rpc_inflight", i)


class RpcServer:
    """Threaded TCP server dispatching to registered handlers.

    handler(params: dict) -> jsonable result; raising RpcError (or any
    exception) returns an error reply instead of killing the connection.

    Pipelined requests (frames carrying a request id) dispatch to a
    small per-connection worker pool and reply OUT OF ORDER as handlers
    finish — a slow fanout partition no longer blocks its siblings on
    the same socket.  Id-less frames keep the old serial semantics.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.handlers: Dict[str, Callable[[Dict[str, Any]], Any]] = {}
        self.hooks: list = []           # fault-injection: fn(method) -> None|Exception
        # which daemon this server fronts ("graphd"/"storaged"/"metad");
        # stamped on the spans its handlers produce
        self.service_role = "unknown"
        # bounded dispatch inbox: pipelined requests in
        # flight across ALL this server's connections; beyond
        # rpc_server_inbox_capacity new ones are rejected with
        # E_OVERLOAD + a drain-rate-derived retry-after instead of
        # queuing unboundedly on the worker pools
        self._inbox = 0
        self._inbox_mu = threading.Lock()
        self._inbox_drain = DrainEstimator()
        # a stopped server must stop SERVING, not just accepting:
        # shutdown() only ends the accept loop, while established
        # (pooled-client) connections would keep answering from their
        # handler threads — a "killed" daemon zombie-serving stale
        # state (a dead metad kept reporting liveness, a
        # dead storaged kept claiming part leadership)
        self._stopped = threading.Event()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                sock.settimeout(300)
                wlock = threading.Lock()
                pool: Optional[ThreadPoolExecutor] = None
                try:
                    while True:
                        req, _, rid = _recv_frame(sock)
                        if outer._stopped.is_set():
                            break       # drop the connection, no reply
                        if rid is None:
                            outer._serve_one(sock, wlock, None, req)
                            continue
                        shed = outer._inbox_enter(req)
                        if shed is not None:
                            try:
                                with wlock:
                                    _send_frame(sock, shed, rid)
                            except (OSError, RpcConnError):
                                pass
                            continue
                        if pool is None:
                            try:
                                workers = int(get_config().get(
                                    "rpc_server_workers"))
                            except Exception:  # noqa: BLE001
                                workers = 8
                            pool = ThreadPoolExecutor(
                                max_workers=max(1, workers),
                                thread_name_prefix="rpc-srv")
                        pool.submit(outer._serve_pooled, sock, wlock,
                                    rid, req)
                except (RpcConnError, socket.timeout, OSError,
                        json.JSONDecodeError, ValueError):
                    pass
                finally:
                    if pool is not None:
                        pool.shutdown(wait=False)

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def _inbox_enter(self, req) -> Optional[Dict[str, Any]]:
        """Admit a pipelined request into the dispatch inbox, or return
        the E_OVERLOAD reply to send instead.  Exempt methods (raft,
        meta.*, graph control ops) always enter; the `rpc:server_inbox`
        failpoint force-sheds a request (raise) or stalls the check
        (delay) for tests."""
        try:
            cap = int(get_config().get("rpc_server_inbox_capacity"))
        except Exception:  # noqa: BLE001 — config not initialized
            cap = 0
        method = req.get("method") if isinstance(req, dict) else None
        if cap <= 0 or _inbox_exempt(method):
            with self._inbox_mu:
                self._inbox += 1
            return None
        forced = False
        try:
            fail.hit("rpc:server_inbox", key=method)
        except FailpointError:
            forced = True
        with self._inbox_mu:
            depth = self._inbox
            if not forced and depth < cap:
                self._inbox += 1
                return None
        retry = self._inbox_drain.retry_after_s(max(depth - cap, 0) + 1)
        _stats().inc_labeled("overload_server_rejections",
                             {"op": str(method), "role": self.service_role})
        return {"ok": False, "error": overload_error(
            retry, f"{self.service_role}:rpc_inbox",
            f"server inbox full (inflight={depth}, capacity={cap})")}

    def _serve_pooled(self, sock, wlock, rid, req):
        try:
            self._serve_one(sock, wlock, rid, req)
        finally:
            with self._inbox_mu:
                self._inbox = max(self._inbox - 1, 0)
            method = req.get("method") if isinstance(req, dict) else None
            if not _inbox_exempt(method):
                # the retry-after hint prices how fast SHEDDABLE work
                # drains — exempt traffic (raft, heartbeats) is often
                # fast and frequent and would inflate the rate,
                # teaching shed clients to retry far too early
                self._inbox_drain.note_done()

    def _serve_one(self, sock, wlock, rid, req):
        reply = self._dispatch(req)
        try:
            # the ack-lost window: the handler HAS run (possibly a
            # committed write) but the reply never reaches the client —
            # the hazard exactly-once dedup exists for.  The key carries
            # method + reply disposition ("storage.write|ok" vs "|err")
            # so schedules can target exactly the acked-write replies
            # (killing an error reply injects a different, weaker fault)
            method = req.get("method") if isinstance(req, dict) else None
            ok = reply.get("ok") if isinstance(reply, dict) else None
            fail.hit("rpc:server_reply",
                     key=f"{method}|{'ok' if ok else 'err'}")
        except FailpointError:
            try:
                # shutdown(), not close(): the connection's read-loop
                # thread is blocked in recv() on this socket, and its
                # in-flight syscall keeps the kernel socket alive past
                # close() — no FIN would go out until that recv returns.
                # shutdown() tears the connection down immediately, so
                # the client sees the mid-call death NOW.
                sock.shutdown(socket.SHUT_RDWR)
                sock.close()
            except OSError:
                pass
            return
        try:
            try:
                with wlock:
                    _send_frame(sock, reply, rid)
            except FrameTooLarge as ex:
                # symmetric MAX_FRAME: the peer gets a diagnosable
                # application error, not an opaque disconnect
                with wlock:
                    _send_frame(sock, {"ok": False, "error": str(ex)},
                                rid)
        except (OSError, RpcConnError):
            pass                      # peer went away; nothing to tell it

    def register(self, method: str, fn: Callable[[Dict[str, Any]], Any]):
        self.handlers[method] = fn

    def register_service(self, obj: Any, prefix: str = ""):
        """Every public method rpc_* of obj becomes `prefix+name`."""
        for name in dir(obj):
            if name.startswith("rpc_"):
                self.register(prefix + name[4:], getattr(obj, name))

    def _dispatch(self, req: Any) -> Dict[str, Any]:
        method = req.get("method") if isinstance(req, dict) else None
        if not method:
            return {"ok": False, "error": "malformed request frame"}
        params = req.get("params", {})
        wire_trace = req.get("trace")
        spans = None
        # cost attribution: when the caller flagged
        # the request ("c"), the handler runs under a fresh CostRecorder
        # — the service layers (storage reads, WAL fsyncs, dedup hits,
        # nested RPCs) fold their per-hop costs into it, and the record
        # rides back in the reply envelope for per-plan-node
        # attribution on the coordinator.  The handler time is shipped
        # as a FIXED-WIDTH decimal so reply byte counts stay
        # deterministic for the wire-byte regression probes.
        crec = CostRecorder() if req.get("c") else None

        def _cost_of(reply: Dict[str, Any]) -> Dict[str, Any]:
            if crec is not None:
                # timing fields merged from NESTED replies (plain ints,
                # e.g. remote_us of a TOSS in-half hop) must not ship
                # upward: their digit count varies run-to-run, which
                # would break the wire-byte determinism the fixed-width
                # `us` exists for — and this handler's wall time below
                # already covers nested handler time (the nested call
                # ran inside it)
                c = {k: v for k, v in crec.as_dict().items()
                     if not k.endswith("_us")}
                c["us"] = f"{min(int((time.perf_counter() - t0) * 1e6), 10 ** 9 - 1):09d}"
                reply["cost"] = c
            return reply

        t0 = time.perf_counter()
        try:
            fail.hit("rpc:server_dispatch", key=method)
            for hook in self.hooks:
                hook(method)
            fn = self.handlers.get(method)
            if fn is None:
                return {"ok": False, "error": f"unknown method `{method}'"}
            dl = req.get("dl")
            if dl is not None:
                # deadline budget rides the envelope as REMAINING
                # seconds (fixed-width decimal string — see the client
                # side); re-anchor on this hop's clock so nested RPCs
                # issued by the handler inherit a decremented budget
                dl = float(dl)
                if dl <= 0:
                    return {"ok": False,
                            "error": "E_QUERY_TIMEOUT: deadline "
                                     "exhausted before dispatch"}
                inner, dl_abs = fn, time.monotonic() + float(dl)

                def fn(p, _inner=inner, _dl=dl_abs):
                    with _cancel.use_cancel(deadline=_dl):
                        return _inner(p)
            if wire_trace:
                # adopt the caller's trace: handler spans go to a fresh
                # sink shipped back in the reply (the coordinator owns
                # the trace; nothing is stored on this side)
                with _trace.adopt_remote(wire_trace[0], wire_trace[1],
                                         self.service_role) as rg:
                    spans = rg.spans
                    with _trace.span(f"rpc.server:{method}"), \
                            use_cost(crec):
                        result = fn(params)
                return _cost_of({"ok": True, "result": result,
                                 "spans": spans})
            with use_cost(crec):
                result = fn(params)
            return _cost_of({"ok": True, "result": result})
        except RpcError as ex:
            reply = {"ok": False, "error": str(ex)}
            if spans:
                # the error-path spans (incl. the rpc.server span with
                # its error attr) are precisely what a failing query's
                # trace needs — ship them like the success path does
                reply["spans"] = spans
            return _cost_of(reply)
        except Exception as ex:  # noqa: BLE001 — server must not die
            reply = {"ok": False, "error": f"{type(ex).__name__}: {ex}"}
            if spans:
                reply["spans"] = spans
            return _cost_of(reply)
        finally:
            # observe error-path latencies too: a histogram that only
            # sees successes understates the tail it exists to expose.
            # REGISTERED methods only — labeling by a client-supplied
            # unknown name would let garbage frames grow one permanent
            # histogram row per bogus method (unbounded cardinality)
            if method in self.handlers:
                _stats().observe("rpc_server_latency_us",
                                 (time.perf_counter() - t0) * 1e6,
                                 {"op": method,
                                  "role": self.service_role})

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name=f"rpc-{self.port}")
        self._thread.start()

    def stop(self):
        self._stopped.set()
        self._server.shutdown()
        self._server.server_close()


class RpcNeverSentError(RpcConnError):
    """The request provably never reached the wire (connect failure or
    connection already dead at entry) — retry is safe for ANY method,
    idempotent or not.  Higher-level retry loops (StorageClient's
    replica walk) key off this to stay double-apply-safe."""


class _Pending:
    __slots__ = ("event", "reply", "nbytes", "error")

    def __init__(self):
        self.event = threading.Event()
        self.reply = None
        self.nbytes = 0
        self.error: Optional[Exception] = None


class _Conn:
    """One pipelined connection: send lock + reader thread + pending map
    keyed by request id.  Death (socket error, malformed frame, close)
    fails every waiter at once."""

    __slots__ = ("sock", "send_lock", "pending", "plock", "_ids",
                 "dead", "inflight", "last_rx", "_reader", "timeout")

    def __init__(self, host: str, port: int, timeout: float):
        fail.hit("rpc:connect")     # raise here == connect refused
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # the socket KEEPS its timeout: a peer that stops reading must
        # not hang sendall() forever while it holds send_lock — the
        # reader tolerates idle timeouts between frames (below), so
        # pooled connections still survive quiet periods
        self.sock = sock
        self.timeout = timeout      # the BASE transport window
        self.send_lock = threading.Lock()
        self.pending: Dict[int, _Pending] = {}
        self.plock = threading.Lock()
        self._ids = itertools.count(1)
        self.dead: Optional[Exception] = None
        self.inflight = 0
        self.last_rx = time.monotonic()   # any frame received
        _gauge_delta(conns=1)
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"rpc-reader-{host}:{port}")
        self._reader.start()

    def _read_loop(self):
        hdr = bytearray(_LEN.size)
        view = memoryview(hdr)
        try:
            while True:
                # idle-tolerant length read: a socket timeout BETWEEN
                # frames just means no traffic — only a timeout
                # mid-frame (or mid-payload below) is a dead peer
                got = 0
                while got < _LEN.size:
                    try:
                        r = self.sock.recv_into(view[got:])
                    except socket.timeout:
                        if got == 0:
                            continue
                        raise RpcConnError("timeout mid-frame")
                    if r == 0:
                        raise RpcConnError("connection closed")
                    got += r
                (n,) = _LEN.unpack(hdr)
                if n > MAX_FRAME:
                    raise RpcConnError(f"frame too large: {n}")
                nbytes = _LEN.size + n
                mv = memoryview(_recv_exact(self.sock, n))
                rid = None
                if mv and mv[0] == 1:
                    if n < 5:
                        raise RpcConnError("malformed pipelined frame")
                    (rid,) = _LEN.unpack(mv[1:5])
                    mv = mv[5:]
                reply = _decode_body(mv)
                # armed kill_conn here == the connection dies with
                # replies (possibly not ours) in flight
                fail.hit("rpc:recv")
                self.last_rx = time.monotonic()
                with self.plock:
                    p = self.pending.pop(rid, None)
                if p is not None:       # late reply after timeout: drop
                    p.reply = reply
                    p.nbytes = nbytes
                    p.event.set()
        except Exception as ex:  # noqa: BLE001 — any framing/socket death
            self.die(ex)

    def die(self, ex: Exception):
        with self.plock:
            if self.dead is not None:
                return              # pending already failed by first death
            self.dead = ex
            waiters = list(self.pending.values())
            self.pending.clear()
        _gauge_delta(conns=-1)
        try:
            self.sock.close()
        except OSError:
            pass
        for p in waiters:
            p.error = ex
            p.event.set()

    def request(self, req: Dict[str, Any], timeout: float
                ) -> Tuple[Any, int, int]:
        """-> (reply, sent bytes, received bytes).  Raises RpcConnError
        on transport failure; the caller decides whether a retry is
        idempotency-safe."""
        p = _Pending()
        with self.plock:
            if self.dead is not None:
                raise RpcNeverSentError(str(self.dead))
            rid = next(self._ids)
            self.pending[rid] = p
            self.inflight += 1
        _gauge_delta(inflight=1)
        try:
            try:
                # a FIRED action here kills the live connection: the
                # request may or may not have hit the wire — the
                # mid-call at-least-once hazard, NOT a never-sent
                fail.hit("rpc:send", key=req.get("method"))
                with self.send_lock:
                    sent = _send_frame(self.sock, req, rid)
            except FrameTooLarge:
                with self.plock:
                    self.pending.pop(rid, None)
                raise                 # connection untouched, no retry
            except FailpointError as ex:
                self.die(ex)
                raise RpcConnError(f"send failed: {ex}") from None
            except OSError as ex:
                self.die(ex)
                raise RpcConnError(f"send failed: {ex}") from None
            # kill-aware reply wait: when the calling thread
            # carries a cancel context (statement-scoped call), wait in
            # slices and poll it — KILL QUERY must interrupt an
            # in-flight hop (e.g. a write stalled on a slow fsync), not
            # ride out the transport timeout.  Context-free callers
            # (heartbeats, replication) keep the single cheap wait.
            if _cancel.current_kill() is None and \
                    _cancel.current_deadline() is None:
                got = p.event.wait(timeout)
            else:
                got, wait_dl = False, time.monotonic() + timeout
                while not got:
                    rem = wait_dl - time.monotonic()
                    if rem <= 0:
                        break
                    got = p.event.wait(min(rem, 0.05))
                    if not got:
                        try:
                            _cancel.check()
                        except Exception:
                            # abandoned mid-flight: rid matching makes
                            # the late reply harmlessly droppable
                            with self.plock:
                                self.pending.pop(rid, None)
                            raise
            if not got:
                with self.plock:
                    self.pending.pop(rid, None)
                if time.monotonic() - self.last_rx >= \
                        max(timeout, self.timeout):
                    # the peer has been COMPLETELY silent for a full
                    # BASE transport window: treat the connection as
                    # dead so the pool stops queueing onto a zombie
                    # socket (fast failure detection for dead hosts).
                    # Judged against self.timeout, not the per-request
                    # wait: a deadline-clamped request can time out in
                    # milliseconds, which says nothing about the
                    # connection — killing it would collaterally abort
                    # sibling in-flight (possibly non-idempotent) calls
                    self.die(RpcConnError(
                        f"peer silent for {max(timeout, self.timeout)}s"))
                    raise RpcConnError(
                        f"rpc timeout after {timeout}s (peer silent)")
                # the connection is demonstrably alive (frames arrived
                # recently) — fail ONLY this request; rid matching makes
                # its late reply harmlessly droppable, and sibling
                # in-flight calls (possibly non-idempotent,
                # non-retryable) must not be collaterally aborted by
                # one slow handler
                raise RpcTimeoutError(f"rpc timeout after {timeout}s")
            if p.error is not None:
                raise RpcConnError(str(p.error))
            return p.reply, sent, p.nbytes
        finally:
            with self.plock:
                self.inflight -= 1
            _gauge_delta(inflight=-1)


class RpcClient:
    """Per-peer pipelined connection pool.

    Concurrent call()s multiplex over pooled connections by request id —
    they overlap in flight instead of serializing behind one socket lock
    (`StorageClient.fanout` to N partitions on one host is now wall-time
    ≈ max(partition), not sum).  Auto-reconnects; automatic retry after
    a mid-call connection death only for idempotent methods (see
    `is_idempotent`)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 retries: int = 2, pool_size: Optional[int] = None):
        self.host, self.port = host, port
        self.timeout = timeout
        self.retries = retries
        if pool_size is None:
            try:
                pool_size = int(get_config().get("rpc_pool_size"))
            except Exception:  # noqa: BLE001 — config not initialized
                pool_size = 2
        self.pool_size = max(1, pool_size)
        self._conns: list = []
        self._lock = threading.Lock()
        self._closed = False

    @classmethod
    def from_addr(cls, addr: str, **kw) -> "RpcClient":
        host, port = addr.rsplit(":", 1)
        return cls(host, int(port), **kw)

    def _pick(self) -> _Conn:
        """Least-loaded live connection; grow the pool while every
        existing connection is busy and the cap allows.  The blocking
        connect happens OUTSIDE the pool lock — one unreachable-peer
        connect must not stall callers that could ride an existing
        live connection."""
        with self._lock:
            if self._closed:
                raise RpcNeverSentError("client closed")
            live = [c for c in self._conns if c.dead is None]
            self._conns = live
            best = min(live, key=lambda c: c.inflight, default=None)
            if best is not None and (best.inflight == 0
                                     or len(live) >= self.pool_size):
                return best
        try:
            c = _Conn(self.host, self.port, self.timeout)
        except (OSError, FailpointError) as ex:
            raise RpcNeverSentError(
                f"connect to {self.host}:{self.port} failed: {ex}"
            ) from None
        with self._lock:
            if self._closed:
                c.die(RpcConnError("client closed"))
                raise RpcNeverSentError("client closed")
            live = [x for x in self._conns if x.dead is None]
            if len(live) >= self.pool_size:
                # a racing caller filled the pool meanwhile — keep the
                # cap: drop the extra socket, ride the least-loaded
                c.die(RpcConnError("pool full"))
                return min(live, key=lambda x: x.inflight)
            self._conns.append(c)
            return c

    def call(self, method: str, **params) -> Any:
        last_err: Optional[Exception] = None
        peer = f"{self.host}:{self.port}"
        br = breaker_for(peer)
        cc = current_cost()

        def note_retry(ex: Exception, attempt: int):
            _stats().inc_labeled("rpc_client_retries", {"op": method})
            # trace coverage: every retry attempt
            # is a leaf in the statement's trace with the peer labeled
            _trace.record_phase("rpc:retry", 0.0, peer=peer, op=method,
                                attempt=attempt,
                                error=type(ex).__name__)

        with _trace.span(f"rpc:{method}", peer=f"{self.host}:{self.port}"):
            for attempt in range(self.retries + 1):
                # deadline budget: no attempt (or backoff sleep) may
                # outlive the statement's remaining budget — raises
                # DeadlineExceeded/QueryKilled into the caller, which
                # surfaces as E_QUERY_TIMEOUT at the graphd boundary
                _cancel.check()
                # per-attempt timer: a success after a reconnect must
                # not record the dead attempt + backoff sleep as op
                # latency (the rpc:<method> span still covers the whole
                # call, retries included)
                t_call = time.perf_counter()
                req = {"method": method, "params": params}
                timeout = self.timeout
                rem = _cancel.remaining()
                if rem is not None:
                    # stamp the REMAINING seconds into the envelope (the
                    # server re-anchors on its own clock — clock-skew-
                    # free relative propagation) and clamp the transport
                    # wait to the budget.  Fixed-width so identical
                    # queries produce byte-identical frames regardless
                    # of how much budget happens to remain (the wire-
                    # byte work counters are a documented regression
                    # probe — docs/OBSERVABILITY.md)
                    req["dl"] = f"{min(max(rem, 0.001), 1e8):013.3f}"
                    timeout = min(timeout, max(rem, 0.001))
                tctx = _trace.wire_context()
                if tctx is not None:
                    req["trace"] = list(tctx)
                if cc is not None:
                    # ask the peer for a cost record in the reply
                    # envelope (per-plan-node attribution)
                    req["c"] = 1
                if not br.allow():
                    # open breaker: fail fast, provably never sent.
                    # Checked OUTSIDE the try: a short-circuit is not a
                    # peer failure — recording it would clear another
                    # thread's half-open probe and re-trip the breaker
                    # on a call that never left the process
                    last_err = RpcNeverSentError(
                        f"circuit open to {self.host}:{self.port}")
                    if attempt < self.retries:
                        # trace only — the breaker short-circuit never
                        # re-sent anything, so the rpc_client_retries
                        # counter (an internal-re-send measure feeding
                        # retry_amplification) must not move
                        _trace.record_phase(
                            "rpc:retry", 0.0, peer=peer, op=method,
                            attempt=attempt, error="CircuitOpen")
                        deadline_sleep(retry_backoff(attempt))
                    continue
                sent_any = False
                try:
                    conn = self._pick()
                    sent_any = True     # bytes may be on the wire now
                    reply, sent, recvd = conn.request(req, timeout)
                except FrameTooLarge:
                    br.release_probe()
                    raise
                except RpcNeverSentError as ex:
                    last_err = ex       # provably never sent: retryable
                    br.record_failure()
                    if attempt < self.retries:
                        note_retry(ex, attempt)
                        deadline_sleep(retry_backoff(attempt))
                    continue
                except RpcTimeoutError as ex:
                    # one slow request on an alive connection: breaker-
                    # neutral (see RpcTimeoutError) — free any probe
                    # slot, keep the mid-call idempotency gate below
                    last_err = ex
                    br.release_probe()
                    if sent_any and not is_idempotent(method):
                        raise RpcConnError(
                            f"rpc {method} to {self.host}:{self.port} "
                            f"failed mid-call and is not idempotent "
                            f"(not retried): {ex}") from None
                    if attempt < self.retries:
                        note_retry(ex, attempt)
                        deadline_sleep(retry_backoff(attempt))
                    continue
                except (OSError, RpcConnError,
                        json.JSONDecodeError) as ex:
                    last_err = ex
                    br.record_failure()
                    # connect failures never reached the peer — always
                    # retryable; mid-call deaths may have applied the
                    # request, so only idempotent methods auto-retry
                    if sent_any and not is_idempotent(method):
                        raise RpcConnError(
                            f"rpc {method} to {self.host}:{self.port} "
                            f"failed mid-call and is not idempotent "
                            f"(not retried): {ex}") from None
                    if attempt < self.retries:
                        note_retry(ex, attempt)
                        deadline_sleep(retry_backoff(attempt))
                    continue
                except BaseException:
                    # non-transport exit (QueryKilled/DeadlineExceeded
                    # from the kill-aware reply wait): no verdict on
                    # the peer — free the probe slot and re-raise
                    br.release_probe()
                    raise
                # ANY reply proves the peer alive — an application
                # error is not a transport failure
                br.record_success()
                us = (time.perf_counter() - t_call) * 1e6
                _stats().observe("rpc_client_latency_us", us,
                                 {"op": method})
                wc = current_work()
                if wc is not None:
                    wc.add_rpc(sent, recvd)
                if cc is not None:
                    # fold the peer's cost record (success AND error
                    # replies — a failing node's costs still land in
                    # PROFILE / the flight recorder) plus our own
                    # call/byte counts into the active node's sink
                    rcost = reply.get("cost")
                    if isinstance(rcost, dict):
                        cc.merge_reply(rcost)
                    cc.add("calls", 1)
                    cc.add("bytes_sent", sent)
                    cc.add("bytes_recv", recvd)
                # remote spans come back on error replies too — a
                # failing branch's storaged subtree must still land in
                # the coordinator's trace
                _trace.graft(reply.get("spans") or [])
                if reply.get("ok"):
                    return reply.get("result")
                _stats().inc_labeled("rpc_client_errors", {"op": method})
                err = reply.get("error", "unknown error")
                if is_overload(err):
                    # the peer SHED this request before its handler ran
                    # (bounded inbox / admission): retrying is safe for
                    # ANY method, and breaker-neutral — the reply
                    # itself proves the peer alive (record_success
                    # already ran above).  Honor the retry-after hint
                    # inside the deadline-budgeted backoff: the sleep
                    # is clamped to the statement's remaining budget
                    # and wakes on KILL QUERY like every other backoff.
                    last_err = RpcError(err)
                    if attempt < self.retries:
                        _stats().inc_labeled("overload_client_retries",
                                             {"op": method})
                        _trace.record_phase(
                            "rpc:retry", 0.0, peer=peer, op=method,
                            attempt=attempt, error="Overload")
                        hint = parse_retry_after(err)
                        # jitter the hint: every client shed in one
                        # saturation burst sees the same depth and the
                        # same hint — sleeping it verbatim re-arrives
                        # the whole herd in one pulse
                        deadline_sleep(
                            hint * random.uniform(0.5, 1.5)
                            if hint is not None
                            else retry_backoff(attempt))
                        continue
                    raise RpcError(err)
                if isinstance(err, str) and \
                        ("E_QUERY_TIMEOUT" in err or
                         err.startswith("DeadlineExceeded")):
                    # the remote hop's re-anchored budget expired first
                    # (sub-ms race with our own clock): surface the
                    # SAME exception the local deadline check raises so
                    # the engine boundary counts and reports timeouts
                    # identically whichever side's clock wins
                    raise _cancel.DeadlineExceeded(err)
                raise RpcError(err)
        # preserve the never-sent distinction through the final raise so
        # higher-level retry loops stay double-apply-safe
        kind = RpcNeverSentError if isinstance(last_err, RpcNeverSentError) \
            else RpcConnError
        raise kind(f"rpc to {self.host}:{self.port} failed: {last_err}")

    def close(self):
        with self._lock:
            self._closed = True
            conns, self._conns = self._conns, []
        for c in conns:
            c.die(RpcConnError("client closed"))


class RpcRaftTransport:
    """RaftTransport over RpcClient connections — raftex.thrift's role.

    peer ids ARE addresses ("host:port"); raft messages dispatch to the
    `raft` method of the peer's RpcServer, which routes to the right
    RaftPart by group.
    """

    def __init__(self):
        self._clients: Dict[str, RpcClient] = {}
        self._lock = threading.Lock()

    def client(self, peer: str) -> RpcClient:
        with self._lock:
            c = self._clients.get(peer)
            if c is None:
                c = self._clients[peer] = RpcClient.from_addr(
                    peer, timeout=2.0, retries=0, pool_size=1)
            return c

    def send(self, peer, group, method, payload):
        try:
            return self.client(peer).call(
                "raft", group=group, rmethod=method, payload=payload)
        except (RpcError, RpcConnError):
            return None


def serve_raft_parts(server: RpcServer, parts: Dict[str, Any]):
    """Register the `raft` dispatch method for a dict group → RaftPart."""
    def handler(params):
        part = parts.get(params["group"])
        if part is None:
            raise RpcError(f"no raft group `{params['group']}' here")
        return part.handle(params["rmethod"], params["payload"])
    server.register("raft", handler)
