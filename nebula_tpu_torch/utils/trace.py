"""The port's copy of `nebula_tpu/utils/trace.py`, whole.

Distributed query tracing — trace/span ids carried in the RPC envelope.

The reference ships per-node PROFILE timings but nothing that crosses
the graphd process boundary; a slow cluster query's time disappears
into storaged.  This module is the cross-service half of the
observability layer: a per-query trace id plus span
ids ride the JSON-TCP envelope (cluster.rpc), every service opens child
spans around its work, and the spans a REMOTE service produced while
handling an RPC are returned in the reply and grafted into the caller's
trace — so the coordinator (the graphd that ran the statement) ends up
holding ONE stitched tree covering graphd executors, storaged reads,
raft appends and the device put/dispatch/fetch phases.  Queryable via
`GET /traces` on the webservice and `SHOW TRACES` in nGQL.

Design constraints:
  * zero cost when no trace is active — `span()` is a no-op context;
  * thread-pool safe — the scheduler and the storage fan-out run on
    pools, so the context is snapshot/restore (`current_ctx` /
    `use_ctx`), and sinks are plain lists (append is atomic);
  * spans are plain dicts the moment they finish (JSON-safe: they ship
    in RPC replies and out of the /traces endpoint verbatim).

Span fields: tid, sid, psid (parent span id), name, svc (service
role), t0 (epoch seconds), dur_us, attrs (flat dict).  Remote spans
grafted from an RPC reply additionally carry remote=True.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

_tls = threading.local()
_span_seq = itertools.count(1)
# span ids must not collide across processes (a trace stitches spans
# from graphd + storaged + metad); prefix with a per-process token
_PROC = f"{os.getpid():x}"


def _new_id(kind: str) -> str:
    return f"{kind}{_PROC}-{next(_span_seq)}"


class _Ctx:
    __slots__ = ("tid", "sid", "sink", "service")

    def __init__(self, tid: str, sid: str, sink: List[dict], service: str):
        self.tid = tid
        self.sid = sid
        self.sink = sink
        self.service = service


def _get_ctx() -> Optional[_Ctx]:
    return getattr(_tls, "ctx", None)


def current_ctx() -> Optional[_Ctx]:
    """Snapshot for cross-thread propagation (fan-out pools)."""
    return _get_ctx()


def wire_context() -> Optional[Tuple[str, str]]:
    """(trace_id, parent_span_id) to put on an outgoing RPC frame."""
    ctx = _get_ctx()
    if ctx is None:
        return None
    return ctx.tid, ctx.sid


class _CtxGuard:
    """Context manager installing a _Ctx (or None) on this thread."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[_Ctx]):
        self._ctx = ctx

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


def use_ctx(ctx: Optional[_Ctx]) -> _CtxGuard:
    """Re-establish a snapshot taken with current_ctx() on a pool
    thread (no-op guard when ctx is None).  Installs a COPY sharing the
    trace id and sink but owning its parent-span slot — span guards
    mutate `ctx.sid`, and concurrent branches of one query must not
    stomp each other's parenting (sink.append itself is atomic)."""
    if ctx is None:
        return _CtxGuard(None)
    return _CtxGuard(_Ctx(ctx.tid, ctx.sid, ctx.sink, ctx.service))


class _SpanGuard:
    """Open span: on exit, append the finished record to the sink."""

    __slots__ = ("_ctx", "_rec", "_t0", "_prev_sid")

    def __init__(self, ctx: Optional[_Ctx], name: str, attrs: Dict[str, Any]):
        self._ctx = ctx
        if ctx is None:
            return
        self._rec = {"tid": ctx.tid, "sid": _new_id("s"),
                     "psid": ctx.sid, "name": name, "svc": ctx.service,
                     "t0": time.time(), "dur_us": 0}
        if attrs:
            self._rec["attrs"] = attrs

    def __enter__(self):
        ctx = self._ctx
        if ctx is None:
            return None
        self._t0 = time.perf_counter()
        self._prev_sid = ctx.sid
        ctx.sid = self._rec["sid"]
        return self._rec

    def __exit__(self, exc_type, exc, tb):
        ctx = self._ctx
        if ctx is None:
            return False
        ctx.sid = self._prev_sid
        self._rec["dur_us"] = int(
            (time.perf_counter() - self._t0) * 1e6)
        if exc is not None:
            self._rec.setdefault("attrs", {})["error"] = \
                f"{type(exc).__name__}: {exc}"
        ctx.sink.append(self._rec)
        return False


def span(name: str, **attrs) -> _SpanGuard:
    """Child span of the active trace; no-op when none is active."""
    return _SpanGuard(_get_ctx(), name, attrs)


def record_phase(name: str, dur_s: float, **attrs):
    """Append an already-measured span (device phases: the runtime times
    put/dispatch/fetch itself; these become leaf spans of the executor
    span that drove the kernel)."""
    ctx = _get_ctx()
    if ctx is None:
        return
    rec = {"tid": ctx.tid, "sid": _new_id("s"), "psid": ctx.sid,
           "name": name, "svc": ctx.service, "t0": time.time() - dur_s,
           "dur_us": int(dur_s * 1e6)}
    if attrs:
        rec["attrs"] = attrs
    ctx.sink.append(rec)


def graft(spans: List[dict]):
    """Merge spans returned by a remote service into the active trace
    (they already carry their own parentage — the root of the remote
    subtree points at the client-side rpc span id we sent over)."""
    ctx = _get_ctx()
    if ctx is None or not spans:
        return
    for s in spans:
        s = dict(s)
        s["remote"] = True
        ctx.sink.append(s)


class _TraceGuard:
    """Root context: owns the sink; stores the finished trace."""

    __slots__ = ("_ctx", "_rec", "_t0", "_prev")

    def __init__(self, name: str, service: str, attrs: Dict[str, Any]):
        tid = _new_id("t")
        sink: List[dict] = []
        self._ctx = _Ctx(tid, "", sink, service)
        self._rec = {"tid": tid, "sid": _new_id("s"), "psid": "",
                     "name": name, "svc": service, "t0": time.time(),
                     "dur_us": 0}
        if attrs:
            self._rec["attrs"] = attrs

    @property
    def trace_id(self) -> str:
        return self._ctx.tid

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        self._ctx.sid = self._rec["sid"]
        _tls.ctx = self._ctx
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        _tls.ctx = self._prev
        self._rec["dur_us"] = int((time.perf_counter() - self._t0) * 1e6)
        if exc is not None:
            self._rec.setdefault("attrs", {})["error"] = \
                f"{type(exc).__name__}: {exc}"
        self._ctx.sink.append(self._rec)
        trace_store().add(self._ctx.tid, self._rec["name"],
                          list(self._ctx.sink))
        return False


def start_trace(name: str, service: str = "standalone",
                **attrs) -> _TraceGuard:
    """Open a new root trace on this thread.  Nested start_trace calls
    (compound `a; b` statements) each get their own trace."""
    return _TraceGuard(name, service, attrs)


class _RemoteGuard:
    """Server-side adoption of an incoming wire context: spans produced
    while handling the RPC go to a FRESH sink that the dispatcher ships
    back in the reply — they are NOT stored locally (the coordinator
    owns the trace)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, tid: str, psid: str, service: str):
        self._ctx = _Ctx(tid, psid, [], service)

    @property
    def spans(self) -> List[dict]:
        return self._ctx.sink

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self._ctx
        return self

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


def adopt_remote(tid: str, psid: str, service: str) -> _RemoteGuard:
    return _RemoteGuard(tid, psid, service)


# -- the per-process store of finished traces -------------------------------


class TraceStore:
    """Bounded ring of recent traces, newest last."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._traces: Dict[str, dict] = {}   # insertion-ordered
        self._lock = threading.Lock()

    def add(self, tid: str, name: str, spans: List[dict]):
        root = next((s for s in spans if not s.get("psid")), None)
        entry = {"tid": tid, "name": name,
                 "t0": root["t0"] if root else time.time(),
                 "dur_us": root["dur_us"] if root else 0,
                 "spans": spans}
        with self._lock:
            self._traces[tid] = entry
            while len(self._traces) > self.capacity:
                self._traces.pop(next(iter(self._traces)))

    def get(self, tid: str) -> Optional[dict]:
        with self._lock:
            return self._traces.get(tid)

    def list(self, limit: int = 50) -> List[dict]:
        """Newest-first summaries (no span bodies)."""
        with self._lock:
            entries = list(self._traces.values())
        return [{"tid": e["tid"], "name": e["name"], "t0": e["t0"],
                 "dur_us": e["dur_us"], "spans": len(e["spans"])}
                for e in reversed(entries[-limit:])]

    def clear(self):
        with self._lock:
            self._traces.clear()


def render_tree(entry: dict) -> str:
    """Indented text rendering of one trace's span tree.  Orphan spans
    (parent not shipped — e.g. a remote subtree whose local anchor was
    dropped) attach under the root rather than vanishing."""
    spans = entry["spans"]
    by_id = {s["sid"]: s for s in spans}
    children: Dict[str, List[dict]] = {}
    root = None
    for s in spans:
        psid = s.get("psid") or ""
        if not psid:
            root = s
            continue
        children.setdefault(
            psid if psid in by_id else "__orphan__", []).append(s)
    lines: List[str] = []

    def visit(s: dict, depth: int):
        attrs = s.get("attrs") or {}
        extra = "".join(f" {k}={v}" for k, v in sorted(attrs.items()))
        svc = s.get("svc", "")
        rem = " [remote]" if s.get("remote") else ""
        lines.append("  " * depth
                     + f"{s['name']} ({svc}{rem}) {s['dur_us']}us{extra}")
        for c in sorted(children.get(s["sid"], []), key=lambda x: x["t0"]):
            visit(c, depth + 1)

    if root is not None:
        visit(root, 0)
    for s in sorted(children.get("__orphan__", []), key=lambda x: x["t0"]):
        visit(s, 1)
    return "\n".join(lines)


_store = TraceStore()


def trace_store() -> TraceStore:
    """The process-wide store (each daemon serves it at /traces)."""
    return _store
