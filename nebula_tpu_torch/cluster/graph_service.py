"""The port's copy of `nebula_tpu/cluster/graph_service.py`, whole.

Graph service — the stateless query frontend (graphd).

Authenticate → session (registered in metad so any graphd can list/kill
it) → execute (the full parse→plan→optimize→schedule pipeline of
exec.engine over a DistributedStore) → wire-encoded ResultSet.  Analog
of the reference's GraphService/QueryInstance/GraphSessionManager
(reference: src/graph/service + src/graph/session).

With a `tpu_runtime` (the port's `gpu.GpuRuntime`) the engine fuses GO
and MATCH into the device nodes, and the runtime pins each space from
the storageds' `storage.export_part` fan-out
(`DistributedStore.build_csr_snapshot`); many handler threads share the
runtime through its dispatch gate and batch former.
"""
from __future__ import annotations

import re
import threading
import time
from typing import Any, Dict, Optional

from ..core.wire import to_wire
from ..exec.engine import QueryEngine, Session
from ..utils.admission import overload_error
from ..utils.config import get_config
from ..utils.stats import stats
from .dstore import DistributedStore
from .meta_client import MetaClient
from .rpc import RpcError, RpcServer
from .storage_service import _ReadBucket

#: statements that bypass the per-coordinator capacity bucket — the
#: diagnosis/repair lane (SHOW QUERIES, KILL, session plumbing) must
#: keep answering on the very coordinator whose overload is being
#: diagnosed (the admission controller's control-lane rule, applied
#: at the capacity gate too)
_CONTROL_LEAD = re.compile(r"[\s(]*(SHOW|KILL|DESC|DESCRIBE|USE)\b",
                           re.IGNORECASE)


class GraphService:
    def __init__(self, my_addr: str, meta: MetaClient, server: RpcServer,
                 tpu_runtime=None, users: Optional[Dict[str, str]] = None):
        self.my_addr = my_addr
        self.meta = meta
        self.store = DistributedStore(meta)
        self.engine = QueryEngine(self.store, tpu_runtime=tpu_runtime)
        # SHOW HOSTS / SHOW SESSIONS read live cluster state through meta
        self.engine.qctx.cluster = meta
        self.sessions: Dict[int, Session] = {}
        from ..utils.racecheck import make_lock
        self.lock = make_lock("graph_sessions")
        # fleet fault tolerance: peers' write epochs fold in
        # from two directions — every metad heartbeat reply (bounded
        # window) and this graphd's own storaged write acks (immediate)
        self.meta.on_epochs = self.engine.cluster_epochs.fold_table
        self.store.on_epoch_ack = self.engine.cluster_epochs.note_ack
        self.engine.epoch_sync = self._epoch_sync
        # graceful drain: once set, new statements are refused with a
        # structured E_SESSION_MOVED + sibling hint; in-flight ones
        # finish inside their deadline budget
        self._draining = False
        self._sibling_cache: tuple = (0.0, None)   # (monotonic ts, addr)
        self._server = server
        # per-COORDINATOR statement capacity (graph_statement_capacity_qps):
        # one bucket per GraphService instance — the unit that scales
        # when a deployment adds graphds (admission slots are process-
        # global and model the shared engine, not the coordinator)
        self._stmt_bucket = _ReadBucket()
        # password auth; default open root (the reference ships
        # enable_authorize=false with root/nebula)
        self.users = users if users is not None else {"root": "nebula"}
        self._users_explicit = users is not None
        server.service_role = "graphd"
        server.register_service(self, prefix="graph.")
        self._reaper = threading.Thread(target=self._reap_idle, daemon=True)
        self._reaper_stop = threading.Event()
        self._reaper.start()

    def start(self):
        self.meta.start_heartbeat()

    def stop(self):
        self._reaper_stop.set()
        self.meta.stop_heartbeat()

    # -- fleet fault tolerance ---------------------------------

    def _epoch_sync(self):
        """Strict check-at-admission: pull metad's merged epoch table
        and fold it, so a leader-consistency cached read observes every
        write acked anywhere in the fleet that reached metad."""
        self.engine.cluster_epochs.fold_table(self.meta.cluster_epochs())

    def _sibling_hint(self) -> Optional[str]:
        """Another ONLINE graphd to hand sessions to (1 s cached — the
        drain path must not hammer metad once per refused statement)."""
        ts, addr = self._sibling_cache
        now = time.monotonic()
        if now - ts < 1.0:
            return addr
        addr = None
        try:
            for h in self.meta.list_hosts():
                if h.get("role") == "graph" and h.get("addr") != self.my_addr \
                        and h.get("status") == "ONLINE":
                    addr = h["addr"]
                    break
        except Exception:  # noqa: BLE001 — metad down: no hint, client ranks
            addr = None
        self._sibling_cache = (now, addr)
        return addr

    def _session_moved(self) -> RpcError:
        sib = self._sibling_hint()
        return RpcError(f"E_SESSION_MOVED: graphd {self.my_addr} draining; "
                        f"sibling={sib or '-'}")

    def drain(self, timeout_s: Optional[float] = None) -> int:
        """Graceful drain: stop admitting, wait for in-flight statements
        to finish inside their deadline budget, leave the metad session
        rows for siblings to adopt.  Returns the number of sessions
        handed off.  A planned restart through here sheds ZERO acked
        statements — every refused statement gets a structured
        E_SESSION_MOVED (provably not executed → any-statement retry is
        safe), never a raw connection reset."""
        self._draining = True
        if timeout_s is None:
            try:
                timeout_s = max(float(get_config().get(
                    "query_timeout_secs")) or 30.0, 1.0)
            except Exception:  # noqa: BLE001
                timeout_s = 30.0
        deadline = time.monotonic() + timeout_s

        def busy() -> bool:
            # the engine registry alone is not enough: a statement that
            # arrived before _draining was set may still be in
            # parse/plan (not yet in s.queries) or writing its reply —
            # the server's dispatch inbox counts a request from receive
            # until its reply frame is WRITTEN, so inbox==0 means every
            # admitted statement's outcome reached the wire.  (drain()
            # is an in-process call — launcher/ops — so it never holds
            # an inbox slot itself.)
            if getattr(self._server, "_inbox", 0) > 0:
                return True
            with self.lock:
                return any(s.queries for s in self.sessions.values())

        settled = 0
        while time.monotonic() < deadline:
            if not busy():
                # require two consecutive idle observations a beat
                # apart: a statement between socket receive and inbox
                # admission is invisible for a few instructions
                settled += 1
                if settled >= 2:
                    break
            else:
                settled = 0
            time.sleep(0.02)
        with self.lock:
            n = len(self.sessions)
        stats().inc("graphd_drains")
        return n

    def rpc_adopt_session(self, p):
        """Re-home a session on THIS graphd after its owner died or
        drained.  The session row is metad-replicated, so identity
        (user, space) survives the owner; credentials are re-checked —
        a sid alone must never be enough to steal a session.  $var
        state was owner-local and is gone (documented in ROBUSTNESS
        §10); space is restored from the replicated row."""
        if self._draining:
            raise self._session_moved()
        sid = p["session_id"]
        user = p.get("user", "root")
        if self.auth_required and not self._check_password(
                user, p.get("password", "")):
            raise RpcError("Bad username/password")
        row = None
        try:
            for s in self.meta.list_sessions():
                if s["sid"] == sid:
                    row = s
                    break
        except Exception as ex:  # noqa: BLE001
            raise RpcError(f"metad unavailable: {ex}") from None
        if row is None:
            raise RpcError(f"E_SESSION_UNKNOWN: session {sid} not in "
                           "metad table (expired or killed)")
        if row.get("user") != user:
            raise RpcError("session user mismatch")
        with self.lock:
            sess = self.sessions.get(sid)
            if sess is None:
                sess = Session(user)
                sess.id = sid
                sess.space = row.get("space") or None
                self.sessions[sid] = sess
                self.engine.sessions[sid] = sess
        try:
            self.meta.update_session(sid, graphd=self.my_addr)
        except Exception:  # noqa: BLE001 — row update is advisory
            pass
        self._note_sessions()
        stats().inc("session_moves")
        return {"session_id": sid, "space": sess.space}

    def rpc_tenant_snapshot(self, p):
        """This graphd's per-tenant admission view (SHOW TENANTS fans
        out over every graph host and merges)."""
        from ..utils.admission import admission
        return admission().tenant_snapshot()

    def _reap_idle(self):
        from ..utils.config import get_config
        while not self._reaper_stop.wait(5.0):
            now = time.time()
            idle_s = float(get_config().get("session_idle_timeout_secs"))
            with self.lock:
                dead = [sid for sid, s in self.sessions.items()
                        if now - s.last_used > idle_s]
            for sid in dead:
                self._drop_session(sid)

    def _drop_session(self, sid: int):
        with self.lock:
            self.sessions.pop(sid, None)
        self.engine.sessions.pop(sid, None)
        self._note_sessions()
        try:
            self.meta.remove_session(sid)
        except Exception:  # noqa: BLE001 — metad may be down; reap anyway
            pass

    def _note_sessions(self):
        """Refresh the per-coordinator session gauge (`graph_sessions`)
        — the fleet view's per-host load signal (metrics_dump --fleet)."""
        with self.lock:
            n = len(self.sessions)
        stats().gauge("graph_sessions", float(n))

    # -- RPC --------------------------------------------------------------

    def _check_password(self, user: str, pwd: str) -> bool:
        """An EXPLICITLY injected users map (constructor arg, the test
        harness / static-config path) wins for the accounts it names —
        the catalog always contains a default root, which must not
        override an operator-configured root password.  Every other
        account is checked against the meta-replicated user catalog
        (CREATE USER / ALTER USER), with NO static fallback — a rotated
        password's predecessor stays dead."""
        if self._users_explicit and user in self.users:
            return self.users[user] == pwd
        from ..graphstore.schema import SchemaError
        try:
            udesc = self.store.catalog.get_user(user)
        except (SchemaError, KeyError):
            udesc = None
        except Exception:  # noqa: BLE001 — meta unreachable: fail closed
            return False
        if udesc is not None:
            return udesc.check_password(pwd)
        return self.users.get(user) == pwd

    @property
    def auth_required(self) -> bool:
        # live: UPDATE CONFIGS enable_authorize must take effect on a
        # running graphd, not only after restart
        from ..utils.config import get_config
        return self._users_explicit or bool(
            get_config().get("enable_authorize"))

    def rpc_authenticate(self, p):
        if self._draining:
            raise self._session_moved()
        user = p.get("user", "root")
        pwd = p.get("password", "")
        if self.auth_required and not self._check_password(user, pwd):
            raise RpcError("Bad username/password")
        sid = self.meta.create_session(user, self.my_addr)
        sess = Session(user)
        sess.id = sid
        with self.lock:
            self.sessions[sid] = sess
        # the engine's registry serves SHOW QUERIES / KILL QUERY — a
        # cluster session must be visible there too (same object, metad
        # session id)
        self.engine.sessions[sid] = sess
        self._note_sessions()
        return {"session_id": sid}

    def rpc_signout(self, p):
        self._drop_session(p["session_id"])
        return True

    def rpc_execute(self, p):
        if self._draining:
            # refused BEFORE execution: the client may retry ANY
            # statement (including writes) on the sibling — nothing ran
            raise self._session_moved()
        cap = float(get_config().get("graph_statement_capacity_qps") or 0)
        if cap > 0 and not _CONTROL_LEAD.match(p.get("stmt", "")):
            retry = self._stmt_bucket.take(cap)
            if retry is not None:
                # shed BEFORE execution: same structured contract as a
                # storaged read-capacity shed — a fleet client walks to
                # a sibling coordinator with spare tokens
                stats().inc_labeled(
                    "overload_server_rejections",
                    {"op": "graph.statement_capacity", "role": "graphd"})
                raise RpcError(overload_error(
                    retry, "graphd:statement_capacity",
                    f"statement capacity {cap:g}/s exhausted"))
        with self.lock:
            sess = self.sessions.get(p["session_id"])
        if sess is None:
            raise RpcError("Session invalid or expired")
        rs = self.engine.execute(sess, p["stmt"])
        if sess.space:
            try:
                self.meta.update_session(sess.id, space=sess.space)
            except Exception:  # noqa: BLE001
                pass
        return {
            "error": rs.error,
            "space": rs.space,
            "latency_us": rs.latency_us,
            # bulk numeric results leave here as typed column blobs
            # (core/wire.py columnar fast path) — the RPC layer ships
            # them out-of-band of the JSON, zero-copy
            "data": to_wire(rs.data) if rs.data is not None else None,
            "plan_desc": rs.plan_desc,
        }

    def rpc_list_sessions(self, p):
        return self.meta.list_sessions()

    def rpc_kill_session(self, p):
        self._drop_session(p["session_id"])
        return True

    def rpc_list_queries(self, p):
        """This graphd's RUNNING queries with live per-operator
        progress (SHOW [ALL] QUERIES fans out over every graphd named
        in metad's session table) — row shape documented at
        QueryEngine.list_running_queries."""
        return self.engine.list_running_queries()

    def rpc_list_statements(self, p):
        """This graphd's insights registry snapshot: per-
        fingerprint mergeable aggregate dicts — SHOW STATEMENTS fans
        out over every registered graph host and sums them exactly
        (shared fixed latency buckets)."""
        return self.engine.insights.snapshot()

    def rpc_session_live(self, p):
        """The live half of SHOW SESSIONS: metad's replicated
        table knows user/space/created, but last-used time and the
        in-flight statement count only exist on the owning graphd."""
        with self.lock:
            items = list(self.sessions.items())
        return {sid: [s.last_used, len(s.queries)] for sid, s in items}

    def rpc_stop_job(self, p):
        """STOP JOB routed from another graphd: this one is the
        executor named in metad's job table — stop it in the LOCAL
        worker pool and report the resulting status."""
        from ..exec.jobs import job_manager
        mgr = job_manager(self.engine.qctx.store)
        job = mgr.jobs.get(p["job_id"])
        if job is None:
            return None
        if job.status != "FINISHED":
            mgr.stop(job)
        return job.status

    def rpc_kill_query(self, p):
        """Set the kill event of a RUNNING query on THIS graphd; returns
        whether anything matched (the issuing graphd raises if no owner
        matched anywhere)."""
        return self.engine.kill_running(p.get("session_id"),
                                        p.get("plan_id"))
