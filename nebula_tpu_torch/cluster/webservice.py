"""The port's copy of `nebula_tpu/cluster/webservice.py`, whole.

HTTP admin endpoints — the proxygen webservice analog.

Every daemon exposes (reference: src/webservice):

    GET /status          liveness + role + git-describe-ish version
    GET /stats           metrics text (`?format=json` for JSON)
    GET /metrics         Prometheus text exposition format
    GET /traces          recent trace summaries (`?id=<tid>` for one
                         trace's spans; add `&format=text` for the
                         indented tree rendering)
    GET /flight          flight-recorder summaries (`?id=<n>` for one
                         entry's full per-operator breakdown)
    GET /queries         live workload plane: in-flight
                         statements with per-operator progress, plus
                         the device dispatch table (queued/running)
    GET /admission       overload plane: admission slots,
                         queue depth by session, watermark memory,
                         observed drain rate
    GET /tenants         tenant QoS plane: per-tenant DWRR
                         weight / running / queued / admitted share
    GET /stalls          stall-watchdog captures (`?id=<n>` for one
                         capture's full thread stacks / dispatch table
                         / kernel-ledger tail)
    GET /kernels         device kernel ledger: recent dispatches with
                         shape bucket / compile-vs-cache / µs / HBM
    GET /slo             multi-window SLO burn rates (availability +
                         latency objectives)
    GET /flags           all flag values (`?format=json`)
    PUT /flags           body `name=value` (or JSON object) — live update

Role-specific endpoints (metad's `/cluster_metrics` federation view)
are mounted through the `providers` dict: path → fn(query_dict) →
(status, body, content_type).

Plus device-plane extras under /stats: device gauges (HBM bytes pinned,
last hop stats) fed through the same StatsManager.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qsl, urlparse

from ..utils.config import ConfigError, get_config
from ..utils.flight import flight_recorder, kernel_ledger
from ..utils.slo import slo_engine
from ..utils.stats import stats
from ..utils.trace import render_tree, trace_store

# provider signature: fn(query: dict) -> (http status, body, ctype)
Provider = Callable[[dict], Tuple[int, str, str]]


def _int_q(q: dict, key: str, default: int) -> int:
    try:
        return int(q.get(key, default))
    except (TypeError, ValueError):
        return default


class WebService:
    def __init__(self, role: str = "unknown", host: str = "127.0.0.1",
                 port: int = 0,
                 providers: Optional[Dict[str, Provider]] = None):
        self.role = role
        self.providers: Dict[str, Provider] = dict(providers or {})
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # noqa: A003 — quiet
                pass

            def _send(self, code: int, body: str,
                      ctype: str = "text/plain"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                u = urlparse(self.path)
                q = dict(parse_qsl(u.query))
                as_json = q.get("format") == "json"
                if u.path == "/status":
                    self._send(200, json.dumps(
                        {"status": "running", "role": outer.role}),
                        "application/json")
                elif u.path == "/stats":
                    if as_json:
                        self._send(200,
                                   json.dumps(stats().snapshot(),
                                              default=str),
                                   "application/json")
                    else:
                        self._send(200, stats().to_text())
                elif u.path == "/metrics":
                    # refresh this process's slo_burn_* gauges on every
                    # scrape: the objectives measure THIS daemon's
                    # statement traffic, and without this a federated
                    # view would carry stale/absent burn rates for the
                    # graphds — the processes whose burn matters
                    try:
                        slo_engine().burn_rates()
                    except Exception:  # noqa: BLE001 — gauges best-effort
                        pass
                    self._send(200, stats().to_prometheus(),
                               "text/plain; version=0.0.4; "
                               "charset=utf-8")
                elif u.path == "/traces":
                    tid = q.get("id")
                    if tid:
                        entry = trace_store().get(tid)
                        if entry is None:
                            self._send(404, f"no trace `{tid}'")
                        elif q.get("format") == "text":
                            self._send(200, render_tree(entry))
                        else:
                            self._send(200, json.dumps(entry,
                                                       default=str),
                                       "application/json")
                    else:
                        self._send(200,
                                   json.dumps(trace_store().list(),
                                              default=str),
                                   "application/json")
                elif u.path == "/flight":
                    # flight recorder: the per-operator
                    # breakdown of sampled/slow/failed statements,
                    # retrievable after the fact
                    fid = q.get("id")
                    if fid:
                        try:
                            entry = flight_recorder().get(int(fid))
                        except ValueError:
                            entry = None
                        if entry is None:
                            self._send(404, f"no flight entry `{fid}'")
                        else:
                            self._send(200, json.dumps(entry,
                                                       default=str),
                                       "application/json")
                    else:
                        limit = _int_q(q, "limit", 50)
                        self._send(200,
                                   json.dumps(
                                       flight_recorder().list(limit),
                                       default=str),
                                   "application/json")
                elif u.path == "/queries":
                    # live workload plane: what is running
                    # RIGHT NOW on this daemon, with per-operator
                    # progress and the device dispatch queue
                    from ..utils.workload import (dispatch_table,
                                                  live_registry)
                    self._send(200, json.dumps(
                        {"queries": live_registry().snapshot(),
                         "dispatches": dispatch_table().snapshot()},
                        default=str), "application/json")
                elif u.path == "/admission":
                    # overload plane: slots, queue depth,
                    # per-session backlog, watermark memory, drain rate
                    from ..utils.admission import admission
                    self._send(200, json.dumps(admission().snapshot(),
                                               default=str),
                               "application/json")
                elif u.path == "/tenants":
                    # tenant QoS plane: per-tenant DWRR
                    # weight / running / queued / admitted share on
                    # THIS coordinator (SHOW TENANTS merges the fleet)
                    from ..utils.admission import admission
                    self._send(200,
                               json.dumps(admission().tenant_snapshot(),
                                          default=str),
                               "application/json")
                elif u.path == "/stalls":
                    from ..utils.workload import stall_watchdog
                    sid = q.get("id")
                    if sid:
                        try:
                            entry = stall_watchdog().get(int(sid))
                        except ValueError:
                            entry = None
                        if entry is None:
                            self._send(404, f"no stall entry `{sid}'")
                        else:
                            self._send(200, json.dumps(entry,
                                                       default=str),
                                       "application/json")
                    else:
                        limit = _int_q(q, "limit", 20)
                        self._send(200,
                                   json.dumps(
                                       stall_watchdog().list(limit),
                                       default=str),
                                   "application/json")
                elif u.path == "/kernels":
                    limit = _int_q(q, "limit", 100)
                    self._send(200,
                               json.dumps(kernel_ledger().list(limit),
                                          default=str),
                               "application/json")
                elif u.path == "/slo":
                    self._send(200,
                               json.dumps(slo_engine().burn_rates(),
                                          default=str),
                               "application/json")
                elif u.path == "/flags":
                    vals = get_config().all_values()
                    if as_json:
                        self._send(200, json.dumps(vals, default=str),
                                   "application/json")
                    else:
                        self._send(200, "\n".join(
                            f"{k}={vals[k]}" for k in sorted(vals)))
                elif u.path in outer.providers:
                    try:
                        code, body, ctype = outer.providers[u.path](q)
                    except Exception as ex:  # noqa: BLE001 — 500, not death
                        code, body, ctype = 500, str(ex), "text/plain"
                    self._send(code, body, ctype)
                else:
                    self._send(404, "not found")

            def do_PUT(self):  # noqa: N802
                u = urlparse(self.path)
                if u.path != "/flags":
                    self._send(404, "not found")
                    return
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n).decode()
                try:
                    if body.lstrip().startswith("{"):
                        updates = json.loads(body)
                    else:
                        updates = dict(
                            ln.split("=", 1) for ln in body.splitlines()
                            if ln.strip())
                    # validate ALL keys before applying ANY — a 400 must
                    # mean nothing changed (the atomic multi-key path)
                    get_config().set_dynamic_many(
                        {k.strip(): v for k, v in updates.items()})
                    self._send(200, "ok")
                except (ConfigError, ValueError) as ex:
                    self._send(400, str(ex))

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name=f"web-{self.port}")
        self._thread.start()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
