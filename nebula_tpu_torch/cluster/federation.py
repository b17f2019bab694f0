"""The port's copy of `nebula_tpu/cluster/federation.py`, whole.

Metric federation — metad scrapes the cluster into one view.

One cluster, one metric surface: each daemon already serves its own
Prometheus `/metrics`, but operating a 3-replica × N-graphd cluster
means N+M+K scrape targets and no single place to ask "what is the
cluster doing".  The `MetricFederator` runs on metad (the one daemon
that already knows every host — heartbeats carry each daemon's
webservice address), periodically scrapes every alive graphd/storaged
`/metrics`, injects `instance`/`role` labels into every sample, and
serves the merged text at `GET /cluster_metrics` — point ONE Prometheus
scrape (or a human) at metad and see the whole cluster.

Scrape failures are non-fatal: a dead host's samples age out of the
merged view and `federation_scrape_errors` counts the misses.  Every
daemon refreshes its OWN `slo_burn_*` gauges inside its /metrics
handler (webservice.py), so each federation round pulls burn rates
computed from that daemon's real traffic — no per-process poller
needed.
"""
from __future__ import annotations

import threading
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

from ..utils.config import define_flag, get_config
from ..utils.slo import slo_engine
from ..utils.stats import stats

define_flag("metric_federation_interval_secs", 5.0,
            "how often metad re-scrapes every daemon's /metrics into "
            "/cluster_metrics (0 disables the background loop; the "
            "endpoint then scrapes on demand)")
define_flag("metric_federation_timeout_secs", 3.0,
            "per-target HTTP timeout for federation scrapes")


def _inject_labels(text: str, instance: str, role: str) -> List[str]:
    """Rewrite one exposition payload: every sample line gains
    instance/role labels; TYPE comments pass through for dedup by the
    merger."""
    extra = (f'instance="{instance}",role="{role}"')
    out: List[str] = []
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            out.append(ln)
            continue
        # sample grammar: name[{labels}] value [timestamp]
        brace = ln.find("{")
        space = ln.find(" ")
        if brace != -1 and (space == -1 or brace < space):
            close = ln.rfind("}")
            if close == -1:
                continue                   # malformed: drop the line
            body = ln[brace + 1:close]
            sep = "," if body else ""
            out.append(ln[:brace + 1] + body + sep + extra + ln[close:])
        elif space != -1:
            out.append(ln[:space] + "{" + extra + "}" + ln[space:])
    return out


class MetricFederator:
    """Scrape-and-merge loop over the meta service's active hosts."""

    def __init__(self, meta_service, self_ws: str = ""):
        self.meta = meta_service
        # metad's own webservice (scraped too, so its raft/meta metrics
        # land in the same view); empty = skip self
        self.self_ws = self_ws
        self._lock = threading.Lock()
        self._merged = ""
        self._last_scrape = 0.0
        self._status: Dict[str, Dict] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- targets ----------------------------------------------------------

    def targets(self) -> List[Tuple[str, str, str]]:
        """[(instance addr, role, ws addr)] for every alive daemon that
        reported a webservice address, plus metad itself."""
        out: List[Tuple[str, str, str]] = []
        if self.self_ws:
            out.append((self.meta.my_addr, "metad", self.self_ws))
        now = time.monotonic()
        from .meta_service import _hb_expire_s
        exp = _hb_expire_s()
        # .copy() is atomic under the GIL; iterating the live dict
        # would race a first-heartbeat insert from an RPC thread
        # ("dictionary changed size during iteration") exactly when
        # membership changes — the moment the federated view matters
        for addr, h in sorted(self.meta.active_hosts.copy().items()):
            ws = h.get("ws")
            if not ws or now - h["last_hb"] >= exp:
                continue
            role = {"graph": "graphd", "storage": "storaged"}.get(
                h["role"], h["role"])
            out.append((addr, role, ws))
        return out

    # -- scraping ---------------------------------------------------------

    def _fetch(self, ws: str, path: str = "/metrics") -> str:
        try:
            timeout = float(get_config().get(
                "metric_federation_timeout_secs"))
        except Exception:  # noqa: BLE001
            timeout = 3.0
        with urllib.request.urlopen(f"http://{ws}{path}",
                                    timeout=timeout) as r:
            return r.read().decode()

    def _fan_out(self, path: str):
        """Concurrently fetch `path` from every alive target — the ONE
        fan-out used by both /cluster_metrics and /cluster_queries, so
        timeout/error handling cannot diverge between them.  Targets
        are fetched concurrently: a rolling restart can leave several
        heartbeat-alive-but-unreachable daemons, and a serial walk
        would stack their timeouts into a tens-of-seconds round
        exactly when the cluster view matters most.  Returns
        [(target, body-or-OSError, seconds)]."""
        from concurrent.futures import ThreadPoolExecutor
        targets = self.targets()

        def fetch_one(tgt):
            t0 = time.monotonic()
            try:
                return tgt, self._fetch(tgt[2], path), \
                    time.monotonic() - t0
            except OSError as ex:
                return tgt, ex, time.monotonic() - t0

        if not targets:
            return []
        with ThreadPoolExecutor(max_workers=min(len(targets), 8),
                                thread_name_prefix="fed-scrape") as pool:
            return list(pool.map(fetch_one, targets))

    def scrape_once(self) -> str:
        """One full scrape round → the merged labeled exposition text.
        (metad's own SLO gauges refresh via its /metrics handler like
        every daemon's — see webservice.py.)"""
        slo_engine().burn_rates()
        lines: List[str] = []
        seen_types: set = set()
        status: Dict[str, Dict] = {}
        for (addr, role, ws), text, dt in self._fan_out("/metrics"):
            if isinstance(text, OSError):
                stats().inc("federation_scrape_errors")
                status[addr] = {"role": role, "ws": ws, "ok": False,
                                "error": str(text)}
                continue
            n = 0
            for ln in _inject_labels(text, addr, role):
                if ln.startswith("# TYPE"):
                    if ln in seen_types:
                        continue
                    seen_types.add(ln)
                elif ln and not ln.startswith("#"):
                    n += 1
                lines.append(ln)
            status[addr] = {"role": role, "ws": ws, "ok": True,
                            "samples": n,
                            "scrape_s": round(dt, 4)}
        stats().inc("federation_scrapes")
        stats().gauge("federation_targets", float(len(status)))
        merged = "\n".join(lines) + ("\n" if lines else "")
        with self._lock:
            self._merged = merged
            self._status = status
            self._last_scrape = time.monotonic()
        return merged

    def cluster_queries(self) -> Dict[str, Dict]:
        """Live workload federation: fan /queries out over
        every alive daemon and return the per-instance in-flight
        statements + dispatch tables, instance/role attached — served
        at metad's GET /cluster_queries.  Always scraped on demand
        (live state is worthless stale), through the same fan-out as
        /cluster_metrics."""
        import json as _json
        out: Dict[str, Dict] = {}
        for (addr, role, ws), body, _dt in self._fan_out("/queries"):
            if not isinstance(body, OSError):
                try:
                    out[addr] = {"role": role, "ok": True,
                                 **_json.loads(body)}
                    continue
                except ValueError as ex:
                    body = ex
            stats().inc("federation_scrape_errors")
            out[addr] = {"role": role, "ok": False, "error": str(body)}
        return out

    def cluster_statements(self) -> Dict:
        """Workload insights federation: fan /statements out
        over every alive graphd and return both the per-instance
        fingerprint tables and ONE exactly-merged view (the fixed
        shared latency buckets make the cross-host histogram sum
        lossless) — served at metad's GET /cluster_statements."""
        import json as _json

        from ..utils.insights import merge_statement_snapshots
        hosts: Dict[str, Dict] = {}
        snaps = []
        for (addr, role, ws), body, _dt in self._fan_out("/statements"):
            if role != "graphd":
                continue
            if not isinstance(body, OSError):
                try:
                    rows = _json.loads(body)
                    hosts[addr] = {"ok": True, "statements": rows}
                    snaps.append(rows)
                    continue
                except ValueError as ex:
                    body = ex
            stats().inc("federation_scrape_errors")
            hosts[addr] = {"ok": False, "error": str(body)}
        return {"hosts": hosts,
                "merged": merge_statement_snapshots(snaps)}

    def render(self) -> str:
        """The merged view, re-scraped on demand when stale (covers the
        interval=0 / no-background-loop configuration)."""
        try:
            interval = float(get_config().get(
                "metric_federation_interval_secs"))
        except Exception:  # noqa: BLE001
            interval = 5.0
        with self._lock:
            fresh = (time.monotonic() - self._last_scrape) < \
                max(interval, 1.0) and self._merged
            if fresh:
                return self._merged
        return self.scrape_once()

    def scrape_status(self) -> Dict[str, Dict]:
        with self._lock:
            return {a: dict(s) for a, s in self._status.items()}

    # -- lifecycle --------------------------------------------------------

    def start(self):
        try:
            interval = float(get_config().get(
                "metric_federation_interval_secs"))
        except Exception:  # noqa: BLE001
            interval = 5.0
        if interval <= 0:
            return                         # on-demand only
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.scrape_once()
                except Exception:  # noqa: BLE001 — keep the loop alive
                    pass
        self._thread = threading.Thread(
            target=loop, daemon=True, name="metric-federation")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
