"""The port's copy of `nebula_tpu/utils/slo.py`, whole.

SLO engine: multi-window burn rates from the live histograms.

Two objectives, computed from telemetry the engine already emits (no
new instrumentation on the hot path):

  * **availability** — fraction of statements that did not error
    (`num_queries` / `num_query_errors` counters); target
    `slo_availability_target` (default 99.9%).
  * **latency** — fraction of statements that finished within
    `slo_latency_target_ms` (from the `query_latency_us_hist`
    cumulative buckets — the threshold snaps to the nearest bucket
    upper bound ≤ target); target `slo_latency_target_pct`.

Burn rate is the standard SRE definition: (bad fraction over a window)
divided by the error budget (1 − target).  Burn 1.0 = consuming budget
exactly at the sustainable rate; 14.4 on the 1h window is the classic
page-now threshold for a 30d budget.  Windows are computed by diffing
periodic snapshots of the cumulative counters (`tick()` — called by the
webservice /slo endpoint, `SHOW SLO`, and the metad federation loop),
so the engine needs no per-request bookkeeping at all.

Surfaced as `slo_burn_*` gauges in /metrics (and therefore in metad's
/cluster_metrics), `GET /slo`, and `SHOW SLO`.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .config import define_flag, get_config

define_flag("slo_availability_target", 0.999,
            "availability objective: fraction of statements that must "
            "not error")
define_flag("slo_latency_target_ms", 1000.0,
            "latency objective threshold (per-statement wall time)")
define_flag("slo_latency_target_pct", 0.99,
            "latency objective: fraction of statements that must "
            "finish under slo_latency_target_ms")

# multi-window burn rates (name → seconds); the long window smooths
# noise, the short window catches a fresh incident fast
WINDOWS: Tuple[Tuple[str, float], ...] = (
    ("5m", 300.0), ("1h", 3600.0), ("6h", 21600.0))

# literal gauge names (one per objective × window) so the metric
# catalogue lint can see them in source — see docs/OBSERVABILITY.md
_BURN_GAUGES: Dict[Tuple[str, str], str] = {
    ("availability", "5m"): "slo_burn_availability_5m",
    ("availability", "1h"): "slo_burn_availability_1h",
    ("availability", "6h"): "slo_burn_availability_6h",
    ("latency", "5m"): "slo_burn_latency_5m",
    ("latency", "1h"): "slo_burn_latency_1h",
    ("latency", "6h"): "slo_burn_latency_6h",
}


class SloEngine:
    """Snapshot-diffing burn-rate calculator over the process stats."""

    def __init__(self):
        self._snaps: List[Tuple[float, Dict[str, float]]] = []
        self._lock = threading.Lock()

    # -- raw totals -------------------------------------------------------

    @staticmethod
    def _totals() -> Dict[str, float]:
        from .stats import stats
        sm = stats()
        with sm.lock:
            queries = float(sm.counters.get("num_queries", 0))
            errors = float(sm.counters.get("num_query_errors", 0))
        lat_total = lat_good = 0.0
        ht = sm.hist_totals("query_latency_us_hist")
        if ht is not None:
            buckets, row = ht
            target_us = float(
                get_config().get("slo_latency_target_ms")) * 1000.0
            cum = 0.0
            for ub, c in zip(buckets, row):
                cum += c
                if ub <= target_us:
                    lat_good = cum
            lat_total = row[-2]
        return {"queries": queries, "errors": errors,
                "lat_total": lat_total, "lat_good": lat_good}

    def tick(self):
        """Record one snapshot; trim history past the longest window."""
        now = time.monotonic()
        tot = self._totals()
        horizon = max(s for _, s in WINDOWS) * 1.2
        with self._lock:
            # collapse bursts: at most ~1 snapshot per second.  SKIP the
            # append (keeping the OLDER snapshot), never replace it — a
            # sub-second poller replacing the newest entry would pin the
            # whole history to "now" and collapse every window base to
            # the last poll interval
            if not self._snaps or now - self._snaps[-1][0] >= 1.0:
                self._snaps.append((now, tot))
            while self._snaps and now - self._snaps[0][0] > horizon:
                self._snaps.pop(0)
        return tot

    def _window_base(self, now: float, secs: float,
                     latest: Dict[str, float]) -> Dict[str, float]:
        """Newest snapshot at least `secs` old.  When history is
        shorter than the window, the base is ZEROS — i.e. the window
        covers the whole process lifetime.  (Diffing from a young
        snapshot instead would silently DROP the pre-snapshot traffic,
        reporting burn 0 over a window that did see errors.)"""
        with self._lock:
            base: Optional[Dict[str, float]] = None
            for ts, tot in self._snaps:
                if now - ts >= secs:
                    base = tot
                else:
                    break
        if base is None:
            base = {k: 0.0 for k in latest}
        return base

    # -- burn rates -------------------------------------------------------

    def burn_rates(self) -> List[Dict[str, Any]]:
        """One row per (objective, window):
        {objective, window, target, total, bad, bad_ratio, burn}.
        Also publishes the `slo_burn_*` gauges."""
        from .stats import stats
        now = time.monotonic()
        latest = self.tick()
        avail_target = float(get_config().get("slo_availability_target"))
        lat_pct = float(get_config().get("slo_latency_target_pct"))
        rows: List[Dict[str, Any]] = []
        for wname, secs in WINDOWS:
            base = self._window_base(now, secs, latest)
            dq = max(latest["queries"] - base.get("queries", 0.0), 0.0)
            de = max(latest["errors"] - base.get("errors", 0.0), 0.0)
            dlt = max(latest["lat_total"] - base.get("lat_total", 0.0), 0.0)
            dlg = max(latest["lat_good"] - base.get("lat_good", 0.0), 0.0)
            for obj, target, total, bad in (
                    ("availability", avail_target, dq, min(de, dq)),
                    ("latency", lat_pct, dlt, max(dlt - dlg, 0.0))):
                budget = 1.0 - target
                ratio = (bad / total) if total > 0 else 0.0
                burn = (ratio / budget) if budget > 0 else 0.0
                rows.append({"objective": obj, "window": wname,
                             "target": target, "total": int(total),
                             "bad": int(bad),
                             "bad_ratio": round(ratio, 6),
                             "burn": round(burn, 4)})
                stats().gauge(_BURN_GAUGES[(obj, wname)], round(burn, 4))
        return rows

    def reset(self):
        with self._lock:
            self._snaps.clear()


_engine = SloEngine()


def slo_engine() -> SloEngine:
    """The process-wide SLO engine (served at /slo and SHOW SLO)."""
    return _engine
