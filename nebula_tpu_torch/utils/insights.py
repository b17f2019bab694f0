"""The port's copy of `nebula_tpu/utils/insights.py`, whole.

Workload insights plane: WHAT ran, aggregated over time.

Every observability layer so far answers "what is this one statement
doing" — tracing follows one statement's spans, the flight
recorder retains one statement's post-mortem, the live workload
plane shows one statement's in-flight progress.  Nothing
aggregates ACROSS statements, so "which query shapes dominate the
fleet", "did the optimizer's plan for this shape regress after a DDL
epoch bump" and "which partitions are hot" were unanswerable.  Three
pieces, pg_stat_statements-style:

  * **Statement fingerprints** — a literal-normalizing digest over the
    parsed AST: every `Literal` becomes `?`, homogeneous value lists
    collapse to `?*` (so ``FROM 1, 2, 3`` and ``FROM 5`` share a
    fingerprint), while structure, statement kind, identifiers, step
    counts and the session space are preserved.  Computed once per
    statement at plan-cache-key time and memoized by (text, space), so
    the steady-state cost is one bounded-LRU lookup.

  * **StatementRegistry** — a bounded per-graphd table keyed by
    fingerprint accumulating calls, error/kill/shed triage, latency +
    queue/device/host µs (latency into the shared fixed buckets so
    per-host tables merge exactly), rows, device dispatches, plan- and
    result-cache hits and multi-lane batching share.  Fed from the same
    completion hook the flight recorder uses: one locked dict update
    per statement.  Per-ENGINE (not process-wide) because a
    LocalCluster runs several graphds in one process and the cluster
    fan-out must not double count.

  * **Plan history + regression sentinel** — per fingerprint, per plan
    shape hash (the optimized plan's kind tree), its own latency
    buckets.  When the active plan flips (DDL epoch bump, optimizer
    toggle, device↔host fallback change) the pre/post stats sit side
    by side and `plan_regressed{fingerprint}` fires once the new
    plan's p50 degrades past `plan_regression_ratio`.

  * **PartHeatTable** — per-partition read/write QPS, rows, bytes and
    latency EWMAs maintained by storaged's `_read_part`/`rpc_write`
    hot paths (two unlocked counter bumps + one EWMA fold), ridden to
    metad on the existing heartbeat and ranked by `SHOW HOTSPOTS`.
    `heat_of()` is the documented read hook for the replica router and
    BALANCE: heat-driven placement reads it, never
    writes.

Everything is gated on `insights_enabled`: off reproduces pre-PR
behavior byte for byte (no fingerprinting, no registry writes).
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import fields, is_dataclass
from typing import Any, Dict, List, Optional, Tuple

from .config import define_flag, get_config
from .stats import LATENCY_BUCKETS_US

define_flag("insights_enabled", True,
            "maintain statement fingerprints + the per-graphd "
            "StatementRegistry behind SHOW STATEMENTS (off = no "
            "fingerprinting, no registry writes; the A/B lever for "
            "the bench overhead probe)")
define_flag("insights_max_fingerprints", 512,
            "distinct fingerprints retained per graphd registry; "
            "least-recently-seen shapes are evicted beyond this")
define_flag("plan_regression_ratio", 1.5,
            "regression sentinel: after a fingerprint's active plan "
            "changes, flag it regressed when the new plan's p50 "
            "exceeds the previous plan's p50 by this factor")
define_flag("plan_regression_min_calls", 8,
            "calls required on BOTH the old and the new plan before "
            "the regression sentinel compares their p50s")
define_flag("heat_ewma_alpha", 0.3,
            "EWMA smoothing factor for per-partition QPS/latency heat "
            "(folded at snapshot time, i.e. once per heartbeat)")


# -- statement fingerprints -------------------------------------------------


def _expr_slots(cls) -> Tuple[str, ...]:
    out: List[str] = []
    for c in reversed(cls.__mro__):
        s = c.__dict__.get("__slots__", ())
        if isinstance(s, str):
            s = (s,)
        out.extend(s)
    return tuple(out)


# per-kind slots to SKIP: pattern_pred carries its raw source text
# (which embeds literals) next to the parsed pattern — normalize the
# pattern, drop the text
_SKIP_SLOTS = {"pattern_pred": ("text",)}


def _norm(node: Any) -> str:
    """One node's literal-normalized canonical form (recursive)."""
    from ..core.expr import Expr, Literal, ListExpr, SetExpr

    if node is None:
        return "~"
    if isinstance(node, Literal):
        return "?"
    if isinstance(node, Expr):
        if isinstance(node, (ListExpr, SetExpr)) \
                and all(isinstance(i, Literal) for i in node.items):
            return "?*"
        skip = _SKIP_SLOTS.get(node.kind, ())
        inner = ",".join(_norm(getattr(node, s))
                         for s in _expr_slots(type(node)) if s not in skip)
        return f"{node.kind}({inner})"
    if is_dataclass(node):
        inner = ",".join(_norm(getattr(node, f.name))
                         for f in fields(node))
        return f"{type(node).__name__}({inner})"
    if isinstance(node, (list, tuple)):
        items = [_norm(x) for x in node]
        # homogeneous runs collapse: FROM 1,2,3 ≡ FROM 5, a 20-row
        # INSERT ≡ a 1-row INSERT of the same tag/prop shape
        out: List[str] = []
        for it in items:
            if out and out[-1] == f"{it}*":
                continue
            out.append(f"{it}*")
        return "[" + ",".join(out) + "]"
    if isinstance(node, dict):
        inner = ",".join(f"{k}:{_norm(v)}" for k, v in node.items())
        return "{" + inner + "}"
    if isinstance(node, bool) or isinstance(node, (int, float)):
        # bare numbers in dataclass fields are STRUCTURE (GO step
        # bounds, hop limits, LIMIT pushdown counts), not literals
        return repr(node)
    if isinstance(node, str):
        return node
    return f"<{type(node).__name__}>"


def normalize_statement(stmt: Any, space: str = "") -> str:
    """The fingerprint's preimage: statement kind + normalized shape +
    space.  Exposed for the golden tests."""
    return f"{space}|{_norm(stmt)}"


def fingerprint_of(stmt: Any, space: str = "") -> str:
    """12-hex-digit digest of the literal-normalized AST."""
    pre = normalize_statement(stmt, space)
    return hashlib.sha1(pre.encode("utf-8", "replace")).hexdigest()[:12]


def parse_error_fingerprint(text: str, space: str = "") -> str:
    """Unparseable text cannot be normalized — digest the raw text so
    repeated garbage still aggregates under one row."""
    pre = f"{space}|Parse({text})"
    return hashlib.sha1(pre.encode("utf-8", "replace")).hexdigest()[:12]


class _FingerprintCache:
    """Bounded (text, space) → fingerprint memo — the steady-state
    per-statement cost of the insights plane."""

    def __init__(self, capacity: int = 2048):
        self._cap = capacity
        self._map: "OrderedDict[Tuple[str, str], str]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, text: str, space: str) -> Optional[str]:
        key = (text, space)
        with self._lock:
            fp = self._map.get(key)
            if fp is not None:
                self._map.move_to_end(key)
            return fp

    def put(self, text: str, space: str, fp: str):
        with self._lock:
            self._map[(text, space)] = fp
            while len(self._map) > self._cap:
                self._map.popitem(last=False)

    def clear(self):
        with self._lock:
            self._map.clear()


# -- latency buckets (shared fixed boundaries → exact cross-host merge) -----


_NB = len(LATENCY_BUCKETS_US) + 1      # +1 overflow bucket


def _bucket_index(us: float) -> int:
    for i, b in enumerate(LATENCY_BUCKETS_US):
        if us <= b:
            return i
    return _NB - 1


def bucket_quantile(counts: List[int], q: float) -> int:
    """Quantile estimate from fixed-bucket counts: the upper boundary
    of the bucket where the cumulative count crosses q·total (overflow
    bucket reports the last finite boundary)."""
    total = sum(counts)
    if total <= 0:
        return 0
    target = q * total
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= target:
            return int(LATENCY_BUCKETS_US[min(i, _NB - 2)])
    return int(LATENCY_BUCKETS_US[-1])


# -- per-fingerprint accumulation ------------------------------------------


_SUM_FIELDS = ("calls", "errors", "kills", "sheds", "lat_sum_us",
               "queue_us", "device_us", "host_us", "rows", "dispatches",
               "plan_cache_hits", "result_cache_hits", "batched_calls",
               "lanes_sum", "plan_changed")


def _new_row(fp: str, text: str, kind: str, space: str) -> Dict[str, Any]:
    row: Dict[str, Any] = {
        "fingerprint": fp, "sample": text[:120], "kind": kind,
        "space": space, "lat_buckets": [0] * _NB,
        "plans": {},                      # plan_hash → {calls, buckets}
        "active_plan": "", "prev_plan": "", "regressed": False,
    }
    for f in _SUM_FIELDS:
        row[f] = 0
    return row


class StatementRegistry:
    """Bounded per-graphd fingerprint → aggregate table.  One locked
    dict update per completed statement; snapshots are mergeable
    across hosts because every histogram shares the fixed buckets."""

    def __init__(self):
        self._rows: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._lock = threading.Lock()
        self.fingerprints = _FingerprintCache()

    @staticmethod
    def enabled() -> bool:
        try:
            return bool(get_config().get("insights_enabled"))
        except Exception:  # noqa: BLE001 — config not initialized
            return True

    @staticmethod
    def _cap() -> int:
        try:
            return int(get_config().get("insights_max_fingerprints"))
        except Exception:  # noqa: BLE001
            return 512

    # -- the completion hook ---------------------------------------------

    def record(self, *, fp: str, text: str, kind: str, space: str,
               latency_us: int, error: Optional[str] = None,
               rows: int = 0, queue_us: int = 0, device_us: int = 0,
               dispatches: int = 0, plan_hash: Optional[str] = None,
               plan_cache_hit: bool = False,
               result_cache_hit: bool = False, lanes: int = 0):
        lat = int(latency_us)
        bi = _bucket_index(lat)
        host_us = max(lat - int(queue_us) - int(device_us), 0)
        with self._lock:
            row = self._rows.get(fp)
            if row is None:
                row = _new_row(fp, text, kind, space)
                self._rows[fp] = row
                while len(self._rows) > self._cap():
                    self._rows.popitem(last=False)
                    _stats().inc("insights_evictions")
                _stats().gauge("insights_fingerprints",
                               float(len(self._rows)))
            else:
                self._rows.move_to_end(fp)
            row["calls"] += 1
            row["lat_buckets"][bi] += 1
            row["lat_sum_us"] += lat
            row["queue_us"] += int(queue_us)
            row["device_us"] += int(device_us)
            row["host_us"] += host_us
            row["rows"] += int(rows)
            row["dispatches"] += int(dispatches)
            if error is not None:
                if error == "ExecutionError: query was killed":
                    row["kills"] += 1
                elif error.startswith("E_OVERLOAD"):
                    row["sheds"] += 1
                else:
                    row["errors"] += 1
            if plan_cache_hit:
                row["plan_cache_hits"] += 1
            if result_cache_hit:
                row["result_cache_hits"] += 1
            if lanes > 1:
                row["batched_calls"] += 1
                row["lanes_sum"] += int(lanes)
            if plan_hash:
                self._record_plan(row, plan_hash, lat, bi)

    def _record_plan(self, row: Dict[str, Any], plan_hash: str,
                     lat: int, bi: int):
        """Plan history + the regression sentinel (caller holds lock)."""
        plans = row["plans"]
        p = plans.get(plan_hash)
        if p is None:
            p = plans[plan_hash] = {"calls": 0, "lat_sum_us": 0,
                                    "buckets": [0] * _NB}
        p["calls"] += 1
        p["lat_sum_us"] += lat
        p["buckets"][bi] += 1
        if row["active_plan"] != plan_hash:
            if row["active_plan"]:
                row["prev_plan"] = row["active_plan"]
                row["plan_changed"] += 1
                row["regressed"] = False
            row["active_plan"] = plan_hash
        prev = plans.get(row["prev_plan"])
        if prev is None:
            return
        try:
            ratio = float(get_config().get("plan_regression_ratio"))
            min_calls = int(get_config().get("plan_regression_min_calls"))
        except Exception:  # noqa: BLE001
            ratio, min_calls = 1.5, 8
        if p["calls"] < min_calls or prev["calls"] < min_calls:
            return
        p50_new = bucket_quantile(p["buckets"], 0.5)
        p50_old = bucket_quantile(prev["buckets"], 0.5)
        regressed = p50_old > 0 and p50_new > ratio * p50_old
        if regressed and not row["regressed"]:
            _stats().inc_labeled("plan_regressed",
                                 {"fingerprint": row["fingerprint"]})
        row["regressed"] = regressed

    # -- reading ---------------------------------------------------------

    def snapshot(self) -> List[Dict[str, Any]]:
        """Mergeable per-fingerprint dicts, most-called first."""
        with self._lock:
            rows = [dict(r, lat_buckets=list(r["lat_buckets"]),
                         plans={h: dict(p, buckets=list(p["buckets"]))
                                for h, p in r["plans"].items()})
                    for r in self._rows.values()]
        rows.sort(key=lambda r: (-r["calls"], r["fingerprint"]))
        return rows

    def get(self, fp: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            r = self._rows.get(fp)
            return dict(r) if r is not None else None

    def clear(self):
        with self._lock:
            self._rows.clear()
        self.fingerprints.clear()

    def __len__(self):
        with self._lock:
            return len(self._rows)


def merge_statement_snapshots(
        snaps: List[List[Dict[str, Any]]]) -> List[Dict[str, Any]]:
    """Fold per-host registry snapshots into one cluster table: sum
    counters and bucket counts elementwise; the sample/kind and plan
    fields follow the host with the most calls for that fingerprint."""
    merged: Dict[str, Dict[str, Any]] = {}
    best_calls: Dict[str, int] = {}
    for snap in snaps:
        for r in snap or ():
            fp = r["fingerprint"]
            m = merged.get(fp)
            if m is None:
                m = merged[fp] = _new_row(fp, r.get("sample", ""),
                                          r.get("kind", ""),
                                          r.get("space", ""))
                best_calls[fp] = -1
            for f in _SUM_FIELDS:
                m[f] += int(r.get(f, 0))
            for i, c in enumerate(r.get("lat_buckets", ())[:_NB]):
                m["lat_buckets"][i] += int(c)
            for h, p in (r.get("plans") or {}).items():
                mp = m["plans"].get(h)
                if mp is None:
                    mp = m["plans"][h] = {"calls": 0, "lat_sum_us": 0,
                                          "buckets": [0] * _NB}
                mp["calls"] += int(p.get("calls", 0))
                mp["lat_sum_us"] += int(p.get("lat_sum_us", 0))
                for i, c in enumerate(p.get("buckets", ())[:_NB]):
                    mp["buckets"][i] += int(c)
            if int(r.get("calls", 0)) > best_calls[fp]:
                best_calls[fp] = int(r.get("calls", 0))
                m["sample"] = r.get("sample", m["sample"])
                m["kind"] = r.get("kind", m["kind"])
                m["space"] = r.get("space", m["space"])
                m["active_plan"] = r.get("active_plan", "")
                m["prev_plan"] = r.get("prev_plan", "")
            m["regressed"] = m["regressed"] or bool(r.get("regressed"))
    out = list(merged.values())
    out.sort(key=lambda r: (-r["calls"], r["fingerprint"]))
    return out


def statement_columns(rows: List[Dict[str, Any]]) -> List[List[Any]]:
    """The SHOW STATEMENTS column contract (docs/OBSERVABILITY.md §10):
    [Fingerprint, Sample, Calls, Errors, P50 Us, P95 Us, Rows,
     DeviceShare, PlanHash, PlanChanged, Regressed]."""
    out = []
    for r in rows:
        lat_sum = max(int(r.get("lat_sum_us", 0)), 1)
        share = round(int(r.get("device_us", 0)) / lat_sum, 3)
        out.append([
            r["fingerprint"], r.get("sample", ""), int(r.get("calls", 0)),
            int(r.get("errors", 0)) + int(r.get("kills", 0))
            + int(r.get("sheds", 0)),
            bucket_quantile(r.get("lat_buckets", []), 0.5),
            bucket_quantile(r.get("lat_buckets", []), 0.95),
            int(r.get("rows", 0)), share, r.get("active_plan", ""),
            int(r.get("plan_changed", 0)), bool(r.get("regressed"))])
    return out


def plan_shape_hash(plan) -> str:
    """12-hex-digit digest of the optimized plan's kind tree — flips
    when the optimizer changes the shape or a device operator falls
    back to its host twin (TpuTraverse ↔ ExpandAll)."""
    try:
        kinds = plan.root.kind_tree()
    except Exception:  # noqa: BLE001 — plan-less admin statements
        return ""
    return hashlib.sha1(
        ",".join(kinds).encode("utf-8", "replace")).hexdigest()[:12]


# -- per-partition heat maps ------------------------------------------------


class _Heat:
    __slots__ = ("reads", "writes", "read_rows", "write_rows",
                 "read_bytes", "write_bytes", "read_lat_us",
                 "write_lat_us", "read_qps", "write_qps",
                 "_last_reads", "_last_writes", "_last_ts")

    def __init__(self):
        self.reads = 0
        self.writes = 0
        self.read_rows = 0
        self.write_rows = 0
        self.read_bytes = 0
        self.write_bytes = 0
        self.read_lat_us = 0.0     # EWMA
        self.write_lat_us = 0.0    # EWMA
        self.read_qps = 0.0        # EWMA, folded at snapshot time
        self.write_qps = 0.0
        self._last_reads = 0
        self._last_writes = 0
        self._last_ts = time.monotonic()


class PartHeatTable:
    """Per-(space, part) load counters on one storaged.  The hot-path
    record calls are two integer bumps and one EWMA fold under a short
    lock; QPS EWMAs fold once per snapshot (i.e. per heartbeat), so
    idle parts decay toward zero without a background thread."""

    def __init__(self):
        self._parts: Dict[Tuple[str, int], _Heat] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _alpha() -> float:
        try:
            return float(get_config().get("heat_ewma_alpha"))
        except Exception:  # noqa: BLE001
            return 0.3

    def _get(self, space: str, pid: int) -> _Heat:
        key = (space, int(pid))
        h = self._parts.get(key)
        if h is None:
            h = self._parts.setdefault(key, _Heat())
        return h

    def record_read(self, space: str, pid: int, rows: int = 0,
                    latency_us: float = 0.0, nbytes: int = 0):
        a = self._alpha()
        with self._lock:
            h = self._get(space, pid)
            h.reads += 1
            h.read_rows += int(rows)
            h.read_bytes += int(nbytes)
            h.read_lat_us += a * (float(latency_us) - h.read_lat_us)

    def record_write(self, space: str, pid: int, rows: int = 0,
                     latency_us: float = 0.0, nbytes: int = 0):
        a = self._alpha()
        with self._lock:
            h = self._get(space, pid)
            h.writes += 1
            h.write_rows += int(rows)
            h.write_bytes += int(nbytes)
            h.write_lat_us += a * (float(latency_us) - h.write_lat_us)

    def heat_of(self, space: str, pid: int) -> float:
        """THE documented read hook for the replica router and BALANCE: one part's current load score — smoothed read+write
        QPS, writes double-weighted (they cost a quorum round).  Purely
        observational; callers must treat 0.0 (unknown part) as cold."""
        with self._lock:
            h = self._parts.get((space, int(pid)))
            if h is None:
                return 0.0
            return h.read_qps + 2.0 * h.write_qps

    def snapshot(self) -> List[Dict[str, Any]]:
        """Fold QPS EWMAs forward and emit per-part rows (the heartbeat
        payload).  Mergeable: counters sum, EWMAs max/avg at the
        consumer."""
        a = self._alpha()
        now = time.monotonic()
        out = []
        with self._lock:
            for (space, pid), h in self._parts.items():
                dt = max(now - h._last_ts, 1e-3)
                r_rate = (h.reads - h._last_reads) / dt
                w_rate = (h.writes - h._last_writes) / dt
                h.read_qps += a * (r_rate - h.read_qps)
                h.write_qps += a * (w_rate - h.write_qps)
                h._last_reads, h._last_writes = h.reads, h.writes
                h._last_ts = now
                out.append({
                    "space": space, "part": pid,
                    "reads": h.reads, "writes": h.writes,
                    "read_rows": h.read_rows, "write_rows": h.write_rows,
                    "read_bytes": h.read_bytes,
                    "write_bytes": h.write_bytes,
                    "read_lat_us": round(h.read_lat_us, 1),
                    "write_lat_us": round(h.write_lat_us, 1),
                    "read_qps": round(h.read_qps, 3),
                    "write_qps": round(h.write_qps, 3),
                    "score": round(h.read_qps + 2.0 * h.write_qps, 3)})
        out.sort(key=lambda r: -r["score"])
        return out

    def clear(self):
        with self._lock:
            self._parts.clear()


def merge_heat_snapshots(
        per_host: Dict[str, List[Dict[str, Any]]]) -> List[Dict[str, Any]]:
    """Fold per-host PartHeat rows into one cluster hotspot table:
    counters and QPS sum across a part's replicas (each replica serves
    its own traffic), latency EWMAs take the max replica, and the
    serving hosts are listed for placement context."""
    merged: Dict[Tuple[str, int], Dict[str, Any]] = {}
    for host, rows in per_host.items():
        for r in rows or ():
            key = (r["space"], int(r["part"]))
            m = merged.get(key)
            if m is None:
                m = merged[key] = {
                    "space": r["space"], "part": int(r["part"]),
                    "reads": 0, "writes": 0, "read_rows": 0,
                    "write_rows": 0, "read_bytes": 0, "write_bytes": 0,
                    "read_lat_us": 0.0, "write_lat_us": 0.0,
                    "read_qps": 0.0, "write_qps": 0.0, "score": 0.0,
                    "hosts": []}
            for f in ("reads", "writes", "read_rows", "write_rows",
                      "read_bytes", "write_bytes"):
                m[f] += int(r.get(f, 0))
            for f in ("read_qps", "write_qps", "score"):
                m[f] = round(m[f] + float(r.get(f, 0.0)), 3)
            for f in ("read_lat_us", "write_lat_us"):
                m[f] = round(max(m[f], float(r.get(f, 0.0))), 1)
            m["hosts"].append(host)
    out = list(merged.values())
    for m in out:
        m["hosts"] = sorted(m["hosts"])
    out.sort(key=lambda r: (-r["score"], r["space"], r["part"]))
    return out


def _stats():
    from .stats import stats
    return stats()
