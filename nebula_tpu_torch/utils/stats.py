"""StatsManager — counters, gauges, rolling series and histograms.

The port's copy of nebula_tpu/utils/stats.py, without the Prometheus
text export (nothing in the port serves it): the process-wide registry
`stats()`, the deterministic per-statement `WorkCounters` with
`use_work` / `current_work`, and the per-plan-node `CostRecorder` with
`use_cost` / `current_cost`.  The device runtime charges a statement's
dispatches, traversed edges and per-hop frontier sizes to the
thread's WorkCounters — a batched statement gets its own lane's counts,
equal to its solo run's.
"""
from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# fixed latency buckets in MICROSECONDS (histograms carry their own
# bucket tuple, so other units just pass buckets= explicitly)
LATENCY_BUCKETS_US: Tuple[float, ...] = (
    100.0, 500.0, 1_000.0, 5_000.0, 10_000.0, 50_000.0, 100_000.0,
    500_000.0, 1_000_000.0, 5_000_000.0, 10_000_000.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, Any]]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Series:
    """A value series over a sliding window of seconds."""

    __slots__ = ("window_s", "points", "total_sum", "total_count", "lock")

    def __init__(self, window_s: float = 600.0):
        self.window_s = window_s
        self.points: List[Tuple[float, float]] = []   # (ts, value)
        self.total_sum = 0.0
        self.total_count = 0
        self.lock = threading.Lock()

    def add(self, v: float):
        now = time.monotonic()
        with self.lock:
            self.points.append((now, v))
            self.total_sum += v
            self.total_count += 1
            self._gc(now)

    def _gc(self, now: float):
        cutoff = now - self.window_s
        i = bisect.bisect_left(self.points, (cutoff, float("-inf")))
        if i > 0:
            del self.points[:i]

    def snapshot(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self.lock:
            self._gc(now)
            vals = sorted(v for _, v in self.points)
            n = len(vals)
            out = {
                "sum": self.total_sum,
                "count": self.total_count,
                "rate": n / self.window_s,
            }
            if n:
                out["avg"] = sum(vals) / n
                for q in (50, 95, 99):
                    out[f"p{q}"] = vals[min(n - 1, int(n * q / 100))]
            return out


class _Histogram:
    """Fixed-bucket cumulative histogram, one count row per label set.

    Buckets are upper bounds; rendering emits CUMULATIVE counts plus the
    implicit +Inf bucket, so monotonicity holds by construction."""

    __slots__ = ("buckets", "per_label", "lock")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = tuple(sorted(buckets))
        # label key → [bucket counts..., count, sum]
        self.per_label: Dict[_LabelKey, List[float]] = {}
        self.lock = threading.Lock()

    def observe(self, value: float, key: _LabelKey):
        i = bisect.bisect_left(self.buckets, value)
        with self.lock:
            row = self.per_label.get(key)
            if row is None:
                row = self.per_label[key] = \
                    [0] * len(self.buckets) + [0, 0.0]
            if i < len(self.buckets):
                row[i] += 1
            row[-2] += 1
            row[-1] += value


class StatsManager:
    def __init__(self):
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self.series: Dict[str, _Series] = {}
        self.labeled: Dict[str, Dict[_LabelKey, float]] = {}
        self.labeled_gauges: Dict[str, Dict[_LabelKey, float]] = {}
        self.histograms: Dict[str, _Histogram] = {}
        self.lock = threading.Lock()

    def inc(self, name: str, delta: int = 1):
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def inc_labeled(self, name: str, labels: Dict[str, Any],
                    delta: float = 1):
        key = _label_key(labels)
        with self.lock:
            series = self.labeled.setdefault(name, {})
            series[key] = series.get(key, 0) + delta

    def gauge(self, name: str, value: float):
        with self.lock:
            self.gauges[name] = value

    def gauge_labeled(self, name: str, labels: Dict[str, Any],
                      value: float):
        """SET a per-label-set gauge (last write wins — unlike
        inc_labeled's accumulate): the per-shard HBM ledger
        (`tpu_shard_hbm_bytes{shard}`) re-states each shard's residency
        at every pin/unpin instead of summing deltas."""
        key = _label_key(labels)
        with self.lock:
            series = self.labeled_gauges.setdefault(name, {})
            series[key] = value

    def add_value(self, name: str, value: float):
        s = self.series.get(name)
        if s is None:
            with self.lock:
                s = self.series.setdefault(name, _Series())
        s.add(value)

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, Any]] = None,
                buckets: Tuple[float, ...] = LATENCY_BUCKETS_US):
        """Record into a fixed-bucket histogram (created on first use;
        the first caller's buckets win — fixed by design so dashboards
        can diff rounds)."""
        h = self.histograms.get(name)
        if h is None:
            with self.lock:
                h = self.histograms.setdefault(name, _Histogram(buckets))
        h.observe(value, _label_key(labels))

    def snapshot(self) -> Dict[str, Any]:
        with self.lock:
            out: Dict[str, Any] = dict(self.counters)
            out.update(self.gauges)
            series = dict(self.series)
            labeled = {n: dict(v) for n, v in self.labeled.items()}
            for n, v in self.labeled_gauges.items():
                labeled.setdefault(n, {}).update(v)
            hists = dict(self.histograms)
        for name, s in series.items():
            for k, v in s.snapshot().items():
                out[f"{name}.{k}"] = v
        for name, per in labeled.items():
            for key, v in per.items():
                lbl = ",".join(f"{k}={val}" for k, val in key)
                out[f"{name}{{{lbl}}}"] = v
        for name, h in hists.items():
            with h.lock:
                per = {k: list(row) for k, row in h.per_label.items()}
            for key, row in per.items():
                lbl = ",".join(f"{k}={val}" for k, val in key)
                suffix = f"{{{lbl}}}" if lbl else ""
                out[f"{name}{suffix}.count"] = row[-2]
                out[f"{name}{suffix}.sum"] = row[-1]
        return out

    def reset(self):
        with self.lock:
            self.counters.clear()
            self.gauges.clear()
            self.series.clear()
            self.labeled.clear()
            self.labeled_gauges.clear()
            self.histograms.clear()


_global = StatsManager()


def stats() -> StatsManager:
    """The process-wide registry (each daemon serves it at /stats)."""
    return _global


# -- deterministic work counters -------------------------------------------


class WorkCounters:
    """Per-query work counts — DETERMINISTIC for a fixed dataset/query,
    unlike wall-clock timings on a noisy VM.  Threaded through the
    engine (ExecutionContext.work), the RPC client (calls + wire
    bytes), and the device runtime (dispatches, traversed edges,
    per-hop frontier sizes); bench.py emits them as the noise-immune
    regression signal."""

    __slots__ = ("edges_traversed", "frontier_sizes", "rpc_calls",
                 "wire_bytes_sent", "wire_bytes_recv",
                 "device_dispatches", "storage_rows", "_lock")

    def __init__(self):
        self.edges_traversed = 0
        self.frontier_sizes: List[int] = []
        self.rpc_calls = 0
        self.wire_bytes_sent = 0
        self.wire_bytes_recv = 0
        self.device_dispatches = 0
        self.storage_rows = 0
        self._lock = threading.Lock()

    def add(self, field: str, n: int = 1):
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def extend_frontier(self, sizes: List[int]):
        with self._lock:
            self.frontier_sizes.extend(int(x) for x in sizes)

    def merge(self, other: "WorkCounters"):
        """Fold another statement's counts into this one (the engine
        folds each statement's ExecutionContext.work into a
        caller-installed probe — see use_work)."""
        d = other.as_dict()
        with self._lock:
            self.edges_traversed += d["edges_traversed"]
            self.frontier_sizes.extend(d["frontier_sizes"])
            self.rpc_calls += d["rpc_calls"]
            self.wire_bytes_sent += d["wire_bytes_sent"]
            self.wire_bytes_recv += d["wire_bytes_recv"]
            self.device_dispatches += d["device_dispatches"]
            self.storage_rows += d["storage_rows"]

    def as_dict(self) -> Dict[str, Any]:
        """Stable-ordered plain dict (the bench JSON schema; see
        docs/OBSERVABILITY.md)."""
        with self._lock:
            return {
                "edges_traversed": self.edges_traversed,
                "frontier_sizes": list(self.frontier_sizes),
                "rpc_calls": self.rpc_calls,
                "wire_bytes_sent": self.wire_bytes_sent,
                "wire_bytes_recv": self.wire_bytes_recv,
                "device_dispatches": self.device_dispatches,
                "storage_rows": self.storage_rows,
            }


class CostRecorder:
    """Per-plan-node cost sink: while a node's executor runs, this thread-local recorder accumulates the cost
    records remote services return in the RPC reply envelope
    (`remote_us`, `rows`, `wal_fsyncs`, `dedup_hits`) plus the client
    side's own call/byte counts and the device runtime's dispatch cost
    (`device_us`, `device_dispatches`, `device_compiles`).  The
    scheduler attaches the result to the node's PROFILE row and the
    flight-recorder entry — cluster-wide cost attribution per plan
    node, not graphd-local wall time."""

    __slots__ = ("data", "_lock")

    def __init__(self):
        self.data: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, field: str, n: int = 1):
        with self._lock:
            self.data[field] = self.data.get(field, 0) + int(n)

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return dict(sorted(self.data.items()))

    def __bool__(self) -> bool:
        with self._lock:
            return bool(self.data)


_cost_tls = threading.local()


def current_cost() -> Optional[CostRecorder]:
    return getattr(_cost_tls, "cost", None)


class _CostGuard:
    __slots__ = ("_rec", "_prev")

    def __init__(self, rec: Optional[CostRecorder]):
        self._rec = rec

    def __enter__(self):
        self._prev = getattr(_cost_tls, "cost", None)
        _cost_tls.cost = self._rec
        return self._rec

    def __exit__(self, *exc):
        _cost_tls.cost = self._prev
        return False


def use_cost(rec: Optional[CostRecorder]) -> _CostGuard:
    """Install `rec` as this thread's cost-attribution target (None
    keeps attribution disabled; the guard still restores correctly).
    Mirrors use_work: fan-out pool threads re-install the submitting
    thread's recorder so per-part costs attribute to the right node."""
    return _CostGuard(rec)


_work_tls = threading.local()


def current_work() -> Optional[WorkCounters]:
    return getattr(_work_tls, "work", None)


class _WorkGuard:
    __slots__ = ("_wc", "_prev")

    def __init__(self, wc: Optional[WorkCounters]):
        self._wc = wc

    def __enter__(self):
        self._prev = getattr(_work_tls, "work", None)
        _work_tls.work = self._wc
        return self._wc

    def __exit__(self, *exc):
        _work_tls.work = self._prev
        return False


def use_work(wc: Optional[WorkCounters]) -> _WorkGuard:
    """Install `wc` as this thread's work-counter target (None keeps
    counting disabled — the guard still restores correctly)."""
    return _WorkGuard(wc)
