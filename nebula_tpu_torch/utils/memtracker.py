"""The port's copy of `nebula_tpu/utils/memtracker.py`, whole.

Per-query memory accounting with kill-on-exceed.

Analog of the reference's MemoryTracker (reference: src/common/memory,
SURVEY §2 row 5): every executor output and every loop that can
explode (variable-length MATCH, path search) charges its allocations
against the query's budget; exceeding it raises MemoryExceeded, which
the engine surfaces as a clean ExecutionError instead of letting one
runaway query OOM the process.

The device plane has its own scarce resource: the port's budget for
pinned device bytes is `GpuRuntime(hbm_limit_bytes=...)`, which the
runtime checks before pinning a snapshot.
"""
from __future__ import annotations

from typing import Any, List, Optional

from .config import define_flag, get_config

define_flag("query_memory_limit_bytes", 1 << 30,
            "per-query intermediate-result budget; 0 disables tracking")


class MemoryExceeded(Exception):
    def __init__(self, used: int, limit: int):
        super().__init__(
            f"query memory exceeded: used≈{used:,} bytes, "
            f"limit {limit:,} (flag query_memory_limit_bytes)")
        self.used = used
        self.limit = limit


def approx_row_bytes(row: List[Any]) -> int:
    """Cheap per-row estimate: container overhead + per-cell cost."""
    total = 64
    for c in row:
        if isinstance(c, str):
            total += 56 + len(c)
        elif isinstance(c, (list, tuple, set)):
            total += 64 + 48 * len(c)
        else:
            total += 48
    return total


def approx_dataset_bytes(rows: List[List[Any]]) -> int:
    """Sampled estimate: first rows price the rest (rows of one node
    output are shape-homogeneous)."""
    n = len(rows)
    if n == 0:
        return 64
    k = min(n, 32)
    sampled = sum(approx_row_bytes(rows[i]) for i in range(k))
    return 64 + (sampled * n) // k


def approx_columnar_bytes(cols) -> int:
    """Charge a columnar result WITHOUT touching `.rows` (which would
    materialize per-row Python lists — the exact cost lazy columnar
    results exist to avoid).  Numeric columns price at their buffer
    size; object columns sample like approx_dataset_bytes."""
    total = 64
    for c in cols:
        dt = getattr(c, "dtype", None)
        if dt is None:
            n = len(c)
            if n:
                k = min(n, 32)
                total += (approx_row_bytes(list(c)[:k]) * n) // k
            continue
        if dt != object:
            total += int(c.nbytes)
            continue
        n = int(c.size)
        if n == 0:
            continue
        k = min(n, 32)
        sampled = approx_row_bytes([c[i] for i in range(k)])
        total += (sampled * n) // k
    return total


class MemoryTracker:
    """One per query execution.  charge() is cumulative: intermediates
    are versioned and kept for $vars/PROFILE, so releases are rare and
    conservatively ignored."""

    __slots__ = ("limit", "used", "_mu")

    def __init__(self, limit: Optional[int] = None):
        import threading
        self._mu = threading.Lock()
        if limit is None:
            limit = int(get_config().get("query_memory_limit_bytes"))
        self.limit = limit
        self.used = 0

    def charge(self, nbytes: int):
        # executors charge from scheduler pool threads concurrently — an
        # unlocked read-modify-write loses updates and under-enforces
        # the kill switch on exactly the large parallel plans it guards
        with self._mu:
            self.used += int(nbytes)
            used = self.used
        if self.limit and used > self.limit:
            raise MemoryExceeded(used, self.limit)

    def charge_rows(self, rows: List[List[Any]]):
        self.charge(approx_dataset_bytes(rows))
