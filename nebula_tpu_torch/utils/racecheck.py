"""The port's copy of `nebula_tpu/utils/racecheck.py`, whole.

Lock-order watchdog — the host plane's sanitizer analog.

The reference gates its threaded C++ through TSan/ASan CI jobs
(reference: .github workflows).  Python's GIL removes data races on
single bytecodes but NOT deadlocks or atomicity races across await
points — the two failure modes this module targets:

* **Lock-order cycles.**  `make_lock(name)` returns a plain RLock in
  production; with NEBULA_LOCKCHECK=1 it returns a checked wrapper that
  records every cross-lock acquisition edge (held → acquiring) into a
  global graph and raises `LockOrderError` the moment an edge closes a
  cycle — a potential deadlock caught deterministically on ANY
  interleaving that exhibits the order, not only the one that hangs.
  Re-entrant acquires and identical names (per-space sd.locks) are
  exempt.

* **Interleaving amplification.**  `race_amplifier()` is a context
  manager that drops sys.setswitchinterval to 10 µs (from 5 ms), making
  the scheduler preempt between nearly every bytecode — the
  stress-test harness (tests/unit/test_race_stress.py) runs concurrent
  engine/raft/balance workloads under it.
"""
from __future__ import annotations

import os
import sys
import threading
from contextlib import contextmanager
from typing import Dict, Set, Tuple

_enabled = os.environ.get("NEBULA_LOCKCHECK") == "1"

# directed edges between lock NAMES: (held, acquiring)
_edges: Set[Tuple[str, str]] = set()
_edges_lock = threading.Lock()
_tls = threading.local()


class LockOrderError(RuntimeError):
    pass


def _would_cycle(frm: str, to: str) -> bool:
    """True if adding frm→to closes a directed cycle over _edges."""
    if frm == to:
        return False
    stack, seen = [to], set()
    while stack:
        cur = stack.pop()
        if cur == frm:
            return True
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(b for (a, b) in _edges if a == cur)
    return False


class CheckedRLock:
    """RLock recording cross-lock acquisition order per thread."""

    __slots__ = ("_lock", "name")

    def __init__(self, name: str):
        self._lock = threading.RLock()
        self.name = name

    def _held(self):
        h = getattr(_tls, "held", None)
        if h is None:
            h = _tls.held = []
        return h

    def acquire(self, blocking=True, timeout=-1):
        held = self._held()
        already = any(n == self.name for n, _ in held)
        if held and not already:
            # a re-entrant acquire ANYWHERE in the stack can never block
            # (the thread owns the lock) — only first acquisitions of a
            # new lock record an order edge
            frm = held[-1][0]
            with _edges_lock:
                if (frm, self.name) not in _edges:
                    if _would_cycle(frm, self.name):
                        raise LockOrderError(
                            f"lock-order cycle: holding `{frm}', "
                            f"acquiring `{self.name}' — the reverse "
                            f"order was already observed")
                    _edges.add((frm, self.name))
        got = self._lock.acquire(blocking, timeout)
        if got:
            if already:
                for i in range(len(held) - 1, -1, -1):
                    if held[i][0] == self.name:
                        held[i] = (self.name, held[i][1] + 1)
                        break
            else:
                held.append((self.name, 1))
        return got

    def release(self):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == self.name:
                if held[i][1] > 1:
                    held[i] = (self.name, held[i][1] - 1)
                else:
                    del held[i]
                break
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()


def make_lock(name: str):
    """A named re-entrant lock; order-checked when NEBULA_LOCKCHECK=1."""
    if _enabled:
        return CheckedRLock(name)
    return threading.RLock()


def edges() -> Set[Tuple[str, str]]:
    """Observed acquisition-order edges (for assertions in tests)."""
    return set(_edges)


def reset():
    with _edges_lock:
        _edges.clear()


@contextmanager
def race_amplifier(interval: float = 1e-5):
    """Preempt threads between (nearly) every bytecode for the scope."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(interval)
    try:
        yield
    finally:
        sys.setswitchinterval(old)
