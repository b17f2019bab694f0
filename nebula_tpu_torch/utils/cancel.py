"""Cooperative cancellation + deadline budgets.

The port's copy of nebula_tpu/utils/cancel.py.

One thread-local pair (kill event, absolute monotonic deadline) is the
statement's cancellation context:

  - graphd's engine installs it around the scheduler run (the statement
    timeout flag `query_timeout_secs` becomes the deadline);
  - the scheduler re-installs it on plan-branch pool threads (like the
    trace/work contexts) and checks it between plan nodes;
  - the RPC client clamps every call's timeout to the remaining budget
    and stamps the REMAINING seconds into the request envelope ("dl"),
    so each hop re-derives an absolute deadline from its own clock —
    relative propagation is clock-skew-free;
  - the RPC server re-installs the context around the handler, which is
    what decrements the budget across graphd → storaged → metad hops;
  - long waits (storage fan-out, TPU pipeline segments) poll it.

`DeadlineExceeded` surfaces to the client as `E_QUERY_TIMEOUT`.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

__all__ = ["DeadlineExceeded", "QueryKilled", "use_cancel", "check",
           "current_kill", "current_deadline", "remaining"]


class DeadlineExceeded(Exception):
    """The statement's deadline budget is spent (→ E_QUERY_TIMEOUT)."""


class QueryKilled(Exception):
    """The statement's kill event fired (KILL QUERY)."""


_tls = threading.local()


def current_kill() -> Optional[threading.Event]:
    return getattr(_tls, "kill", None)


def current_deadline() -> Optional[float]:
    """Absolute time.monotonic() deadline, or None when unbudgeted."""
    return getattr(_tls, "deadline", None)


def remaining() -> Optional[float]:
    dl = current_deadline()
    if dl is None:
        return None
    return dl - time.monotonic()


def check():
    """Raise if the current context is killed or out of budget."""
    ev = current_kill()
    if ev is not None and ev.is_set():
        raise QueryKilled("query was killed")
    rem = remaining()
    if rem is not None and rem <= 0:
        raise DeadlineExceeded(
            f"deadline exceeded by {-rem:.3f}s")


class use_cancel:
    """Install (kill, deadline) for the with-block; nests by stacking —
    an inner deadline never LOOSENS the outer one (min wins), and
    None leaves the outer value in place."""

    def __init__(self, kill: Optional[threading.Event] = None,
                 deadline: Optional[float] = None):
        self.kill = kill
        self.deadline = deadline

    def __enter__(self):
        self._pk = getattr(_tls, "kill", None)
        self._pd = getattr(_tls, "deadline", None)
        if self.kill is not None:
            _tls.kill = self.kill
        if self.deadline is not None:
            _tls.deadline = self.deadline if self._pd is None \
                else min(self._pd, self.deadline)
        return self

    def __exit__(self, *exc):
        _tls.kill = self._pk
        _tls.deadline = self._pd
        return False
