"""The port's copy of `nebula_tpu/utils/consistency.py`, whole.

Read-consistency levels for the storage read path.

Every storage read carries a consistency level:

  * ``leader`` (default) — today's behavior: the part leader serves,
    gated by its heartbeat lease (`RaftPart.has_lease`).  Linearizable
    modulo the lease clock-skew margin.
  * ``follower`` — read-index reads: ANY replica may serve after
    obtaining a read barrier from the leader (`RaftPart.read_index`)
    and waiting for its local apply to catch up.  Observes everything
    committed before the read started; spreads read load across the
    replica set and survives a leader loss as soon as a new leader is
    elected.
  * ``bounded_stale`` — a replica serves purely locally when it heard
    from a live leader within `read_max_stale_ms` (and its applied
    index covers the caller's read-your-writes floor); otherwise it
    rejects with a structured ``E_STALE`` + lag hint and the client
    walks to a fresher replica.  Available even while the leader is
    down or unreachable — the weakest, most available level.

The effective level for a call is the thread-local override
(`use_consistency`, installed by tests and storm drivers) falling back
to the `read_consistency` flag.  Semantics matrix: docs/ROBUSTNESS.md
§8 "Read-path consistency".
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

from .config import define_flag, get_config

LEADER = "leader"
FOLLOWER = "follower"
BOUNDED_STALE = "bounded_stale"
LEVELS = (LEADER, FOLLOWER, BOUNDED_STALE)

define_flag("read_consistency", "leader",
            "default consistency level for storage reads: leader "
            "(lease-gated leader reads, today's behavior), follower "
            "(read-index reads — any replica serves after a leader "
            "read barrier + local apply catch-up), or bounded_stale "
            "(replica serves locally while its staleness is within "
            "read_max_stale_ms, else rejects with E_STALE)")
define_flag("read_max_stale_ms", 5000.0,
            "bounded_stale staleness bound: a non-leader replica may "
            "serve a bounded_stale read only while it heard from a "
            "live leader within this window (and its applied index "
            "covers the caller's read-your-writes floor)")

_tls = threading.local()


def current_override() -> Optional[str]:
    return getattr(_tls, "level", None)


def effective_consistency() -> str:
    """The level this thread's storage reads run at: the TLS override
    if installed, else the `read_consistency` flag (unknown flag values
    degrade to `leader` — the safe default — rather than erroring in
    the middle of a read)."""
    lvl = current_override()
    if lvl in LEVELS:
        return lvl
    try:
        lvl = str(get_config().get("read_consistency"))
    except Exception:  # noqa: BLE001 — config not initialized
        return LEADER
    return lvl if lvl in LEVELS else LEADER


@contextmanager
def use_consistency(level: Optional[str]):
    """Scope a read-consistency override to this thread (storm drivers
    mixing levels concurrently; tests pinning one call's level).
    None = no override (the flag decides) — the pass-through form pool
    threads use to mirror their submitting thread's state."""
    if level is not None and level not in LEVELS:
        raise ValueError(f"unknown consistency level {level!r} "
                         f"(one of {LEVELS})")
    prev = getattr(_tls, "level", None)
    _tls.level = level
    try:
        yield
    finally:
        _tls.level = prev
