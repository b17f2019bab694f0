"""Deterministic failpoint injection — the fail-rs analog.

The port's copy of nebula_tpu/utils/failpoints.py: the registry, `fail`,
`hit` and `FailpointError`.  The seeded `FaultSchedule` and the RPC
`kill_conn` action stay in the reference (the port has no RPC layer).
Named sites carry `fail.hit("site")`; an unarmed site costs one
dict-truthiness check.  Tests arm sites with a small action language:

    fail.arm("tpu:batch_form", "raise")          # the next hit raises
    fail.arm("tpu:dispatch_gate", "delay(0.25)") # one stall
    fail.arm("tpu:batch_form", "-1*raise(x)")    # every hit, forever

Actions:
    off          no-op (consumes a hit — the skip/counting primitive)
    raise[(msg)] raise FailpointError(msg)
    delay(s)     sleep s seconds (stalls, NOT failures)

A spec is a `->`-chain of `[N*]action` terms; N=-1 repeats forever,
omitted N means once.  When the chain exhausts the site disarms.  Arming
also works from the environment:
    NEBULA_FAILPOINTS="tpu:batch_form=raise;tpu:dispatch_gate=delay(0.1)"

Every FIRED action increments the labeled counter
`failpoint_fired{name,action}`.  The port's sites: `tpu:batch_form`
(gpu/batch.py) and `tpu:dispatch_gate` (gpu/runtime.py).
"""
from __future__ import annotations

import os
import re
import threading
import time
from typing import Dict, List

__all__ = ["FailpointError", "FailpointRegistry", "fail", "hit"]


class FailpointError(Exception):
    """An armed `raise` action fired."""


_TERM_RE = re.compile(r"^(?:(-?\d+)\*)?([a-z_]+)(?:\(([^)]*)\))?$")
_ACTIONS = frozenset({"off", "raise", "delay"})


def _parse_spec(spec: str) -> List[List]:
    """'2*off->1*raise(boom)' -> [[2, 'off', None], [1, 'raise', 'boom']]
    (mutable counts — the registry decrements them in place)."""
    terms: List[List] = []
    for raw in spec.split("->"):
        m = _TERM_RE.match(raw.strip())
        if m is None:
            raise ValueError(f"bad failpoint term {raw!r}")
        count = int(m.group(1)) if m.group(1) else 1
        kind, arg = m.group(2), m.group(3)
        if kind not in _ACTIONS:
            raise ValueError(f"unknown failpoint action {kind!r}")
        if kind == "delay":
            arg = float(arg if arg else 0.05)
        terms.append([count, kind, arg])
    if not terms:
        raise ValueError(f"empty failpoint spec {spec!r}")
    return terms


class FailpointRegistry:
    """Name → armed action chain.  `hit()` is the only hot-path entry;
    it returns immediately when nothing is armed anywhere."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: Dict[str, List[List]] = {}  # name → action terms
        self._hits: Dict[str, int] = {}         # per-site hit counter
        env = os.environ.get("NEBULA_FAILPOINTS")
        if env:
            for part in env.split(";"):
                part = part.strip()
                if not part:
                    continue
                name, spec = part.split("=", 1)
                self.arm(name.strip(), spec.strip())

    # -- arming -----------------------------------------------------------

    def arm(self, name: str, spec: str):
        """Arm `name` with an action-chain spec (see module doc)."""
        terms = _parse_spec(spec)
        with self._lock:
            self._armed[name] = terms
            self._hits.setdefault(name, 0)

    def disarm(self, name: str):
        with self._lock:
            self._armed.pop(name, None)

    def reset(self):
        with self._lock:
            self._armed.clear()
            self._hits.clear()

    def hit_count(self, name: str) -> int:
        with self._lock:
            return self._hits.get(name, 0)

    # -- the hot-path entry ----------------------------------------------

    def hit(self, name: str, key=None):
        if not self._armed:             # fast path: nothing armed at all
            return
        with self._lock:
            arm = self._armed.get(name)
            if arm is None:
                return
            self._hits[name] = self._hits.get(name, 0) + 1
            while arm and arm[0][0] == 0:
                arm.pop(0)
            if not arm:
                self._armed.pop(name, None)
                return
            term = arm[0]
            if term[0] > 0:
                term[0] -= 1
            kind, arg = term[1], term[2]
            # eager disarm on exhaustion: the hit AFTER the last term
            # must be a true unarmed no-op (uncounted)
            if term[0] == 0 and len(arm) == 1:
                self._armed.pop(name, None)
        self._fire(name, kind, arg)

    def _fire(self, name: str, kind: str, arg):
        if kind == "off":
            return
        from .stats import stats
        stats().inc_labeled("failpoint_fired",
                           {"name": name, "action": kind})
        if kind == "delay":
            time.sleep(float(arg))
        elif kind == "raise":
            raise FailpointError(arg or f"failpoint {name} fired")


#: process-global registry — all production sites hit() this instance
fail = FailpointRegistry()
hit = fail.hit
