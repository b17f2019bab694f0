"""The port's copy of `nebula_tpu/utils/failpoints.py`, whole.

Deterministic failpoint injection — the TiKV/CockroachDB fail-rs
analog.

Every crash-shaped code path in the cluster layer carries a named
failpoint site (`fail.hit("raft:pre_fsync")`); unarmed sites cost one
dict-truthiness check.  Tests and the chaos harness arm sites with a
small action language, per-site:

    fail.arm("rpc:recv", "2*off->1*kill_conn")   # skip 2 hits, kill on 3rd
    fail.arm("wal:pre_fsync", "delay(0.25)")     # one fsync stall
    fail.arm("toss:pre_in", "-1*raise(torn)")    # every hit, forever

Actions:
    off          no-op (consumes a hit — the skip/counting primitive)
    raise[(msg)] raise FailpointError(msg)
    delay(s)     sleep s seconds (stalls, NOT failures)
    kill_conn    raise ConnectionKilled — the RPC layer translates it
                 into tearing down the live connection mid-call (the
                 at-least-once reply-lost hazard)

A spec is a `->`-chain of `[N*]action` terms; N=-1 repeats forever,
omitted N means once.  When the chain exhausts the site disarms.

Seeded schedules (`FaultSchedule`) arm sites with PSEUDO-RANDOM but
fully deterministic triggers: each rule's decisions are drawn from
`random.Random(f"{seed}:{site}")`, so the k-th hit of a site triggers
identically across runs of the same workload — a failing chaos run is
reproducible from its seed alone (tools/chaos_bench.py prints the
reproducer line).

Arming also works from the environment (CI chaos jobs):
    NEBULA_FAILPOINTS="raft:pre_fsync=delay(0.1);rpc:recv=3*off->1*kill_conn"

Observability: every FIRED action (not unarmed hits) increments the
labeled counter `failpoint_fired{name,action}`.
"""
from __future__ import annotations

import os
import random
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["FailpointError", "ConnectionKilled", "FailpointRegistry",
           "FaultSchedule", "fail", "hit"]


class FailpointError(Exception):
    """An armed `raise` action fired."""


class ConnectionKilled(FailpointError):
    """An armed `kill_conn` action fired; rpc.py translates this into
    killing the live connection (reply lost mid-call)."""


_TERM_RE = re.compile(r"^(?:(-?\d+)\*)?([a-z_]+)(?:\(([^)]*)\))?$")
_ACTIONS = frozenset({"off", "raise", "delay", "kill_conn"})


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
        self._armed: Dict[str, object] = {}     # name → terms | callable
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

    def arm_callable(self, name: str,
                     fn: Callable[[int, object],
                                  Optional[Tuple[str, object]]]):
        """Arm with a decision function: fn(hit_index, key) returns
        (action, arg) or None for no-op.  `key` is the optional context
        the site passed to hit() (e.g. the raft group name), letting a
        rule target one group/part while the site stays global.  The
        seeded-schedule hook."""
        with self._lock:
            self._armed[name] = fn
            self._hits.setdefault(name, 0)

    def disarm(self, name: str):
        with self._lock:
            self._armed.pop(name, None)

    def reset(self):
        with self._lock:
            self._armed.clear()
            self._hits.clear()

    def scoped(self) -> "_Scope":
        """Context manager that restores the pre-entry armed set on exit
        (test isolation)."""
        return _Scope(self)

    def hit_count(self, name: str) -> int:
        with self._lock:
            return self._hits.get(name, 0)

    def armed(self) -> List[str]:
        with self._lock:
            return sorted(self._armed)

    # -- the hot-path entry ----------------------------------------------

    def hit(self, name: str, key=None):
        if not self._armed:             # fast path: nothing armed at all
            return
        with self._lock:
            arm = self._armed.get(name)
            if arm is None:
                return
            idx = self._hits.get(name, 0)
            self._hits[name] = idx + 1
            if not callable(arm):
                while arm and arm[0][0] == 0:
                    arm.pop(0)
                if not arm:
                    self._armed.pop(name, None)
                    return
                term = arm[0]
                if term[0] > 0:
                    term[0] -= 1
                kind, arg = term[1], term[2]
                # eager disarm on exhaustion: the hit AFTER the last
                # term must be a true unarmed no-op (uncounted)
                if term[0] == 0 and len(arm) == 1:
                    self._armed.pop(name, None)
        if callable(arm):
            # decision fns run OUTSIDE the registry lock: a chaos
            # harness decision may block (holding a propose open while
            # a killer thread acts) and must not freeze every other
            # site in the process — raft's own failpoint hits included
            decision = arm(idx, key)
            if decision is None:
                return
            kind, arg = decision
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
        elif kind == "kill_conn":
            raise ConnectionKilled(f"failpoint {name} killed connection")


class _Scope:
    def __init__(self, reg: FailpointRegistry):
        self.reg = reg

    def __enter__(self):
        with self.reg._lock:
            self._saved = dict(self.reg._armed)
        return self.reg

    def __exit__(self, *exc):
        with self.reg._lock:
            self.reg._armed.clear()
            self.reg._armed.update(self._saved)
        return False


class FaultSchedule:
    """A seeded, deterministic set of probabilistic failpoint rules.

    rules: [{"fp": name, "action": "raise"|"delay"|"kill_conn"|"off",
             "arg": optional, "p": probability per hit,
             "max": max fires (default unbounded),
             "after": skip the first N hits (default 0),
             "key": only fire when the site's context key contains
                    this substring (e.g. "meta" → only the metad raft
                    group; default: any)}]

    Each rule draws its per-hit trigger decisions from
    random.Random(f"{seed}:{fp}") — the k-th hit of a site always decides
    identically for a given seed, independent of wall-clock or thread
    interleaving, so a failure reproduces from (seed, workload) alone.
    """

    def __init__(self, seed: int, rules: List[Dict]):
        self.seed = int(seed)
        self.rules = rules
        self.fired: Dict[str, int] = {}
        self._lock = threading.Lock()

    def arm(self, reg: Optional[FailpointRegistry] = None):
        reg = reg or fail
        for rule in self.rules:
            name = rule["fp"]
            rng = random.Random(f"{self.seed}:{name}")
            action = rule.get("action", "raise")
            arg = rule.get("arg")
            if action == "delay" and arg is None:
                arg = 0.05
            p = float(rule.get("p", 1.0))
            after = int(rule.get("after", 0))
            cap = rule.get("max")
            keyf = rule.get("key")
            state = {"fired": 0}

            def decide(idx, key, _rng=rng, _p=p, _after=after, _cap=cap,
                       _state=state, _action=action, _arg=arg,
                       _name=name, _keyf=keyf):
                with self._lock:
                    # one draw per hit (under the schedule lock — hits
                    # arrive from many threads) keeps the decision
                    # stream aligned with the hit index regardless of
                    # earlier outcomes
                    r = _rng.random()
                    if _keyf is not None and _keyf not in str(key):
                        return None
                    if idx < _after:
                        return None
                    if _cap is not None and _state["fired"] >= _cap:
                        return None
                    if r >= _p:
                        return None
                    _state["fired"] += 1
                    self.fired[_name] = self.fired.get(_name, 0) + 1
                return (_action, _arg)

            reg.arm_callable(name, decide)
        return self

    def disarm(self, reg: Optional[FailpointRegistry] = None):
        reg = reg or fail
        for rule in self.rules:
            reg.disarm(rule["fp"])

    def describe(self) -> str:
        parts = [f"{r['fp']}={r.get('action', 'raise')}"
                 f"(p={r.get('p', 1.0)})" for r in self.rules]
        return f"seed={self.seed} " + " ".join(parts)


#: process-global registry — all production sites hit() this instance
fail = FailpointRegistry()
hit = fail.hit
