"""The port's copy of `nebula_tpu/utils/flight.py`, whole.

Always-on flight recorder + device kernel ledger.

The production incident problem: by the time someone asks "what did the
slow/failed query actually do", the query is gone — PROFILE can only be
run on a REPRODUCTION, and reproductions of incident queries are
unreliable.  The flight recorder fixes that by keeping a bounded ring
of COMPLETED statement profiles: every statement's per-operator
breakdown (node kind, wall time, rows, remote cost from the RPC reply
envelopes, device dispatch cost) is collected always — the collection
is a handful of dict inserts per plan node — and a statement's record
is RETAINED when either

  * deterministic sampling admits it (`flight_sample_rate`, a
    counter-based accumulator — not random, so runs reproduce), or
  * capture is FORCED: the statement errored, was killed, timed out,
    tripped a chaos failpoint, or crossed the slow-query threshold.

So the chaos harness (and any production incident) yields the exact
per-operator breakdown of the offending statement after the fact, via
`GET /flight` on the webservice or `SHOW FLIGHT RECORDER` in nGQL.

The module also owns the DEVICE KERNEL LEDGER: a bounded ring of every
kernel dispatch (kernel name, shape bucket, compile-vs-cache, dispatch
µs, HBM high-water) fed by tpu/runtime.py — the telemetry substrate the
batching/multi-chip work will be tuned against.  Kept here (not in the
tpu package) so the webservice can serve `GET /kernels` without
importing jax.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .config import define_flag, get_config

define_flag("flight_recorder_capacity", 256,
            "completed-statement profiles retained in the flight "
            "recorder ring (0 disables retention; collection stays on "
            "so PROFILE is unaffected)")
define_flag("flight_sample_rate", 0.02,
            "fraction of OK statements retained by the flight recorder "
            "(deterministic counter-based sampling, not random); "
            "errored/killed/timed-out/slow statements are always "
            "retained regardless")
define_flag("kernel_ledger_capacity", 512,
            "device kernel dispatch records retained in the ledger "
            "ring (GET /kernels)")


class FlightRecorder:
    """Bounded ring of completed statement profiles, newest last."""

    def __init__(self):
        self._ring: "deque[dict]" = deque()
        self._lock = threading.Lock()
        self._seq = 0            # monotonically growing entry id
        self._acc = 0.0          # deterministic sampling accumulator

    @staticmethod
    def _capacity() -> int:
        try:
            return int(get_config().get("flight_recorder_capacity"))
        except Exception:  # noqa: BLE001 — config not initialized
            return 256

    def _admit_sample(self) -> bool:
        """Counter-based sampling: accumulate the rate per statement
        and admit when the accumulator crosses 1 — rate 0.02 admits
        exactly every 50th OK statement, reproducibly."""
        try:
            rate = float(get_config().get("flight_sample_rate"))
        except Exception:  # noqa: BLE001
            rate = 0.0
        if rate <= 0.0:
            return False
        with self._lock:
            self._acc += min(rate, 1.0)
            if self._acc >= 1.0:
                self._acc -= 1.0
                return True
        return False

    @staticmethod
    def classify(error: Optional[str], latency_us: int,
                 slow_us: int) -> Optional[str]:
        """Forced-capture reason for a finished statement, or None when
        only sampling applies.  Matches the engine's STRUCTURED error
        shapes (exact sentinel / prefix / exception-class token), not
        loose substrings — error text embeds statement fragments, and a
        statement merely CONTAINING the word "killed" must not skew the
        status triage columns."""
        if error is not None:
            if error == "ExecutionError: query was killed":
                return "killed"           # engine.py emits exactly this
            if error.startswith("E_QUERY_TIMEOUT"):
                return "timeout"
            if error.startswith("E_OVERLOAD"):
                return "shed"             # admission/inbox load shedding
            if "FailpointError:" in error:
                return "failpoint"        # exception-class token
            return "error"
        if slow_us > 0 and latency_us > slow_us:
            return "slow"
        return None

    def record(self, *, stmt: str, kind: str, latency_us: int,
               error: Optional[str], trace_id: Optional[str],
               session: Optional[int], operators,
               work: Optional[Dict[str, Any]] = None,
               slow_us: int = 0,
               force: Optional[str] = None,
               fingerprint: Optional[str] = None) -> Optional[dict]:
        """Retain one completed statement if forced or sampled.
        Returns the stored entry (or None when dropped).  `operators`
        (and `work`) may be zero-arg callables — they are only invoked
        AFTER the retain decision, so a dropped statement pays nothing
        beyond the decision itself (the ≤2% overhead budget).
        `force` retains unconditionally under that status — the stall
        watchdog records a still-RUNNING statement this way,
        which classify() cannot see from the outcome alone."""
        cap = self._capacity()
        if cap <= 0:
            return None
        forced = force or self.classify(error, latency_us, slow_us)
        if forced is None and not self._admit_sample():
            return None
        if callable(operators):
            operators = operators()
        if callable(work):
            work = work()
        entry = {
            "ts": time.time(),
            "stmt": stmt[:500],
            "kind": kind,
            "latency_us": int(latency_us),
            "status": forced or "sampled",
            "error": error,
            "trace_id": trace_id,
            "session": session,
            "operators": operators,
            # statement fingerprint: joins this point-in-time
            # capture against the aggregate SHOW STATEMENTS table
            "fingerprint": fingerprint or "",
        }
        if work:
            entry["work"] = work
        with self._lock:
            self._seq += 1
            entry["id"] = self._seq
            self._ring.append(entry)
            while len(self._ring) > cap:
                self._ring.popleft()
        from .stats import stats
        stats().inc_labeled("flight_records", {"status": entry["status"]})
        return entry

    def get(self, entry_id: int) -> Optional[dict]:
        with self._lock:
            for e in self._ring:
                if e["id"] == entry_id:
                    return e
        return None

    def list(self, limit: int = 50) -> List[dict]:
        """Newest-first summaries (no operator bodies)."""
        if limit <= 0:
            return []
        with self._lock:
            entries = list(self._ring)
        return [{"id": e["id"], "ts": e["ts"], "stmt": e["stmt"][:120],
                 "kind": e["kind"], "status": e["status"],
                 "latency_us": e["latency_us"],
                 "operators": len(e["operators"]),
                 "trace_id": e["trace_id"],
                 "fingerprint": e.get("fingerprint", "")}
                for e in reversed(entries[-limit:])]

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._acc = 0.0


class KernelLedger:
    """Bounded ring of device kernel dispatch records, newest last."""

    def __init__(self):
        self._ring: "deque[dict]" = deque()
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, *, kernel: str, shape: List[int], steps: int,
               compiled: bool, dispatch_us: int, hbm_bytes: int,
               retries: int = 0, shards: int = 1,
               exchange_bytes: int = 0):
        try:
            cap = int(get_config().get("kernel_ledger_capacity"))
        except Exception:  # noqa: BLE001
            cap = 512
        if cap <= 0:
            return
        with self._lock:
            self._seq += 1
            self._ring.append({
                "id": self._seq, "ts": time.time(), "kernel": kernel,
                "shape": list(int(x) for x in shape), "steps": int(steps),
                "compiled": bool(compiled),
                "dispatch_us": int(dispatch_us),
                "hbm_bytes": int(hbm_bytes), "retries": int(retries),
                # mesh facts: how many part-axis shards the
                # launch spanned and the bit-packed frontier exchange
                # payload it moved — the "mesh is used, not assumed"
                # proof per dispatch
                "shards": int(shards),
                "exchange_bytes": int(exchange_bytes)})
            while len(self._ring) > cap:
                self._ring.popleft()

    def list(self, limit: int = 100) -> List[dict]:
        if limit <= 0:
            return []
        with self._lock:
            entries = list(self._ring)
        return list(reversed(entries[-limit:]))

    def clear(self):
        with self._lock:
            self._ring.clear()


_recorder = FlightRecorder()
_ledger = KernelLedger()


def flight_recorder() -> FlightRecorder:
    """The process-wide recorder (each daemon serves it at /flight)."""
    return _recorder


def kernel_ledger() -> KernelLedger:
    """The process-wide dispatch ledger (served at /kernels)."""
    return _ledger
