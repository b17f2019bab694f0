"""The port's copy of `nebula_tpu/utils/epochs.py`, whole.

Cluster-coherent write epochs.

The result/plan cache keys carry a write epoch that is
coordinator-local: a mutating statement through graphd A bumps A's
epoch, but graphd B keeps serving its cached rows — the one documented
wrong-rows hole.  This module is the cluster half of the fix.

Every storaged already bumps a per-space store epoch on EVERY applied
mutation (leader and raft followers alike).  ClusterEpochs folds those
per-host counters into a per-space vector

    space -> { storaged_host: (boot_id, epoch) }

and derives from it a LOCAL, monotonically increasing generation
number per space.  The generation — not the raw vector — goes into the
cache key: any observed change anywhere in the vector mints new keys,
so previously cached entries become unreachable (invalidation by
unreachability, same trick as the catalog-version half of the key).

Why a (boot, epoch) pair per host rather than one max-merged scalar:
store epochs are host-local counters that reset on restart.  A plain
max() would let a long-lived host's high epoch mask a freshly
restarted host's low-but-advancing one (missed invalidations); a plain
replace would let an out-of-order heartbeat regress the vector and
resurrect retired cache keys.  Per-host-per-boot max-merge is immune
to both: same boot → monotonic guard drops stale folds; new boot →
unconditional replace (a restart is always news).

Propagation path (both legs ride existing traffic, no new RPC):
  - storaged heartbeat carries {space: [boot, epoch, bump_ts]} → metad
    merges into a leader-local table (like liveness/heat — deliberately
    NOT raft-replicated; a fresh leader rebuilds it from the next
    heartbeat wave) → every heartbeat REPLY carries the merged table →
    graphd folds it here.  Window ≈ storaged hb + graphd hb intervals,
    measured as `epoch_propagation_lag_ms` (now − bump_ts whenever a
    fold advances an entry that carries a timestamp).
  - the storaged write ack already carries the space epoch; the
    writing graphd folds it immediately (note_ack) so its OWN caches
    turn over without waiting a heartbeat — read-your-writes on the
    write coordinator is ack-latency, not heartbeat-latency.

Strict mode (`result_cache_strict_epoch`): before serving a cached
result at leader consistency, the engine pulls metad's merged table
once and folds it — a write acked through ANY coordinator that reached
metad invalidates before the read is served, closing even the
heartbeat window for reads that asked for leader semantics.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

__all__ = ["ClusterEpochs"]


class ClusterEpochs:
    """Per-space cluster write-epoch vector + derived local generation."""

    def __init__(self):
        self._mu = threading.Lock()
        # space -> host -> (boot, epoch)
        self._vec: Dict[str, Dict[str, Tuple[str, int]]] = {}
        # space -> local generation (bumped on every observed advance)
        self._gen: Dict[str, int] = {}
        # space -> max store epoch seen on a write ack (host-anonymous:
        # acks don't say which replica served, so this is a separate
        # monotonic floor under pseudo-host "#ack")
        self._ack: Dict[str, int] = {}

    # -- reads -----------------------------------------------------------

    def gen(self, space: Optional[str]) -> int:
        """Cache-key component: local generation for `space` (0 until a
        fold lands — standalone engines never fold, keys unchanged)."""
        if not space:
            return 0
        with self._mu:
            return self._gen.get(space, 0)

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            return {sp: {"gen": self._gen.get(sp, 0),
                         "ack": self._ack.get(sp, 0),
                         "hosts": {h: [b, e]
                                   for h, (b, e) in hosts.items()}}
                    for sp, hosts in self._vec.items()}

    # -- folds -----------------------------------------------------------

    def fold(self, space: str, host: str, boot: str, epoch: int,
             ts: Optional[float] = None) -> bool:
        """Fold one host's (boot, epoch) into the vector; True when the
        vector advanced (and the space generation was bumped)."""
        epoch = int(epoch)
        advanced = False
        with self._mu:
            hosts = self._vec.setdefault(space, {})
            cur = hosts.get(host)
            if cur is None or cur[0] != boot or epoch > cur[1]:
                hosts[host] = (boot, epoch)
                self._gen[space] = self._gen.get(space, 0) + 1
                advanced = True
        if advanced and ts:
            lag_ms = max(0.0, (time.time() - float(ts)) * 1000.0)
            from .stats import stats
            stats().observe("epoch_propagation_lag_ms", lag_ms)
            stats().inc("cluster_epoch_folds")
        return advanced

    def fold_table(self, table: Optional[Dict[str, Any]]) -> int:
        """Fold a metad-merged table {space: {host: [boot, epoch, ts]}};
        returns how many entries advanced."""
        if not table:
            return 0
        n = 0
        for space, hosts in table.items():
            if not isinstance(hosts, dict):
                continue
            for host, ent in hosts.items():
                try:
                    boot, epoch = ent[0], int(ent[1])
                    ts = float(ent[2]) if len(ent) > 2 and ent[2] else None
                except (TypeError, ValueError, IndexError):
                    continue
                if self.fold(space, host, boot, epoch, ts=ts):
                    n += 1
        return n

    def note_ack(self, space: str, epoch: Any) -> bool:
        """Fold a write-ack store epoch (host unknown).  Monotonic per
        space; an advance bumps the generation, so the writing graphd's
        caches turn over at ack time, before any heartbeat."""
        try:
            epoch = int(epoch)
        except (TypeError, ValueError):
            return False
        if not space or epoch <= 0:
            return False
        with self._mu:
            if epoch <= self._ack.get(space, 0):
                return False
            self._ack[space] = epoch
            self._gen[space] = self._gen.get(space, 0) + 1
        return True


class EpochClock:
    """Storaged-side bump-timestamp tracker: remembers WHEN each
    space's store epoch was last seen advancing, so the heartbeat
    payload can carry a wall-clock bump ts and the folding graphd can
    measure true propagation lag (not just heartbeat cadence)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._seen: Dict[str, Tuple[int, float]] = {}  # space -> (epoch, ts)

    def note(self, space: str, epoch: int) -> None:
        with self._mu:
            cur = self._seen.get(space)
            if cur is None or epoch > cur[0]:
                self._seen[space] = (int(epoch), time.time())

    def ts_for(self, space: str, epoch: int) -> Optional[float]:
        """Bump ts if it corresponds to `epoch` (else None — an epoch
        that advanced without passing through note(), e.g. a follower
        apply, carries no ts and is folded without a lag sample)."""
        with self._mu:
            cur = self._seen.get(space)
            if cur is not None and cur[0] == int(epoch):
                return cur[1]
            return None
