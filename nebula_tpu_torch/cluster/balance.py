"""The port's copy of `nebula_tpu/cluster/balance.py`, whole.

BALANCE DATA / BALANCE LEADER — the part-migration orchestrator.

The reference runs balance as a metad job executing a plan of
BalanceTasks (add learner → catch up → member change → remove;
reference: src/meta/processors/job/BalancePlan+BalanceTask).  Same protocol here, driven from the
graphd job manager through meta + storage RPCs — and the
per-part mechanics live in the SHARED resumable membership task engine
(cluster/repair.py), the same one the metad PartSupervisor drives for
automatic replica repair:

  BALANCE DATA, per part (run_membership_change):
    add_learner:  the target joins as a non-voting learner (or as a
                  voter when the part already lost its quorum — the
                  only way to restore electability), storageds
                  reconcile, and the new member catches up from the
                  leader (snapshot install)
    catchup:      poll until its applied index reaches the leader's
                  commit index (`balance_catchup_timeout_secs`)
    promote:      learner → voter (one meta propose)
    remove:       drop the old replica (leadership handed off first
                  when the leader is the one leaving); its storaged
                  stops the raft member and releases the part state

  Every map change is serialized through the metad raft group, and each
  step adds OR removes (never both), so consecutive raft configurations
  always share a quorum.

  BALANCE LEADER: greedy leader spreading — count leaders per alive
  host, transfer from over- to under-loaded replicas.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional

from .repair import (ClientPartOps, MembershipError, find_leader,
                     run_membership_change, transfer_leader_away)


class BalanceError(Exception):
    pass


def _alive_storage(meta) -> List[str]:
    return sorted(h["addr"] for h in meta.list_hosts()
                  if h["role"] == "storage" and h["alive"])


def _zone_map(meta, alive: List[str]) -> Dict[str, str]:
    """host → zone (unzoned alive hosts form singleton zones), matching
    rpc_create_space's placement model."""
    try:
        zones = meta.list_zones()
    except Exception:  # noqa: BLE001 — old metad without zones
        zones = {}
    out: Dict[str, str] = {}
    for z, hs in zones.items():
        for h in hs:
            out[h] = z
    for h in alive:
        out.setdefault(h, f"__host_{h}")
    return out


def _spaces(meta, space: Optional[str]) -> List[str]:
    if space:
        return [space]
    return sorted(n for n in meta.catalog.spaces)


def _ensure_replica(ops, space: str, pid: int, tgt: str,
                    alive: List[str]):
    """Grow the part onto `tgt` via the shared engine (learner →
    catch-up → promote); wraps engine errors in BalanceError so the
    job surface stays stable."""
    try:
        run_membership_change(ops, space, pid, add=tgt, alive=alive)
    except MembershipError as ex:
        raise BalanceError(str(ex)) from None


def _drop_replica(ops, space: str, pid: int, drop: str,
                  alive: List[str]):
    try:
        run_membership_change(ops, space, pid, remove=drop, alive=alive)
    except MembershipError as ex:
        raise BalanceError(str(ex)) from None


def balance_data(store, space: Optional[str] = None,
                 exclude: Optional[List[str]] = None) -> Dict[str, Any]:
    """Heal under-replication (dead hosts), spread parts over new hosts,
    drop dead replicas.  Returns the executed plan.

    `exclude` (BALANCE DATA REMOVE "host"): drain — the listed hosts are
    treated as gone, so their replicas re-home onto the remaining alive
    hosts and the drained copies are dropped; afterwards DROP HOSTS can
    remove them from the cluster.

    Placement is replica-COUNT balanced today.  A load-aware variant
    has its signal ready: per-part heat (read/write QPS EWMAs) from
    `utils.insights.PartHeatTable.heat_of` rides every storaged
    heartbeat and is merged/ranked at metad (`meta.hotspots`, SHOW
    HOTSPOTS) — weigh `load` by part heat instead of part count to
    split hot parts from each other."""
    meta, sc = store.meta, store.sc
    ops = ClientPartOps(meta, sc)
    alive = [h for h in _alive_storage(meta)
             if not exclude or h not in exclude]
    if not alive:
        raise BalanceError("no alive storage hosts")
    plan: List[Dict[str, Any]] = []
    host_zone = _zone_map(meta, alive)
    for sp_name in _spaces(meta, space):
        pm = meta.parts_of(sp_name)
        rf = min(meta.catalog.spaces[sp_name].replica_factor, len(alive))
        load = Counter(r for reps in pm for r in reps if r in alive)
        for h in alive:
            load.setdefault(h, 0)
        # target replicas per host for an even spread
        total = len(pm) * rf
        cap = -(-total // len(alive))       # ceil
        for pid in range(len(pm)):
            replicas = list(meta.parts_of(sp_name)[pid])
            keep = [r for r in replicas if r in alive]
            # ---- heal: fill to rf on least-loaded hosts, preserving
            # the one-replica-per-zone invariant CREATE SPACE set up
            # (healing into an already-covered zone would let a single
            # zone loss take every replica of the part); zone isolation
            # relaxes only when no uncovered zone has a host left
            while len(keep) < rf:
                covered = {host_zone.get(h) for h in keep}
                cands = [h for h in alive if h not in keep
                         and host_zone.get(h) not in covered]
                if not cands:
                    cands = [h for h in alive if h not in keep]
                if not cands:
                    break
                tgt = min(cands, key=lambda h: load[h])
                _ensure_replica(ops, sp_name, pid, tgt, alive)
                keep.append(tgt)
                replicas.append(tgt)
                load[tgt] += 1
                plan.append({"space": sp_name, "part": pid, "op": "add",
                             "host": tgt})
            # ---- migrate off overloaded hosts: same-zone targets
            # first; a cross-zone move is allowed ONLY into a zone the
            # part's other replicas don't already cover — otherwise a
            # degraded zone's load imbalance is tolerated rather than
            # collapsing the one-replica-per-zone invariant
            for src in [r for r in keep if load[r] > cap]:
                same_zone = [h for h in alive
                             if h not in keep and load[h] < cap
                             and host_zone.get(h) == host_zone.get(src)]
                covered_wo_src = {host_zone.get(h) for h in keep
                                  if h != src}
                other = [h for h in alive if h not in keep
                         and load[h] < cap
                         and host_zone.get(h) not in covered_wo_src]
                cands = same_zone or other
                if not cands:
                    continue
                tgt = min(cands, key=lambda h: load[h])
                _ensure_replica(ops, sp_name, pid, tgt, alive)
                replicas.append(tgt)
                keep = [h for h in keep if h != src] + [tgt]
                load[tgt] += 1
                load[src] -= 1
                plan.append({"space": sp_name, "part": pid, "op": "move",
                             "from": src, "to": tgt})
            # ---- remove dead + migrated-away replicas, ONE per step:
            # the raft safety argument (update_peers) needs every pair of
            # consecutive configurations to share a quorum, which single
            # removals guarantee and batch removals do not
            for drop in [r for r in replicas if r not in keep]:
                _drop_replica(ops, sp_name, pid, drop, alive)
                plan.append({"space": sp_name, "part": pid,
                             "op": "shrink", "dropped": drop,
                             "replicas":
                             list(meta.parts_of(sp_name)[pid])})
    return {"plan": plan, "alive_hosts": alive}


def balance_leader(store, space: Optional[str] = None) -> Dict[str, Any]:
    """Spread raft leadership evenly over alive hosts."""
    meta, sc = store.meta, store.sc
    ops = ClientPartOps(meta, sc)
    alive = set(_alive_storage(meta))
    if not alive:
        raise BalanceError("no alive storage hosts")
    transfers: List[Dict[str, Any]] = []
    for sp_name in _spaces(meta, space):
        pm = meta.parts_of(sp_name)
        lead_count: Counter = Counter()
        leaders: Dict[int, Optional[str]] = {}
        for pid, replicas in enumerate(pm):
            cands = [r for r in replicas if r in alive]
            ld = find_leader(ops, cands, sp_name, pid)
            leaders[pid] = ld
            if ld:
                lead_count[ld] += 1
        for h in alive:
            lead_count.setdefault(h, 0)
        cap = -(-len(pm) // len(alive))     # ceil
        for pid, replicas in enumerate(pm):
            ld = leaders[pid]
            cands = [r for r in replicas if r in alive]
            if not cands:
                continue
            if ld is not None and lead_count[ld] <= cap:
                continue
            under = [c for c in cands if c != ld
                     and lead_count[c] < cap]
            if not under:
                continue
            tgt = min(under, key=lambda h: lead_count[h])
            if transfer_leader_away(ops, sp_name, pid, cands, tgt):
                if ld:
                    lead_count[ld] -= 1
                lead_count[tgt] += 1
                transfers.append({"space": sp_name, "part": pid,
                                  "from": ld, "to": tgt})
    return {"transfers": transfers}
