"""The port's copy of `nebula_tpu/cluster/repair.py`, whole.

Cluster self-healing: the shared resumable membership
task engine + the metad PartSupervisor.

Two consumers drive part membership changes through ONE engine:

  * BALANCE DATA (cluster/balance.py) — operator-triggered, runs on the
    submitting graphd through MetaClient/StorageClient (`ClientPartOps`).
  * auto-repair — the metad leader's PartSupervisor scans host liveness
    against the part map and, when a host stays dead past
    `repair_grace_secs`, drives a raft-persisted RepairPlan through
    `LocalPartOps` (direct proposes + raw storage RPCs).

The engine's phase protocol (each phase idempotent, each adds XOR
removes — consecutive raft configurations always share a quorum):

    add      the target joins as a LEARNER (non-voting: receives
             appends/snapshot install, never counts toward quorum —
             repair can never wedge a live group).  When the part has
             already LOST its voter quorum (a dead voter of a 2-group),
             the target joins as a voter instead: a learner could never
             catch up from a leaderless group, and the single-server
             voter add is what restores electability.
    catchup  poll the target's applied index up to the leader's commit
             index (`balance_catchup_timeout_secs`, live-updatable).
    promote  learner → voter (one meta propose; the voter set grows by
             a member that already holds the log).
    remove   drop the dead/migrated replica from the part map (leader
             handed off first when it is the one leaving).

Crashing between (or inside) any two phases and re-driving from the
recorded phase converges to the same replica set: every phase checks
the current map before mutating.  Failpoint sites `repair:add_learner`,
`repair:catchup`, `repair:promote`, `repair:remove` bracket the phases;
`meta:repair_step` fires before every supervisor-driven phase.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..utils import trace as _trace
from ..utils.config import define_flag, get_config
from ..utils.failpoints import FailpointError, fail
from ..utils.stats import stats

define_flag("repair_enabled", True,
            "metad leader scans host liveness against the part map and "
            "automatically restores full replication when a storaged "
            "stays dead past repair_grace_secs (UPDATE CONFIGS "
            "repair_enabled=false is the operator kill switch; manual "
            "BALANCE DATA keeps working either way)")
define_flag("repair_grace_secs", 60.0,
            "how long a host must stay CONTINUOUSLY dead (no heartbeat "
            "past the liveness horizon) before auto-repair re-replicates "
            "its parts — the hysteresis that keeps a flapping host from "
            "thrashing data moves")
define_flag("repair_max_concurrent", 2,
            "upper bound on concurrently-driven repair plans (each plan "
            "snapshot-installs a whole part onto its target; the limit "
            "caps the catch-up bandwidth repair may take from serving)")
define_flag("repair_scan_interval_secs", 0.5,
            "PartSupervisor scan period on the metad leader")
define_flag("balance_catchup_timeout_secs", 30.0,
            "how long a membership change waits for the new replica's "
            "applied index to reach the leader's commit index before "
            "failing the task — honored by BALANCE DATA and auto-repair "
            "alike, live-updatable via UPDATE CONFIGS")

#: time_to_full_redundancy_s buckets (seconds — snapshot install +
#: catch-up of a whole part, not RPC scale)
REDUNDANCY_BUCKETS_S = (0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
                        300.0, 600.0, 1800.0)

PHASES = ("add_learner", "catchup", "promote", "remove")


class MembershipError(Exception):
    pass


class _Interrupted(Exception):
    """The driving supervisor lost its mandate (deposed / stopping):
    the plan stays RUNNING so the next leader resumes it."""


def catchup_timeout_s() -> float:
    try:
        return max(float(get_config().get("balance_catchup_timeout_secs")),
                   0.1)
    except Exception:  # noqa: BLE001 — config not initialized
        return 30.0


# -- the ops surface the engine drives ---------------------------------------


class PartOps:
    """Meta mutations + storage probes for one consumer of the engine.
    Implementations: ClientPartOps (graphd/balance), LocalPartOps
    (metad supervisor)."""

    def parts_of(self, space: str) -> List[List[str]]:
        raise NotImplementedError

    def learners_of(self, space: str) -> List[List[str]]:
        raise NotImplementedError

    def set_part_replicas(self, space: str, pid: int, replicas):
        raise NotImplementedError

    def set_part_learners(self, space: str, pid: int, learners):
        raise NotImplementedError

    def promote_learner(self, space: str, pid: int, host: str):
        raise NotImplementedError

    def transfer_leader_meta(self, space: str, pid: int, to: str):
        raise NotImplementedError

    def call_host(self, addr: str, method: str, **kw) -> Any:
        raise NotImplementedError

    def reconcile(self, hosts: Iterable[str]):
        """Best-effort storage.reconcile fan-out — hosts may be dead."""
        for h in hosts:
            try:
                self.call_host(h, "storage.reconcile")
            except Exception:  # noqa: BLE001 — host may be mid-death
                pass


class ClientPartOps(PartOps):
    """BALANCE DATA's adapter: MetaClient + StorageClient."""

    def __init__(self, meta, sc):
        self.meta = meta
        self.sc = sc

    def parts_of(self, space):
        return self.meta.parts_of(space)

    def learners_of(self, space):
        return self.meta.learners_of(space)

    def set_part_replicas(self, space, pid, replicas):
        self.meta.set_part_replicas(space, pid, replicas)

    def set_part_learners(self, space, pid, learners):
        self.meta.set_part_learners(space, pid, learners)

    def promote_learner(self, space, pid, host):
        self.meta.promote_learner(space, pid, host)

    def transfer_leader_meta(self, space, pid, to):
        self.meta.transfer_leader(space, pid, to)

    def call_host(self, addr, method, **kw):
        return self.sc._client(addr).call(method, **kw)


class LocalPartOps(PartOps):
    """The metad leader's adapter: meta mutations go straight through
    the local raft group (`_propose`); storage probes use raw per-host
    RPC clients (metad holds no MetaClient of its own)."""

    def __init__(self, svc):
        self.svc = svc
        self._clients: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def parts_of(self, space):
        with self.svc.state_lock:
            pm = self.svc.state.part_map.get(space)
            if pm is None:
                raise MembershipError(f"space `{space}' not found")
            return [list(r) for r in pm]

    def learners_of(self, space):
        with self.svc.state_lock:
            if space not in self.svc.state.part_map:
                raise MembershipError(f"space `{space}' not found")
            return [list(ls) for ls in self.svc.state.learners_of(space)]

    def set_part_replicas(self, space, pid, replicas):
        self.svc._propose({"op": "set_part_replicas", "space": space,
                           "part": pid, "replicas": list(replicas)})

    def set_part_learners(self, space, pid, learners):
        self.svc._propose({"op": "set_part_learners", "space": space,
                           "part": pid, "learners": list(learners)})

    def promote_learner(self, space, pid, host):
        self.svc._propose({"op": "promote_learner", "space": space,
                           "part": pid, "host": host})

    def transfer_leader_meta(self, space, pid, to):
        self.svc._propose({"op": "transfer_leader", "space": space,
                           "part": pid, "to": to})

    def call_host(self, addr, method, **kw):
        from .rpc import RpcClient
        with self._lock:
            c = self._clients.get(addr)
            if c is None:
                c = self._clients[addr] = RpcClient.from_addr(
                    addr, timeout=10.0, retries=0)
        return c.call(method, **kw)

    def close(self):
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass


# -- storage probes ----------------------------------------------------------


def raft_info(ops: PartOps, host: str, space: str, pid: int
              ) -> Optional[Dict]:
    try:
        return ops.call_host(host, "storage.part_raft_info",
                             space=space, part=pid)
    except Exception:  # noqa: BLE001 — host may be mid-death
        return None


def find_leader(ops: PartOps, hosts: Iterable[str], space: str,
                pid: int) -> Optional[str]:
    for h in hosts:
        info = raft_info(ops, h, space, pid)
        if info and info.get("is_leader"):
            return h
    return None


def wait_caught_up(ops: PartOps, host: str, space: str, pid: int,
                   cands: List[str],
                   timeout: Optional[float] = None):
    """Poll the new replica until its applied index reaches the
    leader's commit index as of entry.  The leader's index MUST be
    known — a transient RPC failure must not degrade the target to 0,
    or an empty replica reads as caught up and the shrink phase drops
    the only full copy.  The leader may DIE mid-catchup: re-discover
    its successor among `cands` and resume — a freshly elected
    leader's commit index covers everything the dead one committed."""
    timeout = catchup_timeout_s() if timeout is None else timeout
    dl = time.monotonic() + timeout
    # the catch-up target itself stays a candidate: raft log-
    # completeness can make the NEW replica win the post-crash
    # election, and anchoring on its own commit index is equally safe
    cur: Optional[str] = None
    target = None
    cands = list(dict.fromkeys(list(cands) + [host]))
    while target is None and time.monotonic() < dl:
        li = raft_info(ops, cur, space, pid) if cur else None
        if li is not None and li.get("is_leader", True):
            target = li["commit_index"]
            break
        # named leader dead/deposed: walk the replica set for its
        # successor (an election in flight keeps returning None — poll)
        cur = find_leader(ops, cands, space, pid)
        if cur is None:
            time.sleep(0.05)
    if target is None:
        raise MembershipError(
            f"no reachable leader for {space}/{pid}; cannot establish "
            f"a catch-up target")
    while time.monotonic() < dl:
        info = raft_info(ops, host, space, pid)
        if info and info["last_applied"] >= target:
            return
        time.sleep(0.05)
    raise MembershipError(
        f"replica {host} of {space}/{pid} did not catch up to {target} "
        f"within {timeout:g}s")


def transfer_leader_away(ops: PartOps, space: str, pid: int,
                         hosts: List[str], to: str,
                         timeout: float = 10.0) -> bool:
    """Move raft leadership of the part onto `to` (and reorder the meta
    map leader-first); False when nobody could hand it off."""
    cur = find_leader(ops, hosts, space, pid)
    if cur == to:
        ops.transfer_leader_meta(space, pid, to)
        return True
    if cur is None:
        return False
    try:
        r = ops.call_host(cur, "storage.transfer_part_leader",
                          space=space, part=pid, to=to)
    except Exception:  # noqa: BLE001
        return False
    if not (isinstance(r, dict) and r.get("ok")):
        return False        # definitive refusal — don't poll the timeout
    dl = time.monotonic() + timeout
    while time.monotonic() < dl:
        info = raft_info(ops, to, space, pid)
        if info and info["is_leader"]:
            ops.transfer_leader_meta(space, pid, to)
            return True
        time.sleep(0.05)
    return False


# -- the resumable membership task engine ------------------------------------


def run_membership_change(ops: PartOps, space: str, pid: int,
                          add: Optional[str] = None,
                          remove: Optional[str] = None,
                          alive: Optional[Iterable[str]] = None,
                          start_phase: str = "add_learner",
                          on_phase: Optional[Callable[[str], None]]
                          = None):
    """Drive one part's membership change through the phase protocol.
    `alive`: hosts currently believed live (quorum-path decision +
    reconcile targets).  `start_phase` resumes a half-driven task;
    `on_phase(phase)` is called BEFORE each phase executes (the
    supervisor persists it so a crash re-drives from that phase)."""
    alive_set = set(alive) if alive is not None else None

    def is_alive(h: str) -> bool:
        return alive_set is None or h in alive_set

    try:
        phases = PHASES[PHASES.index(start_phase):]
    except ValueError:
        raise MembershipError(f"unknown phase {start_phase!r}") from None

    for phase in phases:
        if on_phase is not None:
            on_phase(phase)
        if phase == "add_learner" and add is not None:
            fail.hit("repair:add_learner", key=f"{space}/{pid}")
            voters = ops.parts_of(space)[pid]
            if add not in voters:
                live = [v for v in voters if is_alive(v)]
                learners = ops.learners_of(space)[pid]
                use_learner = 2 * len(live) > len(voters)
                if not use_learner:
                    # the liveness view may be pessimistic (post-
                    # election grace, partition): ask the group itself
                    # before resorting to the quorum-restore voter add
                    use_learner = find_leader(ops, voters, space,
                                              pid) is not None
                if use_learner:
                    # a live voter majority exists → a leader does (or
                    # will): the target joins as a LEARNER and can never
                    # wedge the group while it catches up
                    if add not in learners:
                        ops.set_part_learners(space, pid,
                                              learners + [add])
                else:
                    # quorum already lost (e.g. one dead voter of a
                    # 2-group): a learner could never catch up from a
                    # leaderless group — the single-server VOTER add is
                    # what restores electability, and it is quorum-safe
                    # (any old-config majority intersects any new one)
                    ops.set_part_replicas(space, pid,
                                          list(voters) + [add])
                ops.reconcile(sorted(set(
                    [h for h in voters if is_alive(h)] + [add])))
        elif phase == "catchup" and add is not None:
            fail.hit("repair:catchup", key=f"{space}/{pid}")
            # every voter stays a leader candidate (a dead one costs a
            # fast refused connect; a pessimistic liveness view must
            # not hide the real leader from the walk)
            cands = list(ops.parts_of(space)[pid]) + [add]
            wait_caught_up(ops, add, space, pid, cands)
        elif phase == "promote" and add is not None:
            fail.hit("repair:promote", key=f"{space}/{pid}")
            if add in ops.learners_of(space)[pid]:
                with _trace.span("raft:promote_learner", space=space,
                                 part=pid, host=add):
                    ops.promote_learner(space, pid, add)
                ops.reconcile(sorted(set(
                    [h for h in ops.parts_of(space)[pid]
                     if is_alive(h)] + [add])))
        elif phase == "remove" and remove is not None:
            fail.hit("repair:remove", key=f"{space}/{pid}")
            voters = ops.parts_of(space)[pid]
            learners = ops.learners_of(space)[pid]
            if remove in learners:
                ops.set_part_learners(
                    space, pid, [l for l in learners if l != remove])
            if remove in voters:
                keep = [h for h in voters if h != remove]
                if not keep:
                    raise MembershipError(
                        f"refusing to drop the only replica of "
                        f"{space}/{pid}")
                live_keep = [h for h in keep if is_alive(h)] or keep
                leader = find_leader(ops, live_keep, space, pid)
                if leader is None and is_alive(remove):
                    # the leaving replica may still lead: hand off
                    # before the map drops it
                    if not transfer_leader_away(ops, space, pid, voters,
                                                live_keep[0]):
                        raise MembershipError(
                            f"cannot move leadership of {space}/{pid} "
                            f"into the surviving set {keep}")
                    leader = live_keep[0]
                ordered = ([leader] if leader else []) + \
                    [h for h in keep if h != leader]
                ops.set_part_replicas(space, pid, ordered)
                # reconcile the survivors AND the removed host (so it
                # stops its raft member and releases the part state)
                ops.reconcile(sorted(set(live_keep + [remove])))
    return True


# -- the metad-leader supervisor ---------------------------------------------


class PartSupervisor:
    """Scans host liveness × part map on the metad LEADER; when a host
    stays dead past `repair_grace_secs`, creates a raft-persisted
    RepairPlan per under-replicated part and drives it through the
    membership engine.  Plans resume across metad restarts and leader
    failovers: the phase lives in replicated state, every phase is
    idempotent, and a fresh leader's supervisor picks up any RUNNING
    plan it is not already driving."""

    def __init__(self, svc):
        self.svc = svc
        self.ops = LocalPartOps(svc)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._driving: Dict[int, threading.Thread] = {}
        self._mu = threading.Lock()
        # (space, pid) → monotonic not-before for a NEW plan after a
        # failed one (leader-local; a failed plan must not hot-loop)
        self._retry_at: Dict[Tuple[str, int], float] = {}

    # -- lifecycle --------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"part-supervisor-{self.svc.my_addr}")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        with self._mu:
            running = list(self._driving.values())
        for t in running:
            t.join(timeout=2)
        self.ops.close()

    def _interval_s(self) -> float:
        try:
            return max(float(get_config().get(
                "repair_scan_interval_secs")), 0.05)
        except Exception:  # noqa: BLE001
            return 0.5

    def _loop(self):
        while not self._stop.wait(self._interval_s()):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — keep the supervisor alive
                pass

    # -- one scan ---------------------------------------------------------

    def _tick(self):
        svc = self.svc
        if not svc.raft.is_leader():
            # refresh the leadership streak bookkeeping (a later
            # re-election starts a fresh liveness grace) and drop
            # leader-local retry state
            svc._liveness_anchor()
            self._retry_at.clear()
            return
        anchor = svc._liveness_anchor()
        if anchor is None or time.monotonic() < anchor:
            # post-election liveness grace: this leader's view of who
            # is alive is not authoritative yet — neither NEW repairs
            # nor resumed plans may act on it (a resumed plan driven
            # against an all-UNKNOWN view would mis-pick the quorum-
            # restore path)
            return
        liveness = svc.host_liveness()
        with svc.state_lock:
            spaces = {sp: [list(r) for r in pm]
                      for sp, pm in svc.state.part_map.items()}
            learner_maps = {sp: [list(ls) for ls in
                                 svc.state.learners_of(sp)]
                            for sp in spaces}
            repairs = {k: dict(v) for k, v in svc.state.repairs.items()}
            rfs = {sp: svc.state.catalog.spaces[sp].replica_factor
                   for sp in spaces if sp in svc.state.catalog.spaces}
        try:
            grace = max(float(get_config().get("repair_grace_secs")), 0.0)
        except Exception:  # noqa: BLE001
            grace = 60.0
        try:
            enabled = bool(get_config().get("repair_enabled"))
        except Exception:  # noqa: BLE001
            enabled = True
        try:
            max_conc = max(int(get_config().get("repair_max_concurrent")),
                           1)
        except Exception:  # noqa: BLE001
            max_conc = 2

        def status_of(h: str) -> str:
            return liveness.get(h, {}).get("status", "OFFLINE") \
                if h in liveness else "OFFLINE"

        active_keys = {(r["space"], r["part"])
                       for r in repairs.values()
                       if r["status"] == "RUNNING"}
        under = 0
        ripe: List[Tuple[str, int, str]] = []
        now = time.monotonic()
        for sp, pm in spaces.items():
            for pid, reps in enumerate(pm):
                # janitor: a learner on a host dead past the grace is
                # useless (its catch-up can never finish) and would
                # block DROP HOSTS — clear it when no plan owns the part
                stale_l = [l for l in learner_maps[sp][pid]
                           if status_of(l) == "OFFLINE"
                           and liveness.get(l, {}).get("dead_for",
                                                       0.0) >= grace]
                if stale_l and (sp, pid) not in active_keys:
                    try:
                        self.ops.set_part_learners(
                            sp, pid, [l for l in learner_maps[sp][pid]
                                      if l not in stale_l])
                    except Exception:  # noqa: BLE001 — deposed mid-tick
                        return
                dead = [r for r in reps if status_of(r) == "OFFLINE"]
                if not dead:
                    continue
                under += 1
                nb = self._retry_at.get((sp, pid), 0.0)
                if (sp, pid) in active_keys or now < nb:
                    continue
                # hysteresis: the host must have been CONTINUOUSLY dead
                # for the whole grace (a heartbeat resets dead_for)
                past_grace = [r for r in dead
                              if liveness.get(r, {}).get("dead_for",
                                                         0.0) >= grace]
                if past_grace:
                    ripe.append((sp, pid, past_grace[0]))
        stats().gauge("under_replicated_parts", under)

        with self._mu:
            self._driving = {rid: t for rid, t in self._driving.items()
                             if t.is_alive()}
            running = len(self._driving)
            # resume persisted RUNNING plans this leader is not driving
            # (metad restart / leader failover mid-plan) — unless the
            # kill switch is off: a disabled repair plane must not move
            # data, resumed plans included; they stay RUNNING and pick
            # up from their recorded phase when re-enabled
            if enabled:
                for rid, r in sorted(repairs.items()):
                    if running >= max_conc:
                        break
                    if r["status"] != "RUNNING" or rid in self._driving:
                        continue
                    self._spawn(rid, r)
                    running += 1
        if not enabled:
            stats().gauge("repair_tasks_running", running)
            return
        for sp, pid, dead in ripe:
            with self._mu:
                if len(self._driving) >= max_conc:
                    break
            # a part whose LIVE members already satisfy rf (e.g. a
            # crashed task added the target as voter but died before
            # dropping the dead one) needs only the remove leg
            live_members = [r for r in spaces[sp][pid]
                            if liveness.get(r, {}).get("status")
                            == "ONLINE"]
            if len(live_members) >= rfs.get(sp, len(spaces[sp][pid])):
                target = None
            else:
                target = self._pick_target(sp, pid, spaces,
                                           learner_maps, liveness)
                if target is None:
                    continue    # no spare healthy host: stay degraded
            try:
                rid = self.svc._propose({
                    "op": "add_repair", "space": sp, "part": pid,
                    "dead": dead, "target": target, "ts": time.time()})
            except Exception:  # noqa: BLE001 — lost leadership mid-propose
                return
            plan = {"space": sp, "part": pid, "dead": dead,
                    "target": target, "phase": "add_learner",
                    "status": "RUNNING", "created": time.time()}
            with self._mu:
                self._spawn(rid, plan)
        with self._mu:
            stats().gauge("repair_tasks_running",
                          sum(1 for t in self._driving.values()
                              if t.is_alive()))

    def _pick_target(self, space: str, pid: int, spaces, learner_maps,
                     liveness) -> Optional[str]:
        """Best healthy host for the part's new replica: not already a
        member, in a zone the part does not cover when possible, then
        fewest hosted parts (count across spaces, learners included)."""
        reps = spaces[space][pid]
        learners = learner_maps[space][pid]
        # retry affinity: a LIVE learner left behind by a failed or
        # crashed task already holds (part of) the data — finishing its
        # promotion beats starting a fresh copy elsewhere, and keeps
        # retries from stranding learners
        for l in learners:
            if liveness.get(l, {}).get("status") == "ONLINE" \
                    and l not in reps:
                return l
        cands = [h for h, info in liveness.items()
                 if info.get("role") == "storage"
                 and info.get("status") == "ONLINE"
                 and h not in reps and h not in learners]
        if not cands:
            return None
        with self.svc.state_lock:
            zones = {z: list(hs)
                     for z, hs in self.svc.state.zones.items()}
        host_zone: Dict[str, str] = {}
        for z, hs in zones.items():
            for h in hs:
                host_zone[h] = z
        for h in list(liveness):
            host_zone.setdefault(h, f"__host_{h}")
        covered = {host_zone.get(h) for h in reps
                   if liveness.get(h, {}).get("status") == "ONLINE"}
        uncovered = [h for h in cands if host_zone.get(h) not in covered]
        if uncovered:
            cands = uncovered
        load: Dict[str, int] = {h: 0 for h in cands}
        for sp, pm in spaces.items():
            for reps2 in pm:
                for r in reps2:
                    if r in load:
                        load[r] += 1
            for ls in learner_maps[sp]:
                for l in ls:
                    if l in load:
                        load[l] += 1
        return min(sorted(cands), key=lambda h: load[h])

    # -- plan driving -----------------------------------------------------

    def _spawn(self, rid: int, plan: Dict[str, Any]):
        t = threading.Thread(target=self._drive, args=(rid, dict(plan)),
                             daemon=True, name=f"repair-{rid}")
        self._driving[rid] = t
        t.start()

    def _update(self, rid: int, **fields):
        fields.setdefault("updated", time.time())
        self.svc._propose({"op": "update_repair", "rid": rid,
                           "fields": fields})

    def _drive(self, rid: int, plan: Dict[str, Any]):
        svc = self.svc
        sp, pid = plan["space"], plan["part"]

        def on_phase(phase: str):
            if self._stop.is_set() or not svc.raft.is_leader():
                raise _Interrupted
            try:
                if not bool(get_config().get("repair_enabled")):
                    # kill switch flipped mid-plan: stop at the next
                    # phase boundary, leave the plan RUNNING — it
                    # resumes from this phase when re-enabled
                    raise _Interrupted
            except _Interrupted:
                raise
            except Exception:  # noqa: BLE001 — config not initialized
                pass
            fail.hit("meta:repair_step", key=f"{sp}/{pid}|{phase}")
            with _trace.span("meta:repair_step", rid=rid, space=sp,
                             part=pid, phase=phase):
                if plan.get("phase") != phase:
                    self._update(rid, phase=phase)
                    plan["phase"] = phase

        try:
            alive = [h for h, info in svc.host_liveness().items()
                     if info.get("status") == "ONLINE"]
            run_membership_change(
                self.ops, sp, pid, add=plan["target"],
                remove=plan["dead"], alive=alive,
                start_phase=plan.get("phase", "add_learner"),
                on_phase=on_phase)
            self._update(rid, status="DONE", phase="done")
            stats().inc("repair_tasks_done")
            created = float(plan.get("created") or 0.0)
            if created:
                stats().observe("time_to_full_redundancy_s",
                                max(time.time() - created, 0.0),
                                buckets=REDUNDANCY_BUCKETS_S)
        except (FailpointError, _Interrupted):
            # an armed repair:* / meta:repair_step fault, or this
            # supervisor losing its mandate mid-plan: treat like a
            # crash — the plan stays RUNNING and the (possibly new)
            # leader's supervisor re-drives it from the recorded phase
            pass
        except Exception as ex:  # noqa: BLE001 — plan outcome recorded
            self._retry_at[(sp, pid)] = time.monotonic() + \
                max(2.0, 2.0 * self._interval_s())
            if svc.raft.is_leader():
                try:
                    self._update(rid, status="FAILED", error=str(ex))
                    stats().inc("repair_tasks_failed")
                except Exception:  # noqa: BLE001 — deposed mid-update
                    pass
            # deposed: leave RUNNING — the new leader resumes it
        finally:
            with self._mu:
                self._driving.pop(rid, None)
