"""The port's copy of `nebula_tpu/cluster/meta_service.py`, whole.

Meta service — the cluster brain (metad).

Catalog DDL, space/partition map with host placement, host liveness from
heartbeats, session registry, dynamic config, cluster jobs.  Analog of
the reference's src/meta processors + JobManager + ActiveHostsMan,
with one device-plane twist: the part map doubles as the CHIP
PLACEMENT map (partition → mesh slot) that the device plane pins from (SURVEY §2 row 17).

State mutations ride a Raft group over the metad peers ("meta" group).
Commands, snapshots, and client-supplied DDL blobs are JSON wire
payloads (graphstore/schema_wire.py) — never pickle: anything that can
reach an RPC port could otherwise execute arbitrary code on unpickle.
Every non-deterministic input (host placement, timestamps) is resolved
by the leader BEFORE propose and embedded in the command, so replica
replay is deterministic.

Liveness (ActiveHostsMan) is deliberately NOT replicated: each metad
tracks heartbeat arrival times in memory, like the reference.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

from ..graphstore import schema_wire
from ..graphstore.schema import Catalog, SchemaError
from .raft import RaftPart, RaftTransport
from .repair import PartSupervisor
from .rpc import RpcError, RpcServer

HB_EXPIRE_S = 10.0


def _hb_expire_s() -> float:
    """Liveness horizon — flag-tunable so failover tests don't wait 10s
    of wall clock for a killed host to read as dead."""
    try:
        from ..utils.config import get_config
        return float(get_config().get("host_hb_expire_secs"))
    except Exception:  # noqa: BLE001 — config not initialized
        return HB_EXPIRE_S

# catalog methods a DDL command may invoke on replicas
_CATALOG_METHODS = frozenset({
    "create_tag", "create_edge", "alter_tag", "alter_edge",
    "drop_tag", "drop_edge", "create_index", "drop_index",
    "create_fulltext_index", "drop_fulltext_index",
    "add_listener", "remove_listener",
    "create_user_hashed", "set_password_hash", "change_password_hashed",
    "drop_user", "grant_role", "revoke_role"})


def _translate_cred_cmd(cmd):
    """Rewrite legacy plaintext credential DDL to the hashed form —
    applied BEFORE propose (so new raft entries never carry plaintext)
    and again at apply time (so WAL entries written by older builds
    still replay instead of silently dropping accounts)."""
    from ..graphstore.schema import hash_password
    m = cmd.get("method")
    if m not in ("create_user", "alter_user", "change_password"):
        return cmd
    args = list(cmd.get("args", ()))
    kw = dict(cmd.get("kw", {}))
    out = dict(cmd)
    if m == "create_user":
        ine = kw.pop("if_not_exists", False) or             (len(args) > 2 and bool(args[2]))
        out.update(method="create_user_hashed",
                   args=[args[0], hash_password(args[1])],
                   kw={"if_not_exists": ine})
    elif m == "alter_user":
        out.update(method="set_password_hash",
                   args=[args[0], hash_password(args[1])], kw={})
    else:
        out.update(method="change_password_hashed",
                   args=[args[0], hash_password(args[1]),
                         hash_password(args[2])], kw={})
    return out


def _pk(obj) -> str:
    """JSON-encode a schema/command payload for an RPC string field."""
    return json.dumps(schema_wire.to_jso(obj), separators=(",", ":"))


def _unpk(s: str):
    return schema_wire.from_jso(json.loads(s))


class MetaState:
    """The replicated state machine (deterministic apply)."""

    def __init__(self):
        self.catalog = Catalog()
        # space name → [ [replica addrs...] per part ]; [0] is the leader
        self.part_map: Dict[str, List[List[str]]] = {}
        # space name → [ [learner addrs...] per part ] — catching-up
        # replicas: they ride replication but are invisible
        # to routing (parts_of serves voters only) and to quorum until
        # promote_learner moves them into the part map
        self.learner_map: Dict[str, List[List[str]]] = {}
        # rid → repair plan row (the raft-persisted RepairPlan of the
        # PartSupervisor: phase/status survive metad restarts and
        # leader failovers, so a half-driven repair resumes)
        self.repairs: Dict[int, Dict[str, Any]] = {}
        self.next_repair = 1
        self.sessions: Dict[int, Dict[str, Any]] = {}
        self.next_session = 1
        # bounded tombstones of removed sids: KILL SESSION
        # from any coordinator must be idempotent — the second kill
        # (or a kill racing the owner's death/signout) finds the row
        # gone and needs to distinguish "already killed" (quiet
        # success) from "never existed" (error)
        self.removed_sessions: List[int] = []
        self.configs: Dict[str, Any] = {}
        self.jobs: Dict[int, Dict[str, Any]] = {}
        self.next_job = 1
        # zone → member hosts (replica placement isolation, SURVEY §2
        # row 17); hosts outside any zone placement-wise form singleton
        # zones of their own
        self.zones: Dict[str, List[str]] = {}
        # segment ID allocator (the metad ID service): monotonically
        # increasing, raft-replicated, never reused
        self.next_alloc_id = 1
        self.version = 0

    def snapshot(self) -> bytes:
        return schema_wire.dumps(dict(self.__dict__))

    def restore(self, data: bytes):
        self.__dict__.update(schema_wire.loads(data))

    def apply(self, cmd: Dict[str, Any]):
        op = cmd["op"]
        if op == "catalog":
            cmd = _translate_cred_cmd(cmd)
            if cmd["method"] not in _CATALOG_METHODS:
                raise RpcError(f"bad catalog method {cmd['method']!r}")
            out = getattr(self.catalog, cmd["method"])(
                *cmd.get("args", ()), **cmd.get("kw", {}))
            out = None          # schema objects don't cross the wire here
        else:
            out = getattr(self, "_ap_" + op)(cmd)
        self.version += 1
        return out

    def _ap_create_space(self, c):
        sp = self.catalog.create_space(c["name"], **c["kw"])
        self.part_map.setdefault(c["name"], c["assignment"])
        return sp.space_id

    def _ap_drop_space(self, c):
        self.catalog.drop_space(c["name"], if_exists=c["if_exists"])
        self.part_map.pop(c["name"], None)
        self.learner_map.pop(c["name"], None)

    def _ap_create_session(self, c):
        sid = self.next_session
        self.next_session += 1
        self.sessions[sid] = {"user": c["user"], "graphd": c["graphd"],
                              "created": c["ts"], "space": None}
        return sid

    def _ap_update_session(self, c):
        s = self.sessions.get(c["sid"])
        if s:
            s.update(c["fields"])

    def _ap_remove_session(self, c):
        if self.sessions.pop(c["sid"], None) is not None:
            self.removed_sessions.append(c["sid"])
            del self.removed_sessions[:-512]

    def _ap_set_config(self, c):
        self.configs[c["name"]] = c["value"]

    def _ap_add_job(self, c):
        jid = self.next_job
        self.next_job += 1
        self.jobs[jid] = {"cmd": c["cmd"], "space": c.get("space"),
                          "graphd": c.get("graphd", ""),
                          "status": "QUEUE", "ts": c["ts"], "result": None}
        return jid

    def _ap_update_job(self, c):
        j = self.jobs.get(c["jid"])
        if j:
            j.update(c["fields"])

    def _ap_transfer_leader(self, c):
        pm = self.part_map.get(c["space"])
        if pm and 0 <= c["part"] < len(pm):
            replicas = pm[c["part"]]
            if c["to"] in replicas:
                replicas.remove(c["to"])
                replicas.insert(0, c["to"])

    def _ap_add_zone_hosts(self, c):
        z = self.zones.setdefault(c["zone"], [])
        for h in c["hosts"]:
            for other in self.zones.values():
                if h in other:
                    other.remove(h)
            if h not in z:
                z.append(h)

    def _ap_drop_zone(self, c):
        if c["zone"] not in self.zones:
            raise RpcError(f"zone `{c['zone']}' not found")
        self.zones.pop(c["zone"])

    def _ap_merge_zones(self, c):
        """MERGE ZONE a,b INTO z: union the member hosts, drop sources.
        The target may be one of the sources or a new zone."""
        for z in c["zones"]:
            if z not in self.zones:
                raise RpcError(f"zone `{z}' not found")
        members: List[str] = []
        for z in c["zones"]:
            for h in self.zones.pop(z):
                if h not in members:
                    members.append(h)
        tgt = self.zones.setdefault(c["into"], [])
        for h in members:
            if h not in tgt:
                tgt.append(h)

    def _ap_rename_zone(self, c):
        if c["old"] not in self.zones:
            raise RpcError(f"zone `{c['old']}' not found")
        if c["new"] in self.zones:
            raise RpcError(f"zone `{c['new']}' already exists")
        self.zones[c["new"]] = self.zones.pop(c["old"])

    def _ap_divide_zone(self, c):
        """DIVIDE ZONE z INTO z1 (hosts) z2 (hosts): the target host
        lists must partition z's members EXACTLY (reference semantics —
        a divide can neither drop nor import hosts)."""
        zone = c["zone"]
        if zone not in self.zones:
            raise RpcError(f"zone `{zone}' not found")
        parts = [(n, list(hs)) for n, hs in c["parts"]]
        names = [n for n, _ in parts]
        if len(set(names)) != len(names):
            raise RpcError("duplicate target zone name in DIVIDE ZONE")
        if any(not hs for _, hs in parts):
            raise RpcError("DIVIDE ZONE target zones must be non-empty")
        for n in names:
            if n != zone and n in self.zones:
                raise RpcError(f"zone `{n}' already exists")
        claimed: List[str] = []
        for _, hs in parts:
            claimed.extend(hs)
        members = self.zones[zone]
        if sorted(claimed) != sorted(members):
            raise RpcError(
                f"DIVIDE ZONE host lists must partition `{zone}' exactly "
                f"(zone has {sorted(members)}, got {sorted(claimed)})")
        self.zones.pop(zone)
        for n, hs in parts:
            self.zones[n] = list(hs)

    def _ap_drop_hosts(self, c):
        """DROP HOSTS: remove hosts from placement metadata.  Refused
        while any part replica still lives on the host — BALANCE DATA
        REMOVE must drain it first (reference semantics)."""
        for h in c["hosts"]:
            for sp, pm in self.part_map.items():
                for pid, reps in enumerate(pm):
                    if h in reps:
                        raise RpcError(
                            f"host {h} still holds {sp}/part {pid}; "
                            f"run BALANCE DATA REMOVE first")
            for sp, lm in self.learner_map.items():
                for pid, ls in enumerate(lm):
                    if h in ls:
                        raise RpcError(
                            f"host {h} is still a learner of {sp}/part "
                            f"{pid}; wait for the repair to finish")
        for h in c["hosts"]:
            for hs in self.zones.values():
                if h in hs:
                    hs.remove(h)

    def _ap_allocate_ids(self, c):
        start = self.next_alloc_id
        self.next_alloc_id += int(c["count"])
        return start

    def _ap_set_part_replicas(self, c):
        """BALANCE DATA membership step: adopt a new replica list for one
        part.  The orchestrator only ever proposes add-then-remove (one
        side per step), so consecutive configurations share a quorum."""
        pm = self.part_map.get(c["space"])
        if pm is None or not (0 <= c["part"] < len(pm)):
            raise RpcError(f"no part {c['space']}/{c['part']}")
        pm[c["part"]] = list(c["replicas"])
        # a host that became a voter can never linger as a learner
        lm = self.learner_map.get(c["space"])
        if lm and 0 <= c["part"] < len(lm):
            lm[c["part"]] = [l for l in lm[c["part"]]
                             if l not in c["replicas"]]

    def learners_of(self, space: str) -> List[List[str]]:
        """Per-part learner lists, padded to the part count (spaces
        created before the learner plane existed have no entry)."""
        pm = self.part_map.get(space)
        if pm is None:
            return []
        lm = self.learner_map.setdefault(space, [])
        while len(lm) < len(pm):
            lm.append([])
        return lm

    def _ap_set_part_learners(self, c):
        """Membership-change step: adopt a new learner list
        for one part.  Learners never affect quorum, so this step is
        always safe to (re)propose — the idempotency anchor of the
        resumable task engine's add phase."""
        pm = self.part_map.get(c["space"])
        if pm is None or not (0 <= c["part"] < len(pm)):
            raise RpcError(f"no part {c['space']}/{c['part']}")
        lm = self.learners_of(c["space"])
        lm[c["part"]] = [l for l in c["learners"]
                         if l not in pm[c["part"]]]

    def _ap_promote_learner(self, c):
        """Promote a caught-up learner to voter as ONE deterministic
        state change: leave the learner list, join the replica list.
        The voter set grows by a member that already holds the log, so
        the old and new configurations share a quorum."""
        pm = self.part_map.get(c["space"])
        if pm is None or not (0 <= c["part"] < len(pm)):
            raise RpcError(f"no part {c['space']}/{c['part']}")
        lm = self.learners_of(c["space"])
        host = c["host"]
        if host not in lm[c["part"]] and host not in pm[c["part"]]:
            raise RpcError(
                f"{host} is not a learner of {c['space']}/{c['part']}")
        lm[c["part"]] = [l for l in lm[c["part"]] if l != host]
        if host not in pm[c["part"]]:
            pm[c["part"]].append(host)

    def _ap_add_repair(self, c):
        rid = self.next_repair
        self.next_repair += 1
        self.repairs[rid] = {
            "space": c["space"], "part": c["part"], "dead": c["dead"],
            "target": c["target"], "phase": c.get("phase", "add_learner"),
            "status": "RUNNING", "created": c["ts"], "updated": c["ts"],
            "error": None}
        return rid

    def _ap_update_repair(self, c):
        r = self.repairs.get(c["rid"])
        if r:
            r.update(c["fields"])


class MetaService:
    """One metad: raft member + RPC surface."""

    def __init__(self, my_addr: str, peers: List[str], data_dir: str,
                 transport: Optional[RaftTransport] = None,
                 server: Optional[RpcServer] = None):
        self.my_addr = my_addr
        self.peers = peers
        self.state = MetaState()
        from ..utils.racecheck import make_lock
        self.state_lock = make_lock("meta_state")
        # addr → {"role", "last_hb" (monotonic), "parts": {space: [pids]}}
        self.active_hosts: Dict[str, Dict[str, Any]] = {}
        # merged cluster epoch vector: space → {storaged:
        # [boot, epoch, bump_ts]}.  Leader-local like liveness/heat —
        # deliberately NOT raft-replicated; a fresh leader rebuilds it
        # from the next storaged heartbeat wave, and the graphd-side
        # fold is per-host-boot monotonic so the brief hole can only
        # delay invalidations, never resurrect a retired cache key.
        self.cluster_epochs_tbl: Dict[str, Dict[str, list]] = {}
        self._epochs_lock = threading.Lock()
        # post-election liveness grace: liveness is
        # leader-local, so a FRESH metad leader knows no heartbeats —
        # every host would read dead until they re-arrive.  Until one
        # full heartbeat interval of CONTINUOUS leadership has elapsed,
        # silent hosts are UNKNOWN (not OFFLINE): never declared dead,
        # never repaired against.  (term, leader-since monotonic).
        self._leader_streak: Optional[tuple] = None

        if transport is None:
            from .rpc import RpcRaftTransport
            transport = RpcRaftTransport()
        self.raft = RaftPart(
            "meta", my_addr, peers, transport, data_dir,
            apply_cb=self._apply, snapshot_cb=self._snap,
            restore_cb=self._restore)
        self._apply_result: Dict[int, Any] = {}

        self.server = server
        if server is not None:
            server.service_role = "metad"
            server.register_service(self, prefix="meta.")

        # automatic replica repair: scans liveness × part map
        # on the leader, drives raft-persisted RepairPlans
        self.supervisor = PartSupervisor(self)

    # -- raft plumbing ----------------------------------------------------

    def _apply(self, idx: int, data: bytes):
        cmd = schema_wire.loads(data)
        with self.state_lock:
            try:
                self._apply_result[idx] = ("ok", self.state.apply(cmd))
            except Exception as ex:  # noqa: BLE001 — deterministic failure
                self._apply_result[idx] = ("err", str(ex))
            if len(self._apply_result) > 4096:
                for k in sorted(self._apply_result)[:2048]:
                    self._apply_result.pop(k, None)

    def _snap(self) -> bytes:
        with self.state_lock:
            return self.state.snapshot()

    def _restore(self, data: bytes):
        with self.state_lock:
            self.state.restore(data)

    def start(self):
        self.raft.start()
        self.supervisor.start()

    def stop(self):
        self.supervisor.stop()
        self.raft.stop()

    def _propose(self, cmd: Dict[str, Any]):
        if not self.raft.is_leader():
            raise RpcError(f"not leader; leader={self.raft.leader_id or ''}")
        idx = self.raft.propose(schema_wire.dumps(cmd))
        if idx is None:
            # lost leadership mid-propose — redirect like any follower
            raise RpcError(f"not leader; leader={self.raft.leader_id or ''}")
        res = self._apply_result.get(idx)
        if res and res[0] == "err":
            raise RpcError(res[1])
        return res[1] if res else None

    # -- RPC handlers (rpc_* → "meta.*") ----------------------------------

    def rpc_ready(self, p):
        return {"leader": self.raft.is_leader(),
                "leader_hint": self.raft.leader_id}

    def _require_leader(self):
        if not self.raft.is_leader():
            raise RpcError(f"not leader; leader={self.raft.leader_id or ''}")

    def rpc_heartbeat(self, p):
        # liveness must live on the leader — it feeds placement decisions
        # (create_space host assignment); clients follow the hint
        self._require_leader()
        host, role = p["host"], p["role"]
        self.active_hosts[host] = {
            "role": role, "last_hb": time.monotonic(),
            "parts": p.get("parts", {}),
            # webservice addr for metric federation scrapes
            "ws": p.get("ws", ""),
            # per-partition heat rows: storaged's PartHeat
            # snapshot rides every heartbeat; rpc_hotspots merges them
            "heat": p.get("heat") or []}
        # fold the host's per-space store epochs into the merged table
        #: same boot → max-merge, new boot → replace.  The
        # merged table rides EVERY heartbeat reply (graphd and storaged
        # alike), so cache coherence needs no RPC of its own.
        with self._epochs_lock:
            for space, ent in (p.get("epochs") or {}).items():
                try:
                    boot, epoch = ent[0], int(ent[1])
                except (TypeError, ValueError, IndexError):
                    continue
                hosts = self.cluster_epochs_tbl.setdefault(space, {})
                cur = hosts.get(host)
                if cur is None or cur[0] != boot or epoch > int(cur[1]):
                    hosts[host] = [boot, epoch,
                                   ent[2] if len(ent) > 2 else None]
            merged = {sp: dict(hosts)
                      for sp, hosts in self.cluster_epochs_tbl.items()}
        with self.state_lock:
            return {"version": self.state.version,
                    "leader": self.raft.is_leader(),
                    "epochs": merged}

    def rpc_cluster_epochs(self, p):
        """On-demand merged epoch table — the strict check-at-admission
        leg of leader-consistency cached reads and tooling."""
        with self._epochs_lock:
            return {"epochs": {sp: dict(hosts) for sp, hosts
                               in self.cluster_epochs_tbl.items()}}

    def _grace_window_s(self) -> float:
        """How long a fresh leader withholds OFFLINE verdicts: one full
        heartbeat interval — every live host has beaten by then."""
        try:
            from ..utils.config import get_config
            return max(float(get_config().get("heartbeat_interval_secs")),
                       0.05)
        except Exception:  # noqa: BLE001 — config not initialized
            return 1.0

    def _liveness_anchor(self) -> Optional[float]:
        """Monotonic instant this metad's liveness view became
        authoritative: leadership start + one grace window.  None while
        not leading.  Before the anchor, a silent host is UNKNOWN; a
        host's dead-clock can never start earlier than the anchor."""
        if not self.raft.is_leader():
            self._leader_streak = None
            return None
        term = self.raft.current_term
        streak = self._leader_streak
        if streak is None or streak[0] != term:
            streak = self._leader_streak = (term, time.monotonic())
        return streak[1] + self._grace_window_s()

    def host_liveness(self) -> Dict[str, Dict[str, Any]]:
        """addr → {role, status ONLINE|UNKNOWN|OFFLINE, parts, ws,
        dead_for}: the union of heartbeating hosts and every host the
        part/learner/zone maps reference — a fresh leader must LIST the
        hosts it has never heard from (as UNKNOWN), not forget them."""
        now = time.monotonic()
        exp = _hb_expire_s()
        anchor = self._liveness_anchor()
        out: Dict[str, Dict[str, Any]] = {}
        # snapshot: concurrent rpc_heartbeat handlers insert keys while
        # the supervisor iterates (dict-changed-size RuntimeError)
        for a, h in list(self.active_hosts.items()):
            out[a] = {"role": h["role"], "parts": h["parts"],
                      "ws": h.get("ws", ""), "last_hb": h["last_hb"]}
        with self.state_lock:
            placed = {r for pm in self.state.part_map.values()
                      for reps in pm for r in reps}
            placed |= {l for lm in self.state.learner_map.values()
                       for ls in lm for l in ls}
            placed |= {h for hs in self.state.zones.values() for h in hs}
        for a in placed:
            out.setdefault(a, {"role": "storage", "parts": {},
                               "ws": "", "last_hb": None})
        for a, h in out.items():
            hb = h.pop("last_hb")
            if hb is not None and now - hb < exp:
                h["status"], h["dead_for"] = "ONLINE", 0.0
                continue
            # silent.  Its dead-clock starts when the heartbeat horizon
            # passed — but never before the liveness anchor (a fresh
            # leader's grace): continuity of death, not of suspicion.
            dead_since = (hb + exp) if hb is not None else None
            if anchor is None:
                # not leading: no authority to call anyone dead
                h["status"], h["dead_for"] = "UNKNOWN", 0.0
                continue
            dead_since = max(dead_since if dead_since is not None
                             else anchor, anchor)
            if now < dead_since:
                h["status"], h["dead_for"] = "UNKNOWN", 0.0
            else:
                h["status"] = "OFFLINE"
                h["dead_for"] = now - dead_since
        return out

    def rpc_list_hosts(self, p):
        # liveness is leader-local: a follower's view is empty/stale,
        # so it redirects the client to the leader like rpc_heartbeat
        # (a fresh leader reports silent hosts as UNKNOWN, never DEAD,
        # until one heartbeat interval of leadership passed)
        self._require_leader()
        return [{"addr": a, "role": h["role"],
                 "alive": h["status"] == "ONLINE",
                 "status": h["status"],
                 "parts": h["parts"], "ws": h.get("ws", "")}
                for a, h in sorted(self.host_liveness().items())]

    def rpc_hotspots(self, p):
        """Cluster-wide per-partition heat map: merge the
        PartHeat rows the storaged heartbeats carry, rank by load and
        annotate each part with its placement (leader = replicas[0] of
        the part map) — the SHOW HOTSPOTS backend and the read side of
        heat-driven balancing."""
        self._require_leader()
        from ..utils.insights import merge_heat_snapshots
        per_host = {a: h.get("heat") or []
                    for a, h in self.active_hosts.items()
                    if h["role"] == "storage"}
        rows = merge_heat_snapshots(per_host)
        with self.state_lock:
            pm = {sp: [list(r) for r in parts]
                  for sp, parts in self.state.part_map.items()}
        for r in rows:
            reps = pm.get(r["space"], [])
            pid = r["part"]
            r["replicas"] = reps[pid] if pid < len(reps) else []
            r["leader"] = r["replicas"][0] if r["replicas"] else ""
        return rows

    def storage_hosts(self) -> List[str]:
        now = time.monotonic()
        exp = _hb_expire_s()
        return sorted(a for a, h in self.active_hosts.items()
                      if h["role"] == "storage"
                      and now - h["last_hb"] < exp)

    def rpc_create_space(self, p):
        self._require_leader()
        kw = p["kw"]
        partition_num = int(kw.get("partition_num", 8))
        replica = int(kw.get("replica_factor", 1))
        hosts = self.storage_hosts()
        if not hosts:
            raise RpcError("no active storage hosts registered")
        if replica > len(hosts):
            raise RpcError(f"replica_factor {replica} > {len(hosts)} hosts")
        # leader resolves placement; replicas replay it verbatim.  This
        # list IS the chip-placement map for device-pinned spaces.
        # Zone-aware spreading: when zones exist, a part's replicas land
        # in DISTINCT zones (unzoned hosts count as singleton zones), so
        # a zone loss takes at most one replica of any part.
        with self.state_lock:
            zones = {z: [h for h in hs if h in hosts]
                     for z, hs in self.state.zones.items()}
        zoned = {h for hs in zones.values() for h in hs}
        for h in hosts:
            if h not in zoned:
                zones[f"__host_{h}"] = [h]
        zone_names = sorted(z for z, hs in zones.items() if hs)
        if replica > len(zone_names):
            # zone isolation unsatisfiable — fall back to host spreading
            assignment = [[hosts[(pid + r) % len(hosts)]
                           for r in range(replica)]
                          for pid in range(partition_num)]
        else:
            assignment = []
            for pid in range(partition_num):
                reps = []
                for r in range(replica):
                    zn = zones[zone_names[(pid + r) % len(zone_names)]]
                    # decorrelated intra-zone pick: pid % len(zn) would
                    # rotate in lockstep with the zone rotation, starving
                    # some hosts of leaders (reps[0]) entirely
                    reps.append(zn[(pid // len(zone_names)) % len(zn)])
                assignment.append(reps)
        return self._propose({"op": "create_space", "name": p["name"],
                              "kw": kw, "assignment": assignment})

    def rpc_drop_space(self, p):
        return self._propose({"op": "drop_space", "name": p["name"],
                              "if_exists": p.get("if_exists", False)})

    def rpc_ddl(self, p):
        """DDL: {"cmd64": wire-JSON {"op":"catalog","method":...,args,kw}}."""
        cmd = _unpk(p["cmd64"])
        if isinstance(cmd, dict):
            cmd = _translate_cred_cmd(cmd)
        if not isinstance(cmd, dict) or cmd.get("op") != "catalog" or \
                cmd.get("method") not in _CATALOG_METHODS:
            raise RpcError(f"bad ddl command {cmd.get('method') if isinstance(cmd, dict) else cmd!r}")
        # pre-validate on the leader for a clean error before consensus
        # (wire round-trip = deep copy of the catalog)
        with self.state_lock:
            probe = schema_wire.from_jso(schema_wire.to_jso(self.state.catalog))
        try:
            getattr(probe, cmd["method"])(*cmd.get("args", ()),
                                          **cmd.get("kw", {}))
        except (SchemaError, KeyError, ValueError, TypeError) as ex:
            raise RpcError(str(ex)) from None
        return self._propose(cmd)

    def rpc_get_catalog(self, p):
        with self.state_lock:
            if p.get("version") == self.state.version:
                return {"version": self.state.version, "catalog": None,
                        "part_map": None}
            return {"version": self.state.version,
                    "catalog": _pk(self.state.catalog),
                    "part_map": self.state.part_map,
                    "learner_map": self.state.learner_map}

    def rpc_part_map(self, p):
        with self.state_lock:
            pm = self.state.part_map.get(p["space"])
            if pm is None:
                raise RpcError(f"space `{p['space']}' not found")
            return pm

    def rpc_create_session(self, p):
        return self._propose({"op": "create_session", "user": p["user"],
                              "graphd": p["graphd"], "ts": time.time()})

    def rpc_update_session(self, p):
        return self._propose({"op": "update_session", "sid": p["sid"],
                              "fields": p["fields"]})

    def rpc_remove_session(self, p):
        return self._propose({"op": "remove_session", "sid": p["sid"]})

    def rpc_list_sessions(self, p):
        with self.state_lock:
            return [{"sid": k, **v}
                    for k, v in sorted(self.state.sessions.items())]

    def rpc_session_gone(self, p):
        """True iff `sid` WAS a session and has been removed — the
        idempotent-kill predicate (double KILL SESSION from any
        coordinator succeeds quietly; a garbage sid still errors)."""
        with self.state_lock:
            return {"gone": p["sid"] in self.state.removed_sessions}

    def rpc_set_config(self, p):
        return self._propose({"op": "set_config", "name": p["name"],
                              "value": p["value"]})

    def rpc_get_config(self, p):
        with self.state_lock:
            if "name" in p:
                return self.state.configs.get(p["name"])
            return dict(self.state.configs)

    def rpc_submit_job(self, p):
        return self._propose({"op": "add_job", "cmd": p["cmd"],
                              "space": p.get("space"),
                              "graphd": p.get("graphd", ""),
                              "ts": time.time()})

    def rpc_update_job(self, p):
        return self._propose({"op": "update_job", "jid": p["jid"],
                              "fields": p["fields"]})

    def rpc_list_jobs(self, p):
        with self.state_lock:
            return [{"jid": k, **v}
                    for k, v in sorted(self.state.jobs.items())]

    def rpc_transfer_leader(self, p):
        return self._propose({"op": "transfer_leader", "space": p["space"],
                              "part": p["part"], "to": p["to"]})

    def rpc_add_hosts(self, p):
        """ADD HOSTS ... INTO ZONE z: assign hosts to a placement zone
        (moves them out of any previous zone).  Hosts must be
        `host:port` — a malformed entry would raft-replicate verbatim
        and break every later SHOW ZONES."""
        hosts = list(p["hosts"])
        for h in hosts:
            bad = ":" not in h
            if not bad:
                try:
                    int(h.rsplit(":", 1)[1])
                except ValueError:
                    bad = True
            if bad:
                raise RpcError(f"bad host `{h}' (want host:port)")
        return self._propose({"op": "add_zone_hosts", "zone": p["zone"],
                              "hosts": hosts})

    def rpc_drop_zone(self, p):
        return self._propose({"op": "drop_zone", "zone": p["zone"]})

    def rpc_merge_zones(self, p):
        return self._propose({"op": "merge_zones", "zones": list(p["zones"]),
                              "into": p["into"]})

    def rpc_divide_zone(self, p):
        return self._propose({"op": "divide_zone", "zone": p["zone"],
                              "parts": [[n, list(hs)]
                                        for n, hs in p["parts"]]})

    def rpc_rename_zone(self, p):
        return self._propose({"op": "rename_zone", "old": p["old"],
                              "new": p["new"]})

    def rpc_drop_hosts(self, p):
        with self.state_lock:
            zoned = {h for hs in self.state.zones.values() for h in hs}
        for h in p["hosts"]:
            if h not in self.active_hosts and h not in zoned:
                raise RpcError(f"host {h} not found")
        out = self._propose({"op": "drop_hosts", "hosts": list(p["hosts"])})
        # liveness is leader-local (not raft state): forget the host so
        # SHOW HOSTS stops listing it
        for h in p["hosts"]:
            self.active_hosts.pop(h, None)
        return out

    def rpc_list_zones(self, p):
        with self.state_lock:
            return {z: list(hs) for z, hs in self.state.zones.items()}

    def rpc_allocate_ids(self, p):
        """Segment ID allocation (the metad ID service): returns the
        start of a [start, start+count) range unique across the cluster
        lifetime — raft-serialized, never reused."""
        start = self._propose({"op": "allocate_ids",
                               "count": int(p.get("count", 1))})
        return {"start": start, "count": int(p.get("count", 1))}

    def rpc_set_part_replicas(self, p):
        return self._propose({"op": "set_part_replicas",
                              "space": p["space"], "part": p["part"],
                              "replicas": p["replicas"]})

    # -- repair plane: learners + raft-persisted plans ---------

    def rpc_set_part_learners(self, p):
        return self._propose({"op": "set_part_learners",
                              "space": p["space"], "part": p["part"],
                              "learners": p["learners"]})

    def rpc_promote_learner(self, p):
        return self._propose({"op": "promote_learner",
                              "space": p["space"], "part": p["part"],
                              "host": p["host"]})

    def rpc_part_learners(self, p):
        with self.state_lock:
            if p["space"] not in self.state.part_map:
                raise RpcError(f"space `{p['space']}' not found")
            return [list(ls) for ls in
                    self.state.learners_of(p["space"])]

    def rpc_list_repairs(self, p):
        with self.state_lock:
            return [{"rid": k, **v}
                    for k, v in sorted(self.state.repairs.items())]
