"""The port's copy of `nebula_tpu/cluster/meta_client.py`, whole.

MetaClient — cached catalog + part map + heartbeat loop.

Analog of the reference's src/clients/meta MetaClient: every process (graphd, storaged, tools) holds
one; it finds the metad leader, keeps a versioned local replica of the
catalog and partition map (refreshed when a heartbeat reply reports a
newer version), and offers the meta operation set as methods.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..graphstore.schema import Catalog
from ..utils import cancel as _cancel
from .meta_service import _pk, _unpk
from .rpc import (RpcClient, RpcConnError, RpcError, deadline_sleep,
                  retry_backoff)


class MetaError(Exception):
    pass


class MetaClient:
    def __init__(self, meta_addrs: List[str], my_addr: str = "",
                 role: str = "client",
                 heartbeat_interval: Optional[float] = None):
        self.meta_addrs = list(meta_addrs)
        self.my_addr = my_addr
        self.role = role
        # this daemon's HTTP admin (webservice) address, carried in the
        # heartbeat so metad's metric federation knows where to scrape
        # (empty = no webservice / not scrapable)
        self.ws_addr = ""
        if heartbeat_interval is None:
            from ..utils.config import get_config
            heartbeat_interval = float(
                get_config().get("heartbeat_interval_secs"))
        self.hb_interval = heartbeat_interval
        self.catalog = Catalog()
        self.part_map: Dict[str, List[List[str]]] = {}
        # space → per-part learner lists: cached alongside
        # the part map but NEVER consulted by routing — a catching-up
        # learner serves no reads and takes no writes until promoted
        self.learner_map: Dict[str, List[List[str]]] = {}
        # (space, pid) → last leader learned from a storaged's
        # "part_leader_changed: <addr>" hint.  An
        # overlay, not an edit of part_map: it survives refresh()
        # overwriting the map (metad only reorders replicas on explicit
        # BALANCE LEADER — an election-driven leader change never
        # reaches the map, so without this every statement would re-walk
        # until the next transfer)
        self._part_hints: Dict[tuple, str] = {}
        self.version = -1
        from ..utils.racecheck import make_lock
        self.lock = make_lock("meta_client")
        self._clients: Dict[str, RpcClient] = {}
        self._leader: Optional[str] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._hb_parts_fn = None          # set by storaged: () -> {space: [pid]}
        self._hb_heat_fn = None           # set by storaged: () -> PartHeat rows
        self._hb_epochs_fn = None         # set by storaged: () -> epoch vector
        self.on_epochs = None             # set by graphd: merged table fold
        self.on_refresh = None            # hook: called after a cache refresh

    # -- leader discovery -------------------------------------------------

    def _client(self, addr: str) -> RpcClient:
        c = self._clients.get(addr)
        if c is None:
            c = self._clients[addr] = RpcClient.from_addr(addr, timeout=10.0,
                                                          retries=0)
        return c

    def call(self, method: str, _retries: int = 6, **params) -> Any:
        """Call the metad leader, following leader hints / re-probing."""
        last = None
        for attempt in range(_retries):
            # deadline budget: a statement-scoped meta call must stop
            # walking when the budget is spent (heartbeat threads carry
            # no context — check() is a no-op there)
            _cancel.check()
            addrs = ([self._leader] if self._leader else []) + \
                [a for a in self.meta_addrs if a != self._leader]
            for addr in addrs:
                try:
                    r = self._client(addr).call(method, **params)
                    self._leader = addr
                    return r
                except RpcError as ex:
                    last = ex
                    msg = str(ex)
                    if msg.startswith("not leader"):
                        # hint grammar: "not leader; leader=<addr>".  A
                        # reply with NO "=" (or an empty hint — election
                        # in flight) must clear the cache and re-probe,
                        # never adopt the message text as an address
                        halves = msg.split("=", 1)
                        hint = halves[1].strip() if len(halves) == 2 \
                            else ""
                        self._leader = hint or None
                        continue
                    raise MetaError(msg) from None
                except RpcConnError as ex:
                    last = ex
                    self._leader = None
                    continue
            # all metads down / electing: jittered exponential backoff
            # (deadline-clamped) instead of a fixed-step herd
            if attempt < _retries - 1:
                from ..utils.stats import stats as _stats
                _stats().inc("meta_leader_walk_retries")
                deadline_sleep(retry_backoff(attempt, base=0.1, cap=1.0))
        raise MetaError(f"no metad leader reachable: {last}")

    def wait_ready(self, timeout: float = 15.0):
        dl = time.monotonic() + timeout
        while time.monotonic() < dl:
            try:
                self.call("meta.ready", _retries=1)
                return
            except MetaError:
                time.sleep(0.1)
        raise MetaError("metad not ready")

    # -- cache ------------------------------------------------------------

    def refresh(self, force: bool = False):
        from ..utils import trace as _trace
        with self.lock:
            ver = None if force else self.version
        with _trace.span("meta:refresh", force=force):
            r = self.call("meta.get_catalog", version=ver)
        changed = r["catalog"] is not None
        with self.lock:
            if changed:
                self.catalog = _unpk(r["catalog"])
                self.part_map = r["part_map"]
                self.learner_map = r.get("learner_map") or {}
            self.version = r["version"]
        if changed and self.on_refresh is not None:
            self.on_refresh()

    def heartbeat_once(self) -> Dict[str, Any]:
        parts = self._hb_parts_fn() if self._hb_parts_fn else {}
        # per-partition heat rides the heartbeat: snapshot()
        # folds the QPS EWMAs forward, so metad's view decays with the
        # heartbeat cadence; an empty/None payload costs nothing
        heat = self._hb_heat_fn() if self._hb_heat_fn else None
        # per-space store epochs ride up (storaged) and the merged
        # cluster table rides every reply down — the fleet
        # cache-coherence plane needs no RPC of its own
        epochs = self._hb_epochs_fn() if self._hb_epochs_fn else None
        r = self.call("meta.heartbeat", host=self.my_addr, role=self.role,
                      parts=parts, ws=self.ws_addr, heat=heat,
                      epochs=epochs)
        if r["version"] != self.version:
            self.refresh(force=True)
        if self.on_epochs is not None and r.get("epochs"):
            try:
                self.on_epochs(r["epochs"])
            except Exception:  # noqa: BLE001 — fold must never kill the hb
                pass
        return r

    def cluster_epochs(self) -> Dict[str, Any]:
        """Pull metad's merged epoch table on demand — the strict
        check-at-admission leg: one round-trip buys leader
        reads exactness instead of the heartbeat-bounded window."""
        return self.call("meta.cluster_epochs").get("epochs") or {}

    def start_heartbeat(self, parts_fn=None, heat_fn=None, epochs_fn=None):
        self._hb_parts_fn = parts_fn
        self._hb_heat_fn = heat_fn
        self._hb_epochs_fn = epochs_fn
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.hb_interval):
                try:
                    self.heartbeat_once()
                except MetaError:
                    pass
        self._hb_thread = threading.Thread(target=loop, daemon=True,
                                           name=f"meta-hb-{self.my_addr}")
        self._hb_thread.start()

    def stop_heartbeat(self):
        self._stop.set()
        if self._hb_thread:
            self._hb_thread.join(timeout=2)

    # -- meta ops ---------------------------------------------------------

    def create_space(self, name: str, **kw):
        r = self.call("meta.create_space", name=name, kw=kw)
        self.refresh(force=True)
        return r

    def drop_space(self, name: str, if_exists: bool = False):
        self.call("meta.drop_space", name=name, if_exists=if_exists)
        self.refresh(force=True)

    def ddl(self, method: str, *args, **kw):
        """create_tag/create_edge/alter_*/drop_*/create_index/drop_index
        with the same signatures as graphstore.schema.Catalog."""
        cmd = {"op": "catalog", "method": method, "args": args, "kw": kw}
        self.call("meta.ddl", cmd64=_pk(cmd))
        self.refresh(force=True)

    def note_part_leader(self, space: str, pid: int, addr: str):
        """Write a learned leader back into the cached part map (as an
        overlay): the walk that discovered a failover pays once, every
        later statement routes straight to the new leader."""
        if not addr or ":" not in addr:
            return
        with self.lock:
            self._part_hints[(space, pid)] = addr

    def parts_of(self, space: str) -> List[List[str]]:
        with self.lock:
            pm = self.part_map.get(space)
            hints = {p: a for (s, p), a in self._part_hints.items()
                     if s == space} if self._part_hints else None
        if pm is None:
            self.refresh(force=True)
            with self.lock:
                pm = self.part_map.get(space)
        if pm is None:
            raise MetaError(f"space `{space}' not found")
        if not hints:
            return pm
        # hint overlay: front-load the learned leader per part.  A hint
        # whose addr left the replica set (balance moved the part) is
        # simply ignored — the map is the membership authority.
        out = []
        for pid, replicas in enumerate(pm):
            a = hints.get(pid)
            if a and a in replicas and replicas[0] != a:
                replicas = [a] + [x for x in replicas if x != a]
            out.append(replicas)
        return out

    def create_session(self, user: str, graphd: str) -> int:
        return self.call("meta.create_session", user=user, graphd=graphd)

    def remove_session(self, sid: int):
        self.call("meta.remove_session", sid=sid)

    def update_session(self, sid: int, **fields):
        self.call("meta.update_session", sid=sid, fields=fields)

    def list_sessions(self):
        return self.call("meta.list_sessions")

    def session_gone(self, sid: int) -> bool:
        try:
            return bool(self.call("meta.session_gone", sid=sid).get("gone"))
        except Exception:  # noqa: BLE001 — old metad: no tombstones
            return False

    def list_hosts(self):
        return self.call("meta.list_hosts")

    def get_config(self, name: Optional[str] = None):
        return self.call("meta.get_config", **({"name": name} if name else {}))

    def set_config(self, name: str, value: Any):
        self.call("meta.set_config", name=name, value=value)

    def submit_job(self, cmd: str, space: Optional[str] = None,
                   graphd: str = "") -> int:
        """graphd: the submitting/executing graphd — recorded in the
        job row at birth so STOP can always route (no window where the
        row has no executor)."""
        return self.call("meta.submit_job", cmd=cmd, space=space,
                         graphd=graphd)

    def update_job(self, jid: int, **fields):
        self.call("meta.update_job", jid=jid, fields=fields)

    def add_hosts_to_zone(self, hosts, zone: str):
        self.call("meta.add_hosts", hosts=list(hosts), zone=zone)

    def drop_zone(self, zone: str):
        self.call("meta.drop_zone", zone=zone)

    def merge_zones(self, zones, into: str):
        self.call("meta.merge_zones", zones=list(zones), into=into)

    def rename_zone(self, old: str, new: str):
        self.call("meta.rename_zone", old=old, new=new)

    def divide_zone(self, zone: str, parts):
        self.call("meta.divide_zone", zone=zone,
                  parts=[[n, list(hs)] for n, hs in parts])

    def drop_hosts(self, hosts):
        self.call("meta.drop_hosts", hosts=list(hosts))

    def list_zones(self):
        return self.call("meta.list_zones")

    def allocate_ids(self, count: int = 1) -> int:
        """Cluster-unique monotonic id range; returns the range start."""
        return self.call("meta.allocate_ids", count=count)["start"]

    # -- balance / repair plane (BALANCE DATA / auto-repair) --

    def set_part_replicas(self, space: str, part: int, replicas):
        self.call("meta.set_part_replicas", space=space, part=part,
                  replicas=list(replicas))
        self.refresh(force=True)

    def learners_of(self, space: str) -> List[List[str]]:
        """Per-part learner lists (cached; padded to the part count)."""
        pm = self.parts_of(space)
        with self.lock:
            lm = self.learner_map.get(space) or []
        return [list(lm[pid]) if pid < len(lm) else []
                for pid in range(len(pm))]

    def set_part_learners(self, space: str, part: int, learners):
        self.call("meta.set_part_learners", space=space, part=part,
                  learners=list(learners))
        self.refresh(force=True)

    def promote_learner(self, space: str, part: int, host: str):
        self.call("meta.promote_learner", space=space, part=part,
                  host=host)
        self.refresh(force=True)

    def list_repairs(self):
        return self.call("meta.list_repairs")

    def transfer_leader(self, space: str, part: int, to: str):
        self.call("meta.transfer_leader", space=space, part=part, to=to)
        self.refresh(force=True)

    def list_jobs(self):
        return self.call("meta.list_jobs")

    def close(self):
        self.stop_heartbeat()
        for c in self._clients.values():
            c.close()
