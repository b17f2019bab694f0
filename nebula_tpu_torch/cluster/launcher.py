"""The port's copy of `nebula_tpu/cluster/launcher.py`, whole.

LocalCluster — a whole cluster in one process.

The MockCluster analog (reference: src/mock/MockCluster + the pytest
launcher tests/common/nebula_service.py): real RpcServers on ephemeral localhost ports, real raft
between them, N metad × M storaged × K graphd, used by integration
tests, the console (--addr), and as the template for real deployments
(daemons.py runs the same services standalone).

`tpu_runtime` keeps the reference's name and takes the port's device
plane: `LocalCluster(tpu_runtime=GpuRuntime())` serves the graphds'
fused statements on cuda:0 (`GpuRuntime(device="cpu")` runs the
kernels' plain versions), each pinning the space from the storageds'
bulk export.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import List, Optional

from .client import GraphClient
from .graph_service import GraphService
from .meta_client import MetaClient
from .meta_service import MetaService
from .rpc import RpcServer, serve_raft_parts
from .storage_service import StorageService


class LocalCluster:
    def __init__(self, n_meta: int = 1, n_storage: int = 2, n_graph: int = 1,
                 data_dir: Optional[str] = None, tpu_runtime=None):
        self.data_dir = data_dir or tempfile.mkdtemp(prefix="nebula_tpu_")
        self.meta_servers: List[RpcServer] = []
        self.metads: List[MetaService] = []
        self.storage_servers: List[RpcServer] = []
        self.storageds: List[StorageService] = []
        self.graph_servers: List[RpcServer] = []
        self.graphds: List[GraphService] = []
        self.meta_clients: List[MetaClient] = []

        # -- metad quorum --
        servers = [RpcServer() for _ in range(n_meta)]
        meta_addrs = [s.addr for s in servers]
        for i, srv in enumerate(servers):
            ms = MetaService(srv.addr, meta_addrs,
                             os.path.join(self.data_dir, f"meta{i}"),
                             server=srv)
            serve_raft_parts(srv, {"meta": ms.raft})
            srv.start()
            ms.start()
            self.meta_servers.append(srv)
            self.metads.append(ms)
        self.meta_addrs = meta_addrs
        self._wait_meta_leader()

        # -- storaged --
        for i in range(n_storage):
            srv = RpcServer()
            mc = MetaClient(meta_addrs, my_addr=srv.addr, role="storage",
                            heartbeat_interval=0.2)
            mc.wait_ready()
            mc.refresh(force=True)
            ss = StorageService(srv.addr, mc,
                                os.path.join(self.data_dir, f"storage{i}"),
                                server=srv)
            srv.start()
            ss.start()
            mc.heartbeat_once()
            self.storage_servers.append(srv)
            self.storageds.append(ss)
            self.meta_clients.append(mc)

        # -- graphd --
        for i in range(n_graph):
            srv = RpcServer()
            mc = MetaClient(meta_addrs, my_addr=srv.addr, role="graph",
                            heartbeat_interval=0.2)
            mc.wait_ready()
            mc.refresh(force=True)
            gs = GraphService(srv.addr, mc, server=srv,
                              tpu_runtime=tpu_runtime)
            srv.start()
            gs.start()
            self.graph_servers.append(srv)
            self.graphds.append(gs)
            self.meta_clients.append(mc)

    def _wait_meta_leader(self, timeout: float = 10.0):
        dl = time.monotonic() + timeout
        while time.monotonic() < dl:
            if any(m.raft.is_leader() for m in self.metads):
                return
            time.sleep(0.02)
        raise RuntimeError("metad leader election timed out")

    @property
    def graph_addr(self) -> str:
        return self.graph_servers[0].addr

    @property
    def graph_addrs(self) -> List[str]:
        return [s.addr for s in self.graph_servers]

    def client(self, user: str = "root", password: str = "nebula",
               graphd: int = 0) -> GraphClient:
        host, port = self.graph_servers[graphd].addr.rsplit(":", 1)
        c = GraphClient(host, int(port))
        c.authenticate(user, password)
        return c

    def fleet_client(self, user: str = "root", password: str = "nebula"
                     ) -> GraphClient:
        """A failover-capable client holding EVERY graphd endpoint
       : coordinator selection + transparent E_SESSION_MOVED
        / crash failover per the GraphClient fleet contract."""
        c = GraphClient(self.graph_addrs)
        c.authenticate(user, password)
        return c

    def stop_graphd(self, i: int):
        """Hard-stop one graphd (coordinator-crash injection): raw
        connection resets for its clients, sessions adoptable by
        siblings from the metad-replicated table."""
        self.graphds[i].stop()
        self.graph_servers[i].stop()

    def drain_graphd(self, i: int, timeout_s: Optional[float] = None) -> int:
        """Graceful stop of one graphd (planned restart): refuse new
        statements with E_SESSION_MOVED + sibling hint, let in-flight
        ones finish, then stop.  Returns sessions handed off."""
        n = self.graphds[i].drain(timeout_s)
        self.stop_graphd(i)
        return n

    def add_storaged(self) -> StorageService:
        """Join a new storage host to the running cluster (the balance
        test's expansion scenario)."""
        i = len(self.storageds)
        srv = RpcServer()
        mc = MetaClient(self.meta_addrs, my_addr=srv.addr, role="storage",
                        heartbeat_interval=0.2)
        mc.wait_ready()
        mc.refresh(force=True)
        ss = StorageService(srv.addr, mc,
                            os.path.join(self.data_dir, f"storage{i}"),
                            server=srv)
        srv.start()
        ss.start()
        mc.heartbeat_once()
        self.storage_servers.append(srv)
        self.storageds.append(ss)
        self.meta_clients.append(mc)
        return ss

    def stop_storaged(self, i: int):
        """Hard-stop one storage host (crash injection for balance /
        failover tests)."""
        self.storageds[i].stop()
        self.storage_servers[i].stop()

    def stop_metad(self, i: int):
        """Hard-stop one metad (leader-kill injection for the repair /
        failover tests — the surviving quorum elects a successor)."""
        self.metads[i].stop()
        self.meta_servers[i].stop()

    def meta_leader_index(self) -> int:
        """Index of the metad currently leading the meta group (-1 when
        the group is mid-election)."""
        for i, m in enumerate(self.metads):
            if m.raft.is_leader():
                return i
        return -1

    def reconcile_storage(self):
        """Force every storaged to (re)create raft groups for its parts —
        tests call this right after CREATE SPACE instead of waiting a
        heartbeat round."""
        for mc in self.meta_clients:
            mc.refresh(force=True)
        for ss in self.storageds:
            ss.reconcile_parts()

    def stop(self):
        for gs in self.graphds:
            gs.stop()
        for ss in self.storageds:
            ss.stop()
        for ms in self.metads:
            ms.stop()
        for srv in (self.graph_servers + self.storage_servers
                    + self.meta_servers):
            srv.stop()
