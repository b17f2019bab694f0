"""The port's copy of `nebula_tpu/cluster/daemons.py`, whole.

Daemon entrypoints — `python -m nebula_tpu_torch.cluster.daemons <role>`.

The GraphDaemon/MetaDaemon/StorageDaemon analog (reference:
src/daemons): flag parsing, service wiring, signal-friendly foreground
run.  One process per role:

    python -m nebula_tpu_torch.cluster.daemons metad    --addr 0.0.0.0:9559 \
        --peers host1:9559,host2:9559,host3:9559 --data-dir /data/meta
    python -m nebula_tpu_torch.cluster.daemons storaged --addr 0.0.0.0:9779 \
        --meta host1:9559 --data-dir /data/storage
    python -m nebula_tpu_torch.cluster.daemons graphd   --addr 0.0.0.0:9669 \
        --meta host1:9559 [--tpu]
"""
from __future__ import annotations

import argparse
import signal
import threading
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="nebula-tpu-daemon")
    ap.add_argument("role", choices=["metad", "storaged", "graphd"])
    ap.add_argument("--addr", required=True, help="host:port to listen on")
    ap.add_argument("--peers", default="", help="metad: comma-sep peer addrs")
    ap.add_argument("--meta", default="", help="comma-sep metad addrs")
    ap.add_argument("--data-dir", default="./data")
    ap.add_argument("--tpu", action="store_true",
                    help="graphd: enable the device execution plane")
    ap.add_argument("--ws-port", type=int, default=-1,
                    help="HTTP admin port (/status /stats /flags); "
                         "-1 = rpc port + 1000, 0 = disabled")
    ap.add_argument("--local-conf", default="",
                    help="gflags-style key=value config file")
    args = ap.parse_args(argv)

    from ..utils.config import get_config
    if args.local_conf:
        get_config().load_file(args.local_conf)
    import logging
    lvl = {0: logging.INFO, 1: logging.WARNING}.get(
        int(get_config().get("minloglevel")), logging.ERROR)
    if int(get_config().get("v")) > 0:
        lvl = logging.DEBUG
    logging.basicConfig(level=lvl,
                        format="%(asctime)s %(levelname).1s %(name)s "
                               "%(message)s")

    from .meta_client import MetaClient
    from .rpc import RpcServer, serve_raft_parts

    host, port = args.addr.rsplit(":", 1)
    server = RpcServer(host, int(port))

    if args.role == "metad":
        from .meta_service import MetaService
        peers = [p for p in args.peers.split(",") if p] or [args.addr]
        svc = MetaService(args.addr, peers, args.data_dir, server=server)
        serve_raft_parts(server, {"meta": svc.raft})
    else:
        metas = [m for m in args.meta.split(",") if m]
        if not metas:
            ap.error(f"{args.role} requires --meta")
        mc = MetaClient(metas, my_addr=args.addr,
                        role="storage" if args.role == "storaged" else "graph")
        mc.wait_ready()
        mc.refresh(force=True)
        if args.role == "storaged":
            from .storage_service import StorageService
            svc = StorageService(args.addr, mc, args.data_dir, server=server)
        else:
            from .graph_service import GraphService
            rt = None
            if args.tpu:
                # the flag keeps the reference's name: the device plane
                # is a GpuRuntime on cuda:0
                from ..gpu.runtime import GpuRuntime
                rt = GpuRuntime()
            svc = GraphService(args.addr, mc, server=server, tpu_runtime=rt)

    server.start()
    web = None
    fed = None
    if args.ws_port != 0:
        from .webservice import WebService
        ws_port = args.ws_port if args.ws_port > 0 else int(port) + 1000
        web = WebService(role=args.role, host=host, port=ws_port)
        if args.role == "metad":
            # metric federation: this metad scrapes every
            # daemon's /metrics (addresses ride the heartbeats) into
            # one labeled /cluster_metrics view
            from .federation import MetricFederator
            fed = MetricFederator(svc, self_ws=web.addr)
            web.providers["/cluster_metrics"] = lambda q: (
                200, fed.render(),
                "text/plain; version=0.0.4; charset=utf-8")
            import json as _json
            web.providers["/federation"] = lambda q: (
                200, _json.dumps(fed.scrape_status(), default=str),
                "application/json")
            # live workload federation: one endpoint answers
            # "what is the whole cluster running right now"
            web.providers["/cluster_queries"] = lambda q: (
                200, _json.dumps(fed.cluster_queries(), default=str),
                "application/json")
            # auto-repair plans: the raft-persisted
            # RepairPlan table (metrics_dump --repairs scrapes this)
            web.providers["/repairs"] = lambda q: (
                200, _json.dumps(svc.rpc_list_repairs({}), default=str),
                "application/json")
            # workload insights federation: every graphd's
            # fingerprint table, per-host + exactly merged
            web.providers["/cluster_statements"] = lambda q: (
                200, _json.dumps(fed.cluster_statements(), default=str),
                "application/json")
            # heat rides the heartbeats, so metad answers hotspots from
            # its own host table — no extra scrape round
            web.providers["/hotspots"] = lambda q: (
                200, _json.dumps(svc.rpc_hotspots({}), default=str),
                "application/json")
        else:
            # tell metad where to scrape us (rides the heartbeat) —
            # set BEFORE svc.start() so the first heartbeat carries it
            mc.ws_addr = web.addr
            import json as _json
            if args.role == "graphd":
                # this graphd's statement fingerprint table
                # — the target of metad's /cluster_statements fan-out
                web.providers["/statements"] = lambda q: (
                    200, _json.dumps(svc.engine.insights.snapshot(),
                                     default=str),
                    "application/json")
            else:
                # this storaged's per-part heat rows (local, unmerged;
                # the cluster-ranked view lives on metad)
                web.providers["/hotspots"] = lambda q: (
                    200, _json.dumps(svc.part_heat.snapshot(),
                                     default=str),
                    "application/json")
        web.start()
    svc.start()
    if fed is not None:
        fed.start()
    # startup object graph (services, raft parts, the device runtime)
    # is permanent — freeze it out of the GC scan set; periodic gen-2
    # collections over it stall queries
    import gc
    gc.collect()
    gc.freeze()
    print(f"nebula-tpu {args.role} serving on {server.addr}"
          + (f" (admin http on {web.addr})" if web else ""), flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    while not stop.is_set():
        time.sleep(0.5)
    if fed is not None:
        fed.stop()
    svc.stop()
    server.stop()
    if web is not None:
        web.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
