"""The port's copy of `nebula_tpu/exec/scheduler.py`, whole.

DAG scheduler: runs a plan's executors in dependency order.

Analog of the reference's AsyncMsgNotifyBasedScheduler (reference:
src/graph/scheduler).  Plans are
in-process DAGs; each shared node runs exactly once, with per-node
timing/row stats for PROFILE.

Independent branches run CONCURRENTLY on a thread pool (ready-queue
dispatch, the notify-based scheduler's shape) whenever the plan actually
branches and the node work can overlap: cluster-mode executors block on
storage RPCs (socket waits release the GIL), and device-plane nodes
block in jax dispatch.  Chain-shaped plans use the sequential path.
PROFILE runs the SAME schedule as unprofiled runs — `qctx.last_tpu_stats` is thread-local, so parallel
branches attribute device stats to their own node, and ProfileStats
writes are per-node-keyed dict inserts.  The `scheduler_threads` flag
bounds the pool; 0 forces sequential.

Every run also collects an always-on per-node profile (ProfileStats is
cheap: one dict insert per node) plus a per-node CostRecorder that the
RPC layer fills from reply-envelope cost records — the substrate the
flight recorder (utils/flight.py) and cluster-wide PROFILE read.
"""
from __future__ import annotations

import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Dict, List, Optional

from ..core.value import DataSet
from ..query.plan import ExecutionPlan, PlanNode
from .context import ExecutionContext, QueryContext
from .executors import run_node


class ProfileStats:
    """Per-plan-node execution stats.  Safe under the parallel schedule:
    each node runs exactly once, so concurrent record() calls write
    DISTINCT keys (single dict-item writes are atomic under the GIL).

    Besides wall time and rows, a node's row may carry:
      * `remote` — aggregated reply-envelope cost records from every
        RPC the node issued (`remote_us`, `rows`, `bytes_*`,
        `wal_fsyncs`, `dedup_hits`, per-part call counts) — the
        cluster-wide half of PROFILE;
      * `tpu` — the device-plane phase breakdown, plus per-SEGMENT
        rows for fused TpuMatchPipeline nodes (each segment's op,
        wall µs and device dispatch µs individually, not one opaque
        fused node)."""

    def __init__(self):
        self.per_node: Dict[int, Dict] = {}
        self.work = None          # the statement's WorkCounters (engine)

    def record(self, node: PlanNode, us: int, rows: int):
        self.per_node[node.id] = {"kind": node.kind, "exec_us": us, "rows": rows}

    def operators(self) -> List[Dict]:
        """Flight-recorder form: per-operator dicts, plan order not
        guaranteed (keyed rows carry the node id)."""
        return [dict(st, id=nid)
                for nid, st in sorted(self.per_node.items())]

    def describe(self, plan: ExecutionPlan) -> str:
        lines = []

        def visit(n: PlanNode, depth: int):
            st = self.per_node.get(n.id)
            extra = ""
            if st:
                extra = f"  [rows={st['rows']} time={st['exec_us']}us]"
                if "remote" in st:
                    rc = st["remote"]
                    parts = " ".join(f"{k}={rc[k]}" for k in sorted(rc))
                    extra += f" remote={{{parts}}}"
                if "tpu" in st:
                    extra += f" tpu={st['tpu']}"
            lines.append("  " * depth + f"{n.kind}#{n.id}{extra}")
            if st and "segments" in st:
                for seg in st["segments"]:
                    lines.append("  " * (depth + 1)
                                 + f"segment:{seg['op']}"
                                 f"  [rows={seg.get('rows', 0)}"
                                 f" time={seg['us']}us"
                                 f" device={seg.get('device_us', 0)}us]")
            for d in n.deps:
                visit(d, depth + 1)

        visit(plan.root, 0)
        return "\n".join(lines)


class Scheduler:
    def __init__(self, qctx: QueryContext):
        self.qctx = qctx

    def run(self, plan: ExecutionPlan, ectx: Optional[ExecutionContext] = None,
            profile: Optional[ProfileStats] = None) -> DataSet:
        ectx = ectx if ectx is not None else ExecutionContext()
        done: Dict[int, DataSet] = {}
        order: List[PlanNode] = []
        seen = set()

        def topo(n: PlanNode):
            if n.id in seen:
                return
            seen.add(n.id)
            for d in n.deps:
                topo(d)
            order.append(n)

        topo(plan.root)

        # snapshot the submitting thread's trace context once: parallel
        # branches run exec_one on pool threads, which must attribute
        # their spans and work counts to the SAME statement
        from ..utils import cancel as _cancel
        from ..utils import trace
        from ..utils.stats import use_work
        tctx = trace.current_ctx()
        # snapshot the statement's cancel context once, like the trace
        # context: parallel branches run on pool threads, and their RPC
        # hops must clamp to the SAME deadline budget
        c_kill = _cancel.current_kill()
        c_dl = _cancel.current_deadline()

        from ..utils.failpoints import fail as _fail
        from ..utils.workload import use_live
        live = getattr(ectx, "live", None)
        # snapshot the statement's read-consistency override too
        #: a parallel branch's storage reads must run at the
        # same level the submitting thread's use_consistency() installed
        from ..utils import consistency as _consistency
        c_lvl = _consistency.current_override()

        def exec_one(node: PlanNode):
            kill = getattr(ectx, "kill_event", None)
            if kill is not None and kill.is_set():
                from .executors import ExecError
                raise ExecError("query was killed")
            t0 = time.perf_counter()
            # snapshot the thread-local device-stats slot by IDENTITY:
            # a node that dispatched installs a fresh TraverseStats, so
            # `is not prev` attributes it to this node — without
            # clearing the slot, which external consumers (bench, the
            # device-engagement tests) read after the statement
            prev_ts = getattr(self.qctx, "last_tpu_stats", None) \
                if profile is not None else None
            # per-node cost sink: the RPC client folds reply-envelope
            # cost records (and its own call/byte counts) into this
            # while the node's executor runs — even when the node fails,
            # the costs collected so far reach the flight recorder
            from ..utils.stats import CostRecorder, use_cost
            node_cost = CostRecorder() if profile is not None else None
            try:
                with trace.use_ctx(tctx), \
                        _cancel.use_cancel(kill=c_kill, deadline=c_dl), \
                        use_work(getattr(ectx, "work", None)), \
                        use_cost(node_cost), \
                        use_live(live), \
                        _consistency.use_consistency(c_lvl), \
                        trace.span(f"exec:{node.kind}", node=node.id) as rec:
                    # deadline check between plan nodes: a budget spent
                    # in an earlier node must not start the next one
                    _cancel.check()
                    if live is not None:
                        # live workload row: SHOW QUERIES
                        # shows WHICH plan node is running right now
                        live.node_start(node.kind, node.id)
                    # failpoint: delay/fail any statement at a chosen
                    # plan-node kind (stall-watchdog and live-progress
                    # tests arm `exec:node` with key=<kind>)
                    _fail.hit("exec:node", key=node.kind)
                    ds = run_node(node, self.qctx, ectx, plan.space)
                    if rec is not None and ds is not None:
                        # len(ds), not len(ds.rows): a ColumnarDataSet
                        # answers len() from its column buffers without
                        # materializing per-row Python lists (the lazy
                        # result boundary)
                        rec.setdefault("attrs", {})["rows"] = len(ds)
            except BaseException:
                if profile is not None:
                    us = int((time.perf_counter() - t0) * 1e6)
                    profile.record(node, us, 0)
                    if node_cost:
                        profile.per_node[node.id]["remote"] = \
                            node_cost.as_dict()
                raise
            us = int((time.perf_counter() - t0) * 1e6)
            ectx.set_result(node.output_var, ds)
            done[node.id] = ds
            if live is not None:
                live.node_done(len(ds) if ds is not None else 0)
            if profile is not None:
                profile.record(node, us, len(ds) if ds is not None else 0)
                if node_cost:
                    profile.per_node[node.id]["remote"] = \
                        node_cost.as_dict()
                ts = getattr(self.qctx, "last_tpu_stats", None)
                if ts is not None and ts is not prev_ts:
                    # device-plane profile fields (SURVEY §5 tracing):
                    # per-hop expansion sizes + kernel time + buckets
                    profile.per_node[node.id]["tpu"] = {
                        "device_s": round(ts.device_s, 6),
                        "queue_s": round(getattr(ts, "queue_s", 0.0), 6),
                        "put_s": round(ts.put_s, 6),
                        "fetch_s": round(ts.fetch_s, 6),
                        "mat_s": round(ts.mat_s, 6),
                        "hop_edges": ts.hop_edges,
                        "buckets": {"EB": ts.e_cap},
                        "retries": ts.retries,
                        "compiles": getattr(ts, "compiles", 0),
                        "hbm_bytes": getattr(ts, "hbm_bytes", 0),
                    }
                    segs = getattr(ts, "segments", None)
                    if segs:
                        # fused TpuMatchPipeline: each segment's cost
                        # individually, not one opaque node
                        profile.per_node[node.id]["segments"] = segs

        threads = self._pool_size()
        branchy = any(len(n.deps) > 1 for n in order)
        # Sequence nodes order side effects by DFS position only (no DAG
        # edge between prev and next subtrees) — parallel dispatch would
        # break them, so such plans stay sequential
        has_seq = any(n.kind == "Sequence" for n in order)
        if threads > 1 and branchy and not has_seq:
            # PROFILE runs take this path too: the profile
            # must record the schedule real runs use
            from ..utils.stats import stats as _metrics
            _metrics().inc("scheduler_parallel_plans")
            self._run_parallel(order, exec_one, threads)
        else:
            for node in order:
                exec_one(node)
        return done[plan.root.id]

    @staticmethod
    def _pool_size() -> int:
        from ..utils.config import get_config
        try:
            return int(get_config().get("scheduler_threads"))
        except Exception:  # noqa: BLE001 — config not initialized
            return 4

    @staticmethod
    def _run_parallel(order: List[PlanNode], exec_one, threads: int):
        """Ready-queue dispatch: a node is submitted the moment its last
        dependency finishes; independent branches overlap."""
        node_by_id = {n.id: n for n in order}
        # Argument nodes read their producer BY NAME (from_var) with no
        # DAG edge — sequential topo order satisfies it implicitly, the
        # ready-queue must make the edge explicit or the Argument can
        # dispatch before its variable exists
        producer = {n.output_var: n.id for n in order}
        dep_ids: Dict[int, set] = {}
        for n in order:
            ids = {d.id for d in n.deps}
            fv = n.args.get("from_var") if n.args else None
            if fv in producer and producer[fv] != n.id:
                ids.add(producer[fv])
            dep_ids[n.id] = ids
        remaining = {n.id: len(dep_ids[n.id]) for n in order}
        dependents: Dict[int, List[int]] = {n.id: [] for n in order}
        for n in order:
            for d in dep_ids[n.id]:
                dependents[d].append(n.id)
        ready = [n for n in order if remaining[n.id] == 0]
        with ThreadPoolExecutor(max_workers=threads) as pool:
            futures = {pool.submit(exec_one, n): n for n in ready}
            while futures:
                finished, _ = wait(futures, return_when=FIRST_COMPLETED)
                for fut in finished:
                    node = futures.pop(fut)
                    fut.result()        # re-raise executor errors
                    for did in dependents[node.id]:
                        remaining[did] -= 1
                        if remaining[did] == 0:
                            futures[pool.submit(
                                exec_one, node_by_id[did])] = node_by_id[did]
