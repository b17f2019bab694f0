"""The port's copy of `nebula_tpu/exec/jobs.py`, whole.

Job manager + snapshots — the metad JobManager analog
(reference: src/meta/processors/job).

Single-process form: jobs run synchronously and record their status; the
cluster metad wraps this with background scheduling.  Job kinds mirror the
reference: stats, compact (a no-op re-pack host-side), balance data /
balance leader (meaningful in cluster mode; recorded here), ingest.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..core.value import DataSet

class JobStopped(Exception):
    """A task observed its cancel token (STOP JOB) and aborted."""


@dataclass
class Job:
    job_id: int
    command: str
    status: str = "QUEUE"
    start_time: float = 0.0
    stop_time: float = 0.0
    result: Optional[Dict[str, Any]] = None
    space: Optional[str] = None          # RECOVER re-runs in this space
    cancel: Any = None                   # threading.Event (task lifecycle)
    on_start: Any = None                 # fn(job) when a worker picks it up
    on_done: Any = None                  # fn(job) after the worker ends


class JobManager:
    """Async admin-task manager (SURVEY §2 row 16, the AdminTaskManager
    analog): SUBMIT returns the job id immediately; a bounded worker
    pool (flag max_concurrent_admin_jobs) drains the QUEUE — excess
    submissions wait their turn (task throttling), STOP JOB cancels a
    QUEUE'd job outright and interrupts a RUNNING one at its next
    cancel point, and wait() is the test/console convenience for the
    reference TCK's "wait the job to finish" step."""

    def __init__(self):
        from ..utils.racecheck import make_lock
        self.jobs: Dict[int, Job] = {}
        self._ids = itertools.count(1)   # per-manager: deterministic ids
        self._lock = make_lock("job_manager")
        self._queue: list = []           # pending (job, qctx)
        self._running = 0

    @staticmethod
    def _max_concurrent() -> int:
        from ..utils.config import get_config
        try:
            return max(1, int(get_config().get(
                "max_concurrent_admin_jobs")))
        except Exception:  # noqa: BLE001 — config missing in odd embeds
            return 2

    def submit(self, qctx, command: str, space: Optional[str],
               job_id: Optional[int] = None, on_start=None,
               on_done=None) -> Job:
        """Enqueue a job.  `job_id` pins the id (cluster mode: the
        metad-allocated cluster-wide id); `on_start(job)`/`on_done(job)`
        fire from the worker thread (cluster mode: mirror the
        RUNNING/terminal status back to metad's replicated job table)."""
        import threading
        with self._lock:
            jid = job_id if job_id is not None else next(self._ids)
            job = Job(jid, command, space=space,
                      cancel=threading.Event())
            job.on_start = on_start
            job.on_done = on_done
            self.jobs[jid] = job
            self._queue.append((job, qctx))
            self._dispatch_locked()
        return job

    def enqueue_rerun(self, job: Job, qctx):
        """RECOVER JOB: put a FAILED/STOPPED job back on the queue."""
        with self._lock:
            job.status = "QUEUE"
            if job.cancel is not None:
                job.cancel.clear()   # the re-run gets a LIVE cancel token
            self._queue.append((job, qctx))
            self._dispatch_locked()

    def stop(self, job: Job):
        """STOP JOB under the manager lock: purge the queue entry (a
        stale tuple would re-dispatch after RECOVER — double execution)
        and serialize against the QUEUE→RUNNING promotion; a RUNNING
        job only gets its cancel event (aborts at its next cancel
        point)."""
        with self._lock:
            self._queue = [(j, q) for (j, q) in self._queue
                           if j is not job]
            if job.cancel is not None:
                job.cancel.set()
            if job.status != "RUNNING":
                job.status = "STOPPED"
                job.stop_time = time.time()

    def _dispatch_locked(self):
        import threading
        while self._queue and self._running < self._max_concurrent():
            job, qctx = self._queue.pop(0)
            if job.status == "STOPPED":
                continue             # STOP JOB beat the dispatcher
            self._running += 1
            job.status = "RUNNING"
            job.start_time = time.time()
            threading.Thread(target=self._worker, args=(job, qctx),
                             daemon=True,
                             name=f"admin-job-{job.job_id}").start()

    def _worker(self, job: Job, qctx):
        if job.on_start is not None:
            try:
                job.on_start(job)
            except Exception:  # noqa: BLE001 — mirror is best-effort
                pass
        try:
            job.result = self._run(qctx, job.command, job.space, job)
            job.status = "FINISHED"
        except JobStopped:
            job.status = "STOPPED"
            job.result = {"stopped": True}
        except Exception as ex:  # noqa: BLE001 - job errors are recorded
            job.status = "FAILED"
            job.result = {"error": str(ex)}
        finally:
            job.stop_time = time.time()
            if job.on_done is not None:
                try:
                    job.on_done(job)
                except Exception:  # noqa: BLE001 — mirror is best-effort
                    pass
            with self._lock:
                self._running -= 1
                self._dispatch_locked()

    def wait(self, job_id: Optional[int] = None,
             timeout: float = 60.0) -> bool:
        """Block until the job (or ALL jobs) leave QUEUE/RUNNING."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                live = any(
                    (job_id is None or j.job_id == job_id)
                    and j.status in ("QUEUE", "RUNNING")
                    for j in self.jobs.values())
            if not live:
                return True
            time.sleep(0.005)
        return False

    def _run(self, qctx, command: str, space: Optional[str],
             job: Optional[Job] = None) -> Dict[str, Any]:
        token = job.cancel if job is not None else None
        if command.startswith("repartition "):
            # the part split/merge task (SURVEY §2 row 16): re-home the
            # space onto a new partition count; cancellable mid-scan
            if not space:
                raise ValueError("repartition job needs a space")
            if not hasattr(qctx.store, "repartition"):
                raise ValueError(
                    "repartition runs on the standalone store; the "
                    "cluster form needs a metad-orchestrated part-move "
                    "plan (BALANCE DATA) instead")
            n = int(command[len("repartition "):])
            moved = qctx.store.repartition(space, n, cancel=token)
            if moved < 0:
                raise JobStopped()
            return {"moved_vertices": moved, "partition_num": n}
        if command == "stats":
            if not space:
                raise ValueError("stats job needs a space")
            return qctx.store.stats(space)
        if command == "compact":
            # TTL GC — the reference's compaction-filter pass
            removed = 0
            spaces = [space] if space else sorted(
                qctx.store.catalog.spaces)
            for sp in spaces:
                if hasattr(qctx.store, "compact"):
                    removed += qctx.store.compact(sp)
            out = {"compacted": True, "expired_removed": removed}
            if getattr(qctx.store, "_engine", None) is not None:
                # durability leg: checkpoint + journal truncation (the
                # SST-compaction analog, SURVEY §2 row 10)
                out["journal_compacted_to"] = qctx.store.compact_journal()
            return out
        if command in ("balance data", "balance leader") \
                or command.startswith("balance data remove "):
            meta = getattr(qctx.store, "meta", None)
            if meta is not None:        # cluster: run the real plan
                from ..cluster.balance import balance_data, balance_leader
                if command == "balance leader":
                    return balance_leader(qctx.store, space)
                exclude = None
                if command.startswith("balance data remove "):
                    exclude = command[len("balance data remove "):].split(",")
                return balance_data(qctx.store, space, exclude=exclude)
            # standalone: one host owns every part — nothing to move
            if space:
                return {"parts": qctx.store.stats(space)["per_part_edges"]}
            return {}
        if command == "ingest":
            return {}
        if command == "flush":
            # persist in-memory state: a checkpoint + journal truncation
            # (the memtable-flush analog of the reference's FLUSH job)
            if getattr(qctx.store, "_engine", None) is not None:
                return {"journal_compacted_to":
                        qctx.store.compact_journal()}
            return {"flushed": False, "reason": "in-memory store"}
        if command.startswith("rebuild index "):
            if not space:
                raise ValueError("rebuild index job needs a space")
            name = command[len("rebuild index "):]
            return {"entries": qctx.store.rebuild_index(space, name)}
        if command.startswith("rebuild fulltext"):
            if not space:
                raise ValueError("rebuild fulltext job needs a space")
            name = command[len("rebuild fulltext"):].strip()
            names = ([name] if name else
                     [d.name for d in
                      qctx.catalog.fulltext_indexes(space)])
            return {"entries": sum(
                qctx.store.rebuild_fulltext_index(space, n)
                for n in names)}
        raise ValueError(f"unknown job `{command}'")


_snapshots: Dict[str, float] = {}


def job_manager(store) -> JobManager:
    """The store's job manager (created on demand) — store-scoped like
    the catalog, so engines and tests get isolated job state (the
    reference's JobManager lives in each cluster's metad)."""
    mgr = getattr(store, "_job_manager", None)
    if mgr is None:
        mgr = store._job_manager = JobManager()
    return mgr


def _wire_result(result) -> str:
    try:
        import json as _json
        return _json.dumps(result)
    except (TypeError, ValueError):
        return str(result)


def submit_tracked(qctx, command: str, space: Optional[str]) -> Job:
    """Run a job through the local worker pool; in cluster mode the id
    comes from metad's raft-replicated job table (cluster-visible SHOW
    JOBS from any graphd — the reference's metad JobManager) and the
    terminal status is mirrored back on completion."""
    mgr = job_manager(qctx.store)
    cluster = getattr(qctx, "cluster", None)
    if cluster is None:
        return mgr.submit(qctx, command, space)
    # the executor graphd rides in the add_job proposal itself: the row
    # is born with its executor, so STOP can always route
    jid = cluster.submit_job(command, space,
                             graphd=getattr(cluster, "my_addr", ""))

    def on_start(job: Job):
        cluster.update_job(jid, status="RUNNING")

    def on_done(job: Job):
        cluster.update_job(jid, status=job.status,
                           result=_wire_result(job.result))
    return mgr.submit(qctx, command, space, job_id=jid,
                      on_start=on_start, on_done=on_done)


def submit_job(node, qctx) -> DataSet:
    job = submit_tracked(qctx, node.args["job"], node.args.get("space"))
    return DataSet(["New Job Id"], [[job.job_id]])


def stop_job(node, qctx) -> DataSet:
    """STOP JOB <id>: a QUEUE'd job is cancelled outright; a RUNNING
    one gets its cancel event set and aborts at its next cancel point
    (repartition: between source partitions).  Stopping a FINISHED job
    is an error (reference semantics).  In cluster mode the stop routes
    to the EXECUTING graphd named in metad's job table."""
    jid = node.args["job_id"]
    mgr = job_manager(qctx.store)
    job = mgr.jobs.get(jid)
    cluster = getattr(qctx, "cluster", None)
    if job is None and cluster is not None:
        row = next((j for j in cluster.list_jobs() if j["jid"] == jid),
                   None)
        if row is None:
            raise ValueError(f"job {jid} not found")
        if row["status"] == "FINISHED":
            raise ValueError(f"job {jid} already finished")
        addr = row.get("graphd")
        status = None
        if addr:
            from .executors import _graphd_call
            try:
                status = _graphd_call(addr, "graph.stop_job", job_id=jid)
            except Exception:  # noqa: BLE001 — executor down
                status = None
        # Only write a TERMINAL status from the issuer: a reachable
        # executor's running job will mirror its own terminal state via
        # on_done (an issuer-side "RUNNING" write could land after it
        # and wedge the row non-terminal forever).  The STOPPED
        # fallback marks an executor-less/unreachable row recoverable.
        if status in (None, "STOPPED", "FAILED"):
            cluster.update_job(jid, status=status or "STOPPED")
        return DataSet(["Result"], [["Job stopped"]])
    if job is None:
        raise ValueError(f"job {jid} not found")
    if job.status == "FINISHED":
        raise ValueError(f"job {jid} already finished")
    mgr.stop(job)
    if cluster is not None and job.status != "RUNNING":
        # queued-stop never reaches a worker, so no on_done will fire —
        # the issuer owns the terminal write; a RUNNING job's abort is
        # mirrored by its own on_done
        try:
            cluster.update_job(jid, status=job.status)
        except Exception:  # noqa: BLE001
            pass
    return DataSet(["Result"], [["Job stopped"]])


def recover_job(node, qctx) -> DataSet:
    """RECOVER JOB [<id>]: re-queue FAILED/STOPPED jobs (all of them
    when no id is given); returns how many were re-queued.  In cluster
    mode the recovery list comes from metad's table, and THIS graphd
    becomes the executor of each re-run (a dead submitter's jobs are
    re-homed — the reference's job-recovery semantics)."""
    mgr = job_manager(qctx.store)
    jid = node.args.get("job_id")
    cluster = getattr(qctx, "cluster", None)
    if cluster is not None:
        table = cluster.list_jobs()
        rows = [j for j in table
                if j["status"] in ("FAILED", "STOPPED")
                and (jid is None or j["jid"] == jid)]
        if jid is not None and not rows:
            known = {j["jid"]: j for j in table}
            if jid not in known:
                raise ValueError(f"job {jid} not found")
            raise ValueError(
                f"job {jid} is {known[jid]['status']}, not recoverable")
        me = getattr(cluster, "my_addr", "")
        n = 0
        for row in rows:
            local = mgr.jobs.get(row["jid"])
            if local is not None and local.status in ("QUEUE", "RUNNING"):
                # metad says STOPPED (e.g. an issuer's fallback write
                # while this executor was unreachable) but the worker is
                # still live — re-queueing would run the job twice
                continue

            def on_start(job: Job, _jid=row["jid"]):
                cluster.update_job(_jid, status="RUNNING")

            def on_done(job: Job, _jid=row["jid"]):
                cluster.update_job(_jid, status=job.status,
                                   result=_wire_result(job.result))
            cluster.update_job(row["jid"], graphd=me, status="QUEUE")
            if local is not None:
                local.on_start = on_start
                local.on_done = on_done
                mgr.enqueue_rerun(local, qctx)
            else:
                mgr.submit(qctx, row["cmd"], row.get("space"),
                           job_id=row["jid"], on_start=on_start,
                           on_done=on_done)
            n += 1
        return DataSet(["Recovered job num"], [[n]])
    targets = [j for j in mgr.jobs.values()
               if j.status in ("FAILED", "STOPPED")
               and (jid is None or j.job_id == jid)]
    if jid is not None and not targets:
        j = mgr.jobs.get(jid)
        if j is None:
            raise ValueError(f"job {jid} not found")
        raise ValueError(f"job {jid} is {j.status}, not recoverable")
    for j in targets:
        mgr.enqueue_rerun(j, qctx)
    return DataSet(["Recovered job num"], [[len(targets)]])


def show_jobs(node, qctx) -> DataSet:
    jid = node.args.get("job_id")
    cols = ["Job Id", "Command", "Status"]
    cluster = getattr(qctx, "cluster", None)
    if cluster is not None:
        # metad's raft-replicated table: jobs are visible from EVERY
        # graphd, not just the submitter
        rows = [[j["jid"], j["cmd"], j["status"]]
                for j in cluster.list_jobs()
                if jid is None or j["jid"] == jid]
        return DataSet(cols, rows)
    rows = []
    for j in sorted(job_manager(qctx.store).jobs.values(),
                    key=lambda x: x.job_id):
        if jid is not None and j.job_id != jid:
            continue
        rows.append([j.job_id, j.command, j.status])
    return DataSet(cols, rows)


def _backup_dir() -> str:
    from ..utils.config import get_config
    return get_config().get("backup_dir")


def _backup_path(name: str) -> str:
    """backup_dir/<name>, refusing names that escape backup_dir — a
    backquoted identifier may contain ANY character, and DROP BACKUP
    rmtree's the resolved path."""
    import os
    base = _backup_dir()
    if not name or "/" in name or os.sep in name or name in (".", ".."):
        raise ValueError(f"invalid backup name `{name}'")
    path = os.path.join(base, name)
    real = os.path.realpath(path)
    if os.path.basename(real) != name or \
            os.path.dirname(real) != os.path.realpath(base):
        raise ValueError(f"invalid backup name `{name}'")
    return path


def write_backup_meta(path: str, manifest: Dict[str, Any]) -> None:
    """backup.json sidecar — ONE writer for the statement and the
    offline tool so the formats cannot drift."""
    import json
    import os
    with open(os.path.join(path, "backup.json"), "w") as f:
        json.dump({"created": time.time(),
                   "spaces": sorted(manifest["spaces"])}, f)


def iter_backups(base: str):
    """Yield (name, info) for every backup under `base`, skipping
    non-backup dirs — shared by SHOW BACKUPS and the offline tool."""
    import json
    import os
    if not os.path.isdir(base):
        return
    for name in sorted(os.listdir(base)):
        meta = os.path.join(base, name, "backup.json")
        if not os.path.isfile(meta):
            continue
        with open(meta) as f:
            yield name, json.load(f)


def create_backup(qctx, name: Optional[str]) -> DataSet:
    """CREATE BACKUP [AS <name>]: a restorable full-store checkpoint
    (catalog + every space's part states) under backup_dir — the
    statement surface of the reference's BR backup leg.  Online-safe:
    checkpoint() takes each space's lock for a point-in-time cut."""
    import os
    if not hasattr(qctx.store, "checkpoint"):
        raise ValueError("BACKUP needs a standalone store; back up a "
                         "cluster with the offline tool per storaged "
                         "(tools/backup.py), like the reference's br")
    if name is None:
        ts = int(time.time())
        seq = 0
        while True:
            name = f"BACKUP_{ts}" + (f"_{seq}" if seq else "")
            if not os.path.isdir(os.path.join(_backup_dir(), name)):
                break
            seq += 1
    path = _backup_path(name)
    if os.path.isdir(path):
        raise ValueError(f"backup `{name}' already exists")
    manifest = qctx.store.checkpoint(path)
    write_backup_meta(path, manifest)
    return DataSet(["Name"], [[name]])


def list_backups() -> DataSet:
    rows = [[name, "VALID", ",".join(info.get("spaces") or []),
             int(info.get("created", 0))]
            for name, info in iter_backups(_backup_dir())]
    return DataSet(["Name", "Status", "Spaces", "Create Time"], rows)


def drop_backup(qctx, name: str) -> DataSet:
    import os
    import shutil
    path = _backup_path(name)
    if not os.path.isdir(path):
        raise ValueError(f"backup `{name}' not found")
    shutil.rmtree(path)
    return DataSet()


def restore_backup(qctx, name: str) -> DataSet:
    import os
    path = _backup_path(name)
    if not os.path.isdir(path):
        raise ValueError(f"backup `{name}' not found")
    if not hasattr(qctx.store, "restore_backup"):
        raise ValueError("RESTORE BACKUP needs a standalone store; "
                         "restore a cluster offline with "
                         "tools/backup.py per storaged, like the "
                         "reference's br restore")
    out = qctx.store.restore_backup(path)
    return DataSet(["Restored Spaces"], [[",".join(out["spaces"])]])


def create_snapshot(qctx) -> DataSet:
    """CREATE SNAPSHOT: a durable on-disk checkpoint of every space
    (catalog + per-part state + manifest) under the snapshot_dir flag."""
    import os

    from ..utils.config import get_config
    name = f"SNAPSHOT_{int(time.time())}_{len(_snapshots)}"
    base = get_config().get("snapshot_dir")
    path = os.path.join(base, name)
    if hasattr(qctx.store, "checkpoint"):
        qctx.store.checkpoint(path)
    _snapshots[name] = time.time()
    return DataSet(["Name"], [[name]])


def drop_snapshot_dir(name: str):
    import os
    import shutil

    from ..utils.config import get_config
    path = os.path.join(get_config().get("snapshot_dir"), name)
    if os.path.isdir(path):
        shutil.rmtree(path)


def list_snapshots() -> DataSet:
    return DataSet(["Name", "Status", "Hosts"],
                   [[n, "VALID", "local"] for n in sorted(_snapshots)])


def drop_snapshot(qctx, name: str) -> DataSet:
    _snapshots.pop(name, None)
    drop_snapshot_dir(name)
    return DataSet()
