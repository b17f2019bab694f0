"""The port's copy of `nebula_tpu/graphstore/engine.py`, whole.

DurableEngine — log-structured persistence for a standalone store.

The reference's standalone storaged keeps every part in a RocksDB
instance: WAL for durability, memtable for serving, SST compaction for
bounded recovery (reference: src/kvstore).  This build's serving copy
is the in-memory part
dict (feeding the device CSR snapshot), so the persistent engine keeps
the same LSM shape with those roles reassigned:

    WAL        → journal.wal: every mutation appended as the SAME
                 wire-encoded command tuple the cluster raft log carries
                 (resolved rows — defaults like now() never re-evaluate
                 on replay)
    memtable   → the live SpaceData parts
    SST + compaction → checkpoint/: a full store checkpoint written by
                 compact(), after which the journal truncates; recovery
                 cost is bounded by the data written since the last
                 compaction, not the store's lifetime

`GraphStore(data_dir=...)` recovers in place on open: checkpoint load,
then journal replay, then journaling resumes.  Cluster mode does NOT
use this engine — there, durability is each part's raft WAL + snapshot
(storage_service) — so the command vocabulary being shared is what
keeps the two paths semantically identical.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Optional, Tuple

from ..cluster.wal import Wal
from . import schema_wire

# catalog mutators journaled by the catalog proxy (DDL must replay too —
# a recovered store with data but no schema could not decode it)
CATALOG_MUTATORS = frozenset({
    "create_tag", "create_edge", "alter_tag", "alter_edge",
    "drop_tag", "drop_edge", "create_index", "drop_index",
    "create_fulltext_index", "drop_fulltext_index",
    "add_listener", "remove_listener",
    "create_user", "drop_user", "alter_user", "change_password",
    "grant_role", "revoke_role"})


class JournalingCatalog:
    """Catalog proxy: DDL mutations append to the journal after applying
    (same shape as the cluster's CatalogProxy, pointed at a WAL instead
    of metad).

    Credential ops are journaled in their HASHED form
    (create_user_hashed / set_password_hash) — plaintext passwords must
    never reach a durable log."""

    def __init__(self, inner, engine: "DurableEngine"):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_engine", engine)

    def __getattr__(self, name):
        inner = object.__getattribute__(self, "_inner")
        if name in CATALOG_MUTATORS:
            engine = object.__getattribute__(self, "_engine")

            def call(*args, _name=name, **kw):
                out = getattr(inner, _name)(*args, **kw)
                if _name in ("create_user", "alter_user",
                             "change_password"):
                    uname = args[0]
                    h = inner.get_user(uname).pwd_hash
                    if _name == "create_user":
                        engine.log(("catalog", "create_user_hashed",
                                    [uname, h], {"if_not_exists": True}))
                    else:
                        engine.log(("catalog", "set_password_hash",
                                    [uname, h], {}))
                else:
                    engine.log(("catalog", _name, list(args), kw))
                return out
            return call
        return getattr(inner, name)


class DurableEngine:
    def __init__(self, data_dir: str):
        self.dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.ckpt_dir = os.path.join(data_dir, "checkpoint")
        self.journal = Wal(os.path.join(data_dir, "journal.wal"), sync=True)
        from ..utils.racecheck import make_lock
        self.lock = make_lock("journal")
        self._replaying = False

    # -- write path --------------------------------------------------------

    def log(self, cmd: Tuple):
        if self._replaying:
            return
        with self.lock:
            self.journal.append(self.journal.last_index() + 1, 0,
                                schema_wire.dumps(list(cmd)))

    # -- recovery ----------------------------------------------------------

    def recover_into(self, store) -> int:
        """Checkpoint load + journal replay.  Returns #replayed.

        Crash-safety: the checkpoint carries the journal index it
        covers (journal_upto) — if the process died between writing the
        checkpoint and truncating the journal, the stale prefix is
        SKIPPED by index rather than double-applied (pre-checkpoint DDL
        would otherwise fail on the recovered catalog).  If a crash
        landed between the two checkpoint renames, the previous
        checkpoint survives as checkpoint.old and is used instead."""
        import json
        ckpt = self.ckpt_dir
        if not os.path.exists(os.path.join(ckpt, "manifest.json")) and                 os.path.exists(os.path.join(ckpt + ".old",
                                            "manifest.json")):
            ckpt = ckpt + ".old"
        upto = 0
        if os.path.exists(os.path.join(ckpt, "manifest.json")):
            with open(os.path.join(ckpt, "catalog.bin"), "rb") as f:
                store.catalog = schema_wire.loads(f.read())
            with open(os.path.join(ckpt, "manifest.json")) as f:
                manifest = json.load(f)
            upto = manifest.get("journal_upto", 0)
            for name in sorted(manifest["spaces"]):
                info = manifest["spaces"][name]
                spdir = os.path.join(ckpt, f"space_{info['space_id']}")
                for pid in range(info["partition_num"]):
                    with open(os.path.join(spdir, f"part_{pid}.bin"),
                              "rb") as f:
                        store.install_part_state(name, pid, f.read())
        n = 0
        self._replaying = True
        try:
            first = max(self.journal.first_index(), 1, upto + 1)
            from .schema import SchemaError
            for (idx, _term, data) in self.journal.read_range(
                    first, self.journal.last_index() + 1):
                if idx <= upto:
                    continue
                try:
                    self._apply(store, tuple(schema_wire.loads(data)))
                except SchemaError:
                    # Every journaled DDL op SUCCEEDED when it was
                    # logged; a SchemaError on replay can only mean its
                    # effect is already present — an entry logged while
                    # a concurrent compact() was serializing the catalog
                    # lands in BOTH the checkpoint and the surviving
                    # journal tail.  Skipping is the correct idempotent
                    # resolution (data ops never raise SchemaError).
                    pass
                n += 1
        finally:
            self._replaying = False
        return n

    def _apply(self, store, cmd: Tuple):
        op = cmd[0]
        if op == "catalog":
            _, method, args, kw = cmd
            getattr(store.catalog, method)(*args, **kw)
            return
        if op == "create_space":
            store.create_space(cmd[1], **cmd[2])
            return
        if op == "drop_space":
            store.drop_space(cmd[1], if_exists=True)
            return
        if op == "rebuild_index":
            store.rebuild_index(cmd[1], cmd[2])
            return
        if op == "del_vertex":
            store.apply_delete_vertex(cmd[1], cmd[2])
            return
        if op == "del_vertex_rich":
            store.delete_vertex(cmd[1], cmd[2], with_edges=cmd[3])
            return
        if op == "del_tag":
            store.delete_tag(cmd[1], cmd[2], cmd[3])
            return
        if op == "del_edge":
            store.delete_edge(cmd[1], *cmd[2:])
            return
        if op == "upd_vertex":
            store.apply_update_vertex(cmd[1], *cmd[2:])
            return
        if op == "upd_edge_half":
            store.apply_update_edge_half(cmd[1], *cmd[2:])
            return
        if op == "vertex":
            store.apply_vertex(cmd[1], *cmd[2:])
            return
        if op == "edge_half":
            store.apply_edge_half(cmd[1], *cmd[2:])
            return
        if op == "edge_pair":
            _, space, src_v, etype, dst, rank, row = cmd
            store.apply_edge_half(space, src_v, etype, dst, rank, row, "out")
            store.apply_edge_half(space, src_v, etype, dst, rank, row, "in")
            return
        if op == "upd_edge_pair":
            _, space, src_v, etype, dst, rank, updates = cmd
            store.apply_update_edge_half(space, src_v, etype, dst, rank,
                                         updates, "out")
            store.apply_update_edge_half(space, src_v, etype, dst, rank,
                                         updates, "in")
            return
        if op == "clear_part":
            store.clear_part(cmd[1], cmd[2])
            return
        if op == "clear_space":
            store.clear_space(cmd[1], if_exists=True)
            return
        if op == "repartition":
            store.repartition(cmd[1], cmd[2])
            return
        raise ValueError(f"unknown journal op {op!r}")

    # -- compaction ---------------------------------------------------------

    def compact(self, store) -> int:
        """Write a fresh checkpoint, then truncate the journal — the
        SST-compaction analog; bounds recovery replay.

        LOCK ORDER: writers hold sd.lock then take engine.lock (_log
        inside the mutation's critical section keeps journal order ==
        apply order), so compact must NOT hold engine.lock across
        checkpoint() (which takes sd.lock) — ABBA.  It takes engine.lock
        only for the index capture and the truncation; entries logged
        during the checkpoint keep indices > upto, stay in the journal,
        and re-apply in order on recovery — data ops idempotently, DDL
        ops via recover_into's SchemaError skip (the op's effect is
        already in the checkpoint)."""
        import json
        import shutil
        with self.lock:
            upto = self.journal.last_index()
        tmp = self.ckpt_dir + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        store.checkpoint(tmp)
        # stamp the journal position this checkpoint covers (recovery
        # skips <= upto even if the truncation below never happens)
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath) as f:
            manifest = json.load(f)
        manifest["journal_upto"] = upto
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
        old = self.ckpt_dir + ".old"
        if os.path.isdir(old):
            shutil.rmtree(old)
        if os.path.isdir(self.ckpt_dir):
            os.rename(self.ckpt_dir, old)
        os.rename(tmp, self.ckpt_dir)
        if os.path.isdir(old):
            shutil.rmtree(old)
        with self.lock:
            if upto:
                self.journal.compact_to(upto)
        return upto

    def close(self):
        self.journal.close()
