"""The port's copy of `nebula_tpu/utils/config.py`, whole.

Typed config registry — the gflags analog.

Reference behavior (gflags `DEFINE_*` + etc/*.conf + meta-managed config
+ live `/flags` mutation) as one
layered registry:

    defaults  <  config file (`key=value` lines, `#` comments)
              <  environment (NEBULA_<UPPER_NAME>)
              <  dynamic (live /flags PUT, meta config push)

Flags are declared near their use via define_flag(); lookups are
`get_config().get("name")`.  Unknown names raise — typos surface
immediately, like gflags.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass
class FlagDef:
    name: str
    default: Any
    ftype: type
    help: str = ""
    mutable: bool = True          # may /flags or meta change it live?


class ConfigError(Exception):
    pass


def _parse(ftype: type, raw: str) -> Any:
    if ftype is bool:
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise ConfigError(f"bad bool {raw!r}")
    return ftype(raw)


class Config:
    def __init__(self):
        self.defs: Dict[str, FlagDef] = {}
        self.file_layer: Dict[str, Any] = {}
        self.dynamic_layer: Dict[str, Any] = {}
        self.lock = threading.RLock()
        self.listeners: list = []      # fn(name, value) on dynamic change

    def define(self, name: str, default: Any, help: str = "",
               ftype: Optional[type] = None, mutable: bool = True):
        with self.lock:
            if name in self.defs:
                return                 # idempotent re-import
            self.defs[name] = FlagDef(name, default,
                                      ftype or type(default), help, mutable)

    def load_file(self, path: str):
        """gflags-style `key=value` lines (also accepts `--key=value`)."""
        with open(path) as f:
            for ln in f:
                ln = ln.strip()
                if not ln or ln.startswith("#"):
                    continue
                if ln.startswith("--"):
                    ln = ln[2:]
                if "=" not in ln:
                    raise ConfigError(f"bad config line: {ln!r}")
                k, v = ln.split("=", 1)
                k, v = k.strip(), v.strip()
                d = self.defs.get(k)
                if d is None:
                    raise ConfigError(f"unknown flag `{k}' in {path}")
                with self.lock:
                    self.file_layer[k] = _parse(d.ftype, v)

    def get(self, name: str) -> Any:
        d = self.defs.get(name)
        if d is None:
            raise ConfigError(f"unknown flag `{name}'")
        with self.lock:
            if name in self.dynamic_layer:
                return self.dynamic_layer[name]
        env = os.environ.get("NEBULA_" + name.upper())
        if env is not None:
            return _parse(d.ftype, env)
        with self.lock:
            if name in self.file_layer:
                return self.file_layer[name]
        return d.default

    def check(self, name: str, value: Any) -> Any:
        """Validate name + coerce value WITHOUT applying (lets callers
        make multi-key updates atomic).  Wrong-typed values are rejected
        — a poisoned flag would break every later reader."""
        d = self.defs.get(name)
        if d is None:
            raise ConfigError(f"unknown flag `{name}'")
        if not d.mutable:
            raise ConfigError(f"flag `{name}' is not mutable at runtime")
        if isinstance(value, str) and d.ftype is not str:
            return _parse(d.ftype, value)
        if d.ftype is float and isinstance(value, int) \
                and not isinstance(value, bool):
            return float(value)
        if d.ftype is bool and not isinstance(value, bool):
            raise ConfigError(f"flag `{name}' expects bool, got "
                              f"{type(value).__name__}")
        if d.ftype is int and isinstance(value, bool):
            raise ConfigError(f"flag `{name}' expects int, got bool")
        if not isinstance(value, d.ftype):
            raise ConfigError(f"flag `{name}' expects "
                              f"{d.ftype.__name__}, got "
                              f"{type(value).__name__}")
        return value

    def set_dynamic(self, name: str, value: Any):
        self.set_dynamic_many({name: value})

    def set_dynamic_many(self, updates: Dict[str, Any]):
        """Atomic multi-key dynamic update: EVERY key is validated and
        coerced before ANY is applied — a rejected update means nothing
        changed (the PUT /flags and UPDATE CONFIGS contract; one bad
        flag in a batch must not half-apply an overload-survival
        tuning).  Listeners fire once per key, after the whole batch
        is visible, so a listener reading a sibling key (the admission
        drain kick) sees the NEW values."""
        parsed = {k: self.check(k, v) for k, v in updates.items()}
        with self.lock:
            self.dynamic_layer.update(parsed)
            listeners = list(self.listeners)
        for fn in listeners:
            for k, v in parsed.items():
                fn(k, v)

    def all_values(self) -> Dict[str, Any]:
        return {n: self.get(n) for n in sorted(self.defs)}


_global = Config()


def get_config() -> Config:
    return _global


def define_flag(name: str, default: Any, help: str = "",
                mutable: bool = True):
    _global.define(name, default, help, mutable=mutable)
    return name


# -- core flags (mirroring the reference's .conf.default tunables) ---------
define_flag("slow_query_threshold_us", 500_000,
            "queries slower than this land in the slow log")
define_flag("heartbeat_interval_secs", 1.0,
            "meta heartbeat period for graphd/storaged")
define_flag("query_timeout_secs", 300.0,
            "statement deadline budget: propagated (and decremented) "
            "across every RPC hop of the statement; exceeding it "
            "surfaces E_QUERY_TIMEOUT.  0 disables")
define_flag("session_idle_timeout_secs", 28800,
            "idle sessions are reaped after this")
define_flag("max_match_hops", 12, "safety cap for unbounded MATCH *")
define_flag("minloglevel", 0, "log severity threshold")
define_flag("v", 0, "verbose log level")
define_flag("enable_authorize", False, "require password auth in graphd")
define_flag("tpu_enable", True, "allow the device execution plane")
define_flag("tpu_init_edge_budget", 2048,
            "initial per-block edge budget (power of two)")
define_flag("scheduler_threads", 4,
            "plan-branch concurrency; 0/1 = sequential")
define_flag("max_concurrent_admin_jobs", 2,
            "admin-job worker slots; queued jobs wait (task throttling, "
            "the AdminTaskManager analog)")
define_flag("host_hb_expire_secs", 10.0,
            "heartbeat age after which a host reads as dead")
define_flag("tpu_match_device", True,
            "run MATCH Traverse expansion on the device plane")
define_flag("tpu_degree_split_threshold", 0,
            "degree above which a supernode's adjacency is split "
            "across parts at pin time (0 = off); drops the per-part "
            "expansion ceiling toward the mean on skewed graphs")
define_flag("enable_query_tracing", True,
            "record a distributed trace per statement (SHOW TRACES / "
            "GET /traces); off = no spans ride the RPC envelope, which "
            "also makes wire-byte work counters deterministic for "
            "regression probes")
define_flag("tpu_profiler_dir", "",
            "when set, wrap every device kernel run in a profiler "
            "trace written under this directory (SURVEY §5 tracing)")
define_flag("storage_read_capacity_qps", 0,
            "per-storaged read admission rate (reads/s, token bucket; "
            "0 = unlimited).  Reads beyond the rate are shed with the "
            "structured E_OVERLOAD + retry-after contract, so "
            "follower-readable clients walk to a replica with spare "
            "capacity instead of waiting.  Production use: cap a "
            "replica's read load during backfill/compaction; bench "
            "use: model per-replica capacity for the read scale-out "
            "sweep on hosts whose cores can't isolate replicas")
define_flag("graph_statement_capacity_qps", 0,
            "per-COORDINATOR data-statement admission rate "
            "(statements/s, token bucket per graphd; 0 = unlimited).  "
            "Statements beyond the rate are shed with the structured "
            "E_OVERLOAD + retry-after contract, so a fleet "
            "client walks to a sibling coordinator with spare "
            "capacity instead of waiting.  Control statements "
            "(SHOW/KILL/DESC/USE) bypass the bucket — the diagnosis "
            "lane must survive the overload being diagnosed.  "
            "Production use: cap one coordinator during canary or "
            "drain warm-up; bench use: model per-coordinator "
            "capacity for the fleet scale-out sweep on hosts whose "
            "cores can't isolate graphds")
define_flag("tpu_delta_max_edges", 0,
            "device delta-CSR capacity per (block, part) in edges "
            "(rounded up to a power of two; 0 = delta plane off, "
            "every epoch bump re-pins the full snapshot).  With the "
            "delta on, group-committed writes land as a small "
            "device_put into a padded delta buffer that every "
            "traversal kernel merges with the base CSR each hop")
define_flag("tpu_delta_compact_watermark", 0.75,
            "delta fill ratio (of tpu_delta_max_edges, insert or "
            "tombstone side) above which the background compaction "
            "job rebuilds the base CSR off the gate and swaps it "
            "under a short write-side hold")
define_flag("tpu_delta_vmax_slack", 64,
            "extra padded local-vertex rows reserved at snapshot "
            "build when the delta plane is on, so freshly inserted "
            "vertices fit the pinned frontier/bitmap shapes without "
            "forcing a full re-pin")
define_flag("snapshot_dir", "./nebula_snapshots",
            "where CREATE SNAPSHOT checkpoints land")
define_flag("backup_dir", "./nebula_backups",
            "where CREATE BACKUP restorable checkpoints land")
