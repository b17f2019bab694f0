"""Typed config registry — the gflags analog.

The port's copy of nebula_tpu/utils/config.py: `Config`, `define_flag`,
`get_config` and the atomic `set_dynamic_many`.  The reference's core
flags are left out; each flag the port reads is defined beside its use
(the batch flags in gpu/batch.py, `workload_plane_enabled` in
utils/workload.py).

Layers, lowest first (the reference's config-file layer is left out):

    defaults  <  environment (NEBULA_<UPPER_NAME>)
              <  dynamic (set_dynamic_many)

Flags are declared near their use via define_flag(); lookups are
`get_config().get("name")`.  Unknown names raise — typos surface
immediately, like gflags.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional


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
        self.dynamic_layer: Dict[str, Any] = {}
        self.lock = threading.RLock()

    def define(self, name: str, default: Any, help: str = "",
               ftype: Optional[type] = None, mutable: bool = True):
        with self.lock:
            if name in self.defs:
                return                 # idempotent re-import
            self.defs[name] = FlagDef(name, default,
                                      ftype or type(default), help, mutable)

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
        changed."""
        parsed = {k: self.check(k, v) for k, v in updates.items()}
        with self.lock:
            self.dynamic_layer.update(parsed)


_global = Config()


def get_config() -> Config:
    return _global


def define_flag(name: str, default: Any, help: str = "",
                mutable: bool = True):
    _global.define(name, default, help, mutable=mutable)
    return name
