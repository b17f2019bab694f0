"""The port's copy of `nebula_tpu/graphstore/schema_wire.py`, whole.

JSON-safe (de)serialization of the schema catalog.

The meta plane replicates DDL commands and catalog snapshots through
raft and ships the catalog to clients (the meta.thrift struct analog;
reference: src/interface/meta.thrift).  These payloads cross process
boundaries, so they use the
same JSON wire discipline as values (core/wire.py) instead of pickle —
an unpickler reachable from an RPC port is arbitrary code execution.

Tags used here ("propdef", "schemaver", ...) are disjoint from
core.wire's value tags; containers recurse through this module so
schema objects can appear anywhere inside a command's args/kw.
"""
from __future__ import annotations

import json
from typing import Any

from ..core import wire
from .schema import (Catalog, EdgeSchema, IndexDesc, PropDef, PropType,
                     SchemaVersion, SpaceDesc, TagSchema, UserDesc)


def to_jso(v: Any) -> Any:
    if isinstance(v, PropDef):
        return {"@t": "propdef", "n": v.name, "pt": v.ptype.value,
                "null": v.nullable, "d": wire.to_wire(v.default),
                "hd": v.has_default, "fl": v.fixed_len, "c": v.comment}
    if isinstance(v, SchemaVersion):
        return {"@t": "schemaver", "v": v.version,
                "p": [to_jso(p) for p in v.props],
                "tc": v.ttl_col, "td": v.ttl_duration}
    if isinstance(v, TagSchema):
        return {"@t": "tagschema", "n": v.name, "id": v.tag_id,
                "vs": [to_jso(x) for x in v.versions]}
    if isinstance(v, EdgeSchema):
        return {"@t": "edgeschema", "n": v.name, "id": v.edge_type,
                "vs": [to_jso(x) for x in v.versions]}
    if isinstance(v, SpaceDesc):
        return {"@t": "spacedesc", "n": v.name, "id": v.space_id,
                "pn": v.partition_num, "rf": v.replica_factor,
                "vt": v.vid_type, "c": v.comment}
    if isinstance(v, IndexDesc):
        return {"@t": "indexdesc", "n": v.name, "sn": v.schema_name,
                "f": list(v.fields), "e": v.is_edge, "id": v.index_id,
                "ft": v.fulltext, "fl": list(v.field_lens or [])}
    if isinstance(v, UserDesc):
        return {"@t": "userdesc", "n": v.name, "p": v.pwd_hash,
                "r": dict(v.roles)}
    if isinstance(v, Catalog):
        return {"@t": "catalog",
                "users": {n: to_jso(u) for n, u in v.users.items()},
                "spaces": {n: to_jso(sp) for n, sp in v.spaces.items()},
                "tags": [[sid, {n: to_jso(t) for n, t in d.items()}]
                         for sid, d in v._tags.items()],
                "edges": [[sid, {n: to_jso(e) for n, e in d.items()}]
                          for sid, d in v._edges.items()],
                "indexes": [[sid, {n: to_jso(i) for n, i in d.items()}]
                            for sid, d in v._indexes.items()],
                "ft_indexes": [[sid, {n: to_jso(i) for n, i in d.items()}]
                               for sid, d in v._ft_indexes.items()],
                "listeners": [[sid, [list(x) for x in ls]]
                              for sid, ls in v._listeners.items()],
                "next_space": v._next_space,
                "next_schema_id": [[sid, nid] for sid, nid
                                   in v._next_schema_id.items()],
                "version": v.version}
    if isinstance(v, (list, tuple)):
        return {"@t": "list", "v": [to_jso(x) for x in v]}
    if isinstance(v, dict):
        if all(isinstance(k, str) for k in v):
            return {"@t": "map", "v": {k: to_jso(x) for k, x in v.items()}}
        return {"@t": "kvmap",
                "v": [[to_jso(k), to_jso(x)] for k, x in v.items()]}
    return wire.to_wire(v)


def from_jso(j: Any) -> Any:
    if not isinstance(j, dict) or "@t" not in j:
        return wire.from_wire(j)
    t = j["@t"]
    if t == "propdef":
        return PropDef(j["n"], PropType(j["pt"]), j["null"],
                       wire.from_wire(j["d"]), j["hd"], j["fl"], j["c"])
    if t == "schemaver":
        return SchemaVersion(j["v"], [from_jso(p) for p in j["p"]],
                             j["tc"], j["td"])
    if t == "tagschema":
        return TagSchema(j["n"], j["id"], [from_jso(x) for x in j["vs"]])
    if t == "edgeschema":
        return EdgeSchema(j["n"], j["id"], [from_jso(x) for x in j["vs"]])
    if t == "spacedesc":
        return SpaceDesc(j["n"], j["id"], j["pn"], j["rf"], j["vt"], j["c"])
    if t == "indexdesc":
        return IndexDesc(j["n"], j["sn"], list(j["f"]), j["e"], j["id"],
                         j.get("ft", False), list(j.get("fl") or []))
    if t == "userdesc":
        return UserDesc(j["n"], j["p"], j["r"])
    if t == "catalog":
        c = Catalog()
        if "users" in j:        # pre-ACL snapshots keep the default root
            c.users = {n: from_jso(u) for n, u in j["users"].items()}
        c.spaces = {n: from_jso(sp) for n, sp in j["spaces"].items()}
        c._tags = {sid: {n: from_jso(t_) for n, t_ in d.items()}
                   for sid, d in j["tags"]}
        c._edges = {sid: {n: from_jso(e) for n, e in d.items()}
                    for sid, d in j["edges"]}
        c._indexes = {sid: {n: from_jso(i) for n, i in d.items()}
                      for sid, d in j["indexes"]}
        # pre-fulltext snapshots carry neither key
        c._ft_indexes = {sid: {n: from_jso(i) for n, i in d.items()}
                         for sid, d in j.get("ft_indexes", [])}
        c._listeners = {sid: [list(x) for x in ls]
                        for sid, ls in j.get("listeners", [])}
        c._next_space = j["next_space"]
        c._next_schema_id = {sid: nid for sid, nid in j["next_schema_id"]}
        c.version = j["version"]
        return c
    if t == "list":
        return [from_jso(x) for x in j["v"]]
    if t == "map":
        return {k: from_jso(x) for k, x in j["v"].items()}
    if t == "kvmap":
        out = {}
        for kj, xj in j["v"]:
            k = from_jso(kj)
            if isinstance(k, list):
                k = tuple(k)
            out[k] = from_jso(xj)
        return out
    return wire.from_wire(j)


def dumps(v: Any) -> bytes:
    return json.dumps(to_jso(v), separators=(",", ":")).encode()


def loads(data: bytes) -> Any:
    return from_jso(json.loads(data.decode()))
