"""The port's copy of `nebula_tpu/graphstore/schema.py`, whole.

Schema catalog: spaces, tags, edge types — versioned, like the
reference's meta schema processors (reference: src/meta/processors/schema/
+ src/common/meta).

A Space is the top container (graph + partition count + vid type).  Tags and
edge types carry typed, defaultable, nullable, TTL-able property columns and
are versioned: altering a schema appends a new version; rows remember the
version they were written with.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

from ..core.value import (NULL, Date, DateTime, Duration, Time, is_null)


class PropType(Enum):
    BOOL = "bool"
    INT64 = "int64"
    INT32 = "int32"
    INT16 = "int16"
    INT8 = "int8"
    FLOAT = "float"
    DOUBLE = "double"
    STRING = "string"
    FIXED_STRING = "fixed_string"
    TIMESTAMP = "timestamp"
    DATE = "date"
    TIME = "time"
    DATETIME = "datetime"
    DURATION = "duration"
    GEOGRAPHY = "geography"

    @classmethod
    def parse(cls, s: str) -> "PropType":
        s = s.strip().lower()
        alias = {"int": "int64", "integer": "int64", "str": "string"}
        s = alias.get(s, s)
        if s.startswith("fixed_string"):
            return cls.FIXED_STRING
        return cls(s)


_INT_TYPES = (PropType.INT64, PropType.INT32, PropType.INT16, PropType.INT8,
              PropType.TIMESTAMP)
_FLOAT_TYPES = (PropType.FLOAT, PropType.DOUBLE)


def check_type(t: PropType, v: Any) -> bool:
    if is_null(v):
        return True
    if t == PropType.BOOL:
        return isinstance(v, bool)
    if t in _INT_TYPES:
        return isinstance(v, int) and not isinstance(v, bool)
    if t in _FLOAT_TYPES:
        return isinstance(v, (int, float)) and not isinstance(v, bool)
    if t in (PropType.STRING, PropType.FIXED_STRING):
        return isinstance(v, str)
    if t == PropType.DATE:
        return isinstance(v, Date)
    if t == PropType.TIME:
        return isinstance(v, Time)
    if t == PropType.DATETIME:
        return isinstance(v, DateTime)
    if t == PropType.DURATION:
        return isinstance(v, Duration)
    if t == PropType.GEOGRAPHY:
        from ..core.geo import Geography
        return isinstance(v, Geography)
    return True


def coerce(t: PropType, v: Any) -> Any:
    """Insert-time coercion (int→float for double columns; WKT text for
    geography columns)."""
    if is_null(v):
        return v
    if t in _FLOAT_TYPES and isinstance(v, int) and not isinstance(v, bool):
        return float(v)
    if t == PropType.GEOGRAPHY and isinstance(v, str):
        from ..core.geo import GeoError, from_wkt
        try:
            return from_wkt(v)
        except GeoError:
            return v            # check_type rejects with a clean error
    return v


@dataclass
class PropDef:
    name: str
    ptype: PropType
    nullable: bool = True
    default: Any = None          # None = no default
    has_default: bool = False
    fixed_len: int = 0           # FIXED_STRING length
    comment: str = ""

    def to_dict(self):
        return {"name": self.name, "type": self.ptype.value,
                "nullable": self.nullable, "default": self.default,
                "has_default": self.has_default, "fixed_len": self.fixed_len}


@dataclass
class SchemaVersion:
    version: int
    props: List[PropDef]
    ttl_col: str = ""
    ttl_duration: int = 0

    def prop(self, name: str) -> Optional[PropDef]:
        for p in self.props:
            if p.name == name:
                return p
        return None

    def prop_names(self) -> List[str]:
        return [p.name for p in self.props]


@dataclass
class TagSchema:
    name: str
    tag_id: int
    versions: List[SchemaVersion] = field(default_factory=list)

    @property
    def latest(self) -> SchemaVersion:
        return self.versions[-1]


@dataclass
class EdgeSchema:
    name: str
    edge_type: int               # positive id; -id is the reversed direction
    versions: List[SchemaVersion] = field(default_factory=list)

    @property
    def latest(self) -> SchemaVersion:
        return self.versions[-1]


class SchemaError(Exception):
    pass


@dataclass
class SpaceDesc:
    name: str
    space_id: int
    partition_num: int = 8
    replica_factor: int = 1
    vid_type: str = "FIXED_STRING(32)"  # or "INT64"
    comment: str = ""

    def vid_is_int(self) -> bool:
        return self.vid_type.strip().upper().startswith("INT")

    def check_vid(self, vid) -> None:
        """Write-path vid conformance (reference semantics: a write with
        the wrong vid type is an error, never a silent coercion)."""
        if self.vid_is_int():
            if not isinstance(vid, int) or isinstance(vid, bool):
                raise SchemaError(
                    f"vid {vid!r} does not match vid_type "
                    f"{self.vid_type}")
            return
        if not isinstance(vid, str):
            raise SchemaError(
                f"vid {vid!r} does not match vid_type {self.vid_type}")
        vt = self.vid_type.strip().upper()
        if vt.startswith("FIXED_STRING(") and vt.endswith(")"):
            try:
                cap = int(vt[len("FIXED_STRING("):-1])
            except ValueError:
                return
            if len(vid.encode()) > cap:
                raise SchemaError(
                    f"vid {vid!r} exceeds {self.vid_type}")


ROLES = ("GOD", "ADMIN", "DBA", "USER", "GUEST")
ROLE_RANK = {r: i for i, r in enumerate(reversed(ROLES))}


def hash_password(pw: str) -> str:
    import hashlib
    return hashlib.sha256(("nebula::" + pw).encode()).hexdigest()


class UserDesc:
    """One account: password hash + per-space role grants.  The root
    account carries the global GOD role (space key "")."""
    __slots__ = ("name", "pwd_hash", "roles")

    def __init__(self, name: str, pwd_hash: str,
                 roles: Optional[Dict[str, str]] = None):
        self.name = name
        self.pwd_hash = pwd_hash
        self.roles = dict(roles or {})

    def check_password(self, pw: str) -> bool:
        return self.pwd_hash == hash_password(pw)


class Catalog:
    """Space/tag/edge/user catalog — the metad schema plane,
    single-process form.

    The cluster metad (nebula_tpu.cluster.meta) wraps this with Raft +
    heartbeat distribution; executors always read through this interface.
    User/role management mirrors the reference's meta user plane
    (PermissionManager's backing store; reference: src/meta processors
    + src/graph/service/PermissionManager).
    """

    def __init__(self):
        self.spaces: Dict[str, SpaceDesc] = {}
        self._tags: Dict[int, Dict[str, TagSchema]] = {}      # space_id →
        self._edges: Dict[int, Dict[str, EdgeSchema]] = {}
        self._indexes: Dict[int, Dict[str, "IndexDesc"]] = {}
        self._ft_indexes: Dict[int, Dict[str, "IndexDesc"]] = {}
        self._listeners: Dict[int, List[List[str]]] = {}  # [type, endpoint]
        self._next_space = 1
        self._next_schema_id: Dict[int, int] = {}
        self.version = 0   # bumped on every DDL; clients use it for cache TTL
        self.users: Dict[str, UserDesc] = {
            "root": UserDesc("root", hash_password("nebula"), {"": "GOD"})}

    # -- users / roles --
    def create_user(self, name: str, password: str,
                    if_not_exists=False) -> UserDesc:
        if name in self.users:
            if if_not_exists:
                return self.users[name]
            raise SchemaError(f"user `{name}' already exists")
        u = UserDesc(name, hash_password(password))
        self.users[name] = u
        self.version += 1
        return u

    def create_user_hashed(self, name: str, pwd_hash: str,
                           if_not_exists=False) -> UserDesc:
        """Replay/replication form: the hash IS the payload, so durable
        logs (standalone journal, metad raft WAL) never see plaintext."""
        if name in self.users:
            if if_not_exists:
                return self.users[name]
            raise SchemaError(f"user `{name}' already exists")
        u = UserDesc(name, pwd_hash)
        self.users[name] = u
        self.version += 1
        return u

    def set_password_hash(self, name: str, pwd_hash: str):
        self.get_user(name).pwd_hash = pwd_hash
        self.version += 1

    def change_password_hashed(self, name: str, old_hash: str,
                               new_hash: str):
        """CHANGE PASSWORD's check-and-set, replayed INSIDE the state
        machine: validating the old password against a client's cached
        catalog would let a stale (already-rotated) credential authorize
        the change."""
        u = self.get_user(name)
        if u.pwd_hash != old_hash:
            raise SchemaError("old password mismatch")
        u.pwd_hash = new_hash
        self.version += 1

    def drop_user(self, name: str, if_exists=False):
        if name == "root":
            raise SchemaError("the root user cannot be dropped")
        if name not in self.users:
            if if_exists:
                return
            raise SchemaError(f"user `{name}' not found")
        del self.users[name]
        self.version += 1

    def get_user(self, name: str) -> UserDesc:
        u = self.users.get(name)
        if u is None:
            raise SchemaError(f"user `{name}' not found")
        return u

    def alter_user(self, name: str, password: str):
        self.get_user(name).pwd_hash = hash_password(password)
        self.version += 1

    def change_password(self, name: str, old: str, new: str):
        u = self.get_user(name)
        if not u.check_password(old):
            raise SchemaError("old password mismatch")
        u.pwd_hash = hash_password(new)
        self.version += 1

    def grant_role(self, user: str, space: str, role: str):
        role = role.upper()
        if role not in ROLES or role == "GOD":
            raise SchemaError(f"role `{role}' cannot be granted")
        self.get_space(space)
        self.get_user(user).roles[space] = role
        self.version += 1

    def revoke_role(self, user: str, space: str, role: Optional[str] = None):
        u = self.get_user(user)
        cur = u.roles.get(space)
        if cur is None:
            raise SchemaError(
                f"user `{user}' has no role on space `{space}'")
        if role is not None and cur != role.upper():
            raise SchemaError(
                f"user `{user}' holds `{cur}' on `{space}', not "
                f"`{role.upper()}'")
        del u.roles[space]
        self.version += 1

    def role_of(self, user: str, space: Optional[str]) -> Optional[str]:
        u = self.users.get(user)
        if u is None:
            return None
        if u.roles.get("") == "GOD":
            return "GOD"
        return u.roles.get(space) if space else None

    # -- spaces --
    def create_space(self, name: str, partition_num=8, replica_factor=1,
                     vid_type="FIXED_STRING(32)", if_not_exists=False) -> SpaceDesc:
        if name in self.spaces:
            if if_not_exists:
                return self.spaces[name]
            raise SchemaError(f"space `{name}' already exists")
        sp = SpaceDesc(name, self._next_space, partition_num, replica_factor, vid_type)
        self._next_space += 1
        self.spaces[name] = sp
        self._tags[sp.space_id] = {}
        self._edges[sp.space_id] = {}
        self._indexes[sp.space_id] = {}
        self._ft_indexes[sp.space_id] = {}
        self._listeners[sp.space_id] = []
        self._next_schema_id[sp.space_id] = 2  # 1 reserved
        self.version += 1
        return sp

    def drop_space(self, name: str, if_exists=False) -> Optional[SpaceDesc]:
        sp = self.spaces.pop(name, None)
        if sp is None:
            if if_exists:
                return None
            raise SchemaError(f"space `{name}' not found")
        self._tags.pop(sp.space_id, None)
        self._edges.pop(sp.space_id, None)
        self._indexes.pop(sp.space_id, None)
        self._ft_indexes.pop(sp.space_id, None)
        self._listeners.pop(sp.space_id, None)
        for u in self.users.values():
            u.roles.pop(name, None)
        self.version += 1
        return sp

    def get_space(self, name: str) -> SpaceDesc:
        sp = self.spaces.get(name)
        if sp is None:
            raise SchemaError(f"space `{name}' not found")
        return sp

    # -- tags / edges --
    def _alloc_id(self, space_id: int) -> int:
        i = self._next_schema_id[space_id]
        self._next_schema_id[space_id] = i + 1
        return i

    def create_tag(self, space: str, name: str, props: List[PropDef],
                   if_not_exists=False, ttl_col="", ttl_duration=0) -> TagSchema:
        sp = self.get_space(space)
        tags = self._tags[sp.space_id]
        if name in tags:
            if if_not_exists:
                return tags[name]
            raise SchemaError(f"tag `{name}' already exists")
        if name in self._edges[sp.space_id]:
            raise SchemaError(f"`{name}' conflicts with an edge type")
        t = TagSchema(name, self._alloc_id(sp.space_id),
                      [SchemaVersion(0, props, ttl_col, ttl_duration)])
        tags[name] = t
        self.version += 1
        return t

    def create_edge(self, space: str, name: str, props: List[PropDef],
                    if_not_exists=False, ttl_col="", ttl_duration=0) -> EdgeSchema:
        sp = self.get_space(space)
        edges = self._edges[sp.space_id]
        if name in edges:
            if if_not_exists:
                return edges[name]
            raise SchemaError(f"edge `{name}' already exists")
        if name in self._tags[sp.space_id]:
            raise SchemaError(f"`{name}' conflicts with a tag")
        e = EdgeSchema(name, self._alloc_id(sp.space_id),
                       [SchemaVersion(0, props, ttl_col, ttl_duration)])
        edges[name] = e
        self.version += 1
        return e

    def alter_tag(self, space: str, name: str, props: List[PropDef],
                  ttl_col=None, ttl_duration=None) -> TagSchema:
        t = self.get_tag(space, name)
        last = t.latest
        t.versions.append(SchemaVersion(
            last.version + 1, props,
            last.ttl_col if ttl_col is None else ttl_col,
            last.ttl_duration if ttl_duration is None else ttl_duration))
        self.version += 1
        return t

    def alter_edge(self, space: str, name: str, props: List[PropDef],
                   ttl_col=None, ttl_duration=None) -> EdgeSchema:
        e = self.get_edge(space, name)
        last = e.latest
        e.versions.append(SchemaVersion(
            last.version + 1, props,
            last.ttl_col if ttl_col is None else ttl_col,
            last.ttl_duration if ttl_duration is None else ttl_duration))
        self.version += 1
        return e

    def drop_tag(self, space: str, name: str, if_exists=False):
        sp = self.get_space(space)
        if self._tags[sp.space_id].pop(name, None) is None and not if_exists:
            raise SchemaError(f"tag `{name}' not found")
        self.version += 1

    def drop_edge(self, space: str, name: str, if_exists=False):
        sp = self.get_space(space)
        if self._edges[sp.space_id].pop(name, None) is None and not if_exists:
            raise SchemaError(f"edge `{name}' not found")
        self.version += 1

    def get_tag(self, space: str, name: str) -> TagSchema:
        sp = self.get_space(space)
        t = self._tags[sp.space_id].get(name)
        if t is None:
            raise SchemaError(f"tag `{name}' not found in space `{space}'")
        return t

    def get_edge(self, space: str, name: str) -> EdgeSchema:
        sp = self.get_space(space)
        e = self._edges[sp.space_id].get(name)
        if e is None:
            raise SchemaError(f"edge `{name}' not found in space `{space}'")
        return e

    def tags(self, space: str) -> List[TagSchema]:
        return list(self._tags[self.get_space(space).space_id].values())

    def edges(self, space: str) -> List[EdgeSchema]:
        return list(self._edges[self.get_space(space).space_id].values())

    def edge_by_type(self, space: str, etype: int) -> EdgeSchema:
        for e in self.edges(space):
            if e.edge_type == abs(etype):
                return e
        raise SchemaError(f"edge type {etype} not found")

    # -- secondary indexes --
    def create_index(self, space: str, index_name: str, schema_name: str,
                     fields: List[str], is_edge: bool, if_not_exists=False,
                     field_lens: Optional[List[int]] = None) -> "IndexDesc":
        sp = self.get_space(space)
        idxs = self._indexes[sp.space_id]
        if index_name in idxs:
            if if_not_exists:
                return idxs[index_name]
            raise SchemaError(f"index `{index_name}' already exists")
        # validate target schema + fields exist
        schema = (self.get_edge(space, schema_name) if is_edge
                  else self.get_tag(space, schema_name))
        lens = list(field_lens) if field_lens else [0] * len(fields)
        if len(lens) != len(fields):
            raise SchemaError("index field/length count mismatch")
        for f, ln in zip(fields, lens):
            p = schema.latest.prop(f)
            if p is None:
                raise SchemaError(f"prop `{f}' not in `{schema_name}'")
            if ln:
                if p.ptype not in (PropType.STRING, PropType.FIXED_STRING):
                    raise SchemaError(
                        f"prefix length only applies to string props "
                        f"(`{f}' is {p.ptype.value})")
        d = IndexDesc(index_name, schema_name, list(fields), is_edge,
                      index_id=self._alloc_id(sp.space_id),
                      field_lens=lens)
        idxs[index_name] = d
        self.version += 1
        return d

    def drop_index(self, space: str, index_name: str, if_exists=False):
        sp = self.get_space(space)
        if self._indexes[sp.space_id].pop(index_name, None) is None and not if_exists:
            raise SchemaError(f"index `{index_name}' not found")
        self.version += 1

    def indexes(self, space: str) -> List["IndexDesc"]:
        return list(self._indexes[self.get_space(space).space_id].values())

    def indexes_for(self, space: str, schema_name: str, is_edge: bool) -> List["IndexDesc"]:
        return [d for d in self.indexes(space)
                if d.schema_name == schema_name and d.is_edge == is_edge]

    # -- full-text indexes + listeners (SURVEY §2 row 10 Listener; the
    # reference's ES-backed text-search plane) --
    def create_fulltext_index(self, space: str, index_name: str,
                              schema_name: str, field: str, is_edge: bool,
                              if_not_exists=False) -> "IndexDesc":
        sp = self.get_space(space)
        idxs = self._ft_indexes.setdefault(sp.space_id, {})
        if index_name in idxs:
            if if_not_exists:
                return idxs[index_name]
            raise SchemaError(f"fulltext index `{index_name}' already exists")
        schema = (self.get_edge(space, schema_name) if is_edge
                  else self.get_tag(space, schema_name))
        p = schema.latest.prop(field)
        if p is None:
            raise SchemaError(f"prop `{field}' not in `{schema_name}'")
        if p.ptype not in (PropType.STRING, PropType.FIXED_STRING):
            raise SchemaError(
                f"fulltext index requires a string prop; `{field}' "
                f"is {p.ptype.value}")
        d = IndexDesc(index_name, schema_name, [field], is_edge,
                      index_id=self._alloc_id(sp.space_id), fulltext=True)
        idxs[index_name] = d
        self.version += 1
        return d

    def drop_fulltext_index(self, space: str, index_name: str,
                            if_exists=False):
        sp = self.get_space(space)
        idxs = self._ft_indexes.setdefault(sp.space_id, {})
        if idxs.pop(index_name, None) is None and not if_exists:
            raise SchemaError(f"fulltext index `{index_name}' not found")
        self.version += 1

    def fulltext_indexes(self, space: str) -> List["IndexDesc"]:
        sid = self.get_space(space).space_id
        return list(self._ft_indexes.get(sid, {}).values())

    def fulltext_indexes_for(self, space: str, schema_name: str,
                             is_edge: bool) -> List["IndexDesc"]:
        return [d for d in self.fulltext_indexes(space)
                if d.schema_name == schema_name and d.is_edge == is_edge]

    def add_listener(self, space: str, ltype: str, endpoint: str):
        sid = self.get_space(space).space_id
        ls = self._listeners.setdefault(sid, [])
        if any(t == ltype for t, _ in ls):
            raise SchemaError(f"listener {ltype} already added")
        ls.append([ltype, endpoint])
        self.version += 1

    def remove_listener(self, space: str, ltype: str):
        sid = self.get_space(space).space_id
        ls = self._listeners.setdefault(sid, [])
        keep = [x for x in ls if x[0] != ltype]
        if len(keep) == len(ls):
            raise SchemaError(f"no {ltype} listener on `{space}'")
        self._listeners[sid] = keep
        self.version += 1

    def listeners(self, space: str) -> List[List[str]]:
        return list(self._listeners.get(
            self.get_space(space).space_id, []))


@dataclass
class IndexDesc:
    name: str
    schema_name: str
    fields: List[str]
    is_edge: bool
    # unique per creation: DROP + re-CREATE with the same name/fields must
    # NOT resurrect the old entries (the store compares this id)
    index_id: int = 0
    # full-text (ES-listener-backed in the reference) vs secondary B-tree
    fulltext: bool = False
    # per-field string prefix length, 0 = full value (reference:
    # CREATE TAG INDEX i ON t(name(10)) truncates the key)
    field_lens: List[int] = field(default_factory=list)


def fill_row(sv: SchemaVersion, row: Dict[str, Any]) -> Dict[str, Any]:
    """Read-side schema upgrade: a row written before ALTER ... ADD is
    served with the latest version's defaults (or NULL) for the added
    props — the reference's versioned RowReader fallback (SURVEY §2
    row 9).  Returns a copy only when something is missing."""
    missing = [p for p in sv.props if p.name not in row]
    if not missing:
        return row
    out = dict(row)
    for p in missing:
        if p.has_default:
            # coerce exactly like insert-time apply_defaults, so an
            # upgraded row is type-identical to a fresh one (e.g. a
            # double default written as int, a geography as WKT text)
            try:
                out[p.name] = coerce(p.ptype, p.default)
            except Exception:  # noqa: BLE001 — malformed default:
                out[p.name] = NULL   # degrade exactly like the device
                # column encode (csr.py), keeping host/device parity
        else:
            out[p.name] = NULL
    return out


def apply_defaults(sv: SchemaVersion, props: Dict[str, Any],
                   insert_names: Optional[List[str]] = None) -> Dict[str, Any]:
    """Fill defaults / validate nullability for an insert row."""
    out: Dict[str, Any] = {}
    for p in sv.props:
        if p.name in props:
            v = coerce(p.ptype, props[p.name])
            if is_null(v) and not p.nullable:
                raise SchemaError(
                    f"prop `{p.name}' is NOT NULL")
            if not check_type(p.ptype, v):
                raise SchemaError(
                    f"prop `{p.name}' expects {p.ptype.value}, got {type(v).__name__}")
            out[p.name] = v
        elif p.has_default:
            out[p.name] = coerce(p.ptype, p.default)
        elif p.nullable:
            out[p.name] = NULL
        else:
            raise SchemaError(f"prop `{p.name}' is NOT NULL and has no default")
    if insert_names:
        for n in insert_names:
            if sv.prop(n) is None:
                raise SchemaError(f"unknown prop `{n}'")
    return out
