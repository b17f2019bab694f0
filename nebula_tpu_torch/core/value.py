"""nGQL Value model: the universal data currency of the framework.

A copy of `nebula_tpu/core/value.py`.  Re-designed from NebulaGraph's
tagged-union ``Value`` (src/common/datatypes/Value.h) as idiomatic Python: plain Python objects carry scalar values (bool, int,
float, str), and small dataclass-style wrappers carry the graph/temporal
types.  NULL is represented by :class:`NullValue` (8 kinds, matching
NebulaGraph's ``NullType`` enum) — NOT by Python ``None`` — so that null-kind
propagation (BAD_TYPE vs DIV_BY_ZERO etc.) survives round trips.

Semantics implemented here (the parity-critical part):
  * 8 null kinds and their propagation rules
  * three-valued logic (AND/OR/XOR/NOT over kNullValue)
  * cross-type comparison: same-type compares naturally, int/float interop,
    different types yield BAD_TYPE null for relational ops but have a
    stable total order for ORDER BY (``total_order_key``)
  * arithmetic overflow → ERR_OVERFLOW, division by zero → DIV_BY_ZERO
"""
from __future__ import annotations

import datetime as _dt
import math
from enum import Enum
from typing import Any, Dict, Iterable, List, Optional, Tuple

INT64_MIN = -(2**63)
INT64_MAX = 2**63 - 1


class NullKind(Enum):
    NULL = "__NULL__"
    NaN = "__NaN__"
    BAD_DATA = "__BAD_DATA__"
    BAD_TYPE = "__BAD_TYPE__"
    ERR_OVERFLOW = "__OVERFLOW__"
    UNKNOWN_PROP = "__UNKNOWN_PROP__"
    DIV_BY_ZERO = "__DIV_BY_ZERO__"
    OUT_OF_RANGE = "__OUT_OF_RANGE__"


class NullValue:
    """An nGQL NULL with a kind. Interned per kind."""

    __slots__ = ("kind",)
    _interned: Dict[NullKind, "NullValue"] = {}

    def __new__(cls, kind: NullKind = NullKind.NULL):
        v = cls._interned.get(kind)
        if v is None:
            v = object.__new__(cls)
            v.kind = kind
            cls._interned[kind] = v
        return v

    def __repr__(self) -> str:
        return self.kind.value

    def __bool__(self) -> bool:
        return False

    # Nulls of any kind are equal to each other for hashing/dedup purposes
    # (kEquals in the reference distinguishes; dedup treats all nulls equal).
    def __eq__(self, other: Any) -> bool:
        return isinstance(other, NullValue)

    def __hash__(self) -> int:
        return hash("__nebula_null__")


NULL = NullValue(NullKind.NULL)
NULL_NAN = NullValue(NullKind.NaN)
NULL_BAD_DATA = NullValue(NullKind.BAD_DATA)
NULL_BAD_TYPE = NullValue(NullKind.BAD_TYPE)
NULL_OVERFLOW = NullValue(NullKind.ERR_OVERFLOW)
NULL_UNKNOWN_PROP = NullValue(NullKind.UNKNOWN_PROP)
NULL_DIV_BY_ZERO = NullValue(NullKind.DIV_BY_ZERO)
NULL_OUT_OF_RANGE = NullValue(NullKind.OUT_OF_RANGE)


class EmptyValue:
    """The kEmpty value: absence of a value (distinct from NULL)."""

    __slots__ = ()
    _inst: Optional["EmptyValue"] = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = object.__new__(cls)
        return cls._inst

    def __repr__(self) -> str:
        return "__EMPTY__"

    def __bool__(self) -> bool:
        return False

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, EmptyValue)

    def __hash__(self) -> int:
        return hash("__nebula_empty__")


EMPTY = EmptyValue()


def is_null(v: Any) -> bool:
    return isinstance(v, NullValue)


def is_empty(v: Any) -> bool:
    return isinstance(v, EmptyValue)


def is_none_or_null(v: Any) -> bool:
    return v is None or isinstance(v, (NullValue, EmptyValue))


# --------------------------------------------------------------------------
# Temporal types
# --------------------------------------------------------------------------


class Date:
    __slots__ = ("year", "month", "day")

    def __init__(self, year: int = 1970, month: int = 1, day: int = 1):
        self.year, self.month, self.day = year, month, day

    def _key(self):
        return (self.year, self.month, self.day)

    def __eq__(self, o):
        return isinstance(o, Date) and self._key() == o._key()

    def __lt__(self, o):
        return self._key() < o._key()

    def __hash__(self):
        return hash(("Date",) + self._key())

    def __repr__(self):
        return f"{self.year:04d}-{self.month:02d}-{self.day:02d}"

    def to_py(self) -> _dt.date:
        return _dt.date(self.year, self.month, self.day)

    def days_since_epoch(self) -> int:
        return (self.to_py() - _dt.date(1970, 1, 1)).days


class Time:
    __slots__ = ("hour", "minute", "sec", "microsec")

    def __init__(self, hour=0, minute=0, sec=0, microsec=0):
        self.hour, self.minute, self.sec, self.microsec = hour, minute, sec, microsec

    def _key(self):
        return (self.hour, self.minute, self.sec, self.microsec)

    def __eq__(self, o):
        return isinstance(o, Time) and self._key() == o._key()

    def __lt__(self, o):
        return self._key() < o._key()

    def __hash__(self):
        return hash(("Time",) + self._key())

    def __repr__(self):
        return f"{self.hour:02d}:{self.minute:02d}:{self.sec:02d}.{self.microsec:06d}"


class DateTime:
    __slots__ = ("year", "month", "day", "hour", "minute", "sec", "microsec")

    def __init__(self, year=1970, month=1, day=1, hour=0, minute=0, sec=0, microsec=0):
        self.year, self.month, self.day = year, month, day
        self.hour, self.minute, self.sec, self.microsec = hour, minute, sec, microsec

    def _key(self):
        return (self.year, self.month, self.day, self.hour, self.minute, self.sec, self.microsec)

    def __eq__(self, o):
        return isinstance(o, DateTime) and self._key() == o._key()

    def __lt__(self, o):
        return self._key() < o._key()

    def __hash__(self):
        return hash(("DateTime",) + self._key())

    def __repr__(self):
        return (f"{self.year:04d}-{self.month:02d}-{self.day:02d}"
                f"T{self.hour:02d}:{self.minute:02d}:{self.sec:02d}.{self.microsec:06d}")

    def to_timestamp(self) -> int:
        dt = _dt.datetime(self.year, self.month, self.day, self.hour, self.minute,
                          self.sec, self.microsec, tzinfo=_dt.timezone.utc)
        return int(dt.timestamp())


class Duration:
    __slots__ = ("seconds", "microseconds", "months")

    def __init__(self, seconds: int = 0, microseconds: int = 0, months: int = 0):
        # normalize: microseconds carry into seconds (0 <= us < 1e6), so
        # arithmetically-equal durations compare/hash equal and repr
        # stays well-formed after +/- (months are calendar-relative and
        # never fold into seconds)
        carry, microseconds = divmod(microseconds, 1_000_000)
        self.seconds = seconds + carry
        self.microseconds = microseconds
        self.months = months

    def _key(self):
        return (self.months, self.seconds, self.microseconds)

    def __eq__(self, o):
        return isinstance(o, Duration) and self._key() == o._key()

    def __hash__(self):
        return hash(("Duration",) + self._key())

    def __repr__(self):
        return f"P{self.months}MT{self.seconds}.{self.microseconds:06d}S"


# --------------------------------------------------------------------------
# Graph types
# --------------------------------------------------------------------------


class Tag:
    __slots__ = ("name", "props")

    def __init__(self, name: str, props: Optional[Dict[str, Any]] = None):
        self.name = name
        self.props = props or {}

    def __eq__(self, o):
        return isinstance(o, Tag) and self.name == o.name and self.props == o.props

    def __hash__(self):
        return hash(("Tag", self.name, tuple(sorted(self.props))))

    def __repr__(self):
        return f":{self.name}{self.props!r}"


class Vertex:
    __slots__ = ("vid", "tags")

    def __init__(self, vid: Any, tags: Optional[List[Tag]] = None):
        self.vid = vid
        self.tags = tags or []

    def tag_names(self) -> List[str]:
        return [t.name for t in self.tags]

    def properties(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for t in self.tags:
            out.update(t.props)
        return out

    def prop(self, tag: str, name: str) -> Any:
        for t in self.tags:
            if t.name == tag:
                return t.props.get(name, NULL_UNKNOWN_PROP)
        return NULL_UNKNOWN_PROP

    def __eq__(self, o):
        return isinstance(o, Vertex) and self.vid == o.vid

    def __lt__(self, o):
        return _lt_raw(self.vid, o.vid)

    def __hash__(self):
        return hash(("Vertex", self.vid))

    def __repr__(self):
        return f'("{self.vid}"' + "".join(repr(t) for t in self.tags) + ")"


class Edge:
    __slots__ = ("src", "dst", "etype", "name", "ranking", "props")

    def __init__(self, src: Any, dst: Any, name: str, ranking: int = 0,
                 props: Optional[Dict[str, Any]] = None, etype: int = 0):
        self.src, self.dst = src, dst
        self.name, self.ranking = name, ranking
        self.props = props or {}
        self.etype = etype  # signed edge-type id; negative = reversed view

    def key(self) -> Tuple:
        # Direction-insensitive identity of the logical edge.
        if self.etype >= 0:
            return (self.src, self.dst, self.name, self.ranking)
        return (self.dst, self.src, self.name, self.ranking)

    def __eq__(self, o):
        return isinstance(o, Edge) and self.key() == o.key() and self.props == o.props

    def __lt__(self, o):
        return self.key() < o.key()

    def __hash__(self):
        return hash(("Edge",) + self.key())

    def __repr__(self):
        return f'[:{self.name} "{self.src}"->"{self.dst}" @{self.ranking} {self.props!r}]'


class Step:
    __slots__ = ("dst", "name", "etype", "ranking", "props")

    def __init__(self, dst: Vertex, name: str, ranking: int = 0,
                 props: Optional[Dict[str, Any]] = None, etype: int = 1):
        self.dst, self.name, self.ranking = dst, name, ranking
        self.props = props or {}
        self.etype = etype

    def __eq__(self, o):
        return (isinstance(o, Step) and self.dst == o.dst and self.name == o.name
                and self.ranking == o.ranking and self.etype == o.etype)

    def __hash__(self):
        return hash(("Step", self.dst.vid, self.name, self.ranking, self.etype))

    def __repr__(self):
        arrow = "-[" if self.etype >= 0 else "<-["
        close = "]->" if self.etype >= 0 else "]-"
        return f"{arrow}:{self.name}@{self.ranking}{close}{self.dst!r}"


class Path:
    __slots__ = ("src", "steps")

    def __init__(self, src: Vertex, steps: Optional[List[Step]] = None):
        self.src = src
        self.steps = steps or []

    def length(self) -> int:
        return len(self.steps)

    def nodes(self) -> List[Vertex]:
        return [self.src] + [s.dst for s in self.steps]

    def relationships(self) -> List[Edge]:
        out = []
        prev = self.src
        for s in self.steps:
            if s.etype >= 0:
                out.append(Edge(prev.vid, s.dst.vid, s.name, s.ranking, s.props, s.etype))
            else:
                out.append(Edge(s.dst.vid, prev.vid, s.name, s.ranking, s.props, s.etype))
            prev = s.dst
        return out

    def has_duplicate_edges(self) -> bool:
        seen = set()
        es = self.relationships()
        for e in es:
            if e.key() in seen:
                return True
            seen.add(e.key())
        return False

    def has_duplicate_vertices(self) -> bool:
        vids = [v.vid for v in self.nodes()]
        return len(set(vids)) != len(vids)

    def __eq__(self, o):
        return isinstance(o, Path) and self.src == o.src and self.steps == o.steps

    def __hash__(self):
        return hash(("Path", self.src.vid, tuple(hash(s) for s in self.steps)))

    def __repr__(self):
        return repr(self.src) + "".join(repr(s) for s in self.steps)


class DataSet:
    """A named-column row table — the result/interchange format.

    NebulaGraph: src/common/datatypes/DataSet.h.
    """

    __slots__ = ("column_names", "rows")

    def __init__(self, column_names: Optional[List[str]] = None,
                 rows: Optional[List[List[Any]]] = None):
        self.column_names = column_names or []
        self.rows = rows or []

    def append_row(self, row: List[Any]) -> None:
        self.rows.append(row)

    def col_index(self, name: str) -> int:
        return self.column_names.index(name)

    def column(self, name: str) -> List[Any]:
        i = self.col_index(name)
        return [r[i] for r in self.rows]

    def __len__(self) -> int:
        return len(self.rows)

    def __eq__(self, o):
        return (isinstance(o, DataSet) and self.column_names == o.column_names
                and self.rows == o.rows)

    def __repr__(self):
        head = " | ".join(self.column_names)
        body = "\n".join(" | ".join(value_to_string(c) for c in r) for r in self.rows[:20])
        more = f"\n... ({len(self.rows)} rows)" if len(self.rows) > 20 else ""
        return f"{head}\n{'-' * max(len(head), 1)}\n{body}{more}"


_ROWS_SLOT = DataSet.__dict__["rows"]


class ColumnarDataSet(DataSet):
    """DataSet backed by numpy columns; rows materialize lazily.

    The device plane's result handle: device output
    stays columnar — numpy arrays straight off the fetched capture
    buffers — through the executor/result boundary, and per-row Python
    lists are built only if something actually touches ``.rows`` (the
    wire/print boundary, host executors composing further).  ``len()``,
    ``column()`` and column-wise serialization never pay the per-row
    object cost.
    """

    __slots__ = ("_cols",)

    def __init__(self, column_names: List[str], cols: List[Any]):
        self.column_names = list(column_names)
        self._cols = list(cols)          # 1-D numpy arrays, equal length
        _ROWS_SLOT.__set__(self, None)

    # rows: lazy over the backing columns ------------------------------
    @property
    def rows(self) -> List[List[Any]]:
        r = _ROWS_SLOT.__get__(self, ColumnarDataSet)
        if r is None:
            r = self._build_rows()
            _ROWS_SLOT.__set__(self, r)
            self._cols = None            # rows own the data now
        return r

    @rows.setter
    def rows(self, v) -> None:
        _ROWS_SLOT.__set__(self, v)
        self._cols = None

    def _build_rows(self) -> List[List[Any]]:
        import numpy as np
        cols = self._cols
        n = len(cols[0]) if cols else 0
        if n == 0:
            return []
        # object-matrix assembly: one C-level .tolist() per column plus
        # one for the matrix, instead of a Python per-row loop
        m = np.empty((n, len(cols)), dtype=object)
        for j, c in enumerate(cols):
            m[:, j] = c if c.dtype == object else c.tolist()
        return m.tolist()

    def __len__(self) -> int:
        if self._cols is not None:
            return len(self._cols[0]) if self._cols else 0
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def column(self, name: str) -> List[Any]:
        if self._cols is not None:
            c = self._cols[self.col_index(name)]
            return list(c) if c.dtype == object else c.tolist()
        return super().column(name)

    def column_array(self, name: str):
        """The backing numpy column; None once rows were materialized."""
        if self._cols is None:
            return None
        return self._cols[self.col_index(name)]


# --------------------------------------------------------------------------
# Typing / printing
# --------------------------------------------------------------------------

_TYPE_NAMES = [
    (EmptyValue, "__EMPTY__"), (NullValue, "__NULL__"), (bool, "bool"),
    (int, "int"), (float, "float"), (str, "string"), (Date, "date"),
    (Time, "time"), (DateTime, "datetime"), (Vertex, "vertex"), (Edge, "edge"),
    (Path, "path"), (list, "list"), (dict, "map"), (set, "set"),
    (DataSet, "dataset"), (Duration, "duration"),
]


def _register_geo_type():
    # late: geo.py imports nothing from here, but keep import cycles out
    from .geo import Geography
    _TYPE_NAMES.insert(-1, (Geography, "geography"))
    # between duration (14) and __NULL__ (15): its own slot, nulls last
    _KIND_ORDER.setdefault("geography", 14.5)





def type_name(v: Any) -> str:
    for t, n in _TYPE_NAMES:
        if isinstance(v, t):
            return n
    return type(v).__name__


def make_edge(src_vid, other_vid, etype_name, rank, props, signed_dir,
              etype_id) -> "Edge":
    """Edge as seen from a traversal row: signed_dir=+1 means the stored
    edge is src->other; -1 is the reversed view (negative EdgeType, the
    reference's convention).  THE single constructor for this rule —
    graphd executors and storage-side filter eval must agree on it."""
    return Edge(src_vid, other_vid, etype_name, rank, dict(props),
                etype=etype_id if signed_dir > 0 else -etype_id)


def value_to_string(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        if v != v:
            return "NaN"
        if v == math.inf:
            return "inf"
        if v == -math.inf:
            return "-inf"
        return repr(v)
    if isinstance(v, str):
        # escaped so the text form round-trips through the tokenizer —
        # pushed-down filters ship as nGQL text, and a raw quote or
        # backslash would re-parse as a different (or broken) literal
        esc = (v.replace("\\", "\\\\").replace('"', '\\"')
               .replace("\n", "\\n").replace("\t", "\\t")
               .replace("\r", "\\r"))
        return f'"{esc}"'
    if isinstance(v, list):
        return "[" + ", ".join(value_to_string(x) for x in v) + "]"
    if isinstance(v, set):
        return "{" + ", ".join(sorted(value_to_string(x) for x in v)) + "}"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k}: {value_to_string(x)}" for k, x in sorted(v.items())) + "}"
    return repr(v)


# --------------------------------------------------------------------------
# Truthiness / three-valued logic
# --------------------------------------------------------------------------


def to_bool3(v: Any) -> Any:
    """Value → (True|False|null) for WHERE-clause semantics."""
    if isinstance(v, bool):
        return v
    if isinstance(v, (NullValue, EmptyValue)):
        return NULL
    return NULL_BAD_TYPE


def logical_and(a: Any, b: Any) -> Any:
    a3, b3 = to_bool3(a), to_bool3(b)
    if a3 is False or b3 is False:
        return False
    if is_null(a3) or is_null(b3):
        return NULL
    return True


def logical_or(a: Any, b: Any) -> Any:
    a3, b3 = to_bool3(a), to_bool3(b)
    if a3 is True or b3 is True:
        return True
    if is_null(a3) or is_null(b3):
        return NULL
    return False


def logical_xor(a: Any, b: Any) -> Any:
    a3, b3 = to_bool3(a), to_bool3(b)
    if is_null(a3) or is_null(b3):
        return NULL
    return a3 != b3


def logical_not(a: Any) -> Any:
    a3 = to_bool3(a)
    if is_null(a3):
        return NULL
    return not a3


# --------------------------------------------------------------------------
# Arithmetic
# --------------------------------------------------------------------------


def _both_numeric(a, b) -> bool:
    return (isinstance(a, (int, float)) and not isinstance(a, bool)
            and isinstance(b, (int, float)) and not isinstance(b, bool))


def _int_result(x: int) -> Any:
    if x < INT64_MIN or x > INT64_MAX:
        return NULL_OVERFLOW
    return x


def v_add(a: Any, b: Any) -> Any:
    if is_null(a) or is_null(b):
        return a if is_null(a) else b
    if isinstance(a, str) and isinstance(b, str):
        return a + b
    # string + primitive concatenation (nGQL allows str+int etc.)
    if isinstance(a, str) and isinstance(b, (int, float, bool)):
        return a + value_to_string(b).strip('"')
    if isinstance(b, str) and isinstance(a, (int, float, bool)):
        return value_to_string(a).strip('"') + b
    if isinstance(a, list) and isinstance(b, list):
        return a + b
    if isinstance(a, list):
        return a + [b]
    if isinstance(b, list):
        return [a] + b
    if _both_numeric(a, b):
        r = a + b
        if isinstance(a, int) and isinstance(b, int):
            return _int_result(r)
        return r
    if isinstance(a, Date) and isinstance(b, Duration):
        return _date_plus_duration(a, b)
    if isinstance(a, DateTime) and isinstance(b, Duration):
        return _datetime_plus_duration(a, b)
    if isinstance(a, Duration) and isinstance(b, Duration):
        return Duration(a.seconds + b.seconds,
                        a.microseconds + b.microseconds,
                        a.months + b.months)
    if isinstance(a, Time) and isinstance(b, Duration):
        return _time_plus_duration(a, b)
    return NULL_BAD_TYPE


def v_sub(a: Any, b: Any) -> Any:
    if is_null(a) or is_null(b):
        return a if is_null(a) else b
    if _both_numeric(a, b):
        r = a - b
        if isinstance(a, int) and isinstance(b, int):
            return _int_result(r)
        return r
    if isinstance(a, (Date, DateTime, Duration, Time)) \
            and isinstance(b, Duration):
        return v_add(a, _neg_duration(b))
    return NULL_BAD_TYPE


def v_mul(a: Any, b: Any) -> Any:
    if is_null(a) or is_null(b):
        return a if is_null(a) else b
    if _both_numeric(a, b):
        r = a * b
        if isinstance(a, int) and isinstance(b, int):
            return _int_result(r)
        return r
    return NULL_BAD_TYPE


def v_div(a: Any, b: Any) -> Any:
    if is_null(a) or is_null(b):
        return a if is_null(a) else b
    if _both_numeric(a, b):
        if isinstance(a, int) and isinstance(b, int):
            if b == 0:
                return NULL_DIV_BY_ZERO
            q = abs(a) // abs(b)
            return _int_result(q if (a >= 0) == (b >= 0) else -q)  # trunc toward 0
        if b == 0:
            return NULL_DIV_BY_ZERO
        return a / b
    return NULL_BAD_TYPE


def v_mod(a: Any, b: Any) -> Any:
    if is_null(a) or is_null(b):
        return a if is_null(a) else b
    if _both_numeric(a, b):
        if b == 0:
            return NULL_DIV_BY_ZERO
        if isinstance(a, int) and isinstance(b, int):
            return a - b * (abs(a) // abs(b)) * (1 if (a >= 0) == (b >= 0) else -1)
        return math.fmod(a, b)
    return NULL_BAD_TYPE


def v_neg(a: Any) -> Any:
    if is_null(a):
        return a
    if isinstance(a, bool) or not isinstance(a, (int, float)):
        return NULL_BAD_TYPE
    if isinstance(a, int):
        return _int_result(-a)
    return -a


def _neg_duration(d: Duration) -> Duration:
    return Duration(-d.seconds, -d.microseconds, -d.months)


def _time_plus_duration(t: Time, dur: Duration) -> Any:
    """Time-of-day shifted by a duration, wrapping within 24h; month
    components don't apply to a bare time (reference semantics)."""
    if dur.months:
        return NULL_BAD_TYPE
    us = ((t.hour * 3600 + t.minute * 60 + t.sec) * 1_000_000
          + t.microsec + dur.seconds * 1_000_000 + dur.microseconds)
    us %= 24 * 3600 * 1_000_000
    sec, microsec = divmod(us, 1_000_000)
    minute, s = divmod(sec, 60)
    hour, m = divmod(minute, 60)
    return Time(int(hour % 24), int(m), int(s), int(microsec))


def _date_plus_duration(d: Date, dur: Duration) -> Date:
    base = d.to_py()
    m = d.month - 1 + dur.months
    y = d.year + m // 12
    m = m % 12 + 1
    try:
        base = base.replace(year=y, month=m)
    except ValueError:
        # clamp day to month end
        import calendar
        base = base.replace(year=y, month=m, day=calendar.monthrange(y, m)[1])
    base = base + _dt.timedelta(seconds=dur.seconds, microseconds=dur.microseconds)
    return Date(base.year, base.month, base.day)


def _datetime_plus_duration(d: DateTime, dur: Duration) -> DateTime:
    base = _dt.datetime(d.year, d.month, d.day, d.hour, d.minute, d.sec, d.microsec)
    m = d.month - 1 + dur.months
    y = d.year + m // 12
    m = m % 12 + 1
    try:
        base = base.replace(year=y, month=m)
    except ValueError:
        import calendar
        base = base.replace(year=y, month=m, day=calendar.monthrange(y, m)[1])
    base = base + _dt.timedelta(seconds=dur.seconds, microseconds=dur.microseconds)
    return DateTime(base.year, base.month, base.day, base.hour, base.minute,
                    base.second, base.microsecond)


# --------------------------------------------------------------------------
# Comparison
# --------------------------------------------------------------------------

_KIND_ORDER = {
    "__EMPTY__": 0, "bool": 1, "int": 2, "float": 2, "string": 3, "date": 4,
    "time": 5, "datetime": 6, "vertex": 7, "edge": 8, "path": 9, "list": 10,
    "map": 11, "set": 12, "dataset": 13, "duration": 14, "__NULL__": 15,
}


def _comparable(a: Any, b: Any) -> bool:
    if _both_numeric(a, b):
        return True
    ta, tb = type_name(a), type_name(b)
    return ta == tb


def v_eq(a: Any, b: Any) -> Any:
    """nGQL ==: null-propagating equality."""
    if is_null(a) or is_null(b):
        return NULL
    if is_empty(a) or is_empty(b):
        return is_empty(a) and is_empty(b)
    if _both_numeric(a, b):
        return float(a) == float(b)
    if type_name(a) != type_name(b):
        return False
    if isinstance(a, list):
        if len(a) != len(b):
            return False
        for x, y in zip(a, b):
            e = v_eq(x, y)
            if e is not True:
                return e
        return True
    return a == b


def v_ne(a: Any, b: Any) -> Any:
    e = v_eq(a, b)
    if is_null(e):
        return e
    return not e


def _lt_raw(a: Any, b: Any) -> bool:
    try:
        return a < b
    except TypeError:
        return _KIND_ORDER.get(type_name(a), 99) < _KIND_ORDER.get(type_name(b), 99)


def v_lt(a: Any, b: Any) -> Any:
    if is_null(a) or is_null(b) or is_empty(a) or is_empty(b):
        return NULL
    if _both_numeric(a, b):
        return float(a) < float(b)
    if not _comparable(a, b):
        return NULL_BAD_TYPE
    if isinstance(a, list):
        for x, y in zip(a, b):
            lt = v_lt(x, y)
            if lt is True:
                return True
            if is_null(lt):
                return lt
            gt = v_lt(y, x)
            if gt is True:
                return False
        return len(a) < len(b)
    try:
        return bool(a < b)
    except TypeError:
        return NULL_BAD_TYPE


def v_le(a: Any, b: Any) -> Any:
    lt = v_lt(a, b)
    if lt is True:
        return True
    if is_null(lt):
        return lt
    return v_eq(a, b)


def v_gt(a: Any, b: Any) -> Any:
    return v_lt(b, a)


def v_ge(a: Any, b: Any) -> Any:
    return v_le(b, a)


def total_order_key(v: Any):
    """A total-order sort key across heterogeneous values (ORDER BY).

    Empty < numerics < string < ... < NULL (nulls last, matching the
    reference's ORDER BY placement of null/empty).
    """
    tn = type_name(v)
    k = _KIND_ORDER.get(tn, 98)
    if tn in ("int", "float"):
        return (k, float(v))
    if tn in ("__NULL__", "__EMPTY__"):
        return (k, 0)
    if tn == "bool":
        return (k, int(v))
    if tn == "string":
        return (k, v)
    if tn == "list":
        return (k, tuple(total_order_key(x) for x in v))
    if tn == "vertex":
        return (k, total_order_key(v.vid))
    if tn == "edge":
        return (k, tuple(total_order_key(x) for x in v.key()))
    if tn == "path":
        return (k, tuple(total_order_key(x.vid) for x in v.nodes()))
    if tn == "map":
        return (k, tuple((mk, total_order_key(mv)) for mk, mv in sorted(v.items())))
    if tn in ("date", "time", "datetime", "duration"):
        return (k, v._key())
    return (k, str(v))


def hashable_key(v: Any):
    """A hashable identity for DEDUP / GROUP BY / set membership."""
    if isinstance(v, list):
        return ("__list__",) + tuple(hashable_key(x) for x in v)
    if isinstance(v, dict):
        return ("__map__",) + tuple((k, hashable_key(x)) for k, x in sorted(v.items()))
    if isinstance(v, set):
        return ("__set__",) + tuple(sorted((hashable_key(x) for x in v), key=str))
    if isinstance(v, DataSet):
        return ("__ds__", tuple(v.column_names),
                tuple(tuple(hashable_key(c) for c in r) for r in v.rows))
    return v

_register_geo_type()
