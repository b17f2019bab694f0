"""The nGQL values the GO result path carries: NULL kinds, Edge and the
row / columnar result tables.

A copy of the parts of `nebula_tpu/core/value.py` this slice needs
(NullKind, NullValue and the interned NULLs, Edge, DataSet,
ColumnarDataSet, value_to_string).  Temporal and geography values are
left out: the port's yield path refuses prop columns of those types.
"""
from __future__ import annotations

import math
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple


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

    # nulls of any kind are equal for hashing/dedup purposes
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


def is_null(v: Any) -> bool:
    return isinstance(v, NullValue)


class Edge:
    __slots__ = ("src", "dst", "etype", "name", "ranking", "props")

    def __init__(self, src: Any, dst: Any, name: str, ranking: int = 0,
                 props: Optional[Dict[str, Any]] = None, etype: int = 0):
        self.src, self.dst = src, dst
        self.name, self.ranking = name, ranking
        self.props = props or {}
        self.etype = etype  # signed edge-type id; negative = reversed view

    def key(self) -> Tuple:
        # direction-insensitive identity of the logical edge
        if self.etype >= 0:
            return (self.src, self.dst, self.name, self.ranking)
        return (self.dst, self.src, self.name, self.ranking)

    def __eq__(self, o):
        return (isinstance(o, Edge) and self.key() == o.key()
                and self.props == o.props)

    def __lt__(self, o):
        return self.key() < o.key()

    def __hash__(self):
        return hash(("Edge",) + self.key())

    def __repr__(self):
        return (f'[:{self.name} "{self.src}"->"{self.dst}" '
                f'@{self.ranking} {self.props!r}]')


class DataSet:
    """A named-column row table — the result/interchange format."""

    __slots__ = ("column_names", "rows")

    def __init__(self, column_names: Optional[List[str]] = None,
                 rows: Optional[List[List[Any]]] = None):
        self.column_names = column_names or []
        self.rows = rows or []

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
        body = "\n".join(" | ".join(value_to_string(c) for c in r)
                         for r in self.rows[:20])
        more = (f"\n... ({len(self.rows)} rows)"
                if len(self.rows) > 20 else "")
        return f"{head}\n{'-' * max(len(head), 1)}\n{body}{more}"


_ROWS_SLOT = DataSet.__dict__["rows"]


class ColumnarDataSet(DataSet):
    """DataSet backed by numpy columns; rows materialize lazily.

    The device plane's result handle: columns are numpy arrays straight
    off the fetched capture buffers, and per-row Python lists are built
    only if something touches ``.rows``.
    """

    __slots__ = ("_cols",)

    def __init__(self, column_names: List[str], cols: List[Any]):
        self.column_names = list(column_names)
        self._cols = list(cols)          # 1-D numpy arrays, equal length
        _ROWS_SLOT.__set__(self, None)

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
        esc = (v.replace("\\", "\\\\").replace('"', '\\"')
               .replace("\n", "\\n").replace("\t", "\\t")
               .replace("\r", "\\r"))
        return f'"{esc}"'
    if isinstance(v, list):
        return "[" + ", ".join(value_to_string(x) for x in v) + "]"
    if isinstance(v, set):
        return "{" + ", ".join(sorted(value_to_string(x) for x in v)) + "}"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k}: {value_to_string(x)}"
                               for k, x in sorted(v.items())) + "}"
    return repr(v)
