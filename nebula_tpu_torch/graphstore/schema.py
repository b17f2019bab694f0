"""Property types and definitions, copied from
`nebula_tpu/graphstore/schema.py` (the catalog and its versioning wait
for the store slice)."""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any

from ..core.value import is_null


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


_FLOAT_TYPES = (PropType.FLOAT, PropType.DOUBLE)


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
