"""Property types and definitions, copied from
`nebula_tpu/graphstore/schema.py` (the catalog and its versioning wait
for the store slice)."""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any


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


@dataclass
class PropDef:
    name: str
    ptype: PropType
    nullable: bool = True
    default: Any = None          # None = no default
    has_default: bool = False
    fixed_len: int = 0           # FIXED_STRING length
    comment: str = ""
