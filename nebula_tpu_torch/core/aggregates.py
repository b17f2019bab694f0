"""Aggregate function semantics — COUNT/SUM/AVG/MIN/MAX/COLLECT/STD/BIT_*.

A copy of `nebula_tpu/core/aggregates.py`, the analog of NebulaGraph's
AggData/AggFun machinery (src/common/function, AggregateExecutor).

Null/empty semantics: aggregates skip null & empty inputs (COUNT counts
non-null values; COUNT(*) counts rows).  SUM/AVG on an empty group → 0 /
NULL respectively; MIN/MAX of nothing → NULL.
"""
from __future__ import annotations

import math
from typing import Any, List

from .value import (NULL, NULL_BAD_TYPE, hashable_key, is_empty, is_null,
                    v_lt)


def _non_null(values: List[Any]) -> List[Any]:
    return [v for v in values if not is_null(v) and not is_empty(v)]


def _dedup(values: List[Any]) -> List[Any]:
    seen = set()
    out = []
    for v in values:
        k = hashable_key(v)
        if k not in seen:
            seen.add(k)
            out.append(v)
    return out


def _numeric(values: List[Any]):
    for v in values:
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
    return values


def apply_aggregate(func: str, values: List[Any], distinct: bool = False,
                    star: bool = False) -> Any:
    if func == "count":
        vs = values if star else _non_null(values)
        if distinct:
            vs = _dedup(vs)
        return len(vs)

    vs = _non_null(values)
    if distinct:
        vs = _dedup(vs)

    if func == "collect":
        return list(vs)
    if func == "collect_set":
        try:
            return set(vs)
        except TypeError:
            return NULL_BAD_TYPE

    if func == "sum":
        nums = _numeric(vs)
        if nums is None:
            return NULL_BAD_TYPE
        if not nums:
            return 0
        s = sum(nums)
        return s
    if func == "avg":
        nums = _numeric(vs)
        if nums is None:
            return NULL_BAD_TYPE
        if not nums:
            return NULL
        return float(sum(nums)) / len(nums)
    if func == "min":
        if not vs:
            return NULL
        m = vs[0]
        for v in vs[1:]:
            if v_lt(v, m) is True:
                m = v
        return m
    if func == "max":
        if not vs:
            return NULL
        m = vs[0]
        for v in vs[1:]:
            if v_lt(m, v) is True:
                m = v
        return m
    if func == "std":
        nums = _numeric(vs)
        if nums is None:
            return NULL_BAD_TYPE
        if not nums:
            return NULL
        mean = sum(nums) / len(nums)
        return math.sqrt(sum((x - mean) ** 2 for x in nums) / len(nums))
    if func in ("bit_and", "bit_or", "bit_xor"):
        for v in vs:
            if isinstance(v, bool) or not isinstance(v, int):
                return NULL_BAD_TYPE
        if not vs:
            return NULL
        acc = vs[0]
        for v in vs[1:]:
            if func == "bit_and":
                acc &= v
            elif func == "bit_or":
                acc |= v
            else:
                acc ^= v
        return acc
    raise ValueError(f"unknown aggregate `{func}'")
