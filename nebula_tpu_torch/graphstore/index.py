"""Index key normalization, copied from `nebula_tpu/graphstore/index.py`.

Only `norm` and its MIN/MAX sentinels: the secondary indexes themselves
(`IndexData`, the per-part sorted key lists and their scans) wait for
the port's store.
"""
from __future__ import annotations

from typing import Any

from ..core.value import total_order_key


class _Sentinel:
    """MIN sorts below everything, MAX above (via reflected compares:
    tuple elements fall back to these __gt__/__lt__ when their own
    __lt__ returns NotImplemented)."""

    __slots__ = ("lo",)

    def __init__(self, lo: bool):
        self.lo = lo

    def __lt__(self, o):
        return self.lo

    def __gt__(self, o):
        return not self.lo

    def __repr__(self):
        return "-inf" if self.lo else "+inf"


MIN, MAX = _Sentinel(True), _Sentinel(False)


def norm(v: Any):
    """Index column normalization: total order incl. NULL-last."""
    if isinstance(v, _Sentinel):
        return v
    return total_order_key(v)
