"""The port's copy of `nebula_tpu/exec/context.py`, whole.

Query/Execution contexts + row evaluation contexts.

Analog of the reference's QueryContext / ExecutionContext / Iterator
hierarchy (reference: src/graph/context).  Results are named,
versioned DataSets; row contexts adapt a
row of a given shape (GO row, MATCH row, FETCH row) to the ExprContext
protocol.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..core.expr import ExprContext, get_attribute
from ..core.value import (NULL, NULL_BAD_TYPE, NULL_UNKNOWN_PROP, DataSet,
                          Edge, Tag, Vertex, is_null)
from ..graphstore.store import GraphStore
from ..utils.config import define_flag

define_flag("max_match_hops", 12, "safety cap for unbounded MATCH *")


class QueryContext:
    """Per-engine context: store + catalog access, limits, metrics."""

    def __init__(self, store: GraphStore, params: Optional[Dict[str, Any]] = None):
        self.store = store
        self.params = params or {}
        from ..utils.config import get_config
        self.max_match_hops = int(self.params.get(
            "max_match_hops", get_config().get("max_match_hops")))
        self.tpu_runtime = None     # set by nebula_tpu.tpu when pinned
        # write epoch: bumped once per successful mutating
        # statement this engine executed — the result cache's data-
        # freshness key half (the catalog version covers DDL).  Local
        # by design: it is what lets cached hot reads keep answering
        # while storage is unreachable, at the documented cost that
        # writes issued through a DIFFERENT coordinator are invisible
        # to it (docs/ROBUSTNESS.md §8).  Bump through
        # bump_write_epoch(): a racy `+= 1` from concurrent statement
        # threads could move the epoch BACKWARD and re-expose a stale
        # cached result.
        self.write_epoch = 0
        self._epoch_mu = threading.Lock()
        # per-thread device-plane breadcrumbs: graphd serves concurrent
        # sessions through ONE engine/qctx, so a shared slot would
        # cross-attribute PROFILE stats between queries
        self._tls = threading.local()

    @property
    def last_tpu_stats(self):
        return getattr(self._tls, "tpu_stats", None)

    @last_tpu_stats.setter
    def last_tpu_stats(self, v):
        self._tls.tpu_stats = v

    @property
    def last_tpu_fallback(self):
        return getattr(self._tls, "tpu_fallback", None)

    @last_tpu_fallback.setter
    def last_tpu_fallback(self, v):
        self._tls.tpu_fallback = v

    def bump_write_epoch(self) -> int:
        with self._epoch_mu:
            self.write_epoch += 1
            return self.write_epoch

    @property
    def catalog(self):
        return self.store.catalog

    def _space_has_ttl(self, space: str) -> bool:
        """Cached per catalog version: does ANY tag in the space carry a
        TTL (which makes vertices time-variant)?"""
        memo = getattr(self, "_ttl_memo", None)
        if memo is None:
            memo = self._ttl_memo = {}
        ver = getattr(self.catalog, "version", None)
        hit = memo.get(space)
        if hit is not None and hit[0] == ver:
            return hit[1]
        try:
            has = any(t.latest.ttl_col and t.latest.ttl_duration > 0
                      for t in self.catalog.tags(space))
        except Exception:  # noqa: BLE001 — no such space yet
            has = True      # unknown: be conservative, skip caching
        memo[space] = (ver, has)
        return has

    def build_vertex(self, space: str, vid: Any,
                     tags: Optional[List[str]] = None) -> Optional[Vertex]:
        # epoch-keyed memo: a Vertex is immutable for a given space
        # epoch (every write bumps it), and MATCH/GO pipelines rebuild
        # the same vertices once per row — across rows AND statements
        # the cache hit is exact, never stale
        cache = key = None
        from ..graphstore.store import GraphStore
        # Local stores only: the cluster _SpaceView's epoch property is
        # a part_stats RPC fan-out, far costlier than the build it
        # would save (and its CatalogProxy makes the TTL probe remote).
        if tags is None and isinstance(self.store, GraphStore):
            # TTL rows go invisible by WALL CLOCK without an epoch bump —
            # a TTL'd space must rebuild every time.
            if not self._space_has_ttl(space):
                try:
                    ep = self.store.space(space).epoch
                except Exception:  # noqa: BLE001 — space raced away
                    ep = None
                if ep is not None:
                    cache = getattr(self, "_vx_cache", None)
                    if cache is None:
                        cache = self._vx_cache = {}
                    # catalog.version covers DDL (ALTER/DROP TAG change
                    # what fill_row produces without touching the epoch)
                    key = (space, ep,
                           getattr(self.catalog, "version", 0), vid)
                    hit = cache.get(key)
                    if hit is not None:
                        return hit if hit is not False else None

        def memo(val):
            if cache is not None:
                if len(cache) > 200_000:
                    cache.clear()
                cache[key] = val
            return val

        tv = self.store.get_vertex(space, vid)
        if tv is None:
            memo(False)
            return None
        out = []
        for t, props in sorted(tv.items()):
            if tags and t not in tags:
                continue
            out.append(Tag(t, props))
        if tags and not out:
            return None
        return memo(Vertex(vid, out))


class ExecutionContext:
    """var name → list of DataSet versions (latest last).

    Carries the query's MemoryTracker: every stored result charges the
    budget, and exploding executors (variable-length Traverse, path
    search) charge mid-loop so they die before allocating, not after.
    """

    def __init__(self, tracker=None):
        self.results: Dict[str, List[DataSet]] = {}
        self.values: Dict[str, Any] = {}
        if tracker is None:
            from ..utils.memtracker import MemoryTracker
            tracker = MemoryTracker()
        self.tracker = tracker
        # deterministic per-statement work counts (edges traversed, RPC
        # calls, wire bytes, device dispatches...) — the scheduler
        # installs this as the thread's counting target around every
        # executor run, so RPC/runtime layers attribute to the right
        # statement even on pool threads (docs/OBSERVABILITY.md)
        from ..utils.stats import WorkCounters
        self.work = WorkCounters()
        # the statement's live workload-registry row, or None
        # when the plane is disabled / the context is internal — the
        # scheduler updates it per plan node, the device runtime adds
        # queue/dispatch time through the use_live() thread-local
        self.live = None

    def set_result(self, var: str, ds: DataSet):
        if self.tracker is not None and ds is not None:
            from ..core.value import ColumnarDataSet
            if isinstance(ds, ColumnarDataSet) and ds._cols is not None:
                # charge from the numpy buffers: touching .rows here
                # would materialize per-row Python lists for EVERY
                # columnar result (device GO results, fused MATCH
                # pipelines) — the exact cost the lazy result boundary
                # exists to avoid
                from ..utils.memtracker import approx_columnar_bytes
                self.tracker.charge(approx_columnar_bytes(ds._cols))
            else:
                self.tracker.charge_rows(ds.rows)
        self.results.setdefault(var, []).append(ds)

    def get_result(self, var: str) -> DataSet:
        lst = self.results.get(var)
        if not lst:
            return DataSet()
        return lst[-1]

    def has(self, var: str) -> bool:
        return var in self.results


class RowContext(ExprContext):
    """Adapts one result row to expression evaluation.

    row: dict col_name → value.  Conventions:
      _src/_edge/_dst cols (GO rows) enable $^ / edge / $$ resolution with
      vertex props looked up lazily from the store.
    """

    __slots__ = ("qctx", "space", "row", "extra_vars")

    def __init__(self, qctx: Optional[QueryContext], space: Optional[str],
                 row: Dict[str, Any], extra_vars: Optional[Dict[str, Any]] = None):
        self.qctx = qctx
        self.space = space
        self.row = row
        self.extra_vars = extra_vars or {}

    def get_input_prop(self, name):
        if name in self.row:
            return self.row[name]
        return NULL_UNKNOWN_PROP

    def get_var(self, name):
        if name in self.row:
            return self.row[name]
        if name in self.extra_vars:
            return self.extra_vars[name]
        return NULL_UNKNOWN_PROP

    def get_var_prop(self, var, name):
        v = self.get_var(var)
        if not is_null(v):
            return get_attribute(v, name)
        return NULL_UNKNOWN_PROP

    def _vertex_props(self, vid, tag):
        if self.qctx is None or self.space is None or vid is None:
            return {}
        tv = self.qctx.store.get_vertex(self.space, vid)
        if tv is None:
            return {}
        return tv.get(tag, {})

    def get_src_prop(self, tag, name):
        src = self.row.get("_src")
        if isinstance(src, Vertex):
            return src.prop(tag, name)
        props = self._vertex_props(src, tag)
        return props.get(name, NULL_UNKNOWN_PROP)

    def get_dst_prop(self, tag, name):
        dst = self.row.get("_dst")
        if isinstance(dst, Vertex):
            return dst.prop(tag, name)
        props = self._vertex_props(dst, tag)
        return props.get(name, NULL_UNKNOWN_PROP)

    def get_edge_prop(self, edge, name):
        e = self.row.get("_edge")
        if not isinstance(e, Edge):
            # FETCH PROP ON <edge> rows carry the edge in `edges_`
            # (reference: YIELD knows.since over fetched edges)
            e2 = self.row.get("edges_")
            if isinstance(e2, Edge) and (edge is None or e2.name == edge):
                e = e2
        if isinstance(e, Edge):
            if name == "_src":
                return e.src if e.etype >= 0 else e.dst
            if name == "_dst":
                return e.dst if e.etype >= 0 else e.src
            if name == "_rank":
                return e.ranking
            if name == "_type":
                return e.name
            return e.props.get(name, NULL_UNKNOWN_PROP)
        return NULL_UNKNOWN_PROP

    def get_vertex(self, which=""):
        if which == "$$":
            dst = self.row.get("_dst")
            if isinstance(dst, Vertex):
                return dst
            if dst is not None and self.qctx is not None and self.space:
                v = self.qctx.build_vertex(self.space, dst)
                return v if v is not None else Vertex(dst)
            return NULL_BAD_TYPE
        if which in ("$^", ""):
            src = self.row.get("_src")
            if isinstance(src, Vertex):
                return src
            if src is not None and self.qctx is not None and self.space:
                v = self.qctx.build_vertex(self.space, src)
                return v if v is not None else Vertex(src)
        # FETCH rows: a single vertex value column
        v = self.row.get("vertices_")
        if isinstance(v, Vertex):
            return v
        v = self.row.get("_matched")
        if isinstance(v, Vertex):
            return v
        return NULL_BAD_TYPE

    def get_edge(self):
        e = self.row.get("_edge")
        if isinstance(e, Edge):
            return e
        e = self.row.get("edges_")
        if isinstance(e, Edge):
            return e
        e = self.row.get("_matched")
        if isinstance(e, Edge):
            return e
        return NULL_BAD_TYPE


def row_dict(ds: DataSet, row: List[Any]) -> Dict[str, Any]:
    return dict(zip(ds.column_names, row))


class ResultSet:
    """What a statement returns to the client."""

    __slots__ = ("data", "space", "latency_us", "plan_desc", "error",
                 "comment", "retry_after_ms")

    def __init__(self, data: Optional[DataSet] = None, space: Optional[str] = None,
                 latency_us: int = 0, plan_desc: Optional[str] = None,
                 error: Optional[str] = None, comment: str = ""):
        self.data = data if data is not None else DataSet()
        self.space = space
        self.latency_us = latency_us
        self.plan_desc = plan_desc
        self.error = error
        self.comment = comment
        # structured overload surface: set by GraphClient
        # when an E_OVERLOAD error carries a retry-after hint the
        # caller may honor (None for every other outcome)
        self.retry_after_ms: Optional[int] = None

    @property
    def ok(self) -> bool:
        return self.error is None

    def __repr__(self):
        if self.error:
            return f"ERROR: {self.error}"
        return repr(self.data)
