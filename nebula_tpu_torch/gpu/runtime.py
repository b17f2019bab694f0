"""GpuRuntime: pinned snapshots and the GO traversal on one device.

Port of the solo single-device path of `nebula_tpu/tpu/runtime.py`:
`pin` (:555) with `_build_fresh` (:616), `pin_prebuilt` (:871),
`unpin`, `hbm_bytes`, the seed bitmap (:941-987),
`traverse` (:1753) with a columnar YIELD list, `_block_columns` (:2266),
`_materialize_yields` (:2373), `_d2v`, `_cap_keys_for_yields` and
`_cat_parts`, the supernode degree-split at pin time
(`_maybe_degree_split`, :857), `algo_dispatch` (:1105), the algo
plane's one dispatch per iteration, `bfs` (:2121), the device BFS
of FIND SHORTEST PATH, and the delta plane: its arming in
`pin_prebuilt` (the reference's `_arm_delta`, :639),
`_try_delta_update` (:652), `_emit_delta_gauges` (:751), `_maybe_compact`
and `_compact` (:766, :788), `_grab_delta` (:728), `_delta_perms` (:2241)
and the delta decode of `_block_columns` (:2302-2337), the dispatch gate
(`_DispatchGate` :147, `_gated_dispatch` :1052), and the multi-lane
batched GO: `_try_batched` (:1429), the lane seed build (:1138, :976),
`_escalate_lanes` (:1169, here `_run`, which runs a solo statement as
its one lane) and `_lane_attribution` (:1363); GO without yields, whose
rows are `(src_vid, Edge, dst_vid)` triples (`_materialize`, :2354); and
MATCH's device half: `traverse_hops` (:1901), the every-hop capture of
the hop loop, `_build_frames` (:2006), and the frame types and trail
helpers the assembly above it reads, `HopFrame`, `join_frontier_trails`
and `trail_distinct_keep` (:254-405).

The dispatch gate is a read-write lock with writer preference: every
device dispatch (a GO run, solo or batched, a BFS, an algo iteration)
holds the read side; every put (`pin_prebuilt`, a pin from a store, a
compaction's swap), `unpin` and a delta apply hold the write side, so an
apply never lands under a running kernel, and a
snapshot a pin replaced is marked `retired` — a dispatch that finds it
under the gate raises `SnapshotRetired`, a `GpuUnavailable`.

With `batch_max_lanes` > 1 (gpu/batch.py; 0, the default, is off),
concurrent compatible `traverse` calls enrol in one group of the batch
former; one of them runs the hop loop once for all (an (L, P, vmax + H)
frontier through the lane-widened kernels, one gated dispatch, one
fetch) and each takes its own lane back out, with its own hop_edges,
frontier_sizes and WorkCounters — those of its solo run.

`pin(store, space)` builds from the port's own `graphstore.store.
GraphStore` (the reference's `pin`, :555-609, and `_build_fresh`,
:616): a snapshot serves while its epoch is the store's (and it was
built from this store's space: `space_uid`); with a delta plane armed,
the writes the store logged since fold into it; otherwise, and wherever
the fold fails (a broken or gapped log, an overflow, a key the plane
cannot hold, a write to a degree-split snapshot, which arms no plane),
the store is exported again (`graphstore.csr.build_snapshot`, the vmax
slack reserved when the plane is on) and re-pinned.  A plane past
`delta_compact_watermark` is compacted on a thread (`_maybe_compact`,
`_compact`, :766-830): the rebuild runs off the dispatch gate and only
the swap takes its write side.  A store that cannot be exported (the
bench's `datagen.SnapshotStore`, anything but a `GraphStore`) is never
rebuilt or compacted: where the reference would rebuild, `pin` raises
`GpuUnavailable` naming the cause (and unpins the space when the mirror
may be half applied).  A DURATION value written to a DURATION column
raises TypeError from its encode, as the reference's does.

The sharded mesh (`GpuRuntime(mesh=make_mesh(P))`, the reference's
`TpuRuntime(mesh)`, :408-416): a P-part snapshot is pinned slot by slot
(`device.pin_sharded`), and GO, MATCH (batched lanes included) and the
BFS run over the slots (`hop.run_hops_sharded`, `bfs.run_bfs_sharded`),
one bit-packed exchange a hop, under the collective-launch mutex
(:1091-1104).  `TraverseStats.shards` and `.exchange_bytes`, the
per-device budget `hbm_limit_bytes` (the reference's flag
`tpu_hbm_limit_bytes`, `_check_hbm_budget` :829), the gauges `tpu_shards`
and `tpu_shard_hbm_bytes{shard}` (:500-530) and the metric
`tpu_all_to_all_bytes` (:1337-1355, :1720-1748) come with it.  A mesh
over a process group is refused: each rank would hold only its own
parts' captures.

Every prop type decodes as the reference decodes it, temporal and
geography values included (one object a value, `csr.decode_prop`).
`GpuRuntime()` runs on `cuda:0`
(a 1-slot mesh, local mode), and the CPU runs only when the caller
passes `device="cpu"` or a mesh laid over the CPU (the kernels' plain
versions then run).
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import expr as E
from ..core.value import ColumnarDataSet, Edge
from ..graphstore.csr import build_snapshot, decode_prop_column, \
    decode_prop_column_np, degree_split
from ..graphstore.delta import DeltaOverflow, DeltaUnsupported, HostDelta
from ..graphstore.store import GraphStore
from ..utils import trace
from ..utils.failpoints import FailpointError, fail
from ..utils.stats import current_cost, current_work, stats as metrics, \
    use_cost, use_work
from ..utils.workload import current_live, dispatch_table, use_live
from .batch import batch_former
from .bfs import run_bfs, run_bfs_sharded
from .device import DeviceSnapshot, GpuUnavailable, SnapshotRetired, \
    _putter, mesh_lanes, mesh_parts, pin_bytes, pin_sharded, pin_snapshot, \
    put_delta_blocks, resolve_device
from .exprjit import compile_predicate, eval_yield_column_np
from .hop import new_frontier, run_hops, \
    run_hops_sharded, seed_slot_frontiers
from .kernels import mark
from .mesh import InProcess, Mesh

_MAX_YIELD_COLS = 4     # device-gathered yield columns (runtime.py:1812)
# padded local rows a store export reserves, with the delta plane on, for
# vertices inserted after the pin (the reference's flag
# `tpu_delta_vmax_slack`, utils/config.py:230)
DELTA_VMAX_SLACK = 64


def _d2v(host) -> np.ndarray:
    """Cached dense-id → vid array for batch vid decode.  INT64 when every
    vid is an int, object otherwise; also caches whether the mapping is
    the identity (sequential-int-vid spaces skip the gather)."""
    arr = getattr(host, "_d2v_arr", None)
    if arr is None or len(arr) != len(host.dense_to_vid):
        d2v = host.dense_to_vid
        # gate on an ACTUAL int vid: np.asarray would parse digit strings
        sample = next((v for v in d2v if v is not None), None)
        if isinstance(sample, int) and not isinstance(sample, bool):
            try:
                arr = np.asarray(d2v, dtype=np.int64)
            except (TypeError, ValueError, OverflowError):
                arr = np.asarray(d2v, dtype=object)
        else:
            arr = np.asarray(d2v, dtype=object)
        # identity flag published BEFORE the array (a reader that sees
        # the cached array must also see the flag)
        host._d2v_identity = bool(
            arr.dtype.kind == "i"
            and (arr == np.arange(len(arr), dtype=arr.dtype)).all())
        host._d2v_arr = arr
    return arr


def _cap_keys_for_yields(yields, device_props=()) -> Optional[set]:
    """Which capture arrays a yield list reads: a subset of {'src',
    'dst','rank','eidx'} plus 'prop:<name>' for device-gathered props,
    or None (fetch everything) when a yield isn't fully recognized."""
    if yields is None:
        return None
    need = set()
    for e, _ in yields:
        for x in E.walk(e):
            k = x.kind
            if k in ("literal", "function", "edge_prop", "edge"):
                if k == "function":
                    name = getattr(x, "name", "")
                    if name == "src":
                        need.add("src")
                    elif name == "dst":
                        need.add("dst")
                    elif name == "rank":
                        need.add("rank")
                    elif name in ("type", "typeid"):
                        pass             # per-block constants
                    else:
                        return None      # unknown function: fetch all
                elif k == "edge_prop":
                    if x.name == "_rank":
                        need.add("rank")
                    elif x.name == "_src":
                        need.add("src")
                    elif x.name == "_dst":
                        need.add("dst")
                    elif x.name == "_type":
                        pass             # per-block constant
                    elif x.name in device_props:
                        need.add("prop:" + x.name)
                    else:
                        need.add("eidx")
            else:
                return None              # unmodeled expr: fetch all
    return need


def _dst_keys(vids: np.ndarray) -> np.ndarray:
    """int64 sort keys of an object array of dst vids, as the snapshot
    export orders them (`csr.dst_sort_key`): the vid itself in an int
    vid space, the code-point string order otherwise.  An int space's
    dense-to-vid array is an object array when a write left unassigned
    dense ids (None) in the vmax slack; its vids still sort as ints
    (the reference sorts them as strings there, unlike its rebuild)."""
    unset = vids == None  # noqa: E711 — elementwise over objects
    live = vids[~unset]
    if live.size and isinstance(live[0], int):
        return np.where(unset, -1, vids).astype(np.int64)
    return np.unique(vids.astype("U"), return_inverse=True)[1]


def _canonical_perm(ls, rk, dk, is_delta) -> np.ndarray:
    """`np.lexsort((dk, rk, ls))` — the stable sort of one part's
    captured rows by (local src, rank, dst key) — computed as a merge
    when it can be: the base rows come first and are in that order
    already, so only the few delta rows after them are sorted, and each
    is inserted after the base rows whose key is not greater.  The three
    keys pack into one int64 when their ranges fit in 62 bits; otherwise,
    or when the rows are not laid out so, the lexsort itself runs."""
    n_base = int(ls.size - is_delta.sum())
    spans = [(int(c.min()), int(c.max())) for c in (ls, rk, dk)]
    bits = [(hi - lo).bit_length() for lo, hi in spans]
    if sum(bits) <= 62 and not is_delta[:n_base].any():
        key = (((ls - spans[0][0]) << (bits[1] + bits[2]))
               | ((rk - spans[1][0]) << bits[2]) | (dk - spans[2][0]))
        base = key[:n_base]
        if (base[1:] >= base[:-1]).all():
            dkey = key[n_base:]
            order = np.argsort(dkey, kind="stable")
            at = np.searchsorted(base, dkey[order], side="right") \
                + np.arange(order.size)
            perm = np.empty(ls.size, np.int64)
            slot = np.ones(ls.size, bool)
            slot[at] = False
            perm[at] = n_base + order
            perm[slot] = np.arange(n_base)
            return perm
    return np.lexsort((dk, rk, ls))


def _cat_parts(parts, dtype=None):
    """Concatenate per-part kept-prefix slices, preserving (part, slot)
    order; always returns an owned array."""
    if dtype is not None:
        if len(parts) > 1:
            return np.concatenate(parts, dtype=dtype)
        return parts[0].astype(dtype)
    if len(parts) > 1:
        return np.concatenate(parts)
    return parts[0].copy()


def _kept_parts(cap, name: str, pids, perms=None) -> List[np.ndarray]:
    """One block's kept prefix of capture array `name` for each part in
    `pids`, re-ordered by its canonical permutation where `perms` (from
    `_delta_perms`) has one."""
    kc = cap["kcount"]
    parts = [cap[name][p, :kc[p]] for p in pids]
    if perms is not None:
        parts = [a if pm is None else a[pm] for a, pm in zip(parts, perms)]
    return parts


def _cat_kept(cap, name: str, pids, perms=None, dtype=None) -> np.ndarray:
    """`_kept_parts` concatenated, part after part."""
    return _cat_parts(_kept_parts(cap, name, pids, perms), dtype)


def _take_pair_np(col, dcol, rows, e) -> np.ndarray:
    """A prop column's values at [rows, e]: the base column col (P, emax)
    below emax, the delta plane's numpy mirror dcol (P, Dcap) at
    e - emax above it (dcol None: no plane).  rows is a part or an array
    of parts aligned with e."""
    if dcol is None:
        return col[rows, e]
    emax = col.shape[1]
    base = e < emax
    out = np.empty(e.shape, col.dtype)
    if np.ndim(rows) == 0:           # one part: gathers along its rows
        out[base] = col[rows][e[base]]
        out[~base] = dcol[rows][e[~base] - emax]
    else:
        out[base] = col[rows[base], e[base]]
        out[~base] = dcol[rows[~base], e[~base] - emax]
    return out


@contextmanager
def _detached():
    """No WorkCounters, cost sink or live row on this thread: a batch's
    shared run charges each member's lane on its own thread instead."""
    with use_work(None), use_cost(None), use_live(None):
        yield


class _DispatchGate:
    """Read-write gate serializing device dispatch against snapshot
    re-pin and delta apply (the reference's runtime.py:147).

    Dispatches are READERS — they share, so concurrent statements still
    overlap on the card — and a pin or an apply is the WRITER: it waits
    for in-flight dispatches to drain and excludes new ones while it
    runs.  Writer preference (a waiting writer blocks NEW readers) so a
    steady dispatch stream cannot starve a write.

    acquire_* returns the seconds spent waiting — the dispatch side's
    wait is the statement's queue time (tpu_dispatch_queue_us)."""

    __slots__ = ("_cond", "_readers", "_writer", "_writers_waiting")

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self) -> float:
        t0 = time.perf_counter()
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        return time.perf_counter() - t0

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> float:
        t0 = time.perf_counter()
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
                self._writer = True
            finally:
                self._writers_waiting -= 1
        return time.perf_counter() - t0

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    def write_held(self) -> bool:
        """True while a writer holds or waits for the gate — the batch
        former's probe: a group whose window expires then re-arms it
        instead of queueing behind the write."""
        with self._cond:
            return bool(self._writer or self._writers_waiting)


class TraverseStats:
    __slots__ = ("hop_edges", "frontier_sizes", "result_edges", "e_cap",
                 "retries", "steps", "device_s", "pin_s", "put_s",
                 "fetch_s", "mat_s", "total_s", "hbm_bytes", "segments",
                 "queue_s", "shards", "exchange_bytes")

    def __init__(self):
        self.hop_edges: List[int] = []
        self.frontier_sizes: List[int] = []   # popcount entering each hop
        self.result_edges = 0
        self.e_cap: List[int] = []            # per-hop slot width
        self.retries = 0                      # no escalation: always 0
        self.steps = 0
        # per-phase wall time; device_s ends in a device synchronisation
        self.device_s = 0.0
        self.pin_s = 0.0
        self.put_s = 0.0
        self.fetch_s = 0.0
        self.mat_s = 0.0
        self.total_s = 0.0
        self.hbm_bytes = 0
        # per-segment rows of a fused pipeline (gpu/pipeline.py fills
        # it; the scheduler's PROFILE reads it)
        self.segments: List[dict] = []
        # the dispatch gate's wait, plus the forming window when batched
        self.queue_s = 0.0
        # mesh facts: the shard slots the dispatch spanned and the bytes
        # its bit-packed exchanges moved (0 in local mode)
        self.shards = 1
        self.exchange_bytes = 0

    def edges_traversed(self) -> int:
        return int(sum(self.hop_edges))


class HopFrame:
    """One hop's captured edge set, columnar, indexed for path assembly.

    src/dst: (n,) int64 dense vertex ids in capture order (block-major,
    then part, then per-src CSR slot order — matching the host
    get_neighbors iteration).  Edge OBJECTS are decoded lazily: the
    vectorized trail assembly touches only the entries that land on an
    emitted path, and the full `.edges` object array is built only for
    the DFS consumers (the reference's exec/algorithms.py) that ask for
    it.

    Trail-dedup identity is columnar too: (key_et, key_s, key_d, rank)
    is the canonical physical-edge key (reverse-direction copies of one
    logical edge canonicalize equal), compared component-wise — no
    per-edge Python hashing.
    """
    __slots__ = ("src", "dst", "rank", "n", "order", "_us", "_ustart",
                 "_ucnt", "key_et", "key_s", "key_d",
                 "_segs", "_decode_seg", "_eobjs", "_edone", "_all_done")

    @classmethod
    def empty(cls) -> "HopFrame":
        f = cls()
        f.src = np.empty((0,), np.int64)
        f.dst = np.empty((0,), np.int64)
        f.rank = np.empty((0,), np.int64)
        f.key_et = np.empty((0,), np.int64)
        f.key_s = np.empty((0,), np.int64)
        f.key_d = np.empty((0,), np.int64)
        f.n = 0
        f.order = np.empty((0,), np.int64)
        f._us = np.empty((0,), np.int64)
        f._ustart = np.empty((0,), np.int64)
        f._ucnt = np.empty((0,), np.int64)
        f._segs = []
        f._decode_seg = None
        f._eobjs = np.empty((0,), object)
        f._edone = None
        f._all_done = True
        return f

    @classmethod
    def build(cls, src, dst, rank, key_et, key_s, key_d, segs,
              decode_seg) -> "HopFrame":
        """segs: list of (seg_start, seg_end, payload); decode_seg(
        payload, offsets) -> list[Edge] decodes a segment's entries at
        `offsets` (segment-relative)."""
        if src is None or src.size == 0:
            return cls.empty()
        f = cls()
        f.src, f.dst, f.rank = src, dst, rank
        f.key_et, f.key_s, f.key_d = key_et, key_s, key_d
        f.n = src.size
        f.order = np.argsort(src, kind="stable")
        ss = src[f.order]
        starts = np.flatnonzero(np.concatenate(
            [[True], ss[1:] != ss[:-1]]))
        f._us = ss[starts]
        f._ustart = starts
        f._ucnt = np.diff(np.concatenate([starts, [ss.size]]))
        f._segs = segs
        f._decode_seg = decode_seg
        f._eobjs = None
        f._edone = None
        f._all_done = False
        return f

    def out_edges(self, dense_id: int):
        """Indices (into src/dst/edges) of this hop's edges out of
        dense_id, in CSR order."""
        p = np.searchsorted(self._us, dense_id)
        if p >= self._us.size or self._us[p] != dense_id:
            return ()
        return self.order[self._ustart[p]:self._ustart[p]
                          + self._ucnt[p]]

    def src_slices(self):
        """(us, ustart, ucnt): sorted unique srcs with their slice into
        `order` — the vectorized join's lookup table."""
        return self._us, self._ustart, self._ucnt

    def decode(self, idx: np.ndarray) -> np.ndarray:
        """Edge objects for frame indices `idx` (object array, aligned
        with idx).  Decodes each entry at most once across calls."""
        if self._eobjs is None:
            self._eobjs = np.full((self.n,), None, dtype=object)
            self._edone = np.zeros((self.n,), bool)
        eo = self._eobjs
        if idx.size:
            uniq = np.unique(idx)
            need = uniq[~self._edone[uniq]]
            for (s0, s1, payload) in self._segs:
                m = need[(need >= s0) & (need < s1)]
                if m.size == 0:
                    continue
                eo[m] = self._decode_seg(payload, m - s0)
                self._edone[m] = True
        return eo[idx]

    @property
    def edges(self) -> np.ndarray:
        """All Edge objects (decodes the whole frame once) — the DFS
        consumers' contract.  O(1) once fully decoded (a per-access
        `_edone.all()` would make a DFS replay O(n²))."""
        if not self._all_done:
            self.decode(np.arange(self.n, dtype=np.int64))
            self._all_done = True
        return self._eobjs


def join_frontier_trails(fr: "HopFrame", last: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """One searchsorted join of per-trail endpoints against a frame's
    src index.  Returns (parent, fidx): for every (trail, edge)
    continuation, the trail's index into `last` and the frame entry —
    in frame CSR order within each trail.  Shared by the MATCH
    executor's assembly and the fused MATCH aggregation (the reference's
    executors.py and tpu/match_agg.py: one source for the join's edge
    cases).  A caller stops at an empty frame: joining a non-empty
    `last` against one raises IndexError, as in the reference."""
    us, ustart, ucnt = fr.src_slices()
    p = np.searchsorted(us, last)
    p = np.minimum(p, max(us.size - 1, 0))
    hit = us[p] == last
    cnt = np.where(hit, ucnt[p], 0)
    start = np.where(hit, ustart[p], 0)
    ends = np.cumsum(cnt)
    total = int(ends[-1]) if cnt.size else 0
    if total == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64))
    k = np.arange(total, dtype=np.int64)
    parent = np.searchsorted(ends, k, side="right")
    within = k - (ends[parent] - cnt[parent])
    fidx = fr.order[start[parent] + within]
    return parent, fidx


def trail_distinct_keep(frames: List["HopFrame"], path: List[np.ndarray],
                        parent: np.ndarray, fr: "HopFrame",
                        fidx: np.ndarray) -> np.ndarray:
    """Relationship-uniqueness mask: for each candidate continuation,
    compare the new edge's canonical key against every earlier hop of
    its trail (componentwise over the frames' key columns)."""
    keep = np.ones(fidx.size, bool)
    for eh, pe in enumerate(path):
        pf = frames[eh]
        pidx = pe[parent]
        keep &= ~((pf.key_et[pidx] == fr.key_et[fidx])
                  & (pf.key_s[pidx] == fr.key_s[fidx])
                  & (pf.key_d[pidx] == fr.key_d[fidx])
                  & (pf.rank[pidx] == fr.rank[fidx]))
    return keep


class GpuRuntime:
    """Holds the pinned spaces of one device, or of a mesh of shard
    slots, and runs GO, MATCH and the BFS on them.

    device: the one device of local mode (None: cuda:0).  mesh: an
    in-process mesh (`device.make_mesh`) instead; a 1-slot mesh is local
    mode.

    hbm_limit_bytes: the reference's flag `tpu_hbm_limit_bytes` (0, the
    default here, is off): a pin that would put more bytes than this on
    one device, the snapshots already pinned included, raises
    GpuUnavailable.  Each entry of the mesh's device list is one device:
    slots laid on the same entry sum on it.

    degree_split_threshold: the reference's flag
    `tpu_degree_split_threshold` (utils/config.py:184; 0 = off).  When it
    is > 0, `pin_prebuilt` splits every vertex whose degree exceeds it
    into hub rows spread over the parts (graphstore.csr.degree_split).

    delta_max_edges: the reference's flag `tpu_delta_max_edges`, the
    per-(block, part) delta capacity (0 = the delta plane is off).  When
    it is > 0, every pin arms an empty plane on an unsplit snapshot, and
    `pin` folds the writes a store logged since into it.

    delta_compact_watermark: the reference's flag
    `tpu_delta_compact_watermark`: past this fill ratio of the plane, an
    apply starts a background compaction (0 = never)."""

    def __init__(self, device: Any = None, degree_split_threshold: int = 0,
                 delta_max_edges: int = 0, mesh: Optional[Mesh] = None,
                 hbm_limit_bytes: int = 0,
                 delta_compact_watermark: float = 0.75):
        if mesh is None:
            mesh = Mesh(1, [resolve_device(device)], InProcess())
        elif device is not None:
            raise ValueError("pass a device or a mesh, not both")
        self._mesh_epoch = 0
        self._adopt_mesh(mesh)
        self.degree_split_threshold = int(degree_split_threshold)
        self.delta_max_edges = int(delta_max_edges)
        self.delta_compact_watermark = float(delta_compact_watermark)
        self.hbm_limit_bytes = int(hbm_limit_bytes)
        self.snapshots: Dict[str, DeviceSnapshot] = {}
        self._gate = _DispatchGate()

    @staticmethod
    def _check_mesh(mesh: Mesh) -> None:
        """A runtime lies over an in-process mesh whose every device
        resolves."""
        if not mesh.in_process:
            raise GpuUnavailable(
                "a runtime over a process-group mesh is not ported: "
                "each rank holds only its own parts' captures (run "
                "hop.run_hops_sharded on it directly)")
        for d in mesh.devices:
            resolve_device(d)

    def _adopt_mesh(self, mesh: Mesh) -> None:
        self._check_mesh(mesh)
        self.device = mesh.devices[0]
        self.mesh = mesh
        self.mesh_size = mesh_parts(mesh)
        self.mesh_lanes = mesh_lanes(mesh)
        self.local_mode = self.mesh_size == 1

    def _mesh_key(self) -> Tuple[int, int, int]:
        """(lanes, parts, mesh epoch): the launch-grid identity every
        batch compatibility key carries (the reference's runtime.py:471)."""
        return (self.mesh_lanes, self.mesh_size, self._mesh_epoch)

    def set_mesh(self, mesh: Mesh) -> None:
        """Swap the runtime onto another one-axis mesh (the reference's
        runtime.py:476-500).  Under the WRITE side of the dispatch gate
        (in-flight dispatches drain first): every pinned snapshot is
        retired and dropped — its tensors are laid out for the old mesh
        and are freed once no run holds them; a run that grabbed one
        raises SnapshotRetired and its executor runs it again on the new
        pin — the mesh is swapped, and the mesh epoch bumps, so a batch
        group still forming against the old mesh never merges with
        lanes for the new one."""
        self._check_mesh(mesh)
        self._gate.acquire_write()
        try:
            for space in list(self.snapshots):
                self._unpin_locked(space)
            self._adopt_mesh(mesh)
            self._mesh_epoch += 1
        finally:
            self._gate.release_write()
        self._emit_hbm_gauges()

    @contextmanager
    def _collective_launch(self):
        """The collective-launch mutex (the reference's
        runtime.py:1091-1104): a sharded run exchanges between its slots
        every hop; two runs over one mesh must not interleave their
        collectives, so every sharded dispatch holds the mesh's lock.
        Local mode has no exchange and keeps full dispatch concurrency.
        Yields a one-entry list that holds, once the block ends, the bytes
        the mesh's transport shipped inside it (0 in local mode)."""
        sent = [0]
        if self.local_mode:
            yield sent
            return
        transport = self.mesh.transport
        with self.mesh.launch_lock:
            before = transport.sent_bytes
            try:
                yield sent
            finally:
                sent[0] = transport.sent_bytes - before

    # -- pinning ----------------------------------------------------------

    def pin_prebuilt(self, snap) -> DeviceSnapshot:
        """Pin an externally built CsrSnapshot (bulk-ingest / bench path),
        replacing any snapshot of the same space (which is retired).  With
        the degree-split threshold set, an unsplit snapshot is split
        first, and the pinned copy and its host mirror share the split
        layout.  The put runs under the write side of the dispatch gate:
        in-flight dispatches drain first, new ones wait."""
        snap, hd = self._prepare(snap)
        wait_s = self._gate.acquire_write()
        try:
            dev = self._put_locked(snap, hd, None)
        finally:
            self._gate.release_write()
        self._count_pin(wait_s)
        return dev

    def _prepare(self, snap):
        """(snapshot as pinned, its empty delta mirror or None): the
        degree split when the threshold is set, the int32 range check,
        and the plane armed at pin time, so the first write costs one
        small apply.  Degree-split snapshots opt out: hub rows re-home
        edges, so delta row identity breaks."""
        if self.degree_split_threshold > 0 and snap.hub_dense is None:
            snap = degree_split(snap, self.degree_split_threshold)
        if snap.num_parts * snap.vmax >= 1 << 31:
            # dense ids are int32 on the device, as in the reference
            raise GpuUnavailable(
                f"P*vmax = {snap.num_parts * snap.vmax} exceeds int32")
        hd = HostDelta(snap, self.delta_max_edges) \
            if self.delta_max_edges > 0 and snap.hub_dense is None else None
        return snap, hd

    def _put_locked(self, snap, hd, space_uid) -> DeviceSnapshot:
        """Retire the space's snapshot and put `snap` (and its empty
        plane) in its place; the caller holds the write side of the
        gate."""
        self._check_hbm_budget(snap, snap.space,
                               0 if hd is None else hd.nbytes())
        self._unpin_locked(snap.space)
        dev = (pin_snapshot(snap, self.device) if self.local_mode
               else pin_sharded(snap, self.mesh))
        if hd is not None:
            put_delta_blocks(dev, hd)
        dev.space_uid = space_uid
        self.snapshots[snap.space] = dev
        return dev

    def _count_pin(self, wait_s: float) -> None:
        st = metrics()
        st.observe("tpu_repin_wait_us", int(wait_s * 1e6))
        st.inc("tpu_pins")
        self._emit_hbm_gauges()

    def _home_bytes(self, per_slot: Dict[int, int]) -> Counter:
        """Bytes per slot, summed per device of the mesh (the index of
        its entry in the device list)."""
        out: Counter = Counter()
        for part, b in per_slot.items():
            out[self.mesh.homes[part - self.mesh.first]] += b
        return out

    def _check_hbm_budget(self, snap, space: str, delta_bytes: int) -> None:
        """Refuse a pin that would put more than `hbm_limit_bytes` on one
        device (the reference's `_check_hbm_budget`, runtime.py:829): each
        slot takes what `pin_bytes` counts for it (its part's rows, the
        hub tables, its share of the delta plane armed at pin time), the
        slots that share a device sum on it, and the other spaces' pinned
        bytes add to it."""
        if not self.hbm_limit_bytes:
            return
        need = self._home_bytes(pin_bytes(snap, self.mesh, delta_bytes))
        for sp, other in self.snapshots.items():
            if sp != space:
                need.update(self._home_bytes(other.shard_hbm_bytes()))
        home, worst = max(need.items(), key=lambda kv: kv[1])
        if worst > self.hbm_limit_bytes:
            raise GpuUnavailable(
                f"pinning space {space!r} needs {worst:,} bytes on device "
                f"{home} ({self.mesh_size} shard slot(s), other spaces "
                f"included), past the limit of {self.hbm_limit_bytes:,} "
                f"(hbm_limit_bytes)")

    def _emit_hbm_gauges(self) -> None:
        """The residency gauges (the reference's runtime.py:500-530): the
        total, the per-slot ledger `tpu_shard_hbm_bytes{shard}` summed over
        the pinned spaces, and the mesh width `tpu_shards`."""
        per: Counter = Counter()
        for dev in list(self.snapshots.values()):
            per.update(dev.shard_hbm_bytes())
        st = metrics()
        st.gauge("tpu_hbm_bytes_pinned", float(sum(per.values())))
        st.gauge("tpu_shards", float(self.mesh_size))
        for p in self.mesh.parts:
            st.gauge_labeled("tpu_shard_hbm_bytes", {"shard": p},
                             float(per.get(p, 0)))

    @staticmethod
    def _served_epoch(dev: DeviceSnapshot) -> int:
        """The store epoch a snapshot serves: the pin's, advanced by every
        applied delta."""
        return dev.delta.applied_epoch if dev.delta is not None \
            else dev.epoch

    @staticmethod
    def exportable(store) -> bool:
        """Whether `pin` can build a snapshot of `store`: only the port's
        own `GraphStore` is exported; a stand-in that merely serves dense
        ids and logs writes (the bench's `datagen.SnapshotStore`) is
        pinned with `pin_prebuilt` and never rebuilt or compacted."""
        return isinstance(store, GraphStore)

    def pin(self, store, space: str, force: bool = False) -> DeviceSnapshot:
        """The pinned snapshot serving `space` at the store's epoch.  A
        snapshot of this store's space that serves the epoch is returned
        as it is; with a delta plane armed, the writes the store logged
        since are folded into it first (`_try_delta_update`).  Otherwise
        (nothing pinned, `force`, another store's snapshot, no plane, or a
        fold the plane cannot take) the store is exported and re-pinned
        (`_pin_fresh`); a store that cannot be exported raises
        GpuUnavailable naming the cause."""
        sd = store.space(space)
        uid = getattr(sd, "uid", None)
        cur = self.snapshots.get(space)
        if cur is None:
            cause = "none is pinned"
        elif force:
            cause = "a forced re-pin"
        elif cur.space_uid != uid and self.exportable(store):
            # uid guards the (space, epoch) check against another store
            # whose same-named space happens to share the epoch value; a
            # stand-in is served by the snapshot pinned for it
            cause = "the pinned one was not built from this store"
        elif self._served_epoch(cur) == sd.epoch:
            return cur
        elif cur.delta is not None and hasattr(store, "delta_records") \
                and hasattr(store, "delta_reader"):
            dev, cause = self._try_delta_update(store, space, cur)
            if dev is not None:
                return dev
        elif cur.delta is not None:
            cause = "the store logs no writes (no delta_records)"
        else:
            cause = "the pinned one has no delta plane" + (
                " (degree-split)" if cur.num_hubs else "")
        if not self.exportable(store):
            raise GpuUnavailable(
                f"space {space!r} has no snapshot pinned at epoch "
                f"{sd.epoch} ({cause}), and a {type(store).__name__} "
                f"cannot be exported: pin one with pin_prebuilt")
        return self._pin_fresh(store, space, force)

    def _build_fresh(self, store, space: str):
        """Export the store's space for a full (re)pin (the reference's
        `_build_fresh`, :616): with the plane on, the store starts (or
        keeps) watching dirty keys BEFORE the export — a key noted
        between the watch and the export is merely re-read at apply
        time, so no write is lost — and the export reserves the vmax
        slack.  Returns `_prepare`'s (snapshot, empty mirror)."""
        if self.delta_max_edges > 0:
            store.delta_watch(space)
        t0 = time.perf_counter()
        snap = build_snapshot(
            store, space, vmax_extra=DELTA_VMAX_SLACK
            if self.delta_max_edges > 0 else 0)
        metrics().observe("tpu_snapshot_build_us",
                          int((time.perf_counter() - t0) * 1e6))
        return self._prepare(snap)

    def _pin_fresh(self, store, space: str, force: bool) -> DeviceSnapshot:
        """Build and pin (the reference's `pin`, :583-609): the put runs
        under the write side of the dispatch gate, and a concurrent pin
        that already put a snapshot serving this epoch wins."""
        sd = store.space(space)
        uid = getattr(sd, "uid", None)
        snap, hd = self._build_fresh(store, space)
        wait_s = self._gate.acquire_write()
        try:
            old = self.snapshots.get(space)
            if old is not None and not force and not old.retired \
                    and old.space_uid == uid \
                    and self._served_epoch(old) == sd.epoch:
                return old
            dev = self._put_locked(snap, hd, uid)
        finally:
            self._gate.release_write()
        self._count_pin(wait_s)
        return dev

    def _try_delta_update(self, store, space: str, dev: DeviceSnapshot
                          ) -> Tuple[Optional[DeviceSnapshot], str]:
        """Advance a delta-armed snapshot to the store's epoch without a
        re-pin: read the dirty keys, apply them to the host mirror by
        re-reading the store, put only the changed blocks, and trim the
        consumed keys from the log.  It runs under the write side of the
        dispatch gate and re-reads the log there: writes that landed
        while it waited fold into this apply, and a concurrent first pin
        that applied them already leaves nothing to do.  Returns (the
        snapshot, "") or, where the reference takes the full-rebuild
        path, (None, the cause).  After a failed apply the mirror may be
        half applied: on a store that cannot be rebuilt the space is
        unpinned; on one that can, the rebuild retires it."""
        self._gate.acquire_write()
        try:
            replaced = self.snapshots.get(space) is not dev or dev.retired
            if not replaced:
                cause = self._apply_delta_locked(store, space, dev)
        finally:
            self._gate.release_write()
        if replaced:                     # a concurrent pin swapped it
            return self.pin(store, space), ""
        if cause:
            return None, cause
        self._emit_delta_gauges(dev)
        metrics().inc("tpu_repin_avoided")
        self._maybe_compact(store, space, dev)
        return dev, ""

    def _apply_delta_locked(self, store, space: str,
                            dev: DeviceSnapshot) -> str:
        """The apply of `_try_delta_update`; the caller holds the write
        side of the gate.  Returns "" or the cause of a failure."""
        dd = dev.delta
        rec = store.delta_records(space)
        if rec is None:
            return "the delta log is broken or not watching"
        keys, target, floor = rec
        if floor > dd.applied_epoch:
            return (f"the delta log starts at epoch {floor}, after the "
                    f"plane's {dd.applied_epoch} (a log gap)")
        if target == dd.applied_epoch:
            return ""                    # a concurrent update got there
        try:
            changes = dd.host.apply(store.delta_reader(space), keys)
        except (DeltaOverflow, DeltaUnsupported) as ex:
            if not self.exportable(store):
                self._unpin_locked(space)
            return f"delta apply failed ({type(ex).__name__}: {ex})"
        put_delta_blocks(dev, dd.host, sorted(changes.blocks))
        if changes.num_vertices:
            nv = np.ascontiguousarray(dd.host.snap.num_vertices, np.int32)
            if dev.shards:
                for sh in dev.shards:
                    sh.num_vertices = torch.from_numpy(
                        nv[sh.part:sh.part + 1].copy()).to(sh.device)
            else:
                dev.num_vertices = torch.from_numpy(nv).to(self.device)
        # the tag columns the writes changed are put again whole, as the
        # reference's runtime.py:692-705 does; each slot its own row
        for tag, colname in sorted(changes.tag_cols):
            tt = dd.host.snap.tags.get(tag)
            for tags, put in ([(sh.tags, _putter(sh.device, rows=sh.part))
                               for sh in dev.shards]
                              or [(dev.tags, _putter(self.device))]):
                dt = tags.get(tag)
                if dt is None or tt is None:
                    continue
                if colname == "present":
                    dt.present = put(tt.present)
                else:
                    dt.props[colname] = put(tt.props[colname])
        dd.applied_epoch = target
        store.delta_trim(space, keys)
        self._emit_hbm_gauges()
        return ""

    def _emit_delta_gauges(self, dev: DeviceSnapshot) -> None:
        """The plane's residency gauges (the reference's :751)."""
        if dev.delta is None:
            return
        hd = dev.delta.host
        st = metrics()
        st.gauge("tpu_delta_edges",
                 float(hd.total_edges() + hd.total_tombs()))
        st.gauge("tpu_delta_bytes", float(hd.nbytes()))
        per, tpp = hd.edges_per_part(), hd.tombs_per_part()
        for p in range(dev.num_parts):
            st.gauge_labeled("tpu_shard_delta_edges", {"shard": p},
                             float(per[p] + tpp[p]))

    def _maybe_compact(self, store, space: str,
                       dev: DeviceSnapshot) -> None:
        """The watermark check after an apply (the reference's :766): past
        the fill ratio, start the background compaction.  Never on a
        store that cannot be exported."""
        wm = self.delta_compact_watermark
        if wm <= 0 or dev.delta is None or dev.retired \
                or not self.exportable(store):
            return
        if dev.delta.host.fill_ratio() < wm:
            return
        if getattr(dev, "_compacting", False):
            return
        dev._compacting = True
        t = threading.Thread(target=self._compact,
                             args=(store, space, dev), daemon=True,
                             name=f"gpu-compact-{space}")
        dev._compact_thread = t
        t.start()

    def _compact(self, store, space: str, dev: DeviceSnapshot) -> None:
        """Fold the plane back into a fresh base (the reference's :788):
        the whole build runs OFF the dispatch gate (reads keep flowing
        against the old base and its plane); only the swap takes the
        write side.  A snapshot replaced while building is left alone.
        Errors are swallowed, as the reference's are: the old snapshot
        serves on."""
        t0 = time.perf_counter()
        try:
            with trace.span("tpu:compaction", space=space):
                snap, hd = self._build_fresh(store, space)
                fail.hit("tpu:compact_swap", key=space)
                self._gate.acquire_write()
                try:
                    if self.snapshots.get(space) is not dev \
                            or dev.retired:
                        return           # superseded while building
                    new = self._put_locked(snap, hd, dev.space_uid)
                finally:
                    self._gate.release_write()
                metrics().inc("tpu_compactions")
                self._emit_delta_gauges(new)
                self._emit_hbm_gauges()
                trace.record_phase("tpu:compaction",
                                   time.perf_counter() - t0, space=space)
        except FailpointError:
            pass                         # KILL test hook: abort cleanly
        except Exception:  # noqa: BLE001 — background thread must not die
            pass
        finally:
            dev._compacting = False

    @staticmethod
    def _grab_delta(dev: DeviceSnapshot, block_keys, prop_names):
        """Grab ONE consistent delta view for a run: (view, per-block
        tensor dicts — on a sharded pin, one such list a slot).  `view` is
        the (epoch, blocks) tuple; the materializer decodes this run's
        capture against view[1]'s numpy mirrors, never against dev.delta's
        current state (an apply replaces, never mutates, so the grabbed
        arrays stay coherent)."""

        def tensors(e):
            d = {k: e[k] for k in ("d_src", "d_dst", "d_rank", "d_valid",
                                   "d_tomb")}
            d["d_props"] = {n: e["d_props"][n] for n in prop_names}
            return d

        if dev.delta is None:
            none = [None] * len(block_keys)
            return None, ([none] * len(dev.shards) if dev.shards else none)
        view = dev.delta.view
        entries = [view[1].get(bk) for bk in block_keys]
        if dev.shards:
            return view, [[None if e is None else tensors(e["slots"][i])
                           for e in entries]
                          for i in range(len(dev.shards))]
        return view, [None if e is None else tensors(e) for e in entries]

    @staticmethod
    def _insert_view(dview, block_keys):
        """The delta view the capture decodes against: None when the
        blocks' planes hold no insert row — a plane without one appends
        no slot, so the capture is in base order and decodes as without a
        plane."""
        if dview is None or not any(
                dview[1][bk]["np"]["d_valid"].any() for bk in block_keys):
            return None
        return dview

    def unpin(self, space: str) -> None:
        """Drop a space's snapshot (it is retired), under the write side
        of the dispatch gate."""
        self._gate.acquire_write()
        try:
            self._unpin_locked(space)
        finally:
            self._gate.release_write()

    def _unpin_locked(self, space: str) -> None:
        old = self.snapshots.pop(space, None)
        if old is not None:
            old.retired = True
        self._emit_hbm_gauges()

    def hbm_bytes(self) -> int:
        return sum(s.hbm_bytes() for s in self.snapshots.values())

    @contextmanager
    def _gated_dispatch(self, kernel: str):
        """The prologue and epilogue of every device dispatch (GO solo or
        batched, the BFS, an algo iteration): register in the live
        DispatchTable (queued → running → done), hit the
        `tpu:dispatch_gate` failpoint, wait on the READ side of the
        dispatch gate, and land the wait in
        `tpu_dispatch_queue_us{kernel}`, the statement's cost sink and
        its live-registry row.  Yields the queue wait in µs."""
        tok = dispatch_table().enter(kernel)
        acquired = False
        try:
            # inside the try: a `raise` action must still exit the token
            fail.hit("tpu:dispatch_gate", key=kernel)
            self._gate.acquire_read()
            acquired = True
            wait_us = dispatch_table().mark_running(tok)
            metrics().observe("tpu_dispatch_queue_us", wait_us,
                              {"kernel": kernel})
            cc = current_cost()
            if cc is not None:
                cc.add("queue_us", wait_us)
            lv = current_live()
            if lv is not None:
                lv.add("queue_us", wait_us)
            yield wait_us
        finally:
            if acquired:
                self._gate.release_read()
            dispatch_table().exit(tok)

    @staticmethod
    def _check_live(dev: DeviceSnapshot) -> None:
        """Under the read gate: a snapshot a pin replaced is not run."""
        if dev.retired:
            raise SnapshotRetired(
                f"the snapshot of space {dev.space!r} was retired by a "
                f"concurrent pin")

    @staticmethod
    def _charge(device_us: int, stats: Optional["TraverseStats"] = None,
                queue_us: int = 0) -> None:
        """Charge one dispatch to this thread's WorkCounters, cost sink
        and live row (the reference's `_escalate_locked` and
        `_lane_attribution`): the dispatch and its device µs, with a
        traversal's `stats` its edges and frontier sizes, and queue µs
        the gate did not charge already (a batched lane's)."""
        wc = current_work()
        if wc is not None:
            wc.add("device_dispatches")
            if stats is not None:
                wc.add("edges_traversed", stats.edges_traversed())
                wc.extend_frontier(stats.frontier_sizes)
        for sink, field in ((current_cost(), "device_dispatches"),
                            (current_live(), "dispatches")):
            if sink is not None:
                sink.add("device_us", device_us)
                sink.add(field, 1)
                if queue_us:
                    sink.add("queue_us", queue_us)

    def algo_dispatch(self, kernel: str, fn, *args):
        """One device dispatch of the algo plane: an iteration step of
        static full-graph shapes, under the read side of the dispatch
        gate.  Runs fn(*args), waits for the device and returns (result,
        wall µs); the µs land in the cost sink and the live row, one
        dispatch in the WorkCounters."""
        with self._gated_dispatch(kernel):
            t0 = time.perf_counter()
            res = fn(*args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            us = int((time.perf_counter() - t0) * 1e6)
        self._charge(us)
        return res, us

    # -- traversal --------------------------------------------------------

    @staticmethod
    def _seed_sorted(dense_ids: Sequence[int], P: int,
                     vmax: int) -> List[int]:
        """Normalized seed list with the range check: an id outside
        [0, P*vmax) (a stale or foreign snapshot) fails loudly here and
        never reaches a kernel."""
        d = sorted(set(int(x) for x in dense_ids if x >= 0))
        if d and d[-1] >= P * vmax:
            raise ValueError(
                f"dense seed id {d[-1]} out of range for snapshot "
                f"(P={P}, vmax={vmax})")
        return d

    def _seed_frontier(self, dev: DeviceSnapshot,
                       dense_ids: Sequence[int]) -> torch.Tensor:
        """The solo seed frontier buffer (hop.new_frontier): lane 0 of a
        one-lane `_seed_frontier_lanes`."""
        return self._seed_frontier_lanes(dev, [dense_ids])[0]

    def _seed_frontier_lanes(self, dev: DeviceSnapshot,
                             lane_dense: Sequence[Sequence[int]]
                             ) -> torch.Tensor:
        """The lane-batched seed build (the reference's vmapped seed
        builder, runtime.py:976, fed by `_seed_frontier_prep_lanes`
        :1138): every lane's seed ids padded with -1 to one (L, cap)
        block, marked by ONE `mark` launch into an (L, P, vmax + H)
        stack of frontier buffers.  The port sizes L exactly (no pow2
        padding: nothing is compiled per shape)."""
        P, vmax = dev.num_parts, dev.vmax
        lanes = [self._seed_sorted(d, P, vmax) for d in lane_dense]
        cap = max((len(d) for d in lanes), default=0) or 1
        pad = np.full((len(lanes), cap), -1, np.int32)
        for i, d in enumerate(lanes):
            pad[i, :len(d)] = d
        ids = torch.from_numpy(pad).to(self.device)
        fbm = new_frontier(dev, lanes=len(lanes))
        mark(ids, P, vmax, out=fbm[..., :vmax])
        return fbm

    @staticmethod
    def _blocks_for(etypes: Sequence[str], direction: str):
        keys = []
        for et in etypes:
            if direction in ("out", "both"):
                keys.append((et, "out"))
            if direction in ("in", "both"):
                keys.append((et, "in"))
        return keys

    def _compile_filter(self, dev: DeviceSnapshot, sd, block_keys,
                        edge_filter: Optional[E.Expr]):
        """The WHERE program, compiled against the first block's prop
        types (the optimizer rule allows one edge type under a filter),
        or None without a filter; raises CannotCompile as the program
        would."""
        if edge_filter is None:
            return None
        bl = dev.host.blocks[block_keys[0]]
        pred, _ = compile_predicate(
            edge_filter, bl.prop_types, dev.pool,
            vid_to_dense=sd.dense_id, device=self.device)
        if pred.error is not None:
            raise pred.error
        return pred

    def traverse(self, store, space: str, vids: Sequence[Any],
                 etypes: Sequence[str], direction: str, steps: int,
                 edge_filter: Optional[E.Expr] = None,
                 capture: bool = True,
                 yields: Optional[List[Tuple[Any, str]]] = None
                 ) -> Tuple[Any, TraverseStats]:
        """Run an N-step GO expansion on the device.

        Returns (rows, stats).  Without `yields`, rows are (src_vid,
        Edge, dst_vid) triples for every final-hop edge passing the
        predicate.  With `yields` — (Expr, name) pairs that evaluate
        columnar-side — rows is a ColumnarDataSet holding the final
        output as numpy columns; with capture=False only the stats are
        computed.  Raises CannotCompile for a filter that does not
        vectorize and for what this slice does not port (see module
        docstring)."""
        t_start = time.perf_counter()
        dev = self.pin(store, space)
        sd = store.space(space)
        stats = TraverseStats()
        stats.steps = steps
        stats.pin_s = time.perf_counter() - t_start

        block_keys = self._blocks_for(etypes, direction)
        pred = self._compile_filter(dev, sd, block_keys, edge_filter)

        dense = [sd.dense_id(v) for v in vids]
        dense = [d for d in dense if d >= 0]
        if not dense:
            return [], stats

        # edge props the yields read and every block carries are gathered
        # on the device at the compacted final-hop slots (at most 4); the
        # rest decode on the host via the captured eidx.  Edge rows (no
        # yields) decode every prop of the block.
        yield_cols: tuple = ()
        if capture:
            wanted = None if yields is None else {
                x.name for e, _ in yields for x in E.walk(e)
                if x.kind == "edge_prop" and not x.name.startswith("_")}
            yield_cols = tuple(sorted(
                n for n in wanted or ()
                if all(n in dev.host.blocks[bk].props for bk in block_keys))
            )[:_MAX_YIELD_COLS]
        fetch_keys = _cap_keys_for_yields(yields, yield_cols) \
            if capture else None
        if fetch_keys is not None and fetch_keys & {"src", "dst"} \
                and any(d == "in" for _, d in block_keys):
            # reverse blocks serve src(edge) from the dst array and vice
            # versa (physical-edge orientation) — need both
            fetch_keys |= {"src", "dst"}
        prop_names = set(yield_cols)
        if pred is not None:
            prop_names |= set(pred.columns)
        dview, dextras = self._grab_delta(dev, block_keys, prop_names)
        delta_epoch = None if dview is None else dview[0]
        dview = self._insert_view(dview, block_keys)
        if fetch_keys is not None and dview is not None:
            # delta rows interleave with base rows in canonical CSR order
            # at materialize time: the host re-sort needs every identity
            # column whatever the yields read
            fetch_keys |= {"src", "dst", "rank", "eidx"}
        blocks = self._run_blocks(dev, block_keys)

        caps = None
        if capture:
            # multi-lane batched dispatch: concurrent compatible
            # statements share ONE run of the hop loop; None falls
            # through to the solo path (batching off, no company, a
            # 1-lane group, the tpu:batch_form failpoint)
            key = ("traverse", id(dev), dev.epoch, tuple(block_keys), steps,
                   None if edge_filter is None else E.to_text(edge_filter),
                   yield_cols,
                   None if fetch_keys is None else frozenset(fetch_keys),
                   None if delta_epoch is None else ("delta", delta_epoch),
                   self._mesh_key())
            caps = self._try_batched(
                key, dense, stats,
                lambda lane_dense: self._run(
                    dev, blocks, lane_dense, steps, pred, True, yield_cols,
                    fetch_keys, dextras, attribute=False))
        if caps is None:
            res, info = self._run(dev, blocks, [dense], steps, pred, capture,
                                  yield_cols, fetch_keys, dextras)
            caps = self._lane_attribution(res, info, 0, stats)
        if not capture:
            stats.total_s = time.perf_counter() - t_start
            return [], stats

        t_mat = time.perf_counter()
        if yields is None:
            rows = self._materialize(store, space, dev, block_keys, caps,
                                     dview)
        else:
            rows = self._materialize_yields(store, space, dev, block_keys,
                                            caps, yields, dview)
        stats.mat_s = time.perf_counter() - t_mat
        stats.result_edges = len(rows)
        stats.total_s = time.perf_counter() - t_start
        return rows, stats

    # -- MATCH device plane: layered hop frames ----------------------------

    def traverse_hops(self, store, space: str, vids: Sequence[Any],
                      etypes: Sequence[str], direction: str, max_hop: int,
                      edge_filter: Optional[E.Expr] = None
                      ) -> Tuple[List[HopFrame], TraverseStats]:
        """Device expansion for MATCH's Traverse: `max_hop` expansions
        with the WHERE program applied at EVERY hop (a MATCH edge filter
        holds over the whole variable-length pattern), capturing each
        hop's kept edges.  Returns one HopFrame per hop — every
        predicate-passing edge out of a vertex reachable at the depth
        before it — and the stats.  The caller assembles trail paths from
        the layered frames on the host (`join_frontier_trails`,
        `trail_distinct_keep`).  Raises CannotCompile for a filter that
        does not vectorize."""
        t_start = time.perf_counter()
        dev = self.pin(store, space)
        sd = store.space(space)
        stats = TraverseStats()
        stats.steps = max_hop
        stats.pin_s = time.perf_counter() - t_start

        block_keys = self._blocks_for(etypes, direction)
        pred = self._compile_filter(dev, sd, block_keys, edge_filter)
        dense = [sd.dense_id(v) for v in vids]
        dense = [d for d in dense if d >= 0]
        if not dense:
            return [HopFrame.empty() for _ in range(max_hop)], stats

        dview, dextras = self._grab_delta(
            dev, block_keys, () if pred is None else pred.columns)
        delta_epoch = None if dview is None else dview[0]
        dview = self._insert_view(dview, block_keys)
        blocks = self._run_blocks(dev, block_keys)
        fetch_keys = {"src", "dst", "rank", "eidx"}

        def run(lane_dense, attribute=True):
            return self._run(dev, blocks, lane_dense, max_hop, pred, True,
                             (), fetch_keys, dextras, attribute=attribute,
                             capture_hops=True)

        # concurrent MATCH expansions of one program share ONE run; the
        # "hops" key keeps a MATCH and a GO apart
        key = ("hops", id(dev), dev.epoch, tuple(block_keys), max_hop,
               None if edge_filter is None else E.to_text(edge_filter),
               None if delta_epoch is None else ("delta", delta_epoch),
               self._mesh_key())
        caps = self._try_batched(
            key, dense, stats, lambda ld: run(ld, attribute=False),
            kernel="hops")
        if caps is None:
            res, info = run([dense])
            caps = self._lane_attribution(res, info, 0, stats)

        t_mat = time.perf_counter()
        frames = self._build_frames(store, space, dev, block_keys, caps,
                                    dview)
        stats.mat_s = time.perf_counter() - t_mat
        stats.result_edges = sum(f.n for f in frames)
        stats.total_s = time.perf_counter() - t_start
        return frames, stats

    @staticmethod
    def _fetch_cap(cap: Dict[str, torch.Tensor], fetch_keys):
        """One block's lane-major capture to the host, as one dict per
        lane: its kcount (P,), then its kept prefix [:, :K] of each array
        the yields read, K the largest kept count over that lane's parts
        — a lane never carries another lane's width.  The lanes' prefixes
        are packed side by side on the device, so each array crosses in
        one copy."""
        kc = cap["kcount"].cpu().numpy()                 # (L, P)
        ks = [int(k.max()) if k.size else 0 for k in kc]
        lanes: List[Dict[str, np.ndarray]] = [{"kcount": k} for k in kc]
        cuts = np.cumsum(ks)[:-1]
        for name, v in cap.items():
            if name == "kcount" or (fetch_keys is not None
                                    and name not in fetch_keys):
                continue
            parts = [v[lane, :, :k] for lane, k in enumerate(ks)]
            packed = (parts[0] if len(parts) == 1
                      else torch.cat(parts, dim=1)).cpu().numpy()
            for lane, a in enumerate(np.split(packed, cuts, axis=1)):
                lanes[lane][name] = a
        return lanes

    @staticmethod
    def _run_blocks(dev: DeviceSnapshot, block_keys):
        """The blocks a run reads: the pin's, or on a sharded pin one
        such list a slot."""
        if dev.shards:
            return [[sh.blocks[bk] for bk in block_keys]
                    for sh in dev.shards]
        return [dev.blocks[bk] for bk in block_keys]

    def _run(self, dev: DeviceSnapshot, blocks, lane_dense, steps: int,
             pred, capture: bool, yield_cols, fetch_keys, dextras,
             attribute: bool = True, capture_hops: bool = False):
        """One run of the hop loop for the seeds of L statements (the
        reference's `_escalate_lanes`; a solo statement is the L = 1
        case), with no bucket ladder — the port sizes its slots exactly:
        ONE gated dispatch, ONE seed build, ONE run of the hop loop over
        an (L, P, vmax + H) frontier, ONE fetch.  A batch's launching
        member runs it on its own thread (attribute=False: the gate's
        wait is not charged to that thread, since each member charges its
        own lane in `_lane_attribution`); batch.py fans the result out.
        Returns (res, info): res holds lane-major host arrays —
        hop_edges and frontier_sizes (L, P, steps) and, with capture, per
        lane its blocks' captures (with capture_hops, MATCH's every-hop
        mode, per lane one such list per hop, the dispatch's kernel name
        "hops") — and info the launch-level facts each lane's de-mux
        needs.  tpu_kernel_runs grows by ONE per run.  On a sharded pin
        the same run goes over the mesh's slots (`hop.run_hops_sharded`,
        under the collective-launch mutex), and its captures come back in
        the local layout."""
        info: Dict[str, Any] = {"attributed": attribute}
        kernel = "hops" if capture_hops else "traverse"
        with (nullcontext() if attribute else _detached()), \
                self._gated_dispatch(kernel) as wait_us, \
                self._collective_launch() as sent:
            info["gate_wait_us"] = wait_us
            self._check_live(dev)
            tp = time.perf_counter()
            if dev.shards:
                frontier = seed_slot_frontiers(dev, [
                    self._seed_sorted(d, dev.num_parts, dev.vmax)
                    for d in lane_dense])
            else:
                frontier = self._seed_frontier_lanes(dev, lane_dense)
            info["put_s"] = time.perf_counter() - tp
            t0 = time.perf_counter()
            if dev.shards:
                res = run_hops_sharded(
                    self.mesh, dev.shards, blocks, frontier, steps,
                    pred=pred, capture=capture, yield_cols=yield_cols,
                    deltas_by_slot=dextras, capture_hops=capture_hops)
            else:
                res = run_hops(dev, blocks, frontier, steps, pred=pred,
                               capture=capture, yield_cols=yield_cols,
                               deltas=dextras, capture_hops=capture_hops)
            out = {"hop_edges": res["hop_edges"].cpu().numpy()}
            t1 = time.perf_counter()                     # synchronised
            info["device_s"] = t1 - t0
            out["frontier_sizes"] = res["frontier_sizes"].cpu().numpy()
            if capture:
                # per lane, its blocks' captures — of each hop with
                # capture_hops
                by_hop = []
                for blocks_cap in (res["cap"] if capture_hops
                                   else [res["cap"]]):
                    caps = [self._fetch_cap(c, fetch_keys)
                            for c in blocks_cap]
                    by_hop.append([list(lane) for lane in zip(*caps)]
                                  if caps else [[] for _ in lane_dense])
                out["cap"] = [list(lane) for lane in zip(*by_hop)] \
                    if capture_hops else by_hop[0]
            info["fetch_s"] = time.perf_counter() - t1
            info["e_cap"] = list(res["e_cap"])
            info["hbm_bytes"] = self.hbm_bytes()
        info.update(self._exchange_facts(sent[0]))
        metrics().inc("tpu_kernel_runs")
        return out, info

    def _exchange_facts(self, xbytes: int) -> Dict[str, int]:
        """A dispatch's mesh facts (the reference's runtime.py:1337-1355,
        :1720-1748): the slots it spanned and `xbytes`, the bytes its
        bit-packed exchanges moved as the transport counted them (every
        hop of GO and MATCH but the last, every level of the BFS: the
        reference's `a2a_payload_bytes` formula times the exchanges),
        counted into `tpu_all_to_all_bytes`."""
        metrics().gauge("tpu_shards", float(self.mesh_size))
        if xbytes:
            metrics().inc("tpu_all_to_all_bytes", xbytes)
        return {"shards": self.mesh_size, "exchange_bytes": xbytes}

    def _lane_attribution(self, res, info, lane: int, stats: TraverseStats,
                          form_wait_us: int = 0):
        """De-mux one lane of a run: fill this statement's stats with its
        own lane's counts (hop_edges, frontier_sizes) and the run's
        timings, charge its thread's work, cost and live sinks exactly as
        its solo run would, and return its lane's block captures (None
        without capture)."""
        stats.hop_edges = [int(x) for x in res["hop_edges"][lane].sum(axis=0)]
        stats.frontier_sizes = [
            int(x) for x in res["frontier_sizes"][lane].sum(axis=0)]
        stats.device_s = info["device_s"]
        stats.put_s = info["put_s"]
        stats.fetch_s = info["fetch_s"]
        stats.queue_s = (info["gate_wait_us"] + form_wait_us) / 1e6
        stats.e_cap = list(info["e_cap"])
        stats.hbm_bytes = info["hbm_bytes"]
        stats.shards = info["shards"]
        stats.exchange_bytes = info["exchange_bytes"]
        self._charge(int(stats.device_s * 1e6), stats,
                     0 if info["attributed"] else int(stats.queue_s * 1e6))
        return res["cap"][lane] if "cap" in res else None

    # -- multi-lane batched dispatch ---------------------------------------

    def _try_batched(self, key, dense, stats: TraverseStats, launch,
                     kernel: str = "traverse"):
        """Submit this dispatch to the batch former under the
        compatibility `key` (the mode — GO's "traverse" or MATCH's
        "hops" —, snapshot, blocks, steps, WHERE and YIELD program,
        fetched columns and delta view: statements grabbed under
        different delta views never share a run).  Returns this
        statement's captures after a shared run, or None when it should
        run solo: batching off, no concurrent company, a 1-lane group, or
        the `tpu:batch_form` failpoint rejected enrolment."""
        former = batch_former()
        if not former.enabled():
            return None
        try:
            tk = former.submit(key, dense, launch, kernel=kernel,
                               gate_busy=self._gate.write_held)
        except FailpointError:
            return None          # batch forming rejected → solo dispatch
        if tk is None:
            return None
        return self._lane_attribution(tk.res, tk.info, tk.lane, stats,
                                      tk.form_wait_us)

    # -- BFS (FIND SHORTEST PATH device plane) -----------------------------

    def bfs(self, store, space: str, srcs: Sequence[Any],
            etypes: Sequence[str], direction: str, max_steps: int,
            edge_filter: Optional[E.Expr] = None
            ) -> Tuple[np.ndarray, TraverseStats]:
        """Level-synchronous device BFS from `srcs`.

        Returns (dist, stats): dist is the (P, vmax) int32 numpy array of
        BFS depths (-1 unreached; dense id v at [v % P, v // P]); the
        caller rebuilds paths on the host.  With `edge_filter` (raises
        CannotCompile for a filter that does not vectorize) the BFS
        traverses only mask-passing edges, at every level.  When every
        block's reverse twin is pinned, dense levels go bottom-up, as the
        reference's single-chip program does; stats.hop_edges counts the
        branch's slots per level (out-edges of the frontier top-down,
        in-edges of the unvisited set bottom-up)."""
        t_start = time.perf_counter()
        dev = self.pin(store, space)
        sd = store.space(space)
        stats = TraverseStats()
        stats.steps = max_steps
        stats.pin_s = time.perf_counter() - t_start

        block_keys = self._blocks_for(etypes, direction)
        pred = self._compile_filter(dev, sd, block_keys, edge_filter)
        P, vmax = dev.num_parts, dev.vmax
        dense = [sd.dense_id(v) for v in srcs]
        dense = [d for d in dense if d >= 0]
        if not dense:
            return np.full((P, vmax), -1, np.int32), stats

        # direction-optimizing: each block's REVERSE twin rides along so
        # dense levels can go bottom-up (the reference's
        # runtime.py:2160-2172); for "both" the twins of the out and in
        # blocks are the in and out blocks.  It is OFF while a delta plane
        # is armed: bottom-up scans the reverse adjacency with swapped
        # endpoint semantics the merge does not model, so every level
        # goes top-down, merged.  A sharded pin is top-down at every level
        # too, as the reference's sharded runtime (runtime.py:2169)
        rev_of = {"out": "in", "in": "out"}
        rev_keys = [(et, rev_of[d]) for et, d in block_keys]
        have_rev = self.local_mode and dev.delta is None \
            and all(rk in dev.blocks for rk in rev_keys)
        _, dextras = self._grab_delta(
            dev, block_keys, () if pred is None else pred.columns)
        n_phantom = P * vmax - int(np.asarray(dev.host.num_vertices).sum())

        with self._gated_dispatch("bfs") as wait_us, \
                self._collective_launch() as sent:
            stats.queue_s = wait_us / 1e6
            self._check_live(dev)
            tp = time.perf_counter()
            if dev.shards:
                seeds = seed_slot_frontiers(
                    dev, [self._seed_sorted(dense, P, vmax)])
            else:
                seeds = self._seed_frontier(dev, dense)
            stats.put_s = time.perf_counter() - tp

            t0 = time.perf_counter()
            if dev.shards:
                res = run_bfs_sharded(
                    self.mesh, dev.shards,
                    self._run_blocks(dev, block_keys), seeds, max_steps,
                    pred=pred, deltas_by_slot=dextras)
            else:
                res = run_bfs(dev, [dev.blocks[bk] for bk in block_keys],
                              [dev.blocks[rk] for rk in rev_keys]
                              if have_rev else None, seeds, max_steps,
                              pred=pred, n_phantom=n_phantom,
                              deltas=dextras)
            dist = res["dist"].cpu().numpy()            # synchronises
            hop_edges = res["hop_edges"].cpu().numpy()
            stats.device_s = time.perf_counter() - t0
        facts = self._exchange_facts(sent[0])
        stats.shards = facts["shards"]
        stats.exchange_bytes = facts["exchange_bytes"]
        stats.hop_edges = [int(x) for x in hop_edges.sum(axis=0)]
        stats.e_cap = list(res["e_cap"])
        stats.hbm_bytes = self.hbm_bytes()
        stats.total_s = time.perf_counter() - t_start
        return dist, stats

    # -- host materialization ---------------------------------------------

    @staticmethod
    def _delta_perms(cap, pids, kc, P: int, emax: int, d2v_arr, d2v_id):
        """Per-part permutations restoring canonical CSR slot order over
        the merged base+delta capture: within a part, base rows sit in
        (local_src, rank, dst_key) order and delta rows are appended —
        the union must interleave exactly where a full rebuild would
        have placed the new rows.  dst_key is the vid itself for int
        vids, code-point string order otherwise (`_dst_keys`).  Each permutation is the
        stable lexsort's (`_canonical_perm`), so parallel edges keep
        base-before-delta order.  A part that captured no delta row is
        in that order already: its entry is None, and nothing runs."""
        perms = []
        for p in pids:
            k = int(kc[p])
            e = np.asarray(cap["eidx"][p, :k])
            is_delta = e >= emax
            if not is_delta.any():
                perms.append(None)
                continue
            s_ = np.asarray(cap["src"][p, :k]).astype(np.int64)
            d_ = np.asarray(cap["dst"][p, :k]).astype(np.int64)
            r_ = np.asarray(cap["rank"][p, :k]).astype(np.int64)
            if d2v_id:
                dk = d_
            else:
                dk = d2v_arr[d_]
                if dk.dtype == object:
                    dk = _dst_keys(dk)
            perms.append(_canonical_perm(s_ // P, r_, dk.astype(np.int64),
                                         is_delta))
        return perms

    def _build_frames(self, store, space: str, dev: DeviceSnapshot,
                      block_keys, caps, dview=None) -> List[HopFrame]:
        """One columnar HopFrame per hop from the every-hop captures
        (`caps`: per hop, one host dict per block).  A frame holds its
        hop's kept edges block after block, then part after part in CSR
        slot order — with a delta view, each part's rows re-sorted into
        canonical order (`_delta_perms`) — as dense-id and canonical-key
        columns.  No Edge object is built here: each block's segment
        decodes only the entries the assembly asks for, its props from
        the base column or, for a delta row, the view's numpy mirror at
        eidx - emax."""
        host = dev.host
        d2v_arr = _d2v(host)
        d2v_id = host._d2v_identity
        P = dev.num_parts
        etype_ids = {et: store.catalog.get_edge(space, et).edge_type
                     for et, _ in block_keys}

        def make_decode(et, dirn, sgn):
            hb = host.blocks[(et, dirn)]
            de = None if dview is None else dview[1].get((et, dirn))

            def decode_seg(payload, offs):
                ss, dd, rr, ee, sp = (a[offs] for a in payload)
                props = {n: decode_prop_column(
                    hb.prop_types[n], _take_pair_np(
                        hb.props[n],
                        None if de is None else de["np"]["d_props"][n],
                        sp, ee), host.pool)
                    for n in hb.props}
                sv = ss if d2v_id else d2v_arr[ss]
                dvv = dd if d2v_id else d2v_arr[dd]
                names = list(props)
                cols = [props[n] for n in names]
                rrl = rr.tolist()
                return [Edge(s, d, et, rrl[i],
                             {n: c[i] for n, c in zip(names, cols)},
                             etype=sgn)
                        for i, (s, d) in enumerate(zip(sv.tolist(),
                                                       dvv.tolist()))]
            return decode_seg

        def decode_seg(payload_dec, offs):
            payload, dec = payload_dec
            return dec(payload, offs)

        frames = []
        for hop_caps in caps:
            srcs, dsts, rks = [], [], []
            ket, ks, kd = [], [], []
            segs = []
            pos = 0
            for (et, dirn), cap in zip(block_keys, hop_caps):
                kc = cap["kcount"]
                pids = [p for p in range(len(kc)) if kc[p] > 0]
                if not pids:
                    continue
                perms = None
                if dview is not None and dview[1].get((et, dirn)) is not None:
                    perms = self._delta_perms(
                        cap, pids, kc, P, host.blocks[(et, dirn)].nbr.shape[1],
                        d2v_arr, d2v_id)
                ss, dd, rr = (_cat_kept(cap, n, pids, perms, np.int64)
                              for n in ("src", "dst", "rank"))
                ee = _cat_kept(cap, "eidx", pids, perms)
                sel_p = np.repeat(np.asarray(pids, np.int64),
                                  [int(kc[p]) for p in pids])
                eid = etype_ids[et]
                sgn = eid if dirn == "out" else -eid
                srcs.append(ss)
                dsts.append(dd)
                rks.append(rr)
                # canonical physical-edge key: the out and in copies of
                # one logical edge compare equal (the trail dedup's)
                ket.append(np.full(ss.size, eid, np.int64))
                ks.append(ss if dirn == "out" else dd)
                kd.append(dd if dirn == "out" else ss)
                segs.append((pos, pos + ss.size,
                             ((ss, dd, rr, ee, sel_p),
                              make_decode(et, dirn, sgn))))
                pos += ss.size
            if not srcs:
                frames.append(HopFrame.empty())
                continue
            frames.append(HopFrame.build(
                np.concatenate(srcs), np.concatenate(dsts),
                np.concatenate(rks), np.concatenate(ket),
                np.concatenate(ks), np.concatenate(kd),
                segs, decode_seg))
        return frames

    def _block_columns(self, store, space: str, dev: DeviceSnapshot,
                       block_keys, caps,
                       prop_names: Optional[Sequence[str]] = None,
                       dview=None, as_np: bool = True):
        """Vectorized gather of the captured final-hop edge set: per-block
        dicts of flat numpy arrays — sv/dv (vids), rr (ranks), decoded
        prop columns (`prop_names`, or every prop of the block; numpy
        columns, or lists of values with as_np=False).

        With a delta view (`dview`, grabbed when the run started) the
        merged rows are re-sorted per part into canonical CSR order
        (device-gathered yield columns by the same permutation), and a
        delta row's props decode from the view's numpy mirror at
        eidx - emax: the base and delta halves are indexed apart."""
        host = dev.host
        d2v_arr = _d2v(host)
        d2v_id = host._d2v_identity
        P = dev.num_parts
        etype_ids = {et: store.catalog.get_edge(space, et).edge_type
                     for et, _ in block_keys}
        for (et, dirn), cap in zip(block_keys, caps):
            hb = host.blocks[(et, dirn)]
            de = None if dview is None else dview[1].get((et, dirn))
            # kept entries are a compacted PREFIX per part row
            kc = cap["kcount"]
            pids = [p for p in range(len(kc)) if kc[p] > 0]
            if not pids:
                continue
            n_rows = int(sum(int(kc[p]) for p in pids))
            perms = None if de is None else self._delta_perms(
                cap, pids, kc, P, hb.nbr.shape[1], d2v_arr, d2v_id)

            def catp(name, dtype=None):
                return _cat_kept(cap, name, pids, perms, dtype)

            ss = catp("src", np.int64) if "src" in cap else None
            dd = catp("dst", np.int64) if "dst" in cap else None
            rr = catp("rank") if "rank" in cap else None
            props = {}
            dec = decode_prop_column_np if as_np else decode_prop_column
            ee_parts = None
            for n in (hb.props if prop_names is None
                      else [x for x in prop_names if x in hb.props]):
                if ("prop:" + n) in cap:
                    raw = catp("prop:" + n)     # device-gathered
                elif "eidx" in cap:
                    if ee_parts is None:
                        ee_parts = _kept_parts(cap, "eidx", pids, perms)
                    dcol = None if de is None else de["np"]["d_props"][n]
                    raw = [_take_pair_np(hb.props[n], dcol, p, e)
                           for p, e in zip(pids, ee_parts)]
                    raw = np.concatenate(raw) if len(raw) > 1 else raw[0]
                else:
                    continue
                props[n] = dec(hb.prop_types[n], raw, host.pool)
            eid = etype_ids[et]
            yield {"et": et, "dirn": dirn,
                   "etype": eid if dirn == "out" else -eid, "n": n_rows,
                   "sv": (ss if d2v_id else d2v_arr[ss])
                   if ss is not None else None,
                   "dv": (dd if d2v_id else d2v_arr[dd])
                   if dd is not None else None,
                   "rr": rr, "props": props}

    def _materialize(self, store, space: str, dev: DeviceSnapshot,
                     block_keys, caps, dview=None
                     ) -> List[Tuple[Any, Edge, Any]]:
        """GO's rows without yields: (src_vid, Edge, dst_vid) triples, the
        Edge objects built in one zip loop over the decoded columns."""
        rows: List[Tuple[Any, Edge, Any]] = []
        for b in self._block_columns(store, space, dev, block_keys, caps,
                                     dview=dview, as_np=False):
            et, etype = b["et"], b["etype"]
            names = list(b["props"])
            cols = [b["props"][n] for n in names]
            rr = b["rr"].tolist()
            for i, (sv, dv) in enumerate(zip(b["sv"].tolist(),
                                             b["dv"].tolist())):
                props = {n: c[i] for n, c in zip(names, cols)}
                rows.append((sv, Edge(sv, dv, et, rr[i], props,
                                      etype=etype), dv))
        return rows

    def _materialize_yields(self, store, space: str, dev: DeviceSnapshot,
                            block_keys, caps, yields,
                            dview=None) -> ColumnarDataSet:
        """Final output as a lazy columnar DataSet (fused Project)."""
        needed = [x.name for e, _ in yields for x in E.walk(e)
                  if x.kind == "edge_prop"]
        per_block: List[List[np.ndarray]] = []
        for b in self._block_columns(store, space, dev, block_keys, caps,
                                     prop_names=needed, dview=dview):
            per_block.append([eval_yield_column_np(e, b)
                              for e, _ in yields])
        names = [alias for _, alias in yields]
        if not per_block:
            return ColumnarDataSet(
                names, [np.empty(0, object) for _ in yields])
        if len(per_block) == 1:
            return ColumnarDataSet(names, per_block[0])

        def _cat(j):
            # mixed int/float blocks concatenate as object, never upcast
            # (5 must not become 5.0)
            blks = [blk[j] for blk in per_block]
            kinds = {b.dtype.kind for b in blks}
            if len(kinds) > 1 and "O" not in kinds:
                blks = [b.astype(object) for b in blks]
            return np.concatenate(blks)

        return ColumnarDataSet(names, [_cat(j) for j in range(len(yields))])
