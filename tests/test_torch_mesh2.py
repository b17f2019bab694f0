"""The port's two-axis ("lane", "part") grid and its runtime over a
process group, against the JAX reference's, on the CPU.

Twins of tests/unit/test_sharded.py's `test_mesh2_grid_and_degrade` and
`test_runtime_on_two_axis_mesh_parity`: the port runs on
`make_mesh2(2, 4, devices=[cpu] * 8)` (eight CPU "devices", one a slot,
as the reference's virtual mesh has) and on the grid `make_mesh2(2, 4)`
lays on one card (every slot on one device, the rows sharing its
copies), the reference on `TpuRuntime(make_mesh2(2, 4))` over the
8-device virtual CPU mesh of tests/conftest.py, each with one snapshot
carried across with `snapshot_from_fields`: GO (unsplit and
degree-split, with and without a WHERE), MATCH's frames and the BFS give
equal rows, hop_edges, frontier_sizes and exchange_bytes.  Then batched
lanes on `make_mesh2(2, 2)` in the shape of
`test_sharded_batched_lanes_parity`, GO through a delta plane's writes
on the grid, `set_mesh` from one axis to two mid-form, the copies lane
rows share, and the BFS's one lane on row 0.  Last, a `GpuRuntime` over
two gloo ranks (`process_group_mesh(4, cpu)`, tests/torch_mesh_workload.py
in each rank) against the in-process 4-slot mesh and the reference, and
a rank that calls alone.  Tolerance: exact — the path moves integers
and copies float64 values.
"""
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nebula_tpu.bench import datagen as ref_datagen
from nebula_tpu.core import expr as RE
from nebula_tpu.core import wire as ref_wire
from nebula_tpu.exec.engine import QueryEngine as RefQueryEngine
from nebula_tpu.tpu import TpuRuntime
from nebula_tpu.tpu import make_mesh as ref_make_mesh
from nebula_tpu.tpu import make_mesh2 as ref_make_mesh2
from nebula_tpu.tpu import mesh_lanes as ref_mesh_lanes
from nebula_tpu.tpu import mesh_parts as ref_mesh_parts
from nebula_tpu.utils.config import get_config as ref_get_config

import chip_smoke
import torch_mesh_workload as W
from nebula_tpu_torch.bench import datagen as D
from nebula_tpu_torch.core import expr as PE
from nebula_tpu_torch.exec.engine import QueryEngine
from nebula_tpu_torch.gpu import GpuRuntime, GpuUnavailable
from nebula_tpu_torch.gpu import bfs as port_bfs
from nebula_tpu_torch.gpu import device as port_device
from nebula_tpu_torch.gpu.batch import batch_former
from nebula_tpu_torch.gpu.device import make_mesh, make_mesh2, \
    mesh_lanes, mesh_parts, pin_bytes, pin_home_bytes
from nebula_tpu_torch.gpu.hop import a2a_payload_bytes, lane_chunks
from nebula_tpu_torch.gpu.mesh import InProcess, Mesh
from nebula_tpu_torch.graphstore.csr import snapshot_from_fields
from nebula_tpu_torch.utils.config import get_config
from nebula_tpu_torch.utils.stats import stats
from nebula_tpu_torch.utils.workload import live_registry

from test_torch_delta import DCAP, SEEDS, _PortStore, _Writer, \
    _assert_cols_equal, _cols, _store, delta_cfg  # noqa: F401
from test_torch_delta import _fields as _delta_fields
from test_torch_delta import _yields as _delta_yields
from test_torch_sharded import _assert_frames_equal, _fields, _where, \
    _yields

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
EIGHT = [CPU] * 8
STEPS = W.STEPS


def one_card_grid(lanes, parts):
    """The grid make_mesh2(lanes, parts) lays on one card: every slot on
    the one device, home 0."""
    n = lanes * parts
    return Mesh(parts, [CPU] * n, InProcess(), homes=[0] * n, lanes=lanes)


# ---------------------------------------------------------------------------
# make_mesh2: the grid and its degrade
# ---------------------------------------------------------------------------


def test_mesh2_grid_and_degrade(monkeypatch):
    """Twin of the reference's: the grid, the lane axis collapsing first
    on too few devices (the port given an explicit list of eight, the
    reference its eight virtual devices: divergence 16), the
    explicit-devices ValueError, and the (1, 1) grid in local mode
    serving the one-device runtime's rows.  With devices=None several slots share a card, so
    the port's grid never degrades: on one card make_mesh2(2, 4) is a
    2 x 4 grid."""
    for lanes_of, parts_of, mk in (
            (ref_mesh_lanes, ref_mesh_parts, ref_make_mesh2),
            (mesh_lanes, mesh_parts,
             lambda *a: make_mesh2(*a, devices=EIGHT))):
        m = mk(2, 4)
        assert (lanes_of(m), parts_of(m)) == (2, 4)
        m2 = mk(4, 8)
        assert (lanes_of(m2), parts_of(m2)) == (1, 8)
    with pytest.raises(ValueError):
        ref_make_mesh2(2, 8, devices=jax.devices()[:4])
    with pytest.raises(ValueError):
        make_mesh2(2, 8, devices=[CPU] * 4)
    grid = make_mesh2(2, 4, devices=EIGHT)
    assert [r.homes for r in grid.rows] == [(0, 1, 2, 3), (4, 5, 6, 7)]
    assert grid.parts == [0, 1, 2, 3] and len(grid.rows) == 2

    m11 = make_mesh2(1, 1, devices=[CPU])
    assert (mesh_lanes(m11), mesh_parts(m11)) == (1, 1)
    rt11 = GpuRuntime(mesh=m11)
    assert rt11.local_mode
    arrs, ref_snap = _social_ref(4)
    ref11 = TpuRuntime(ref_make_mesh2(1, 1, devices=jax.devices()[:1]))
    assert ref11.local_mode
    ref11.pin_prebuilt(ref_snap)
    rt11.pin_prebuilt(snapshot_from_fields(_fields(ref_snap)))
    seeds = [1, 5]
    want, wst = ref11.traverse(ref_datagen.SnapshotStore(ref_snap), "snb",
                               seeds, ["KNOWS"], "out", 2,
                               yields=_yields(RE))
    got, st = rt11.traverse(D.SnapshotStore(rt11.snapshots["snb"].host),
                            "snb", seeds, ["KNOWS"], "out", 2,
                            yields=_yields(PE))
    _assert_cols_equal(_cols(got), _cols(want), "(1, 1)")
    assert st.shards == wst.shards == 1
    assert st.exchange_bytes == wst.exchange_bytes == 0

    # devices=None on one card: no degrade, every slot shares it
    monkeypatch.setattr(port_device, "_cards", lambda who: [CPU])
    for k in ("NEBULA_COORDINATOR", "NEBULA_NUM_PROCESSES",
              "NEBULA_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    card = make_mesh2(2, 4)
    want_grid = one_card_grid(2, 4)
    assert (mesh_lanes(card), mesh_parts(card)) == (2, 4)
    assert [(r.devices, r.homes) for r in card.rows] == \
        [(r.devices, r.homes) for r in want_grid.rows]
    assert (mesh_lanes(make_mesh2()), mesh_parts(make_mesh2())) == (1, 1)
    assert mesh_parts(make_mesh(8)) == 8


def test_make_mesh_and_make_mesh2_in_a_joined_group(monkeypatch):
    """With devices=None in a joined process group (here one gloo rank,
    `init_multihost` answering that it joined), make_mesh and make_mesh2
    lay their slots over the ranks on this rank's card, with the
    ProcessGroup transport; make_mesh2's lane axis collapses to 1, since
    a runtime there forms no batch (divergence 15).  A runtime on
    make_mesh2(2, 4) there answers GO as the in-process 4-slot mesh."""
    import torch.distributed as dist
    from nebula_tpu_torch.gpu.mesh import ProcessGroup
    monkeypatch.setattr(port_device, "init_multihost", lambda: True)
    monkeypatch.setattr(port_device, "_cards", lambda who: [CPU])
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    _, snap, seeds = W.social()
    store = D.SnapshotStore(snap)
    inproc = GpuRuntime(mesh=make_mesh(4, devices=[CPU]))
    inproc.pin_prebuilt(snap)
    want, wst = inproc.traverse(store, "snb", seeds, ["KNOWS"], "out", 3,
                                yields=_yields(PE))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            shapes = [(mesh_lanes(m), mesh_parts(m), m.parts, m.devices,
                       type(m.transport))
                      for m in (make_mesh(), make_mesh(4), make_mesh2(),
                                make_mesh2(2), make_mesh2(2, 4))]
            rt = GpuRuntime(mesh=make_mesh2(2, 4))
            rt.pin_prebuilt(snap)
            got, st = rt.traverse(store, "snb", seeds, ["KNOWS"], "out", 3,
                                  yields=_yields(PE))
        finally:
            dist.destroy_process_group()
    PG = ProcessGroup
    assert shapes == [(1, 1, [0], (CPU,), PG),
                      (1, 4, [0, 1, 2, 3], (CPU,) * 4, PG),
                      (1, 1, [0], (CPU,), PG),
                      (1, 1, [0], (CPU,), PG),
                      (1, 4, [0, 1, 2, 3], (CPU,) * 4, PG)]
    _assert_cols_equal(_cols(got), _cols(want), "joined make_mesh2(2, 4)")
    assert (st.hop_edges, st.frontier_sizes, st.exchange_bytes) == \
        (wst.hop_edges, wst.frontier_sizes, wst.exchange_bytes)
    assert st.exchange_bytes > 0


def test_lane_chunks_are_contiguous():
    assert lane_chunks(8, 2) == [4, 4]
    assert lane_chunks(3, 2) == [2, 1]
    assert lane_chunks(1, 2) == [1, 0]
    assert lane_chunks(5, 1) == [5]


@pytest.mark.parametrize("persons, parts", [(1003, 8), (4000, 8),
                                            (2001, 4)])
def test_chip_smoke_halve_parts_is_snapshot_from_arrays(persons, parts):
    """chip_smoke's [10h] lays the north star at 4 parts by halving its
    8-part snapshot (`halve_parts`): array for array the layout
    `snapshot_from_arrays` gives the same arrays at half the parts (a
    multigraph, whose repeated (src, dst) keys keep their order; vertex
    counts no multiple of the parts)."""
    arrs = D.make_social_arrays(persons, 12, seed=7)
    keys = arrs["src"] * persons + arrs["dst"]
    assert np.unique(keys).size < keys.size
    got = chip_smoke.halve_parts(
        D.snapshot_from_arrays(arrs, parts=parts, space="ns"))
    want = D.snapshot_from_arrays(arrs, parts=parts // 2, space="ns")
    assert (got.num_parts, got.vmax, got.space, got.epoch) == \
        (want.num_parts, want.vmax, want.space, want.epoch)
    for a, b in ((got.num_vertices, want.num_vertices),
                 *((getattr(got.blocks[k], f), getattr(want.blocks[k], f))
                   for k in want.blocks for f in ("indptr", "nbr", "rank")),
                 *((got.blocks[k].props[n], want.blocks[k].props[n])
                   for k in want.blocks for n in want.blocks[k].props)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.blocks.keys() == want.blocks.keys()
    assert all(got.blocks[k].prop_types == want.blocks[k].prop_types
               for k in want.blocks)
    assert got.dense_to_vid == want.dense_to_vid
    assert got.pool.strings == want.pool.strings
    assert got.hub_dense is None and not got.tags


# ---------------------------------------------------------------------------
# GO, MATCH and the BFS on a 2 x 4 grid against the reference's
# ---------------------------------------------------------------------------


def _social_ref(parts):
    arrs = ref_datagen.make_social_arrays(W.PERSONS, W.DEGREE)
    return arrs, ref_datagen.snapshot_from_arrays(arrs, parts=parts)


@pytest.fixture(scope="module")
def grids():
    """Per layout: the reference's runtime on make_mesh2(2, 4), the
    port's on make_mesh2(2, 4, devices=[cpu] * 8) ("grid"), on the one
    card's grid ("card") and on make_mesh(4) ("axis"), pinned on one
    snapshot, built once a layout on first use."""
    cache = {}

    def get(layout):
        if layout in cache:
            return cache[layout]
        arrs, ref_snap = _social_ref(4)
        thr = W.THRESHOLD if layout == "split" else 0
        cfg = ref_get_config()
        cfg.set_dynamic("tpu_degree_split_threshold", thr)
        try:
            ref_rt = TpuRuntime(ref_make_mesh2(2, 4))
            ref_rt.init_eb = 1 << 12      # one bucket: one compile a case
            ref_rt.pin_prebuilt(ref_snap)
        finally:
            cfg.set_dynamic("tpu_degree_split_threshold", 0)
        assert (ref_rt.mesh_lanes, ref_rt.mesh_size) == (2, 4)
        carried = snapshot_from_fields(_fields(ref_snap))
        rts = {"grid": make_mesh2(2, 4, devices=EIGHT),
               "card": one_card_grid(2, 4),
               "axis": make_mesh(4, devices=[CPU])}
        rts = {k: GpuRuntime(mesh=m, degree_split_threshold=thr)
               for k, m in rts.items()}
        for rt in rts.values():
            rt.pin_prebuilt(carried)
        seeds = np.unique(arrs["src"][:64])[:16].tolist()
        if thr:
            hubs = rts["grid"].snapshots["snb"].host.hub_dense
            assert len(hubs)
            seeds = sorted(set(seeds) | {int(hubs[0]), int(hubs[-1])})
        cache[layout] = dict(ref_rt=ref_rt, rts=rts, seeds=seeds,
                             carried=carried,
                             ref_store=ref_datagen.SnapshotStore(ref_snap),
                             store=D.SnapshotStore(carried))
        return cache[layout]

    return get


@pytest.mark.parametrize("filt", [False, True], ids=["all", "w_gt_50"])
@pytest.mark.parametrize("layout", ["unsplit", "split"])
def test_go_on_the_grid_matches_reference(grids, layout, filt):
    g = grids(layout)
    want, wst = g["ref_rt"].traverse(
        g["ref_store"], "snb", g["seeds"], ["KNOWS"], "out", STEPS,
        edge_filter=_where(RE) if filt else None, yields=_yields(RE))
    vmax = g["carried"].vmax
    assert len(want) > 0
    for name, rt in g["rts"].items():
        got, st = rt.traverse(
            g["store"], "snb", g["seeds"], ["KNOWS"], "out", STEPS,
            edge_filter=_where(PE) if filt else None, yields=_yields(PE))
        _assert_cols_equal(_cols(got), _cols(want), f"{name} {layout}")
        assert (st.hop_edges, st.frontier_sizes) == \
            (wst.hop_edges, wst.frontier_sizes), name
        assert st.shards == wst.shards == 4
        assert st.exchange_bytes == wst.exchange_bytes \
            == 2 * a2a_payload_bytes(4, vmax)


def test_match_frames_on_the_grid_match_reference(grids):
    g = grids("unsplit")
    for filt in (None, "w"):
        want, wst = g["ref_rt"].traverse_hops(
            g["ref_store"], "snb", g["seeds"], ["KNOWS"], "out", 3,
            edge_filter=_where(RE) if filt else None)
        for name, rt in g["rts"].items():
            got, st = rt.traverse_hops(
                g["store"], "snb", g["seeds"], ["KNOWS"], "out", 3,
                edge_filter=_where(PE) if filt else None)
            _assert_frames_equal(got, want, f"{name} {filt}")
            assert (st.hop_edges, st.frontier_sizes) == \
                (wst.hop_edges, wst.frontier_sizes), name
            assert st.exchange_bytes == wst.exchange_bytes \
                == 2 * a2a_payload_bytes(4, g["carried"].vmax)


@pytest.mark.parametrize("layout", ["unsplit", "split"])
def test_bfs_on_the_grid_matches_reference(grids, layout):
    g = grids(layout)
    src = g["seeds"][:1]
    want, wst = g["ref_rt"].bfs(g["ref_store"], "snb", src, ["KNOWS"],
                                "out", 5)
    for name, rt in g["rts"].items():
        got, st = rt.bfs(g["store"], "snb", src, ["KNOWS"], "out", 5)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
        assert (got >= 0).sum() > 1
        assert st.hop_edges == wst.hop_edges, name
        assert st.exchange_bytes == wst.exchange_bytes, name


def test_grid_bfs_runs_its_one_lane_on_row_0(grids, monkeypatch):
    """The BFS's one lane runs on lane row 0 only (the reference
    replicates CSR and dist over the rows, bfs.py:64-68; every row would
    compute the same dist): on the eight-device grid every level expands
    row 0's copies and never row 1's."""
    g = grids("unsplit")
    rt = g["rts"]["grid"]
    dev = rt.snapshots["snb"]
    row0 = {id(b) for sh in dev.shards[:4] for b in sh.blocks.values()}
    row1 = {id(b) for sh in dev.shards[4:] for b in sh.blocks.values()}
    assert len(dev.shards) == 8 and not row0 & row1
    read = []
    step = port_bfs.sharded_level_step

    def spy(blocks, *a, **k):
        read.extend(id(b) for b in blocks)
        return step(blocks, *a, **k)

    monkeypatch.setattr(port_bfs, "sharded_level_step", spy)
    got, _ = rt.bfs(g["store"], "snb", g["seeds"][:1], ["KNOWS"], "out", 5)
    assert read and set(read) <= row0
    want, _ = g["rts"]["axis"].bfs(g["store"], "snb", g["seeds"][:1],
                                   ["KNOWS"], "out", 5)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the copies lane rows share, and the per-device budget
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("delta", [False, True], ids=["base", "plane"])
def test_lane_rows_share_a_devices_copies(delta):
    """Lane rows whose slot for part p lies on one device share one copy
    of part p (the reference puts one replica a device of the column):
    on the one card's grid row 1 reads row 0's tensors, and the pin
    holds the bytes of a one-axis pin; on eight devices each row holds
    its own copies.  `pin_bytes` is the pin's ledger, `pin_home_bytes`
    its bytes a device, and the budget charges each device once."""
    snap = D.snapshot_from_arrays(D.make_social_arrays(400, 5), parts=4)
    kw = {"delta_max_edges": 64} if delta else {}
    axis = GpuRuntime(mesh=make_mesh(4, devices=[CPU]), **kw)
    one = axis.pin_prebuilt(snap)
    per_part = one.shard_hbm_bytes()
    hd = one.delta.host.nbytes() if delta else 0

    card = GpuRuntime(mesh=one_card_grid(2, 4), **kw)
    dev = card.pin_prebuilt(snap)
    assert len(dev.shards) == 4 and dev.slot_index == [0, 1, 2, 3] * 2
    for a, b in zip(dev.slot_shards[:4], dev.slot_shards[4:]):
        assert a is b
    assert dev.hbm_bytes() == one.hbm_bytes()
    assert dev.shard_hbm_bytes() == per_part
    assert dev.home_bytes() == {0: one.hbm_bytes()} \
        == pin_home_bytes(dev.host, card.mesh, hd)
    assert pin_bytes(dev.host, card.mesh, hd) == dev.shard_hbm_bytes()

    grid = GpuRuntime(mesh=make_mesh2(2, 4, devices=EIGHT), **kw)
    dev8 = grid.pin_prebuilt(snap)
    assert len(dev8.shards) == 8 and dev8.slot_index == list(range(8))
    for a, b in zip(dev8.shards[:4], dev8.shards[4:]):
        assert (a.part, a.home + 4) == (b.part, b.home)
        for x, y in zip(a._leaves(), b._leaves()):
            assert x.data_ptr() != y.data_ptr()
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert dev8.shard_hbm_bytes() == {p: 2 * b for p, b in per_part.items()}
    assert dev8.home_bytes() == {h: per_part[h % 4] for h in range(8)} \
        == pin_home_bytes(dev8.host, grid.mesh, hd)
    assert pin_bytes(dev8.host, grid.mesh, hd) == dev8.shard_hbm_bytes()
    if delta:
        bk = ("KNOWS", "out")
        slots = dev8.delta.view[1][bk]["slots"]
        assert len(slots) == 8 and slots[0]["d_src"] is not slots[4]["d_src"]

    # the budget: each of the eight devices holds one part's copy
    limit = max(per_part.values())
    GpuRuntime(mesh=make_mesh2(2, 4, devices=EIGHT), hbm_limit_bytes=limit,
               **kw).pin_prebuilt(snap)
    with pytest.raises(GpuUnavailable):
        GpuRuntime(mesh=make_mesh2(2, 4, devices=EIGHT),
                   hbm_limit_bytes=limit - 1, **kw).pin_prebuilt(snap)
    # on the one card the rows' shared copies count once
    need = one.hbm_bytes()
    GpuRuntime(mesh=one_card_grid(2, 4), hbm_limit_bytes=need,
               **kw).pin_prebuilt(snap)
    with pytest.raises(GpuUnavailable):
        GpuRuntime(mesh=one_card_grid(2, 4), hbm_limit_bytes=need - 1,
                   **kw).pin_prebuilt(snap)


def test_go_through_writes_on_the_grid_matches_reference(  # noqa: F811
        delta_cfg):
    """A 2 x 4 grid pin of a delta-armed twin store: GO's columns and
    counts equal the reference's grid after every write group, each
    copy merging its own part's delta rows."""
    ref_st, twin = _store(4, 64), _store(4, 64)
    ref_rt = TpuRuntime(ref_make_mesh2(2, 4))
    assert ref_rt.pin(ref_st, "g").delta is not None
    twin.delta_watch("g")
    from nebula_tpu.graphstore import csr as ref_csr
    slack = int(ref_get_config().get("tpu_delta_vmax_slack"))
    snap = snapshot_from_fields(_delta_fields(ref_csr.build_snapshot(
        twin, "g", vmax_extra=slack)))
    rt = GpuRuntime(mesh=make_mesh2(2, 4, devices=EIGHT),
                    delta_max_edges=DCAP)
    dev = rt.pin_prebuilt(snap)
    assert dev.delta is not None and len(dev.shards) == 8
    port_st = _PortStore(twin)
    writers = (_Writer(ref_st), _Writer(twin))
    for group in ("empty", "inserts", "deletes", "overwrite", "mixed"):
        if group != "empty":
            for w in writers:
                w.group(group)
        want, wst = ref_rt.traverse(ref_st, "g", SEEDS, ["knows"], "out",
                                    STEPS, yields=_delta_yields(RE))
        got, st = rt.traverse(port_st, "g", SEEDS, ["knows"], "out", STEPS,
                              yields=_delta_yields(PE))
        assert len(got) == len(want) > 0, group
        _assert_cols_equal(_cols(got), _cols(want), group)
        assert (st.hop_edges, st.frontier_sizes) == \
            (wst.hop_edges, wst.frontier_sizes), group
        assert st.exchange_bytes == wst.exchange_bytes > 0
    assert rt.snapshots["g"] is dev and dev.delta.host.total_edges() > 0


# ---------------------------------------------------------------------------
# batched lanes on a 2 x 2 grid, and set_mesh from one axis to two
# ---------------------------------------------------------------------------


def _company(qids):
    for qid in qids:
        live_registry().register(qid=qid, session=0, user="t",
                                 stmt="dummy", kind="Go")


def _batching_off(qids):
    cfg = get_config()
    with cfg.lock:
        for k in ("batch_max_lanes", "batch_wait_us"):
            cfg.dynamic_layer.pop(k, None)
    for qid in qids:
        live_registry().deregister(qid)
    batch_former().reset()


GO2 = "GO 2 STEPS FROM {seed} OVER KNOWS YIELD dst(edge) AS d"


def _session(engine_cls, store, rt):
    eng = engine_cls(store, tpu_runtime=rt)
    s = eng.new_session()
    assert eng.execute(s, "USE g").error is None
    return eng, s


def _rows(eng, s, q):
    rs = eng.execute(s, q)
    assert rs.error is None, rs.error
    return sorted(map(repr, rs.data.rows))


@pytest.mark.parametrize("n", [3, 4])
def test_batched_lanes_on_a_2x2_grid(n):
    """Concurrent GO statements through the engine on a 2 x 2 grid form
    ONE run, its lanes split over the two rows (`lane_chunks`); every
    statement's rows equal its solo run's and the reference's grid's,
    and the exchange carries every lane (the port pads none)."""
    st = D.make_social_graph(80, 4, parts=2, seed=99, space="g")
    ref_st = ref_datagen.make_social_graph(80, 4, parts=2, seed=99,
                                           space="g")
    rt = GpuRuntime(mesh=make_mesh2(2, 2, devices=[CPU] * 4))
    eng, s = _session(QueryEngine, st, rt)
    ref_eng, ref_s = _session(RefQueryEngine, ref_st,
                              TpuRuntime(ref_make_mesh2(2, 2)))
    seeds = [1, 2, 3, 5][:n]
    truth = {sd: _rows(eng, s, GO2.format(seed=sd)) for sd in seeds}
    for sd in seeds:
        assert truth[sd] == _rows(ref_eng, ref_s, GO2.format(seed=sd))
    qids = (-501, -502)
    batch_former().reset()
    _company(qids)
    get_config().set_dynamic_many({"batch_max_lanes": n,
                                   "batch_wait_us": 2_000_000})
    s0 = stats().snapshot()
    out, errs = {}, []

    def run(sd):
        try:
            e, ss = eng, eng.new_session()
            assert e.execute(ss, "USE g").error is None
            out[sd] = _rows(e, ss, GO2.format(seed=sd))
        except BaseException as ex:  # noqa: BLE001 — asserted below
            errs.append(ex)

    try:
        ths = [threading.Thread(target=run, args=(sd,), daemon=True)
               for sd in seeds]
        for t in ths:
            t.start()
        for t in ths:
            t.join(60)
        assert not any(t.is_alive() for t in ths)
        s1 = stats().snapshot()
    finally:
        _batching_off(qids)
    assert not errs, errs
    assert s1.get("tpu_batches_formed", 0) \
        - s0.get("tpu_batches_formed", 0) == 1
    assert s1.get("tpu_kernel_runs", 0) - s0.get("tpu_kernel_runs", 0) == 1
    vmax = rt.snapshots["g"].vmax
    assert s1.get("tpu_all_to_all_bytes", 0) \
        - s0.get("tpu_all_to_all_bytes", 0) == a2a_payload_bytes(2, vmax, n)
    assert out == truth


def _bt_store():
    """tests/unit/test_batch.py's `batched_store`, in the port's store."""
    import random

    from nebula_tpu_torch.graphstore.schema import PropDef, PropType
    from nebula_tpu_torch.graphstore.store import GraphStore
    rng = random.Random(11)
    st = GraphStore()
    st.create_space("g", partition_num=4, vid_type="INT64")
    st.catalog.create_tag("g", "P", [PropDef("x", PropType.INT64)])
    st.catalog.create_edge("g", "KNOWS", [PropDef("w", PropType.INT64)])
    for v in range(60):
        st.insert_vertex("g", v, "P", {"x": v})
    for v in range(60):
        for _ in range(4):
            st.insert_edge("g", v, "KNOWS", rng.randrange(60), 0, {"w": v})
    return st


def test_set_mesh_from_one_axis_to_two_mid_form():
    """The reference's `test_repin_to_wider_mesh_mid_form_splits_group`
    onto a grid: statements enrolled before `set_mesh(make_mesh2(2, 4))`
    and statements enrolled after land in different groups (the mesh key
    carries the lanes and the epoch), every statement gets its rows (the
    retired group's rerun on the new pin), and the grid serves after."""
    rt = GpuRuntime(device="cpu")
    eng, s = _session(QueryEngine, _bt_store(), rt)
    seeds = [1, 2, 3, 5]
    truth = {sd: _rows(eng, s, GO2.format(seed=sd)) for sd in seeds}
    qids = (-511, -512)
    batch_former().reset()
    _company(qids)
    get_config().set_dynamic_many({"batch_max_lanes": 3,
                                   "batch_wait_us": 500_000})
    s0 = stats().snapshot()
    out, errs = {}, []

    def run(sd):
        try:
            ss = eng.new_session()
            assert eng.execute(ss, "USE g").error is None
            out[sd] = _rows(eng, ss, GO2.format(seed=sd))
        except BaseException as ex:  # noqa: BLE001 — asserted below
            errs.append(ex)

    key0 = rt._mesh_key()
    try:
        pre = [threading.Thread(target=run, args=(sd,), daemon=True)
               for sd in seeds[:2]]
        for t in pre:
            t.start()
        deadline = time.monotonic() + 30
        while not any(len(g.members) == 2
                      for g in batch_former()._groups.values()):
            assert time.monotonic() < deadline, "no pre-repin group of 2"
            time.sleep(0.005)
        rt.set_mesh(make_mesh2(2, 4, devices=EIGHT))
        post = [threading.Thread(target=run, args=(sd,), daemon=True)
                for sd in seeds[2:]]
        for t in post:
            t.start()
        for t in pre + post:
            t.join(60)
        assert not any(t.is_alive() for t in pre + post)
        s1 = stats().snapshot()
    finally:
        _batching_off(qids)
    assert not errs, errs
    assert out == truth
    assert s1.get("tpu_batches_formed", 0) \
        - s0.get("tpu_batches_formed", 0) == 2
    assert rt._mesh_key() == (2, 4, key0[2] + 1) and not rt.local_mode
    dev = rt.snapshots["g"]
    assert dev.mesh.lanes == 2 and len(dev.shards) == 8
    assert _rows(eng, s, GO2.format(seed=7)) == \
        _rows(*_session(QueryEngine, _bt_store(), GpuRuntime(device="cpu")),
              GO2.format(seed=7))


# ---------------------------------------------------------------------------
# a runtime over a process group: two gloo ranks
# ---------------------------------------------------------------------------

_RANK = r"""
import os, pickle, sys, time
from datetime import timedelta
import torch
import torch.distributed as dist
rank, store, out, mode, timeout = sys.argv[1:6]
rank = int(rank)
dist.init_process_group("gloo", init_method="file://" + store, world_size=2,
                        rank=rank, timeout=timedelta(seconds=float(timeout)))
import torch_mesh_workload as W
from nebula_tpu_torch.gpu.mesh import process_group_mesh

def mesh():
    return process_group_mesh(4, torch.device("cpu"))

if mode == "serve":
    res = W.run(mesh)
    res["parts"] = mesh().parts
    with open(out, "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
    sys.exit(0)
# mode "alone": rank 0 calls the runtime; rank 1 never does
from nebula_tpu_torch.bench import datagen as D
from nebula_tpu_torch.gpu import GpuRuntime
flag = store + ".done"
if rank == 1:
    end = time.monotonic() + 120
    while not os.path.exists(flag) and time.monotonic() < end:
        time.sleep(0.05)
    os._exit(0)
_, snap, seeds = W.social()
rt = GpuRuntime(mesh=mesh())
rt.pin_prebuilt(snap)
t0 = time.monotonic()
try:
    rt.traverse(D.SnapshotStore(snap), "snb", seeds, ["KNOWS"], "out", 3)
    res = {"error": None}
except Exception as ex:
    res = {"error": type(ex).__name__, "message": str(ex)[:300]}
res["waited_s"] = time.monotonic() - t0
with open(out, "wb") as f:
    pickle.dump(res, f)
open(flag, "w").close()
os._exit(0)
"""


def _ranks(mode, timeout_s, limit_s):
    """Run `_RANK` in two gloo processes; returns what each wrote."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "tests")])
    # one intra-op thread a rank: the suite's other workers keep the cores
    env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _RANK, str(r),
             os.path.join(tmp, "store"), outs[r], mode, str(timeout_s)],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            logs = [p.communicate(timeout=limit_s)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log
        got = []
        for o in outs:
            if os.path.exists(o):
                with open(o, "rb") as f:
                    # written by this test's own rank processes
                    got.append(pickle.load(f))
        return got


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def _ref_workload(writes):
    """The reference's side of the workload: GO, MATCH and the BFS on
    `TpuRuntime(make_mesh(4))`, and IC5 and IC9 through its device
    engine before and after `writes`."""
    arrs, ref_snap = _social_ref(4)
    _, _, seeds = W.social()
    cfg = ref_get_config()
    cfg.set_dynamic("tpu_degree_split_threshold", W.THRESHOLD)
    try:
        rt = TpuRuntime(ref_make_mesh(4))
        rt.init_eb = 1 << 12
        rt.pin_prebuilt(ref_snap)
    finally:
        cfg.set_dynamic("tpu_degree_split_threshold", 0)
    store = ref_datagen.SnapshotStore(ref_snap)
    out = {"go": rt.traverse(store, "snb", seeds, ["KNOWS"], "out", STEPS,
                             edge_filter=_where(RE), yields=_yields(RE)),
           "hops": rt.traverse_hops(store, "snb", seeds, ["KNOWS"], "out",
                                    STEPS, edge_filter=_where(RE)),
           "bfs": rt.bfs(store, "snb", seeds[:1], ["KNOWS"], "out", 5)}
    ic_store, _ = ref_datagen.make_snb_interactive(W.IC_PERSONS, parts=4)
    # its delta plane armed as the port's is: a plane's hop_edges count
    # the tombstoned slots, a rebuilt pin's do not
    cfg.set_dynamic("tpu_delta_max_edges", W.IC_DELTA_CAP)
    try:
        eng = RefQueryEngine(ic_store,
                             tpu_runtime=TpuRuntime(ref_make_mesh(4)))
        s = eng.new_session()
        assert eng.execute(s, "USE ic").error is None
        qs = chip_smoke.ic_statements()
        out["ic"] = {}
        for when in ("before", "after"):
            if when == "after":
                for q in writes:
                    assert eng.execute(s, q).error is None, q
            for name in ("IC5", "IC9"):
                eng.qctx.last_tpu_stats = None
                rs = eng.execute(s, qs[name])
                assert rs.error is None, rs.error
                ts = eng.qctx.last_tpu_stats
                out["ic"][f"{name} {when}"] = (
                    [ref_wire.dumps(list(r)) for r in rs.data.rows],
                    (list(ts.hop_edges), list(ts.frontier_sizes)))
    finally:
        cfg.set_dynamic("tpu_delta_max_edges", 0)
    return out


def test_a_runtime_over_two_gloo_ranks():
    """Two ranks, each a `GpuRuntime` on `process_group_mesh(4, cpu)`
    (two slots a rank), run the same calls (SPMD): GO with a WHERE on a
    degree-split snapshot, MATCH's every-hop frames, the BFS, a GO asked
    with batching on (it runs solo: no batch forms across a process
    group), and IC5 and IC9 through `QueryEngine` before and after
    chip_smoke's `ic_writes`, folded through the delta plane.  Both
    ranks give the in-process 4-slot mesh's rows and TraverseStats, and
    the reference's rows and counts."""
    ranks = _ranks("serve", 60, 240)
    assert len(ranks) == 2
    assert sorted(r.pop("parts") for r in ranks) == [[0, 1], [2, 3]]
    local = W.run(lambda: make_mesh(4, devices=[CPU]))
    for r in ranks:
        # the in-process mesh's batch former was asked; the ranks' not
        assert r["batch"] == {"tpu_batches_formed": 0,
                              "tpu_kernel_runs": 1, "submits": 0}
        assert local["batch"]["submits"] == 1
        _assert_same({k: v for k, v in r.items() if k != "batch"},
                     {k: v for k, v in local.items() if k != "batch"})
    assert local["ic_pins"] == {"tpu_pins": 0, "tpu_repin_avoided": 1}
    vmax = W.social()[1].vmax
    assert local["go"][1]["exchange_bytes"] == 2 * a2a_payload_bytes(4, vmax)
    assert local["bfs"][1]["exchange_bytes"] == 5 * a2a_payload_bytes(4, vmax)

    ref = _ref_workload(local["ic_writes"])
    (want, wst), (cols, facts) = ref["go"], local["go"]
    _assert_cols_equal(cols, _cols(want), "go")
    assert (facts["hop_edges"], facts["frontier_sizes"],
            facts["exchange_bytes"]) == \
        (wst.hop_edges, wst.frontier_sizes, wst.exchange_bytes)
    (want, wst), (frames, facts) = ref["hops"], local["hops"]
    assert len(frames) == len(want)
    for a, b in zip(want, frames):
        for k in W.FRAME_KEYS:
            np.testing.assert_array_equal(np.asarray(getattr(a, k),
                                                     np.int64), b[k])
        assert [repr(e) for e in a.edges] == b["edges"]
    assert facts["hop_edges"] == wst.hop_edges
    (want, wst), (dist, facts) = ref["bfs"], local["bfs"]
    np.testing.assert_array_equal(dist, np.asarray(want))
    assert (facts["hop_edges"], facts["exchange_bytes"]) == \
        (wst.hop_edges, wst.exchange_bytes)
    assert ref["ic"] == local["ic"]


def test_a_rank_that_calls_alone_fails_within_its_timeout():
    """A rank that calls the runtime while the other does not waits in
    the first collective until the group's timeout, and that error is
    the call's: it neither hangs nor answers from the host."""
    (res,) = _ranks("alone", 5, 120)
    assert res["error"] is not None, res
    assert 4 <= res["waited_s"] < 30, res


def test_a_process_group_runtime_compacts_in_the_call(monkeypatch):
    """Past the watermark an in-process runtime compacts on a thread; a
    process-group runtime compacts in the call that crossed it, so that
    every rank swaps its pin at the same point of the SPMD sequence."""
    from types import SimpleNamespace

    from nebula_tpu_torch.gpu.mesh import ProcessGroup
    from nebula_tpu_torch.graphstore.store import GraphStore
    ran = []

    def fake_dev():
        host = SimpleNamespace(fill_ratio=lambda: 0.9)
        return SimpleNamespace(delta=SimpleNamespace(host=host),
                               retired=False)

    for mesh in (make_mesh(4, devices=[CPU]),
                 Mesh(4, [CPU] * 2, ProcessGroup(), first=2)):
        rt = GpuRuntime(mesh=mesh, delta_compact_watermark=0.5)
        monkeypatch.setattr(rt, "_compact", lambda store, space, dev:
                            ran.append(threading.current_thread()))
        dev = fake_dev()
        rt._maybe_compact(GraphStore(), "g", dev)
        if mesh.in_process:
            dev._compact_thread.join(10)
    assert ran[0] is not threading.current_thread()
    assert ran[1] is threading.current_thread()
