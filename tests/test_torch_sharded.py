"""The port's sharded mesh against the JAX reference's, on the CPU.

Twin of tests/unit/test_sharded.py.  The port's in-process mesh is laid
over the CPU (`make_mesh(P, devices=[cpu])`, every slot in this process,
the kernels' plain versions running) and held against the reference's
`TpuRuntime(make_mesh(P))` on the 8-device virtual CPU mesh that
tests/conftest.py forces, on one snapshot carried across with
`snapshot_from_fields`: GO 3 STEPS (unsplit and degree-split, with and
without a WHERE), MATCH's frames, the BFS, GO through a delta plane with
writes pending, batched lanes, and the split GO and the BFS under three
layouts of slot groups (one group of four, four of one, two of two:
tests/test_torch_exchange.py holds the exchange itself); then the shard
ledger, the per-device budget, the part/mesh check, K15's and K16's
plain versions against the reference's functions, the part offset of
expand and merge_delta, and a two-process gloo run of the process-group
transport against the in-process one.  Tolerance: exact — the path moves integers
and copies float64 values.
"""
import json
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.bench import datagen as ref_datagen
from nebula_tpu.core import expr as RE
from nebula_tpu.tpu import TpuRuntime
from nebula_tpu.tpu import make_mesh as ref_make_mesh
from nebula_tpu.tpu import hop as ref_hop
from nebula_tpu.tpu.bfs import bfs_exchange_bytes as ref_bfs_bytes
from nebula_tpu.utils.config import get_config as ref_get_config

from nebula_tpu_torch.bench import datagen as D
from nebula_tpu_torch.core import expr as PE
from nebula_tpu_torch.gpu import GpuRuntime, GpuUnavailable
from nebula_tpu_torch.gpu import kernels as K
from nebula_tpu_torch.gpu.batch import batch_former
from nebula_tpu_torch.gpu.bfs import bfs_exchange_bytes
from nebula_tpu_torch.gpu.device import make_mesh, mesh_parts, pin_bytes, \
    pin_sharded
from nebula_tpu_torch.gpu.hop import a2a_payload_bytes, run_hops_sharded, \
    seed_slot_frontiers
from nebula_tpu_torch.gpu.mesh import Mesh, ProcessGroup, init_multihost
from nebula_tpu_torch.graphstore.csr import degree_split, \
    snapshot_from_fields
from nebula_tpu_torch.utils.config import get_config
from nebula_tpu_torch.utils.stats import stats
from nebula_tpu_torch.utils.workload import live_registry

from test_torch_delta import DCAP, SEEDS, _PortStore, _Writer, \
    _assert_cols_equal, _cols, _store, delta_cfg  # noqa: F401
from test_torch_delta import _fields as _delta_fields
from test_torch_delta import _yields as _delta_yields

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
PERSONS, DEGREE = 600, 6           # make_social_arrays of the GO cases
THRESHOLD = 24                     # the split layout's degree threshold
STEPS = 3


def _fields(snap):
    """Plain arrays and lists out of a reference CsrSnapshot."""
    return {
        "space": snap.space, "epoch": snap.epoch,
        "num_parts": snap.num_parts, "vmax": snap.vmax,
        "num_vertices": np.asarray(snap.num_vertices),
        "dense_to_vid": list(snap.dense_to_vid),
        "pool": list(snap.pool.strings), "hub_dense": snap.hub_dense,
        "blocks": {k: {"indptr": b.indptr, "nbr": b.nbr, "rank": b.rank,
                       "props": dict(b.props),
                       "prop_types": {n: t.name
                                      for n, t in b.prop_types.items()}}
                   for k, b in snap.blocks.items()},
    }


def _where(M):
    return M.Binary(">", M.EdgeProp("KNOWS", "w"), M.Literal(50))


def _yields(M):
    return [(M.FunctionCall("dst", [M.EdgeExpr()]), "d"),
            (M.FunctionCall("src", [M.EdgeExpr()]), "s"),
            (M.FunctionCall("rank", [M.EdgeExpr()]), "r"),
            (M.EdgeProp("KNOWS", "w"), "w"),
            (M.EdgeProp("KNOWS", "f"), "f")]


def _mesh(P):
    return make_mesh(P, devices=[CPU])


@pytest.fixture(scope="module")
def graphs():
    """Per (P, layout): the reference runtime on make_mesh(P), the port's
    P-slot mesh runtime and its local runtime, pinned on one snapshot,
    built once a key on first use."""
    arrs = ref_datagen.make_social_arrays(PERSONS, DEGREE)
    cache = {}

    def get(P, layout):
        if (P, layout) in cache:
            return cache[(P, layout)]
        ref_snap = ref_datagen.snapshot_from_arrays(arrs, parts=P)
        thr = THRESHOLD if layout == "split" else 0
        cfg = ref_get_config()
        cfg.set_dynamic("tpu_degree_split_threshold", thr)
        try:
            ref_rt = TpuRuntime(ref_make_mesh(P))
            ref_rt.init_eb = 1 << 12      # one bucket: one compile a case
            ref_rt.pin_prebuilt(ref_snap)
        finally:
            cfg.set_dynamic("tpu_degree_split_threshold", 0)
        carried = snapshot_from_fields(_fields(ref_snap))
        rt = GpuRuntime(mesh=_mesh(P), degree_split_threshold=thr)
        rt.pin_prebuilt(carried)
        local = GpuRuntime(device="cpu", degree_split_threshold=thr)
        local.pin_prebuilt(carried)
        dev = rt.snapshots["snb"]
        seeds = np.unique(arrs["src"][:64])[:16].tolist()
        if thr:
            assert dev.num_hubs > 0
            hubs = dev.host.hub_dense
            seeds = sorted(set(seeds) | {int(hubs[0]), int(hubs[-1])})
        cache[(P, layout)] = dict(
            ref_rt=ref_rt, rt=rt, local=local, seeds=seeds, carried=carried,
            ref_store=ref_datagen.SnapshotStore(ref_snap),
            store=D.SnapshotStore(carried))
        return cache[(P, layout)]

    return get


# ---------------------------------------------------------------------------
# GO, MATCH and the BFS against the reference's sharded runtime
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("filt", [False, True], ids=["all", "w_gt_50"])
@pytest.mark.parametrize("layout", ["unsplit", "split"])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_go_matches_reference_mesh(graphs, P, layout, filt):
    g = graphs(P, layout)
    want, wst = g["ref_rt"].traverse(
        g["ref_store"], "snb", g["seeds"], ["KNOWS"], "out", STEPS,
        edge_filter=_where(RE) if filt else None, yields=_yields(RE))
    got, st = g["rt"].traverse(
        g["store"], "snb", g["seeds"], ["KNOWS"], "out", STEPS,
        edge_filter=_where(PE) if filt else None, yields=_yields(PE))
    assert len(got) == len(want) > 0
    _assert_cols_equal(_cols(got), _cols(want), f"P={P} {layout}")
    assert st.hop_edges == wst.hop_edges
    assert st.frontier_sizes == wst.frontier_sizes
    assert st.shards == wst.shards == P
    vmax = g["rt"].snapshots["snb"].vmax
    assert st.exchange_bytes == wst.exchange_bytes \
        == 2 * a2a_payload_bytes(P, vmax)
    # the port's own local run: the same rows, in order, and counts
    loc, lst = g["local"].traverse(
        g["store"], "snb", g["seeds"], ["KNOWS"], "out", STEPS,
        edge_filter=_where(PE) if filt else None, yields=_yields(PE))
    _assert_cols_equal(_cols(got), _cols(loc), "local")
    assert (st.hop_edges, st.frontier_sizes) == \
        (lst.hop_edges, lst.frontier_sizes)
    assert lst.shards == 1 and lst.exchange_bytes == 0


def _assert_frames_equal(got, want, tag):
    assert len(got) == len(want), tag
    for h, (a, b) in enumerate(zip(want, got)):
        assert a.n == b.n > 0, (tag, h)
        for k in ("src", "dst", "rank", "key_et", "key_s", "key_d"):
            np.testing.assert_array_equal(
                np.asarray(getattr(a, k), np.int64), getattr(b, k),
                err_msg=f"{tag} hop {h} {k}")
        assert [repr(e) for e in a.edges] == [repr(e) for e in b.edges], \
            (tag, h)


@pytest.mark.parametrize("P", [2, 4])
def test_match_frames_match_reference_mesh(graphs, P):
    g = graphs(P, "unsplit")
    for filt in (None, "w"):
        want, wst = g["ref_rt"].traverse_hops(
            g["ref_store"], "snb", g["seeds"], ["KNOWS"], "out", 3,
            edge_filter=_where(RE) if filt else None)
        got, st = g["rt"].traverse_hops(
            g["store"], "snb", g["seeds"], ["KNOWS"], "out", 3,
            edge_filter=_where(PE) if filt else None)
        _assert_frames_equal(got, want, f"P={P} {filt}")
        assert st.hop_edges == wst.hop_edges and st.shards == P
        assert st.exchange_bytes == 2 * a2a_payload_bytes(
            P, g["rt"].snapshots["snb"].vmax)


@pytest.mark.parametrize("P", [2, 4])
def test_bfs_matches_reference_mesh(graphs, P):
    g = graphs(P, "unsplit")
    src = g["seeds"][:1]
    want, wst = g["ref_rt"].bfs(g["ref_store"], "snb", src, ["KNOWS"],
                                "out", 5)
    got, st = g["rt"].bfs(g["store"], "snb", src, ["KNOWS"], "out", 5)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got >= 0).sum() > 1
    assert st.hop_edges == wst.hop_edges
    vmax = g["rt"].snapshots["snb"].vmax
    assert st.exchange_bytes == wst.exchange_bytes \
        == bfs_exchange_bytes(P, vmax, 5) == ref_bfs_bytes(P, vmax, 5)
    # the local run is direction-optimizing: the depths agree, not the
    # per-level slot counts
    loc, _ = g["local"].bfs(g["store"], "snb", src, ["KNOWS"], "out", 5)
    np.testing.assert_array_equal(got, loc)


# the slot groups of a 4-slot mesh: one group of four, four of one, two
# of two (gpu/mesh.py Mesh.groups); the graphs fixture's mesh is the first
GROUPINGS = {"one_group": [CPU], "four_groups": [CPU] * 4,
             "two_groups": [CPU, CPU]}


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_go_and_bfs_match_under_slot_groupings(graphs, grouping):
    """The split GO 3 STEPS WHERE w > 50 and the BFS on a 4-slot mesh
    laid out as `grouping`: rows, hop_edges, frontier_sizes, depths and
    exchange_bytes equal to the one-group run's and the reference's."""
    g = graphs(4, "split")
    rt = GpuRuntime(mesh=make_mesh(4, devices=GROUPINGS[grouping]),
                    degree_split_threshold=THRESHOLD)
    rt.pin_prebuilt(g["carried"])
    assert len(rt.mesh.groups) == {"one_group": 1, "four_groups": 4,
                                   "two_groups": 2}[grouping]
    want, wst = g["ref_rt"].traverse(
        g["ref_store"], "snb", g["seeds"], ["KNOWS"], "out", STEPS,
        edge_filter=_where(RE), yields=_yields(RE))
    one, ost = g["rt"].traverse(
        g["store"], "snb", g["seeds"], ["KNOWS"], "out", STEPS,
        edge_filter=_where(PE), yields=_yields(PE))
    got, st = rt.traverse(
        g["store"], "snb", g["seeds"], ["KNOWS"], "out", STEPS,
        edge_filter=_where(PE), yields=_yields(PE))
    assert len(got) == len(want) > 0
    _assert_cols_equal(_cols(got), _cols(want), grouping)
    _assert_cols_equal(_cols(got), _cols(one), grouping)
    for s in (wst, ost):
        assert (st.hop_edges, st.frontier_sizes, st.exchange_bytes) == \
            (s.hop_edges, s.frontier_sizes, s.exchange_bytes)
    vmax = rt.snapshots["snb"].vmax
    assert st.exchange_bytes == 2 * a2a_payload_bytes(4, vmax)
    src = g["seeds"][:1]
    want, wst = g["ref_rt"].bfs(g["ref_store"], "snb", src, ["KNOWS"],
                                "out", 5)
    one, ost = g["rt"].bfs(g["store"], "snb", src, ["KNOWS"], "out", 5)
    got, st = rt.bfs(g["store"], "snb", src, ["KNOWS"], "out", 5)
    assert (got >= 0).sum() > 1
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, one)
    for s in (wst, ost):
        assert (st.hop_edges, st.exchange_bytes) == \
            (s.hop_edges, s.exchange_bytes)
    assert st.exchange_bytes == bfs_exchange_bytes(4, vmax, 5)


def test_go_through_writes_matches_reference_mesh(delta_cfg):  # noqa: F811
    """A 4-slot pin of a delta-armed twin store: GO's columns, in order,
    and its counts equal the reference's 4-part mesh run after every write
    group, each slot merging only its own part's delta rows."""
    ref_st, twin = _store(4, 64), _store(4, 64)
    ref_rt = TpuRuntime(ref_make_mesh(4))
    assert ref_rt.pin(ref_st, "g").delta is not None
    twin.delta_watch("g")
    from nebula_tpu.graphstore import csr as ref_csr
    slack = int(ref_get_config().get("tpu_delta_vmax_slack"))
    snap = snapshot_from_fields(_delta_fields(ref_csr.build_snapshot(
        twin, "g", vmax_extra=slack)))
    rt = GpuRuntime(mesh=_mesh(4), delta_max_edges=DCAP)
    dev = rt.pin_prebuilt(snap)
    assert dev.delta is not None and len(dev.shards) == 4
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
        assert st.hop_edges == wst.hop_edges, group
        assert st.frontier_sizes == wst.frontier_sizes, group
        assert st.exchange_bytes == wst.exchange_bytes > 0
    assert rt.snapshots["g"] is dev and dev.delta.host.total_edges() > 0
    # each slot's delta rows are its own part's
    bk = ("knows", "out")
    for i, sh in enumerate(dev.shards):
        rows = dev.delta.view[1][bk]["slots"][i]
        np.testing.assert_array_equal(
            rows["d_src"].numpy(),
            dev.delta.view[1][bk]["np"]["d_src"][sh.part:sh.part + 1])


# ---------------------------------------------------------------------------
# the shard ledger, the per-device budget, the part/mesh check
# ---------------------------------------------------------------------------


def test_shard_hbm_ledger(graphs):
    g = graphs(4, "split")
    rt = g["rt"]
    dev = rt.snapshots["snb"]
    host = dev.host
    per = dev.shard_hbm_bytes()
    assert set(per) == {0, 1, 2, 3}
    assert sum(per.values()) == dev.hbm_bytes() == rt.hbm_bytes()
    H = dev.num_hubs
    for p, sh in zip(range(4), dev.shards):
        assert sh.part == p
        # only part p's rows, and the (H,) hub tables
        mine = host.num_vertices[p:p + 1].astype(np.int32).nbytes + 12 * H
        for bk, b in host.blocks.items():
            d = sh.blocks[bk]
            for name in ("indptr", "nbr", "rank"):
                np.testing.assert_array_equal(getattr(d, name).numpy(),
                                              getattr(b, name)[p:p + 1])
                mine += getattr(b, name)[p].nbytes
            for n, col in b.props.items():
                np.testing.assert_array_equal(d.props[n].numpy(),
                                              col[p:p + 1])
                mine += col[p].nbytes
        # and part p's rows of every tag table
        assert set(sh.tags) == set(host.tags)
        for name, t in host.tags.items():
            d = sh.tags[name]
            for dcol, col in [(d.present, t.present)] + [
                    (d.props[n], c) for n, c in t.props.items()]:
                np.testing.assert_array_equal(dcol.numpy(), col[p:p + 1])
                mine += col[p].nbytes
        assert per[p] == mine
    # the local pin holds the same bytes but the hub tables' copies
    assert sum(per.values()) == g["local"].hbm_bytes() + 3 * 12 * H
    rt._emit_hbm_gauges()
    snap = stats().snapshot()
    assert snap.get("tpu_shards") == 4.0
    gauges = [snap.get(f"tpu_shard_hbm_bytes{{shard={p}}}") for p in range(4)]
    assert gauges == [float(per[p]) for p in range(4)]
    assert sum(gauges) == snap.get("tpu_hbm_bytes_pinned")


def test_hbm_budget_is_per_device():
    """A budget of half the snapshot refuses a 1-slot pin and accepts a
    4-slot one over four devices (each slot parks a quarter); four slots
    on ONE device sum on it and are refused too."""
    snap = D.snapshot_from_arrays(D.make_social_arrays(400, 5), parts=4)
    limit = snap.hbm_bytes() // 2
    with pytest.raises(GpuUnavailable):
        GpuRuntime(device="cpu", hbm_limit_bytes=limit).pin_prebuilt(snap)
    with pytest.raises(GpuUnavailable):
        GpuRuntime(mesh=make_mesh(4, devices=[CPU]),
                   hbm_limit_bytes=limit).pin_prebuilt(snap)
    rt = GpuRuntime(mesh=make_mesh(4, devices=[CPU] * 4),
                    hbm_limit_bytes=limit)
    dev = rt.pin_prebuilt(snap)
    assert max(dev.shard_hbm_bytes().values()) <= limit
    store = D.SnapshotStore(snap)
    rows, st = rt.traverse(store, "snb", [1, 5, 9], ["KNOWS"], "out", 3,
                           yields=_yields(PE))
    local = GpuRuntime(device="cpu")
    local.pin_prebuilt(snap)
    want, _ = local.traverse(store, "snb", [1, 5, 9], ["KNOWS"], "out", 3,
                             yields=_yields(PE))
    _assert_cols_equal(_cols(rows), _cols(want), "budget")
    assert st.shards == 4


@pytest.mark.parametrize("slots,split,delta", [
    (1, False, False), (1, True, False), (1, False, True),
    (4, False, False), (4, True, False), (4, False, True)])
def test_pin_bytes_is_the_pins_ledger(slots, split, delta):
    """`pin_bytes` counts, before the put, exactly what the pin then
    holds on each slot (the hub tables on every slot and the delta plane
    armed at pin time included), and the budget holds each device to
    that: four slots on one device refuse a limit one byte below their
    sum and accept the sum."""
    snap = D.snapshot_from_arrays(D.make_social_arrays(400, 5), parts=4)
    kw = {"degree_split_threshold": 8 if split else 0,
          "delta_max_edges": 64 if delta else 0}
    mk = (lambda **k: GpuRuntime(device="cpu", **k)) if slots == 1 else (
        lambda **k: GpuRuntime(mesh=make_mesh(slots, devices=[CPU]), **k))
    rt = mk(**kw)
    dev = rt.pin_prebuilt(snap)
    assert (dev.num_hubs > 0) == split and (dev.delta is not None) == delta
    hd = dev.delta.host.nbytes() if delta else 0
    assert pin_bytes(dev.host, rt.mesh, hd) == dev.shard_hbm_bytes()
    need = dev.hbm_bytes()
    with pytest.raises(GpuUnavailable):
        mk(hbm_limit_bytes=need - 1, **kw).pin_prebuilt(snap)
    assert mk(hbm_limit_bytes=need, **kw).pin_prebuilt(snap).hbm_bytes() \
        == need


def test_part_mesh_mismatch_is_unavailable():
    snap = D.snapshot_from_arrays(D.make_social_arrays(200, 4), parts=8)
    with pytest.raises(GpuUnavailable):
        GpuRuntime(mesh=_mesh(4)).pin_prebuilt(snap)


def test_make_mesh_lays_slots_over_devices():
    m = make_mesh(8, devices=[CPU])
    assert mesh_parts(m) == 8 and m.devices == (CPU,) * 8
    assert m.homes == (0,) * 8 and m.parts == list(range(8))
    m2 = make_mesh(4, devices=[CPU] * 2)
    assert m2.homes == (0, 0, 1, 1)
    rt = GpuRuntime(mesh=make_mesh(1, devices=[CPU]))
    assert rt.local_mode and rt.mesh_size == 1
    with pytest.raises(ValueError):
        GpuRuntime(device="cpu", mesh=m)
    # a process-group mesh is out of the runtime's scope
    with pytest.raises(GpuUnavailable):
        GpuRuntime(mesh=Mesh(4, [CPU] * 2, ProcessGroup(), first=2))


def test_init_multihost_reads_the_reference_environment(monkeypatch):
    """The process-group counterpart of the reference's init_multihost:
    a no-op without NEBULA_COORDINATOR, a ValueError when it is set
    without the other two (nothing is joined either way)."""
    for k in ("NEBULA_COORDINATOR", "NEBULA_NUM_PROCESSES",
              "NEBULA_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert init_multihost() is False
    monkeypatch.setenv("NEBULA_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="NEBULA_NUM_PROCESSES"):
        init_multihost()


# ---------------------------------------------------------------------------
# batched lanes on a 4-slot mesh
# ---------------------------------------------------------------------------


def test_sharded_batched_lanes(graphs):
    """Concurrent GO statements on a 4-slot mesh form ONE lanes x slots
    run, every statement's rows equal its solo run's, and the exchange
    bytes of the shared run count every lane."""
    g = graphs(4, "unsplit")
    rt = g["rt"]
    seeds = g["seeds"]
    sets = [seeds[2 * i:2 * i + 2] for i in range(4)]

    def go(sd):
        return rt.traverse(g["store"], "snb", sd, ["KNOWS"], "out", 2,
                           edge_filter=_where(PE), yields=_yields(PE))

    solo = [go(sd) for sd in sets]
    former = batch_former()
    former.reset()
    for qid in (-301, -302):
        live_registry().register(qid=qid, session=0, user="t",
                                 stmt="dummy", kind="Go")
    # the group launches once its four lanes are in: the window only
    # bounds a late thread's wait
    get_config().set_dynamic_many({"batch_max_lanes": 4,
                                   "batch_wait_us": 2_000_000})
    s0 = stats().snapshot()
    out, errs = {}, {}
    try:
        def run(i):
            try:
                out[i] = go(sets[i])
            except BaseException as ex:  # noqa: BLE001 — asserted below
                errs[i] = ex

        ths = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(60)
        s1 = stats().snapshot()
    finally:
        cfg = get_config()
        with cfg.lock:
            for k in ("batch_max_lanes", "batch_wait_us"):
                cfg.dynamic_layer.pop(k, None)
        for qid in (-301, -302):
            live_registry().deregister(qid)
        former.reset()
    assert not errs, errs
    assert s1.get("tpu_batches_formed", 0) \
        - s0.get("tpu_batches_formed", 0) == 1
    assert s1.get("tpu_kernel_runs", 0) - s0.get("tpu_kernel_runs", 0) == 1
    vmax = rt.snapshots["snb"].vmax
    assert s1.get("tpu_all_to_all_bytes", 0) \
        - s0.get("tpu_all_to_all_bytes", 0) == a2a_payload_bytes(4, vmax, 4)
    for i in range(4):
        rows, st = out[i]
        _assert_cols_equal(_cols(rows), _cols(solo[i][0]), f"lane {i}")
        assert st.hop_edges == solo[i][1].hop_edges
        assert st.exchange_bytes == a2a_payload_bytes(4, vmax, 4)


# ---------------------------------------------------------------------------
# K15, K16: the plain versions against the reference's functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lanes", [False, True], ids=["solo", "lanes"])
@pytest.mark.parametrize("vmax", [1, 31, 32, 33, 1000])
def test_pack_and_unpack_match_reference(vmax, lanes):
    rng = np.random.default_rng(vmax * 2 + lanes)
    L, P = (3, 4) if lanes else (1, 4)
    m = rng.random((L, P, vmax)) < 0.4
    m[0, 0, vmax - 1] = True                  # the last column's bit
    if lanes:
        want = np.asarray(jax.vmap(ref_hop._pack_bits)(jnp.asarray(m)))
    else:
        want = np.asarray(ref_hop._pack_bits(jnp.asarray(m[0])))[None]
    got = K.pack_bits(torch.from_numpy(m))
    assert got.dtype == torch.int32 and want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # unpack what a slot received: rows from every slot, ORed
    recv = rng.integers(0, 1 << 32, (L, P, want.shape[-1]), dtype=np.uint64)
    recv = recv.astype(np.uint32)
    if lanes:
        ref_out = np.asarray(jax.vmap(lambda r: ref_hop._unpack_or(
            r, vmax))(jnp.asarray(recv)))
    else:
        ref_out = np.asarray(ref_hop._unpack_or(jnp.asarray(recv[0]),
                                                vmax))[None]
    buf = torch.zeros((L, 1, vmax + 5), dtype=torch.bool)
    out = K.unpack_or(torch.from_numpy(recv.view(np.int32)), vmax,
                      buf[:, 0, :vmax])
    np.testing.assert_array_equal(out.numpy(), ref_out)
    assert not buf[:, 0, vmax:].any()


@pytest.mark.parametrize("L", [1, 3])
def test_hub_pair_matches_reference_extension(L):
    """owned_hub_bits in every slot, summed, then fill_hub_columns: each
    slot's row equals the reference's `_extend_fbm_local` row, lane by
    lane."""
    rng = np.random.default_rng(L)
    P, vmax, H = 4, 50, 7
    hubs = rng.choice(P * vmax, H, replace=False).astype(np.int32)
    owner, local = hubs % P, hubs // P
    fbm = rng.random((L, P, vmax)) < 0.3
    fbm[0, owner[0], local[0]] = True
    to = torch.from_numpy
    slots = [torch.zeros((L, 1, vmax + H), dtype=torch.bool)
             for _ in range(P)]
    for p, s in enumerate(slots):
        s[:, 0, :vmax] = to(fbm[:, p])
    owned = [K.owned_hub_bits(s, p, to(owner), to(local))
             for p, s in enumerate(slots)]
    assert owned[0].dtype == torch.int32 and owned[0].shape == (L, H)
    summed = sum(owned)
    for s in slots:
        K.fill_hub_columns(s, summed)
    for lane in range(L):
        want = np.asarray(ref_hop._extend_fbm_local(
            jnp.asarray(fbm[lane]), jnp.asarray(owner), jnp.asarray(local),
            P))
        for p, s in enumerate(slots):
            np.testing.assert_array_equal(s[lane, 0].numpy(), want[p])


def test_payload_bytes_match_reference():
    for P in (1, 2, 4, 8):
        for vmax in (1, 32, 33, 125_000):
            for lanes in (1, 3):
                assert a2a_payload_bytes(P, vmax, lanes) == \
                    ref_hop.a2a_payload_bytes(P, vmax, lanes)
                assert bfs_exchange_bytes(P, vmax, 5, lanes) == \
                    ref_bfs_bytes(P, vmax, 5, lanes)


# ---------------------------------------------------------------------------
# K1 and K9's part offset: a one-row slice with pid = p is row p
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["unsplit", "split"])
def test_expand_slice_with_pid_is_row_p(layout):
    arrs = D.make_social_arrays(500, 6)
    snap = D.snapshot_from_arrays(arrs, parts=4)
    if layout == "split":
        snap = degree_split(snap, THRESHOLD)
    b = snap.blocks[("KNOWS", "out")]
    P, rows = b.indptr.shape[0], b.indptr.shape[1] - 1
    rng = np.random.default_rng(7)
    fbm = torch.from_numpy(rng.random((2, P, rows)) < 0.2)   # two lanes
    hd = None if snap.hub_dense is None else torch.from_numpy(
        np.asarray(snap.hub_dense, np.int32))
    t = [torch.from_numpy(a) for a in (b.indptr, b.nbr, b.rank)]
    full = K.expand(*t, fbm, hd, extra=3)
    for p in range(P):
        part = K.expand(*(a[p:p + 1] for a in t), fbm[:, p:p + 1], hd,
                        extra=3, parts=P, pid=p)
        w = part[0].shape[-1]
        for a, f in zip(part[:4], full[:4]):
            np.testing.assert_array_equal(a[:, 0].numpy(),
                                          f[:, p, :w].numpy())
        np.testing.assert_array_equal(part[4][:, 0].numpy(),
                                      full[4][:, p].numpy())
    # the defaults leave the whole-snapshot call as it was
    again = K.expand(*t, fbm, hd, extra=3, parts=P, pid=0)
    for a, f in zip(again, full):
        assert torch.equal(a, f)


def test_merge_slice_with_pid_is_row_p():
    rng = np.random.default_rng(11)
    P, vmax, EB, Dcap, Tcap, emax = 4, 20, 10, 6, 4, 30
    total = torch.from_numpy(rng.integers(0, EB + 1, (2, P)).astype(
        np.int32))
    j = np.arange(EB)
    ve = j < total.numpy()[..., None]

    def slots(fill):
        base = np.where(ve, rng.integers(0, emax, (2, P, EB)), fill)
        return np.concatenate([base, np.full((2, P, Dcap), fill)], -1)

    s = [torch.from_numpy(slots(f).astype(np.int32))
         for f in (-1, -1, 0, 0)]
    fbm = torch.from_numpy(rng.random((2, P, vmax)) < 0.5)
    d = [torch.from_numpy(rng.integers(0, vmax, (P, Dcap)).astype(np.int32)),
         torch.from_numpy(rng.integers(0, P * vmax, (P, Dcap)).astype(
             np.int32)),
         torch.from_numpy(rng.integers(0, 3, (P, Dcap)).astype(np.int32)),
         torch.from_numpy(rng.random((P, Dcap)) < 0.8),
         torch.from_numpy(np.sort(rng.integers(0, emax, (P, Tcap)),
                                  1).astype(np.int32))]
    full = [x.clone() for x in s]
    fv, ft = K.merge_delta(*full, total, fbm, *d, emax)
    for p in range(P):
        part = [x[:, p:p + 1].clone() for x in s]
        pv, pt = K.merge_delta(*part, total[:, p:p + 1], fbm[:, p:p + 1],
                               *(x[p:p + 1] for x in d), emax, parts=P,
                               pid=p)
        for a, f in zip(part + [pv, pt], full + [fv, ft]):
            np.testing.assert_array_equal(a[:, 0].numpy(), f[:, p].numpy())


# ---------------------------------------------------------------------------
# the process-group transport: two gloo ranks against the in-process mesh
# ---------------------------------------------------------------------------

_GLOO_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
rank, store, out, persons, degree, thr = sys.argv[1:7]
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=2, rank=int(rank))
from nebula_tpu_torch.bench import datagen as D
from nebula_tpu_torch.gpu.device import pin_sharded
from nebula_tpu_torch.gpu.hop import run_hops_sharded, seed_slot_frontiers
from nebula_tpu_torch.gpu.mesh import process_group_mesh
from nebula_tpu_torch.graphstore.csr import degree_split
arrs = D.make_social_arrays(int(persons), int(degree))
snap = degree_split(D.snapshot_from_arrays(arrs, parts=4), int(thr))
mesh = process_group_mesh(4, torch.device("cpu"))
dev = pin_sharded(snap, mesh)
seeds = sorted(set(np.unique(arrs["src"][:64])[:16].tolist())
               | {int(snap.hub_dense[0])})
res = run_hops_sharded(
    mesh, dev.shards, [[sh.blocks[("KNOWS", "out")]] for sh in dev.shards],
    seed_slot_frontiers(dev, [seeds]), 3, yield_cols=("w",))
cap = res["cap"][0]
np.savez(out, parts=np.asarray(mesh.parts),
         hop_edges=res["hop_edges"].numpy(),
         frontier_sizes=res["frontier_sizes"].numpy(),
         sent=np.asarray(mesh.transport.sent_bytes),
         seeds=np.asarray(seeds),
         **{k: v.numpy() for k, v in cap.items()})
dist.destroy_process_group()
"""


def test_two_gloo_ranks_equal_the_in_process_mesh():
    """Two processes of two slots each run GO 3 STEPS (degree-split, so
    the hub sum crosses ranks too) through the process-group transport;
    each rank's parts equal the same parts of the in-process 4-slot run,
    and the bytes the ranks shipped sum to the in-process exchange's."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _GLOO_RANK, str(r),
             os.path.join(tmp, "store"), outs[r], str(PERSONS),
             str(DEGREE), str(THRESHOLD)],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            logs = [p.communicate(timeout=120)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log
        ranks = [dict(np.load(o)) for o in outs]

    arrs = D.make_social_arrays(PERSONS, DEGREE)
    snap = degree_split(D.snapshot_from_arrays(arrs, parts=4), THRESHOLD)
    mesh = _mesh(4)
    dev = pin_sharded(snap, mesh)
    seeds = ranks[0]["seeds"].tolist()
    res = run_hops_sharded(
        mesh, dev.shards,
        [[sh.blocks[("KNOWS", "out")]] for sh in dev.shards],
        seed_slot_frontiers(dev, [seeds]), 3, yield_cols=("w",))
    cap = res["cap"][0]
    for r in ranks:
        parts = r["parts"].tolist()
        assert parts == [2 * int(parts[0] // 2), 2 * int(parts[0] // 2) + 1]
        np.testing.assert_array_equal(r["hop_edges"],
                                      res["hop_edges"][:, parts].numpy())
        np.testing.assert_array_equal(
            r["frontier_sizes"], res["frontier_sizes"][:, parts].numpy())
        np.testing.assert_array_equal(r["kcount"],
                                      cap["kcount"][:, parts].numpy())
        for i, p in enumerate(parts):
            k = int(r["kcount"][0, i])
            for name in ("src", "dst", "rank", "eidx", "prop:w"):
                np.testing.assert_array_equal(
                    r[name][0, i, :k], cap[name][0, p, :k].numpy())
    assert int(res["hop_edges"].sum()) > 0
    sent = int(ranks[0]["sent"]) + int(ranks[1]["sent"])
    assert sent == mesh.transport.sent_bytes \
        == 2 * a2a_payload_bytes(4, snap.vmax)
    assert json.dumps(sorted(r["parts"].tolist() for r in ranks)) == \
        "[[0, 1], [2, 3]]"
