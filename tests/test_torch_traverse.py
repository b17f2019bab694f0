"""The port's GO slice against the JAX reference, end to end on the CPU.

One social graph (make_social_arrays(2000, 8), P = 8) is built by both
packages and must be identical array for array.  The reference snapshot
is then carried into the port through `snapshot_from_fields`, and the
reference `TpuRuntime` (local mode, one device) and the port's
`GpuRuntime(device="cpu")` run the same GO N STEPS with the same WHERE
and YIELD.  Tolerance: exact — the path moves integers and copies
float64 values, and the predicate compares float64 with float64.
"""
import numpy as np
import pytest

from nebula_tpu.bench import datagen as ref_datagen
from nebula_tpu.core import expr as RE
from nebula_tpu.tpu import TpuRuntime, make_mesh

from nebula_tpu_torch.bench import datagen as port_datagen
from nebula_tpu_torch.core import expr as PE
from nebula_tpu_torch.gpu import CannotCompile, GpuRuntime, GpuUnavailable
from nebula_tpu_torch.graphstore.csr import snapshot_from_fields

P = 8


def _fields(snap):
    """Plain arrays and lists out of a reference CsrSnapshot."""
    return {
        "space": snap.space, "epoch": snap.epoch,
        "num_parts": snap.num_parts, "vmax": snap.vmax,
        "num_vertices": np.asarray(snap.num_vertices),
        "dense_to_vid": list(snap.dense_to_vid),
        "pool": list(snap.pool.strings),
        "hub_dense": snap.hub_dense,
        "blocks": {k: {"indptr": b.indptr, "nbr": b.nbr, "rank": b.rank,
                       "props": dict(b.props),
                       "prop_types": {n: t.name
                                      for n, t in b.prop_types.items()}}
                   for k, b in snap.blocks.items()},
    }


@pytest.fixture(scope="module")
def graph():
    arrs = ref_datagen.make_social_arrays(2000, 8)
    ref_snap = ref_datagen.snapshot_from_arrays(arrs, parts=P)
    port_arrs = port_datagen.make_social_arrays(2000, 8)
    port_snap = port_datagen.snapshot_from_arrays(port_arrs, parts=P)
    carried = snapshot_from_fields(_fields(ref_snap))
    ref_rt = TpuRuntime(make_mesh(1))
    # start at a bucket that fits every case: one XLA compile per case
    # instead of a climb up the escalation ladder (rows are unchanged)
    ref_rt.init_eb = 1 << 13
    ref_rt.pin_prebuilt(ref_snap)
    port_rt = GpuRuntime(device="cpu")
    port_rt.pin_prebuilt(carried)
    seeds = np.unique(arrs["src"][:64])[:16].tolist()
    return dict(arrs=arrs, port_arrs=port_arrs, ref_snap=ref_snap,
                port_snap=port_snap, carried=carried, ref_rt=ref_rt,
                port_rt=port_rt, seeds=seeds,
                ref_store=ref_datagen.SnapshotStore(ref_snap),
                port_store=port_datagen.SnapshotStore(carried))


def _assert_snapshots_equal(ref, port):
    assert (ref.space, ref.epoch, ref.num_parts, ref.vmax) == \
        (port.space, port.epoch, port.num_parts, port.vmax)
    np.testing.assert_array_equal(ref.num_vertices, port.num_vertices)
    assert list(ref.dense_to_vid) == list(port.dense_to_vid)
    assert ref.pool.strings == port.pool.strings
    assert sorted(ref.blocks) == sorted(port.blocks)
    for k, rb in ref.blocks.items():
        pb = port.blocks[k]
        for name in ("indptr", "nbr", "rank"):
            a, b = getattr(rb, name), getattr(pb, name)
            assert a.dtype == b.dtype and a.shape == b.shape, (k, name)
            np.testing.assert_array_equal(a, b)
        assert sorted(rb.props) == sorted(pb.props)
        for n in rb.props:
            assert rb.props[n].dtype == pb.props[n].dtype
            np.testing.assert_array_equal(rb.props[n], pb.props[n])
        assert {n: t.name for n, t in rb.prop_types.items()} == \
            {n: t.name for n, t in pb.prop_types.items()}


def test_datagen_and_snapshot_identical(graph):
    for key in ("src", "dst", "w", "f", "city"):
        np.testing.assert_array_equal(graph["arrs"][key],
                                      graph["port_arrs"][key])
    _assert_snapshots_equal(graph["ref_snap"], graph["port_snap"])
    _assert_snapshots_equal(graph["ref_snap"], graph["carried"])


def test_host_oracle_identical(graph):
    for w_gt in (None, 50):
        r = ref_datagen.host_csr_traverse(graph["ref_snap"], graph["seeds"],
                                          3, w_gt=w_gt, materialize=True)
        p = port_datagen.host_csr_traverse(graph["carried"], graph["seeds"],
                                           3, w_gt=w_gt, materialize=True)
        assert r[:2] == p[:2]
        np.testing.assert_array_equal(r[2], p[2])
        np.testing.assert_array_equal(r[3], p[3])


def _yields(M):
    return [(M.FunctionCall("dst", [M.EdgeExpr()]), "d"),
            (M.FunctionCall("src", [M.EdgeExpr()]), "s"),
            (M.FunctionCall("rank", [M.EdgeExpr()]), "r"),
            (M.EdgeProp("KNOWS", "w"), "w"),
            (M.EdgeProp("KNOWS", "f"), "f")]


_FILTERS = {
    "none": None,
    "w_gt_50": lambda M: M.Binary(">", M.EdgeProp("KNOWS", "w"),
                                  M.Literal(50)),
    "f_lt_half": lambda M: M.Binary("<", M.EdgeProp("KNOWS", "f"),
                                    M.Literal(0.5)),
    "city_eve": lambda M: M.Binary("==", M.EdgeProp("KNOWS", "city"),
                                   M.Literal("eve")),
}


@pytest.mark.parametrize("filt", sorted(_FILTERS))
@pytest.mark.parametrize("direction", ["out", "in"])
@pytest.mark.parametrize("steps", [1, 2, 3])
def test_go_matches_reference(graph, steps, direction, filt):
    mk = _FILTERS[filt]
    ref_rows, ref_st = graph["ref_rt"].traverse(
        graph["ref_store"], "snb", graph["seeds"], ["KNOWS"], direction,
        steps, edge_filter=mk(RE) if mk else None, yields=_yields(RE))
    rows, st = graph["port_rt"].traverse(
        graph["port_store"], "snb", graph["seeds"], ["KNOWS"], direction,
        steps, edge_filter=mk(PE) if mk else None, yields=_yields(PE))
    assert rows.column_names == ref_rows.column_names
    assert len(rows) == len(ref_rows) > 0
    for name in rows.column_names:
        a = np.asarray(ref_rows.column_array(name))
        b = np.asarray(rows.column_array(name))
        assert a.dtype == b.dtype, name
        # equal IN ORDER: the capture order is part of the contract
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert st.hop_edges == ref_st.hop_edges
    assert st.frontier_sizes == ref_st.frontier_sizes
    assert st.result_edges == ref_st.result_edges == len(rows)


def test_go_rows_match_host_oracle(graph):
    """The port's own CPU oracle (bench.py's content check) agrees too."""
    for w_gt in (None, 50):
        filt = None if w_gt is None else PE.Binary(
            ">", PE.EdgeProp("KNOWS", "w"), PE.Literal(w_gt))
        rows, st = graph["port_rt"].traverse(
            graph["port_store"], "snb", graph["seeds"], ["KNOWS"], "out", 3,
            edge_filter=filt, yields=_yields(PE))
        total, kept, d, w = port_datagen.host_csr_traverse(
            graph["carried"], graph["seeds"], 3, w_gt=w_gt, materialize=True)
        assert st.edges_traversed() == total and len(rows) == kept
        dd = np.asarray(rows.column_array("d"), np.int64)
        ww = np.asarray(rows.column_array("w"), np.int64)
        a, b = np.lexsort((ww, dd)), np.lexsort((w, d))
        np.testing.assert_array_equal(dd[a], d[b])
        np.testing.assert_array_equal(ww[a], w[b])


def test_capture_off_counts_only(graph):
    _, ref_st = graph["ref_rt"].traverse(
        graph["ref_store"], "snb", graph["seeds"], ["KNOWS"], "out", 2,
        capture=False)
    rows, st = graph["port_rt"].traverse(
        graph["port_store"], "snb", graph["seeds"], ["KNOWS"], "out", 2,
        capture=False)
    assert rows == [] and st.hop_edges == ref_st.hop_edges
    assert st.frontier_sizes == ref_st.frontier_sizes


def test_out_of_slice_paths_raise(graph):
    rt, store = graph["port_rt"], graph["port_store"]
    # GO without yields is ported: (src_vid, Edge, dst_vid) rows, held
    # against the reference in tests/test_torch_match.py
    rows, st = rt.traverse(store, "snb", graph["seeds"], ["KNOWS"], "out", 2)
    assert len(rows) == st.result_edges > 0
    assert rows[0][1].src == rows[0][0] and rows[0][1].dst == rows[0][2]
    with pytest.raises(CannotCompile):
        rt.traverse(store, "snb", graph["seeds"], ["KNOWS"], "out", 2,
                    edge_filter=PE.Binary("<", PE.EdgeProp("KNOWS", "city"),
                                          PE.Literal("m")),
                    yields=_yields(PE))
    with pytest.raises(GpuUnavailable):
        rt.traverse(store, "other", graph["seeds"], ["KNOWS"], "out", 2,
                    yields=_yields(PE))


def test_seed_out_of_range_never_reaches_a_kernel(graph):
    snap = graph["carried"]
    with pytest.raises(ValueError, match="out of range"):
        GpuRuntime._seed_sorted([0, snap.num_parts * snap.vmax],
                                snap.num_parts, snap.vmax)


def test_default_device_without_cuda_raises():
    import torch
    if torch.cuda.is_available():
        assert GpuRuntime().device.type == "cuda"
    else:
        with pytest.raises(GpuUnavailable):
            GpuRuntime()
