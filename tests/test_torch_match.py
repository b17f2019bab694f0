"""MATCH's device half in the port against the JAX reference, on the CPU.

Four levels, each held against `nebula_tpu/` with exact equality (the
path moves integers and copies float64 values):

  * the program: the port's `run_hops(..., capture_hops=True)` (the
    kernels' plain versions) against the reference's jitted
    `_build_local_fn(..., capture_hops=True)`, unsplit and degree-split,
    without a filter and with three WHERE programs: each hop's per-block
    kept count and kept prefixes, hop_edges and frontier_sizes;
  * the frames: `GpuRuntime(device="cpu").traverse_hops` against
    `TpuRuntime(make_mesh(1)).traverse_hops` on one carried snapshot
    (make_social_arrays(2000, 8), P = 8), in order — src, dst, rank, the
    canonical key columns and the `repr` of every decoded Edge — for
    directions out, in and both, on a two-edge-type store, and through
    the writes of twin delta-armed stores; with the trail count of the
    frames against `host_trail_paths` (both packages') where every
    (src, dst) key is unique, and the parallel-edge rule where it is not;
  * GO's Edge rows (`traverse` without yields) against the reference's;
  * DATE, DATETIME, TIME, GEOGRAPHY and DURATION props (values before
    1970 and NULLs among them): GO's yields and Edge rows, MATCH frames
    and a WHERE over two temporal columns, against the reference's, the
    values also compared with `==` once carried into the port;
  * batching: concurrent MATCH expansions share one run, each equal to
    its solo run, and a GO never shares a MATCH's run.

The copied numpy helpers (`HopFrame`, `join_frontier_trails`,
`trail_distinct_keep`) are held against the reference's on random
frames, empty and all-miss ones included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nebula_tpu.bench import datagen as ref_datagen
from nebula_tpu.core import expr as RE
from nebula_tpu.graphstore import csr as ref_csr
from nebula_tpu.graphstore.schema import PropDef as RefPropDef
from nebula_tpu.graphstore.schema import PropType as RefPropType
from nebula_tpu.graphstore.store import GraphStore
from nebula_tpu.tpu import TpuRuntime, make_mesh
from nebula_tpu.tpu import hop as ref_hop
from nebula_tpu.tpu import runtime as ref_runtime
from nebula_tpu.tpu.exprjit import compile_predicate as ref_compile
from nebula_tpu.utils.config import get_config as ref_get_config

from nebula_tpu_torch.bench import datagen as D
from nebula_tpu_torch.core import expr as PE
from nebula_tpu_torch.gpu import GpuRuntime, HopFrame, \
    join_frontier_trails, trail_distinct_keep
from nebula_tpu_torch.gpu.exprjit import compile_predicate
from nebula_tpu_torch.gpu.hop import run_hops
from nebula_tpu_torch.graphstore.csr import snapshot_from_fields

# the twin delta-armed stores and their one write script, and the batch
# former's fixtures, are those of the delta and batching twins
from test_torch_batch import _batching, _counter, _threads, clean, \
    company  # noqa: F401 — fixtures
from test_torch_delta import GROUPS, SEEDS, _PortStore, _port_pin, \
    _store, _Writer, delta_cfg  # noqa: F401 — fixture
from test_torch_value import to_port

P = 8
SPLIT = 64                      # degree-split threshold of the split cases
REF_EB = 1 << 13                # reference slot budget: nothing overflows


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


def _ref_rt(snap, split=0):
    cfg = ref_get_config()
    cfg.set_dynamic("tpu_degree_split_threshold", split)
    try:
        rt = TpuRuntime(make_mesh(1))
        rt.init_eb = REF_EB      # one bucket that fits every case
        rt.pin_prebuilt(snap)
    finally:
        cfg.set_dynamic("tpu_degree_split_threshold", 0)
    return rt


@pytest.fixture(scope="module")
def graph():
    arrs = ref_datagen.make_social_arrays(2000, 8)
    ref_snap = ref_datagen.snapshot_from_arrays(arrs, parts=P)
    carried = snapshot_from_fields(_fields(ref_snap))
    rts = {"unsplit": GpuRuntime(device="cpu"),
           "split": GpuRuntime(device="cpu", degree_split_threshold=SPLIT)}
    for rt in rts.values():
        rt.pin_prebuilt(carried)
    ref_rts = {"unsplit": _ref_rt(ref_snap),
               "split": _ref_rt(ref_datagen.snapshot_from_arrays(
                   arrs, parts=P), SPLIT)}
    hubs = rts["split"].snapshots["snb"].host.hub_dense
    # the usual 16 seeds plus two hubs, whose edges reach every part
    seeds = sorted(set(np.unique(arrs["src"][:64])[:16].tolist())
                   | {int(hubs[0]), int(hubs[-1])})
    return dict(arrs=arrs, ref_snap=ref_snap, carried=carried, rts=rts,
                ref_rts=ref_rts, seeds=seeds,
                ref_store=ref_datagen.SnapshotStore(ref_snap),
                store=D.SnapshotStore(carried))


_FILTERS = {
    "none": None,
    "w_gt_50": lambda M: M.Binary(">", M.EdgeProp("KNOWS", "w"),
                                  M.Literal(50)),
    "f_lt_half": lambda M: M.Binary("<", M.EdgeProp("KNOWS", "f"),
                                    M.Literal(0.5)),
    "city_eve": lambda M: M.Binary("==", M.EdgeProp("KNOWS", "city"),
                                   M.Literal("eve")),
}


def _filt(name, M):
    mk = _FILTERS[name]
    return None if mk is None else mk(M)


# ---------------------------------------------------------------------------
# the program: run_hops(capture_hops=True) against _build_local_fn
# ---------------------------------------------------------------------------


def _ref_program(graph, layout, filt, bks, steps):
    snap = graph["ref_rts"][layout].snapshots["snb"].host
    pred, pred_cols = None, []
    if filt != "none":
        pred, pred_cols = ref_compile(
            _filt(filt, RE), snap.blocks[bks[0]].prop_types, snap.pool,
            vid_to_dense=lambda v: int(v))
    names = [n for n in pred_cols if not n.startswith("_")]
    blocks = tuple(
        {"indptr": jnp.asarray(snap.blocks[bk].indptr),
         "nbr": jnp.asarray(snap.blocks[bk].nbr),
         "rank": jnp.asarray(snap.blocks[bk].rank),
         "props": {n: jnp.asarray(snap.blocks[bk].props[n]) for n in names}}
        for bk in bks)
    fn = jax.jit(ref_hop._build_local_fn(
        P, REF_EB, steps, len(bks), pred=pred, pred_cols=pred_cols,
        capture=True, capture_hops=True, hub_dense=snap.hub_dense))
    fr = np.zeros((P, snap.vmax), bool)
    d = np.asarray(graph["seeds"])
    fr[d % P, d // P] = True
    out = fn(blocks, jnp.asarray(fr))
    assert not np.asarray(out["ovf_expand"]).any()
    return {"hop_edges": np.asarray(out["hop_edges"]),
            "frontier_sizes": np.asarray(out["frontier_sizes"]),
            "kcount": np.asarray(out["kcount"]),
            "cap": {k: np.asarray(v) for k, v in out["cap"].items()}}


def _port_program(graph, layout, filt, bks, steps):
    rt = graph["rts"][layout]
    dev = rt.snapshots["snb"]
    pred = None
    if filt != "none":
        pred, _ = compile_predicate(
            _filt(filt, PE), dev.blocks[bks[0]].prop_types, dev.pool,
            vid_to_dense=graph["store"].space("snb").dense_id,
            device=rt.device)
    return dev, run_hops(dev, [dev.blocks[bk] for bk in bks],
                         rt._seed_frontier(dev, graph["seeds"]), steps,
                         pred=pred, capture_hops=True)


@pytest.mark.parametrize("filt", sorted(_FILTERS))
@pytest.mark.parametrize("layout", ["unsplit", "split"])
def test_every_hop_program_matches_reference(graph, layout, filt):
    steps = 3
    bks = [("KNOWS", "out"), ("KNOWS", "in")]      # two blocks a hop
    dev, res = _port_program(graph, layout, filt, bks, steps)
    assert (layout == "split") == (dev.num_hubs > 0)
    ref = _ref_program(graph, layout, filt, bks, steps)
    np.testing.assert_array_equal(res["hop_edges"].numpy(), ref["hop_edges"])
    np.testing.assert_array_equal(res["frontier_sizes"].numpy(),
                                  ref["frontier_sizes"])
    assert len(res["cap"]) == steps
    for h, blocks in enumerate(res["cap"]):
        assert len(blocks) == len(bks)
        for b, cap in enumerate(blocks):
            assert set(cap) == {"src", "dst", "rank", "eidx", "kcount"}
            kc = cap["kcount"].numpy()
            np.testing.assert_array_equal(kc, ref["kcount"][:, h, b],
                                          err_msg=f"hop {h} block {b}")
            assert kc.sum() > 0
            for k in ("src", "dst", "rank", "eidx"):
                got = cap[k].numpy()
                want = ref["cap"][k][:, h, b]
                for p in range(P):
                    np.testing.assert_array_equal(
                        got[p, :kc[p]], want[p, :kc[p]],
                        err_msg=f"hop {h} block {b} {k} part {p}")


def test_filter_prunes_the_next_frontier(graph):
    """The mark's keep is the predicate's mask: a WHERE that drops an
    edge drops its dst from the next frontier, so every filtered hop's
    frontier is the distinct dsts the hop before it kept."""
    dev, res = _port_program(graph, "unsplit", "w_gt_50",
                             [("KNOWS", "out")], 3)
    _, full = _port_program(graph, "unsplit", "none", [("KNOWS", "out")], 3)
    sizes = res["frontier_sizes"].numpy().sum(0)
    for h in range(2):
        (cap,) = res["cap"][h]
        kc = cap["kcount"].numpy()
        kept = np.concatenate([cap["dst"][p, :kc[p]].numpy()
                               for p in range(P)])
        assert sizes[h + 1] == np.unique(kept).size
    assert (sizes[1:] < full["frontier_sizes"].numpy().sum(0)[1:]).all()


# ---------------------------------------------------------------------------
# the frames: traverse_hops against the reference's
# ---------------------------------------------------------------------------


def _assert_frames_equal(got, want, tag):
    assert len(got) == len(want), tag
    for h, (a, b) in enumerate(zip(want, got)):
        assert a.n == b.n, (tag, h)
        for k in ("src", "dst", "rank", "key_et", "key_s", "key_d"):
            x, y = getattr(a, k), getattr(b, k)
            assert y.dtype == np.int64, (tag, h, k)
            np.testing.assert_array_equal(np.asarray(x, np.int64), y,
                                          err_msg=f"{tag} hop {h} {k}")
        assert [repr(e) for e in a.edges] == [repr(e) for e in b.edges], \
            (tag, h)


def _hops_both(graph, layout, direction, filt, steps=3):
    want, wst = graph["ref_rts"][layout].traverse_hops(
        graph["ref_store"], "snb", graph["seeds"], ["KNOWS"], direction,
        steps, edge_filter=_filt(filt, RE))
    got, st = graph["rts"][layout].traverse_hops(
        graph["store"], "snb", graph["seeds"], ["KNOWS"], direction, steps,
        edge_filter=_filt(filt, PE))
    return want, wst, got, st


@pytest.mark.parametrize("filt", sorted(_FILTERS))
@pytest.mark.parametrize("direction", ["out", "in", "both"])
def test_frames_match_reference(graph, direction, filt):
    want, wst, got, st = _hops_both(graph, "unsplit", direction, filt)
    _assert_frames_equal(got, want, f"{direction} {filt}")
    assert all(f.n > 0 for f in got)
    assert st.hop_edges == wst.hop_edges
    assert st.frontier_sizes == wst.frontier_sizes
    assert st.result_edges == wst.result_edges == sum(f.n for f in got)
    assert st.steps == 3


@pytest.mark.parametrize("filt", ["none", "w_gt_50"])
def test_split_frames_match_reference_split(graph, filt):
    """On a degree-split snapshot hub rows live on other parts: the frame
    equals the reference's split frame in order, and the unsplit one as a
    multiset."""
    want, wst, got, st = _hops_both(graph, "split", "out", filt)
    _assert_frames_equal(got, want, f"split {filt}")
    assert st.hop_edges == wst.hop_edges
    _, _, flat, _ = _hops_both(graph, "unsplit", "out", filt)
    for a, b in zip(got, flat):
        ka = np.lexsort((a.rank, a.dst, a.src))
        kb = np.lexsort((b.rank, b.dst, b.src))
        for k in ("src", "dst", "rank"):
            np.testing.assert_array_equal(getattr(a, k)[ka],
                                          getattr(b, k)[kb])


def test_frames_match_the_every_hop_oracle(graph):
    """host_hop_edges, the oracle chip_smoke.py holds the card's frames
    against, equals the CPU frames as a multiset, hop for hop."""
    for layout in ("unsplit", "split"):
        for w_gt in (None, 50):
            filt = "none" if w_gt is None else "w_gt_50"
            frames, _ = graph["rts"][layout].traverse_hops(
                graph["store"], "snb", graph["seeds"], ["KNOWS"], "out", 3,
                edge_filter=_filt(filt, PE))
            oracle = D.host_hop_edges(graph["carried"], graph["seeds"], 3,
                                      w_gt=w_gt)
            for f, (s, d, r) in zip(frames, oracle):
                a, b = np.lexsort((f.rank, f.dst, f.src)), \
                    np.lexsort((r, d, s))
                np.testing.assert_array_equal(f.src[a], s[b])
                np.testing.assert_array_equal(f.dst[a], d[b])
                np.testing.assert_array_equal(f.rank[a], r[b])


def test_no_known_seed_gives_empty_frames(graph):
    frames, st = graph["rts"]["unsplit"].traverse_hops(
        graph["store"], "snb", [-5, 10 ** 9], ["KNOWS"], "out", 3)
    assert len(frames) == 3 and all(f.n == 0 for f in frames)
    assert st.hop_edges == [] and st.result_edges == 0


def test_e_cap_is_each_hops_own_width(graph):
    """A result-neutral difference: the reference stacks every hop's
    capture at one uniform bucket (hop.py:_norm_ebs); the port sizes each
    hop exactly — one block's widest part expansion."""
    rt = graph["rts"]["unsplit"]
    dev = rt.snapshots["snb"]
    res, info = rt._run(dev, [dev.blocks[("KNOWS", "out")]],
                        [graph["seeds"]], 3, None, True, (), None,
                        [None], capture_hops=True)
    assert info["e_cap"] == [int(x) for x in
                             res["hop_edges"][0].max(axis=0)]
    assert info["e_cap"][0] < info["e_cap"][1] < info["e_cap"][2]
    want, wst, got, st = _hops_both(graph, "unsplit", "out", "none")
    assert st.e_cap == info["e_cap"]
    assert len(set(wst.e_cap)) == 1 and wst.e_cap[0] >= max(st.e_cap)
    _assert_frames_equal(got, want, "e_cap")


# ---------------------------------------------------------------------------
# two edge types, and frames through writes
# ---------------------------------------------------------------------------


def _two_type_store(parts=4, n=120, seed=3):
    rng = np.random.default_rng(seed)
    st = GraphStore()
    st.create_space("g2", partition_num=parts, vid_type="INT64")
    st.catalog.create_tag("g2", "person",
                          [RefPropDef("age", RefPropType.INT64)])
    for v in range(n):
        st.insert_vertex("g2", v, "person", {"age": v % 70})
    st.catalog.create_edge("g2", "knows", [
        RefPropDef("w", RefPropType.INT64),
        RefPropDef("f", RefPropType.DOUBLE),
        RefPropDef("tag", RefPropType.STRING)])
    st.catalog.create_edge("g2", "likes", [
        RefPropDef("w", RefPropType.INT64),
        RefPropDef("score", RefPropType.DOUBLE)])
    for _ in range(n * 4):
        s, d = (int(x) for x in rng.integers(0, n, 2))
        st.insert_edge("g2", s, "knows", d, int(rng.integers(0, 2)),
                       {"w": int(rng.integers(0, 100)),
                        "f": float(rng.random()),
                        "tag": ["ann", "bob", "cid"][int(rng.integers(3))]})
    for _ in range(n * 3):
        s, d = (int(x) for x in rng.integers(0, n, 2))
        st.insert_edge("g2", s, "likes", d, 0,
                       {"w": int(rng.integers(0, 100)),
                        "score": float(rng.random())})
    return st


@pytest.mark.parametrize("direction", ["out", "both"])
def test_two_edge_types_match_reference(direction):
    st = _two_type_store()
    snap = ref_csr.build_snapshot(st, "g2")
    ref_rt = TpuRuntime(make_mesh(1))
    ref_rt.init_eb = 1 << 10
    ref_rt.pin_prebuilt(snap)
    rt = GpuRuntime(device="cpu")
    rt.pin_prebuilt(snapshot_from_fields(_fields(snap)))
    seeds = [1, 2, 3, 5, 8]
    for filt in (False, True):
        def w(M):
            return M.Binary(">", M.EdgeProp("knows", "w"), M.Literal(30)) \
                if filt else None
        want, wst = ref_rt.traverse_hops(st, "g2", seeds, ["knows", "likes"],
                                         direction, 3, edge_filter=w(RE))
        got, gst = rt.traverse_hops(st, "g2", seeds, ["knows", "likes"],
                                    direction, 3, edge_filter=w(PE))
        _assert_frames_equal(got, want, f"{direction} filt={filt}")
        assert gst.hop_edges == wst.hop_edges
        # both edge types, with their own props, in the last frame
        names = {e.name for e in got[-1].edges}
        assert names == {"knows", "likes"}


@pytest.mark.parametrize("parts,direction", [(2, "out"), (4, "both")])
def test_frames_through_writes_match_reference(delta_cfg, parts, direction):
    ref_st, twin = _store(parts, 60 + parts), _store(parts, 60 + parts)
    ref_rt = TpuRuntime(make_mesh(1))
    assert ref_rt.pin(ref_st, "g").delta is not None
    port_rt = _port_pin(twin)
    port_st = _PortStore(twin)
    dev = port_rt.snapshots["g"]
    writers = (_Writer(ref_st), _Writer(twin))
    for group in ("empty",) + GROUPS:
        if group != "empty":
            for w in writers:
                w.group(group)
        for filt in (False, True):
            def where(M):
                return M.Binary(">", M.EdgeProp("knows", "w"),
                                M.Literal(40)) if filt else None
            want, wst = ref_rt.traverse_hops(ref_st, "g", SEEDS, ["knows"],
                                             direction, 3,
                                             edge_filter=where(RE))
            got, gst = port_rt.traverse_hops(port_st, "g", SEEDS, ["knows"],
                                             direction, 3,
                                             edge_filter=where(PE))
            tag = f"{group} filt={filt}"
            _assert_frames_equal(got, want, tag)
            assert gst.hop_edges == wst.hop_edges, tag
            assert gst.frontier_sizes == wst.frontier_sizes, tag
    assert port_rt.snapshots["g"] is dev          # no re-pin
    assert dev.delta.host.total_edges() > 0


# ---------------------------------------------------------------------------
# trails: the frames' count against host_trail_paths
# ---------------------------------------------------------------------------


def _trail_count(frames, seeds, join, distinct):
    """The executor's trail assembly, counting: extend every trail by
    the frame's edges out of its last vertex, drop continuations that
    reuse an edge of the trail."""
    last = np.asarray(sorted(set(seeds)), np.int64)
    path, total = [], 0
    for fr in frames:
        if last.size == 0 or fr.n == 0:
            break
        parent, fidx = join(fr, last)
        keep = distinct(frames, path, parent, fr, fidx)
        parent, fidx = parent[keep], fidx[keep]
        total += int(fidx.size)
        path = [pe[parent] for pe in path] + [fidx]
        last = fr.dst[fidx]
    return total


def _trail_graph(arrs, seeds, steps):
    """Frames of `steps` hops from `seeds` over the snapshot of `arrs`, by
    both runtimes (held equal in order); returns (carried, port frames,
    reference frames)."""
    ref_snap = ref_datagen.snapshot_from_arrays(arrs, parts=P, space="twb")
    carried = snapshot_from_fields(_fields(ref_snap))
    ref_rt = TpuRuntime(make_mesh(1))
    ref_rt.init_eb = REF_EB
    ref_rt.pin_prebuilt(ref_snap)
    rt = GpuRuntime(device="cpu")
    rt.pin_prebuilt(carried)
    want, _ = ref_rt.traverse_hops(ref_datagen.SnapshotStore(ref_snap),
                                   "twb", seeds, ["KNOWS"], "out", steps)
    got, _ = rt.traverse_hops(D.SnapshotStore(carried), "twb", seeds,
                              ["KNOWS"], "out", steps)
    _assert_frames_equal(got, want, "trail graph")
    return carried, got, want


def _trails_both(got, want, seeds):
    n = _trail_count(got, seeds, join_frontier_trails, trail_distinct_keep)
    assert n == _trail_count(want, seeds, ref_runtime.join_frontier_trails,
                             ref_runtime.trail_distinct_keep)
    return n


def test_trail_count_equals_host_trail_paths():
    """bench.py config 4b's check at CPU size: every (src, dst) key is
    unique (the last draw of each kept, as a store's overwrite keeps
    it), and the frames' trail count equals host_trail_paths."""
    arrs = D.unique_keys(D.make_social_arrays(3000, 6, seed=11,
                                              src_hot_frac=0.0))
    key = arrs["src"] * arrs["n"] + arrs["dst"]
    assert np.unique(key).size == key.size
    deg = np.bincount(arrs["src"], minlength=arrs["n"])
    seeds = np.flatnonzero(deg >= 3)[:40].tolist()
    carried, got, want = _trail_graph(arrs, seeds, 4)
    n = _trails_both(got, want, seeds)
    assert n > 10_000
    assert n == D.host_trail_paths(carried, seeds, 4) \
        == ref_datagen.host_trail_paths(carried, seeds, 4)


def test_unique_keys_keeps_each_keys_last_draw():
    arrs = {"n": 5, "src": np.array([0, 1, 0, 2, 1, 0]),
            "dst": np.array([1, 2, 1, 3, 2, 4]),
            "w": np.arange(6)}
    out = D.unique_keys(arrs)
    assert out["n"] == 5
    assert out["w"].tolist() == [2, 3, 4, 5]
    assert out["src"].tolist() == [0, 2, 1, 0]


def test_parallel_edges_follow_the_key_rule():
    """On a multigraph the frames identify a trail's edge by its key
    (key_et, key_s, key_d, rank), host_trail_paths by its slot: port and
    reference frames agree with each other, and count fewer trails than
    the slot oracle; with each key's last draw kept, all three agree."""
    arrs = D.make_social_arrays(2000, 8)
    key = arrs["src"] * arrs["n"] + arrs["dst"]
    assert np.unique(key).size < key.size        # parallel edges
    seeds = np.unique(arrs["src"][:64])[:16].tolist()
    carried, got, want = _trail_graph(arrs, seeds, 3)
    n = _trails_both(got, want, seeds)
    assert n < D.host_trail_paths(carried, seeds, 3)
    uniq = D.unique_keys(arrs)
    carried, got, want = _trail_graph(uniq, seeds, 3)
    assert _trails_both(got, want, seeds) \
        == D.host_trail_paths(carried, seeds, 3)


# ---------------------------------------------------------------------------
# GO's Edge rows: traverse without yields
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("filt", ["none", "w_gt_50"])
@pytest.mark.parametrize("direction", ["out", "in"])
def test_edge_rows_match_reference(graph, direction, filt):
    want, wst = graph["ref_rts"]["unsplit"].traverse(
        graph["ref_store"], "snb", graph["seeds"], ["KNOWS"], direction, 2,
        edge_filter=_filt(filt, RE))
    rows, st = graph["rts"]["unsplit"].traverse(
        graph["store"], "snb", graph["seeds"], ["KNOWS"], direction, 2,
        edge_filter=_filt(filt, PE))
    assert len(rows) == len(want) == st.result_edges > 0
    # equal IN ORDER, each (src_vid, Edge, dst_vid) with its props
    assert [repr(r) for r in rows] == [repr(r) for r in want]
    assert st.hop_edges == wst.hop_edges


def test_edge_rows_through_writes_match_reference(delta_cfg):
    ref_st, twin = _store(2, 71), _store(2, 71)
    ref_rt = TpuRuntime(make_mesh(1))
    ref_rt.pin(ref_st, "g")
    port_rt = _port_pin(twin)
    port_st = _PortStore(twin)
    for w in (_Writer(ref_st), _Writer(twin)):
        w.group("inserts")
        w.group("deletes")
    want, _ = ref_rt.traverse(ref_st, "g", SEEDS, ["knows"], "out", 1)
    rows, _ = port_rt.traverse(port_st, "g", SEEDS, ["knows"], "out", 1)
    assert [repr(r) for r in rows] == [repr(r) for r in want]
    assert any(r[1].ranking >= 50 for r in rows)   # the inserted rows


# ---------------------------------------------------------------------------
# temporal and geography props: GO yields, Edge rows, MATCH frames and a
# WHERE over two temporal columns, decoded as the reference decodes them
# ---------------------------------------------------------------------------

_INT_NULL = np.iinfo(np.int64).min


def _dated_columns(n, pool):
    """The `dated` fixture's prop columns over n edge slots: int64 words
    as the snapshot stores them, every 50th slot of each NULL."""
    i = np.arange(n, dtype=np.int64)
    wkts = [f"POINT({(k * 37) % 360 - 180} {(k * 11) % 180 - 90}.25)"
            for k in range(20)]
    codes = np.asarray([pool.encode(w) for w in wkts], np.int64)
    cols = {
        # DATE: days since the epoch, 1968-1971
        "d": (i % 800) - 400,
        "d2": (i * 7) % 800 - 400,
        # DATETIME: epoch microseconds, about 1969-1971, microseconds set
        "t": (i - n // 2) * 86_400_000_123 + (i * 7919) % 1_000_000,
        # TIME: microseconds of the day
        "tm": (i * 7_777_777_777) % 86_400_000_000,
        "g": codes[i % len(codes)],
        # DURATION: the reference decodes its raw word
        "du": i * 1000 - 5000,
    }
    types = {"d": RefPropType.DATE, "d2": RefPropType.DATE,
             "t": RefPropType.DATETIME, "tm": RefPropType.TIME,
             "g": RefPropType.GEOGRAPHY, "du": RefPropType.DURATION}
    for k, (name, c) in enumerate(cols.items()):
        c[(i + k) % 50 == 0] = _INT_NULL
    return cols, types


@pytest.fixture(scope="module")
def dated():
    """make_social_arrays(300, 4), P = 4, with DATE columns `d` and `d2`,
    a DATETIME `t`, a TIME `tm`, a GEOGRAPHY `g` (pool codes of 20 point
    WKTs) and a DURATION `du` added to the reference snapshot's blocks
    before it is carried; values on both sides of 1970, NULLs among
    them."""
    arrs = ref_datagen.make_social_arrays(300, 4)
    ref_snap = ref_datagen.snapshot_from_arrays(arrs, parts=4)
    for b in ref_snap.blocks.values():
        cols, types = _dated_columns(b.nbr.size, ref_snap.pool)
        for name, c in cols.items():
            b.props[name] = c.reshape(b.nbr.shape)
            b.prop_types[name] = types[name]
    carried = snapshot_from_fields(_fields(ref_snap))
    rt = GpuRuntime(device="cpu")
    rt.pin_prebuilt(carried)
    return dict(ref_rt=_ref_rt(ref_snap),
                ref_store=ref_datagen.SnapshotStore(ref_snap), rt=rt,
                store=D.SnapshotStore(carried),
                seeds=np.unique(arrs["src"][:32])[:8].tolist())


def _dated_kinds(values):
    return {type(v).__name__ for v in values}


def test_match_frames_refuse_a_date_prop(dated):
    """Once a refusal (divergence 9); now the frames over the temporal,
    geography and duration props equal the reference's, in order, and
    their Edges equal the reference's carried into the port."""
    want, wst = dated["ref_rt"].traverse_hops(
        dated["ref_store"], "snb", dated["seeds"], ["KNOWS"], "out", 2)
    got, st = dated["rt"].traverse_hops(dated["store"], "snb",
                                        dated["seeds"], ["KNOWS"], "out", 2)
    _assert_frames_equal(got, want, "dated")
    for a, b in zip(want, got):
        assert list(b.edges) == to_port(list(a.edges))
    assert st.hop_edges == wst.hop_edges
    edges = [e for f in want for e in f.edges]
    assert _dated_kinds(e.props["d"] for e in edges) == {"Date",
                                                        "NullValue"}
    assert _dated_kinds(e.props["g"] for e in edges) == {"Geography",
                                                        "NullValue"}
    assert any(e.props["t"].year < 1970 for e in edges
               if type(e.props["t"]).__name__ == "DateTime")


_DATED_YIELDS = {
    "edge rows": None,
    "date yield": ["d"],
    "temporal yields": ["d", "t", "tm", "g"],
    "duration yield": ["du", "d2"],
}


def _dated_yields(names, M):
    return None if names is None else [(M.EdgeProp("KNOWS", n), n)
                                       for n in names]


def _dated_rows_equal(got, want, names):
    assert len(got) == len(want) > 0
    if names is None:
        assert [repr(r) for r in got] == [repr(r) for r in want]
        assert [list(r) for r in got] == to_port([list(r) for r in want])
        return
    assert got.column_names == want.column_names == names
    for n in names:
        a, b = want.column(n), got.column(n)
        assert [repr(x) for x in b] == [repr(x) for x in a], n
        assert b == to_port(a), n


@pytest.mark.parametrize("yields", sorted(_DATED_YIELDS))
def test_go_refuses_a_date_prop(dated, yields):
    """Once a refusal (divergence 9); now GO's Edge rows and its YIELD
    of DATE, DATETIME, TIME, GEOGRAPHY and DURATION columns equal the
    reference's, in order."""
    names = _DATED_YIELDS[yields]
    want, wst = dated["ref_rt"].traverse(
        dated["ref_store"], "snb", dated["seeds"], ["KNOWS"], "out", 2,
        yields=_dated_yields(names, RE))
    got, st = dated["rt"].traverse(
        dated["store"], "snb", dated["seeds"], ["KNOWS"], "out", 2,
        yields=_dated_yields(names, PE))
    _dated_rows_equal(got, want, names)
    assert st.hop_edges == wst.hop_edges


_DATED_WHERE = {
    "d < d2": lambda M: M.Binary("<", M.EdgeProp("KNOWS", "d"),
                                 M.EdgeProp("KNOWS", "d2")),
    "d2 >= d": lambda M: M.Binary(">=", M.EdgeProp("KNOWS", "d2"),
                                  M.EdgeProp("KNOWS", "d")),
    "t > t or tm == tm": lambda M: M.Binary(
        "OR", M.Binary(">", M.EdgeProp("KNOWS", "t"),
                       M.EdgeProp("KNOWS", "t")),
        M.Binary("==", M.EdgeProp("KNOWS", "tm"),
                 M.EdgeProp("KNOWS", "tm"))),
    "g == g and d2 > d": lambda M: M.Binary(
        "AND", M.Binary("==", M.EdgeProp("KNOWS", "g"),
                        M.EdgeProp("KNOWS", "g")),
        M.Binary(">", M.EdgeProp("KNOWS", "d2"),
                 M.EdgeProp("KNOWS", "d"))),
}


@pytest.mark.parametrize("where", sorted(_DATED_WHERE))
def test_temporal_where_matches_reference(dated, where):
    """A WHERE over two temporal columns of one kind (the predicate
    program compares their words) keeps the reference's rows in GO and
    its edges in every MATCH frame."""
    names = ["d", "t", "tm", "g"]
    want, wst = dated["ref_rt"].traverse(
        dated["ref_store"], "snb", dated["seeds"], ["KNOWS"], "out", 2,
        edge_filter=_DATED_WHERE[where](RE), yields=_dated_yields(names, RE))
    got, st = dated["rt"].traverse(
        dated["store"], "snb", dated["seeds"], ["KNOWS"], "out", 2,
        edge_filter=_DATED_WHERE[where](PE), yields=_dated_yields(names, PE))
    _dated_rows_equal(got, want, names)
    assert st.hop_edges == wst.hop_edges
    fw, _ = dated["ref_rt"].traverse_hops(
        dated["ref_store"], "snb", dated["seeds"], ["KNOWS"], "out", 2,
        edge_filter=_DATED_WHERE[where](RE))
    fg, _ = dated["rt"].traverse_hops(
        dated["store"], "snb", dated["seeds"], ["KNOWS"], "out", 2,
        edge_filter=_DATED_WHERE[where](PE))
    _assert_frames_equal(fg, fw, where)


# ---------------------------------------------------------------------------
# batching: concurrent MATCH expansions share one run
# ---------------------------------------------------------------------------

STMT_SEEDS = [[0, 1], [2, 3], [4, 5], [6, 7]]


def _match(rt, store, seeds, filt):
    return lambda: rt.traverse_hops(store, "snb", seeds, ["KNOWS"], "out", 3,
                                    edge_filter=_filt(filt, PE))


@pytest.mark.parametrize("layout,filt", [("unsplit", "none"),
                                         ("split", "w_gt_50")])
def test_batched_match_equals_solo(graph, clean, company, layout, filt):
    rt, store = graph["rts"][layout], graph["store"]
    sets = [[graph["seeds"][i] for i in s] for s in STMT_SEEDS]
    truth = [_match(rt, store, s, filt)() for s in sets]
    _batching(len(sets), 2_000_000)
    formed, runs = _counter("tpu_batches_formed"), _counter("tpu_kernel_runs")
    out, errs = _threads([_match(rt, store, s, filt) for s in sets])
    assert not errs, errs
    assert _counter("tpu_batches_formed") == formed + 1
    assert _counter("tpu_kernel_runs") == runs + 1
    for i in range(len(sets)):
        frames, st = out[i]
        t_frames, t_st = truth[i]
        _assert_frames_equal(frames, t_frames, f"statement {i}")
        assert st.hop_edges == t_st.hop_edges
        assert st.frontier_sizes == t_st.frontier_sizes
        assert st.result_edges == t_st.result_edges


def test_go_and_match_never_share_a_run(graph, clean, company):
    rt, store = graph["rts"]["unsplit"], graph["store"]
    sets = [[graph["seeds"][i] for i in s] for s in STMT_SEEDS[:2]]
    ys = [(PE.FunctionCall("dst", [PE.EdgeExpr()]), "d")]

    def go(s):
        return lambda: rt.traverse(store, "snb", s, ["KNOWS"], "out", 3,
                                   yields=ys)

    t_match = [_match(rt, store, s, "none")() for s in sets]
    t_go = [go(s)() for s in sets]
    # four lanes allowed: the two kinds could fill one group, if they
    # shared a key; each kind forms its own two-lane group instead
    _batching(4, 1_000_000)
    formed, runs = _counter("tpu_batches_formed"), _counter("tpu_kernel_runs")
    out, errs = _threads([_match(rt, store, s, "none") for s in sets]
                         + [go(s) for s in sets])
    assert not errs, errs
    assert _counter("tpu_batches_formed") == formed + 2
    assert _counter("tpu_kernel_runs") == runs + 2
    for i in range(2):
        _assert_frames_equal(out[i][0], t_match[i][0], f"match {i}")
        rows, want = out[2 + i][0], t_go[i][0]
        np.testing.assert_array_equal(np.asarray(rows.column_array("d")),
                                      np.asarray(want.column_array("d")))


# ---------------------------------------------------------------------------
# the copied numpy helpers against the reference's
# ---------------------------------------------------------------------------


def _frame_pair(rng, n, n_src):
    """The same random frame in both packages (no decode segments), over
    n_src vertices, ranks 0-1 and edge types 1-2."""
    src = rng.integers(0, n_src, n).astype(np.int64)
    dst = rng.integers(0, n_src, n).astype(np.int64)
    rank = rng.integers(0, 2, n).astype(np.int64)
    et = rng.integers(1, 3, n).astype(np.int64)
    cols = (src, dst, rank, et, src.copy(), dst.copy())
    return (ref_runtime.HopFrame.build(*cols, [], None),
            HopFrame.build(*[c.copy() for c in cols], [], None))


CASES = ["random", "empty_frame", "all_miss", "empty_last"]


@pytest.mark.parametrize("case", CASES)
def test_join_and_distinct_match_reference(case):
    """Three hops over one small random frame (so trails come back to
    edges they used), then the edge cases: an empty frame (joining a
    non-empty frontier against it raises in both packages, which is why
    every caller stops at an empty frame), a frontier that hits no src,
    an empty frontier."""
    rng = np.random.default_rng(CASES.index(case))
    frames = [_frame_pair(rng, 60, 8)] * 3
    if case == "empty_frame":
        frames[1] = (ref_runtime.HopFrame.empty(), HopFrame.empty())
    frames_r = [f[0] for f in frames]
    frames_p = [f[1] for f in frames]
    last = np.arange(8, dtype=np.int64)
    if case == "all_miss":
        last = last + 1000
    if case == "empty_last":
        last = last[:0]
    path_r, path_p = [], []
    rejected = 0
    for fr, fp in zip(frames_r, frames_p):
        assert fp.n == fr.n
        for a, b in zip(fr.src_slices(), fp.src_slices()):
            np.testing.assert_array_equal(a, b)
        if fp.n == 0:
            for join, f in ((ref_runtime.join_frontier_trails, fr),
                            (join_frontier_trails, fp)):
                with pytest.raises(IndexError):
                    join(f, last)
            break
        pr, ir = ref_runtime.join_frontier_trails(fr, last)
        pp, ip = join_frontier_trails(fp, last)
        np.testing.assert_array_equal(pr, pp)
        np.testing.assert_array_equal(ir, ip)
        kr = ref_runtime.trail_distinct_keep(frames_r, path_r, pr, fr, ir)
        kp = trail_distinct_keep(frames_p, path_p, pp, fp, ip)
        np.testing.assert_array_equal(kr, kp)
        rejected += int((~kp).sum())
        pp, ip = pp[kp], ip[kp]
        path_r = [pe[pp] for pe in path_r] + [ip]
        path_p = [pe[pp] for pe in path_p] + [ip]
        last = fp.dst[ip]
        for v in (0, 7, 1000):
            np.testing.assert_array_equal(np.asarray(fr.out_edges(v)),
                                          np.asarray(fp.out_edges(v)))
    if case == "random":
        assert rejected > 0 and path_p[-1].size > 0
    if case in ("all_miss", "empty_last"):
        assert all(pe.size == 0 for pe in path_p)


def test_hop_frame_decodes_each_entry_once():
    """decode() runs the segment decoder only for entries not yet
    decoded; `.edges` decodes the rest, once, as the reference's."""
    calls = {"ref": [], "port": []}

    def dec(tag):
        def decode_seg(payload, offs):
            calls[tag].append(offs.tolist())
            return [f"e{payload + int(o)}" for o in offs]
        return decode_seg

    src = np.array([3, 1, 3, 2, 1], np.int64)
    dst = np.array([4, 5, 6, 7, 8], np.int64)
    z = np.zeros(5, np.int64)
    segs = [(0, 2, 0), (2, 5, 100)]
    fr = ref_runtime.HopFrame.build(src, dst, z, z, src, dst, segs,
                                    dec("ref"))
    fp = HopFrame.build(src, dst, z, z, src, dst, segs, dec("port"))
    for f in (fr, fp):
        assert list(f.decode(np.array([4, 0, 4]))) == ["e102", "e0", "e102"]
        assert list(f.edges) == ["e0", "e1", "e100", "e101", "e102"]
        assert list(f.edges) == ["e0", "e1", "e100", "e101", "e102"]
    assert calls["ref"] == calls["port"] == [[0], [2], [1], [0, 1]]
    e_r, e_p = ref_runtime.HopFrame.empty(), HopFrame.empty()
    assert e_r.n == e_p.n == 0 and list(e_p.edges) == []
    assert HopFrame.build(np.empty(0, np.int64), *[None] * 5, [],
                          None).n == 0
