"""`GpuRuntime.pin(store, space)` building from the port's own
`GraphStore`, against the reference `TpuRuntime` pinning a twin
reference `GraphStore`, on the CPU.

Twin stores are built from one seed by one script, one in each package.
The reference runtime is `TpuRuntime(make_mesh(1))` (local mode, its
flags set as the port runtime's constructor arguments are); the port's
is `GpuRuntime(device="cpu")`.  These are the store-built twins of
tests/unit/test_tpu.py's pin, GO, BFS, degree-split, string-vid,
non-identity-vid and shared-runtime tests: GO rows (compared in order,
value by value), `TraverseStats.hop_edges` and `frontier_sizes`, and
BFS depths must equal the reference's.  Then the rebuild: wherever the
reference's `_try_delta_update` gives up (an overflow, a broken log, a
log gap, a write to a degree-split pin) the port rebuilds and re-pins
with the reference's rows; a plane past the compaction watermark is
compacted on a thread (joined here) into a snapshot with the same rows;
a failing compaction leaves the old snapshot serving; and the bench's
`SnapshotStore` stand-in, which cannot be exported, still raises
`GpuUnavailable` naming the cause and never compacts.  Tolerance: exact.
"""
import random
import types

import numpy as np
import pytest

import nebula_tpu.core.value as ref_value
import nebula_tpu.graphstore.schema as ref_schema
import nebula_tpu.graphstore.store as ref_store
from nebula_tpu.tpu import TpuRuntime, make_mesh
from nebula_tpu.utils.config import get_config

import nebula_tpu_torch.core.value as port_value
import nebula_tpu_torch.graphstore.schema as port_schema
import nebula_tpu_torch.graphstore.store as port_store
from nebula_tpu_torch.bench import datagen as D
from nebula_tpu_torch.gpu import GpuRuntime, GpuUnavailable
from nebula_tpu_torch.gpu import runtime as port_runtime
from nebula_tpu_torch.graphstore.csr import build_snapshot, \
    expand_frontier_host
from nebula_tpu_torch.utils.stats import stats as port_stats

from test_torch_value import same_value

P = 8
DCAP = 64


def _ns(value, schema, store):
    return types.SimpleNamespace(
        GraphStore=store.GraphStore, PropDef=schema.PropDef,
        PropType=schema.PropType, NULL=value.NULL)


REF = _ns(ref_value, ref_schema, ref_store)
PORT = _ns(port_value, port_schema, port_store)


def random_store(M, seed=0, n=120, avg_deg=5, spacename="g",
                 extra_edge_type=False, parts=P):
    """tests/unit/test_tpu.py:random_store, in either package."""
    rng = random.Random(seed)
    st = M.GraphStore()
    st.create_space(spacename, partition_num=parts, vid_type="INT64")
    st.catalog.create_tag(spacename, "person", [
        M.PropDef("age", M.PropType.INT64),
        M.PropDef("name", M.PropType.STRING)])
    st.catalog.create_edge(spacename, "knows", [
        M.PropDef("w", M.PropType.INT64), M.PropDef("f", M.PropType.DOUBLE),
        M.PropDef("tag", M.PropType.STRING)])
    if extra_edge_type:
        st.catalog.create_edge(spacename, "likes", [
            M.PropDef("w", M.PropType.INT64)])
    names = ["ann", "bob", "cid", "dee"]
    for v in range(n):
        st.insert_vertex(spacename, v, "person",
                         {"age": rng.randint(0, 80),
                          "name": rng.choice(names)})
    for v in range(n):
        for _ in range(rng.randint(0, avg_deg * 2)):
            d = rng.randrange(n)
            props = {"w": rng.randint(-5, 100) if rng.random() > .1
                     else M.NULL,
                     "f": rng.uniform(0, 1), "tag": rng.choice(names)}
            st.insert_edge(spacename, v, "knows", d, rng.randint(0, 2),
                           props)
        if extra_edge_type and rng.random() > .5:
            st.insert_edge(spacename, v, "likes", rng.randrange(n), 0,
                           {"w": rng.randint(0, 10)})
    return st


def twins(*a, **kw):
    return random_store(REF, *a, **kw), random_store(PORT, *a, **kw)


def hubby(M, seed=2, n=120, extra=60):
    st = random_store(M, seed, n=n, avg_deg=5)
    rng = random.Random(9)
    for _ in range(extra):
        st.insert_edge("g", 7, "knows", rng.randrange(n), rng.randint(0, 2),
                       {"w": rng.randint(0, 99), "f": 0.5, "tag": "ann"})
    return st


@pytest.fixture()
def ref_flags():
    """Set the reference runtime's flags for one test; every flag is
    restored afterwards."""
    cfg = get_config()
    touched = set()

    def set_(**kw):
        touched.update(kw)
        cfg.set_dynamic_many(kw)

    yield set_
    with cfg.lock:
        for k in touched:
            cfg.dynamic_layer.pop(k, None)


def ref_runtime():
    rt = TpuRuntime(make_mesh(1))
    rt.init_eb = 1 << 12
    return rt


def assert_rows_equal(got, want, tag=""):
    assert len(got) == len(want), (tag, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (tag, i)
        for a, b in zip(g, w):
            assert same_value(a, b), (tag, i, g, w)


def text_rows(rows):
    return [tuple(port_value.value_to_string(x) for x in r) for r in rows]


def go_both(ref_rt, ref_st, rt, st, vids, etypes, direction, steps,
            tag="", space="g"):
    want, ws = ref_rt.traverse(ref_st, space, vids, etypes, direction, steps)
    got, gs = rt.traverse(st, space, vids, etypes, direction, steps)
    assert_rows_equal(got, want, tag)
    assert gs.hop_edges == ws.hop_edges, tag
    assert gs.frontier_sizes == ws.frontier_sizes, tag
    return got


def counter(name):
    return port_stats().snapshot().get(name, 0)


# ---------------------------------------------------------------------------
# the store-built twins of tests/unit/test_tpu.py
# ---------------------------------------------------------------------------


def test_pin_and_hbm():
    _, st = twins(1)
    rt = GpuRuntime(device="cpu")
    pins = counter("tpu_pins")
    dev = rt.pin(st, "g")
    assert dev.num_parts == P
    assert dev.hbm_bytes() > 0 and rt.hbm_bytes() == dev.hbm_bytes()
    assert counter("tpu_pins") == pins + 1
    # same epoch → cached object
    assert rt.pin(st, "g") is dev
    # write bumps epoch → re-pin (no plane armed)
    st.insert_edge("g", 0, "knows", 1, 9, {"w": 1, "f": .5, "tag": "x"})
    dev2 = rt.pin(st, "g")
    assert dev2 is not dev and dev2.epoch != dev.epoch and dev.retired
    assert counter("tpu_pins") == pins + 2
    # force re-pins at the same epoch
    dev3 = rt.pin(st, "g", force=True)
    assert dev3 is not dev2 and dev3.epoch == dev2.epoch


@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("direction", ["out", "in", "both"])
def test_traverse_matches_reference(steps, direction):
    ref_st, st = twins(2)
    rows = go_both(ref_runtime(), ref_st, GpuRuntime(device="cpu"), st,
                   [3, 17, 44], ["knows"], direction, steps)
    assert rows


def test_traverse_multi_etype():
    ref_st, st = twins(3, extra_edge_type=True)
    go_both(ref_runtime(), ref_st, GpuRuntime(device="cpu"), st,
            [1, 2, 3], ["knows", "likes"], "out", 2)


@pytest.mark.parametrize("direction", ["out", "both"])
def test_traverse_hops_on_a_store_never_pinned(direction):
    """MATCH's device half pins on first use too: frames equal the
    reference's, hop by hop."""
    ref_st, st = twins(5)
    want, ws = ref_runtime().traverse_hops(ref_st, "g", [3, 17, 44],
                                           ["knows"], direction, 3)
    rt = GpuRuntime(device="cpu")
    assert "g" not in rt.snapshots
    got, gs = rt.traverse_hops(st, "g", [3, 17, 44], ["knows"], direction,
                               3)
    assert len(got) == len(want) and all(f.n > 0 for f in got)
    for h, (a, b) in enumerate(zip(want, got)):
        assert a.n == b.n, h
        for k in ("src", "dst", "rank", "key_et", "key_s", "key_d"):
            np.testing.assert_array_equal(np.asarray(getattr(a, k),
                                                     np.int64),
                                          getattr(b, k), err_msg=f"{h} {k}")
        assert [ref_value.value_to_string(e) for e in a.edges] == \
            [port_value.value_to_string(e) for e in b.edges], h
    assert gs.hop_edges == ws.hop_edges


def test_frontier_oracle():
    """One-hop expansion of the port's own export == the sources of the
    device GO's second hop."""
    _, st = twins(4)
    snap = build_snapshot(st, "g")
    blk = snap.block("knows", "out")
    sd = st.space("g")
    dense = [sd.dense_id(v) for v in [5, 9]]
    want = expand_frontier_host(snap, blk, np.asarray(dense, np.int32))
    rows, _ = GpuRuntime(device="cpu").traverse(st, "g", [5, 9], ["knows"],
                                                "out", 2)
    springs = sorted({sd.dense_id(e.src) for (_, e, _) in rows})
    assert springs and set(springs) <= set(int(x) for x in want)


def test_write_invalidates_snapshot():
    ref_st, st = twins(9)
    ref_rt, rt = ref_runtime(), GpuRuntime(device="cpu")
    rows1 = go_both(ref_rt, ref_st, rt, st, [3], ["knows"], "out", 1)
    for s in (ref_st, st):
        s.insert_edge("g", 3, "knows", 99, 7, {"w": 50, "f": .1,
                                               "tag": "zz"})
    rows2 = go_both(ref_rt, ref_st, rt, st, [3], ["knows"], "out", 1)
    assert len(rows2) == len(rows1) + 1


def test_single_chip_local_mode():
    ref_st, st = twins(11)
    rt = GpuRuntime(device="cpu")
    assert rt.local_mode
    go_both(ref_runtime(), ref_st, rt, st, [3, 17, 44], ["knows"], "out", 3)


def test_direction_optimizing_bfs_parity_local():
    """The store-built pin's BFS: depths and per-level hop_edges equal
    the reference's, and `datagen.host_bfs` over the port's export."""
    ref_st, st = twins(21, n=400, avg_deg=6)
    ref_rt, rt = ref_runtime(), GpuRuntime(device="cpu")
    snap = build_snapshot(st, "g")
    sd = st.space("g")
    for srcs in ([1], [2, 3, 5], list(range(40))):
        want, ws = ref_rt.bfs(ref_st, "g", srcs, ["knows"], "out", 6)
        got, gs = rt.bfs(st, "g", srcs, ["knows"], "out", 6)
        np.testing.assert_array_equal(got, np.asarray(want, np.int32))
        assert gs.hop_edges == ws.hop_edges
        host = D.host_bfs(snap, [sd.dense_id(v) for v in srcs], 6,
                          etype="knows")
        vv = np.arange(host.shape[0])
        np.testing.assert_array_equal(got[vv % P, vv // P], host)


def test_non_identity_vid_decode():
    """Vids that are not the dense ids decode through the d2v gather."""
    pair = []
    for M in (REF, PORT):
        rng = random.Random(5)
        st = M.GraphStore()
        st.create_space("nid", partition_num=P, vid_type="INT64")
        st.catalog.create_tag("nid", "person",
                              [M.PropDef("age", M.PropType.INT64)])
        st.catalog.create_edge("nid", "knows",
                               [M.PropDef("w", M.PropType.INT64)])
        vids = [v * 13 + 1001 for v in range(80)]
        rng.shuffle(vids)
        for v in vids:
            st.insert_vertex("nid", v, "person", {"age": v % 90})
        for v in vids:
            for _ in range(rng.randint(0, 6)):
                st.insert_edge("nid", v, "knows", rng.choice(vids),
                               rng.randint(0, 2), {"w": rng.randint(0, 99)})
        pair.append(st)
    rt = GpuRuntime(device="cpu")
    port_runtime._d2v(rt.pin(pair[1], "nid").host)
    assert not rt.snapshots["nid"].host._d2v_identity
    rows = go_both(ref_runtime(), pair[0], rt, pair[1], vids[:3], ["knows"],
                   "out", 2, space="nid")
    vidset = set(vids)
    assert rows and all(sv in vidset and dv in vidset
                        for (sv, _e, dv) in rows)


def test_shared_runtime_two_stores_no_cache_collision():
    """One runtime, two port stores whose same-named spaces share an
    epoch value: the uid guard serves each store its own graph."""
    pairs = [twins(seed) for seed in (21, 22)]
    ref_rt, rt = ref_runtime(), GpuRuntime(device="cpu")
    wants = [go_both(ref_rt, r, rt, p, [3, 17], ["knows"], "out", 2)
             for r, p in pairs]
    assert text_rows(wants[0]) != text_rows(wants[1])     # distinct graphs
    pairs[1][1].space("g").epoch = pairs[0][1].space("g").epoch
    pairs[1][0].space("g").epoch = pairs[0][0].space("g").epoch
    go_both(ref_rt, pairs[0][0], rt, pairs[0][1], [3, 17], ["knows"],
            "out", 2)
    got = go_both(ref_rt, pairs[1][0], rt, pairs[1][1], [3, 17], ["knows"],
                  "out", 2)
    assert text_rows(got) == text_rows(wants[1])


def test_degree_split_device_parity(ref_flags):
    ref_flags(tpu_degree_split_threshold=8)
    ref_st, st = hubby(REF), hubby(PORT)
    ref_rt, rt = ref_runtime(), GpuRuntime(device="cpu",
                                           degree_split_threshold=8)
    dev = rt.pin(st, "g", force=True)
    assert dev.num_hubs > 0
    for steps, direction in ((1, "out"), (2, "in"), (3, "both")):
        go_both(ref_rt, ref_st, rt, st, [3, 7, 44], ["knows"], direction,
                steps, tag=f"{steps} {direction}")
    want, _ = ref_rt.bfs(ref_st, "g", [7], ["knows"], "out", 4)
    got, _ = rt.bfs(st, "g", [7], ["knows"], "out", 4)
    np.testing.assert_array_equal(got, np.asarray(want, np.int32))


def test_degree_split_string_vids(ref_flags):
    ref_flags(tpu_degree_split_threshold=4)
    pair = []
    for M in (REF, PORT):
        st = M.GraphStore()
        st.create_space("svh", partition_num=P, vid_type="FIXED_STRING(16)")
        st.catalog.create_tag("svh", "person",
                              [M.PropDef("name", M.PropType.STRING)])
        st.catalog.create_edge("svh", "knows",
                               [M.PropDef("w", M.PropType.INT64)])
        rng = random.Random(3)
        vids = [f"v{i:03d}" for i in range(60)]
        for v in vids:
            st.insert_vertex("svh", v, "person", {"name": v})
        for v in vids:
            for _ in range(rng.randint(1, 4)):
                st.insert_edge("svh", v, "knows", rng.choice(vids), 0,
                               {"w": rng.randint(0, 9)})
        for i in range(25):
            st.insert_edge("svh", "v000", "knows", rng.choice(vids), i,
                           {"w": 1})
        pair.append(st)
    rt = GpuRuntime(device="cpu", degree_split_threshold=4)
    assert rt.pin(pair[1], "svh").num_hubs > 0
    rows = go_both(ref_runtime(), pair[0], rt, pair[1], ["v000", "v005"],
                   ["knows"], "out", 2, space="svh")
    assert rows and all(isinstance(s, str) and isinstance(d, str)
                        for (s, _e, d) in rows)


# ---------------------------------------------------------------------------
# the delta plane on a store pin: the fold, the rebuilds, compaction
# ---------------------------------------------------------------------------


def _write(st, M, i0, n, src=1, spread=3):
    """n edge inserts from `spread` sources starting at `src`."""
    for i in range(i0, i0 + n):
        st.insert_edge("g", src + i % spread, "knows", (7 * i + 2) % 120,
                       50 + i, {"w": 1000 + i, "f": .5, "tag": "zz"})


def _delta_pair(ref_flags, dcap=DCAP, wm=2.0, **kw):
    ref_flags(tpu_delta_max_edges=dcap, tpu_delta_compact_watermark=wm,
              tpu_delta_vmax_slack=64)
    ref_st, st = twins(17, **kw)
    ref_rt = ref_runtime()
    rt = GpuRuntime(device="cpu", delta_max_edges=dcap,
                    delta_compact_watermark=wm)
    assert ref_rt.pin(ref_st, "g").delta is not None
    assert rt.pin(st, "g").delta is not None
    return ref_rt, ref_st, rt, st


def _edits(M, s):
    """Inserts, a delete and an overwrite of `w`."""
    _write(s, M, 0, 10)
    r = next(iter(s.get_neighbors("g", [4], ["knows"])))
    s.delete_edge("g", 4, "knows", r[3], r[2])
    r = next(iter(s.get_neighbors("g", [9], ["knows"])))
    s.insert_edge("g", 9, "knows", r[3], r[2], {**r[4], "w": 7})


def test_writes_fold_into_the_plane(ref_flags):
    ref_rt, ref_st, rt, st = _delta_pair(ref_flags)
    dev = rt.snapshots["g"]
    pins, avoided = counter("tpu_pins"), counter("tpu_repin_avoided")
    for M, s in ((REF, ref_st), (PORT, st)):
        _edits(M, s)
    for direction in ("out", "in"):
        go_both(ref_rt, ref_st, rt, st, [1, 4, 9], ["knows"], direction, 2)
    assert rt.snapshots["g"] is dev and dev.delta.host.total_edges() > 0
    assert dev.delta.host.total_tombs() > 0
    assert counter("tpu_pins") == pins
    assert counter("tpu_repin_avoided") == avoided + 1
    assert port_stats().snapshot()["tpu_delta_edges"] > 0
    want, _ = ref_rt.bfs(ref_st, "g", [1], ["knows"], "out", 5)
    got, _ = rt.bfs(st, "g", [1], ["knows"], "out", 5)
    np.testing.assert_array_equal(got, np.asarray(want, np.int32))


def test_vertex_insert_into_the_slack_keeps_the_rebuild_order(ref_flags):
    """A vertex inserted after the pin lands in the vmax slack and leaves
    unassigned dense ids (None) in the snapshot's dense-to-vid array.
    The port's rows keep a fresh pin's order (int vids sort as ints, as
    the export sorts them); the reference's sort them as strings there,
    so its rows equal the port's as a multiset, not in order."""
    ref_rt, ref_st, rt, st = _delta_pair(ref_flags)
    for M, s in ((REF, ref_st), (PORT, st)):
        _edits(M, s)
        s.insert_vertex("g", 500, "person", {"age": 1, "name": "new"})
        s.insert_edge("g", 1, "knows", 500, 0, {"w": 1, "f": .1,
                                                "tag": "n"})
    vids = [1, 4, 9]
    want, ws = ref_rt.traverse(ref_st, "g", vids, ["knows"], "out", 2)
    got, gs = rt.traverse(st, "g", vids, ["knows"], "out", 2)
    fresh, _ = GpuRuntime(device="cpu").traverse(st, "g", vids, ["knows"],
                                                 "out", 2)
    assert text_rows(got) == text_rows(fresh)
    assert rt.snapshots["g"].delta.host.total_edges() > 0
    assert sorted(text_rows(got)) == sorted(
        tuple(ref_value.value_to_string(x) for x in r) for r in want)
    assert gs.hop_edges == ws.hop_edges
    assert gs.frontier_sizes == ws.frontier_sizes
    dist, _ = rt.bfs(st, "g", [1], ["knows"], "out", 3)
    d = st.space("g").dense_id(500)
    assert dist[d % P, d // P] == 1


def test_overflow_rebuilds_and_repins(ref_flags):
    ref_rt, ref_st, rt, st = _delta_pair(ref_flags, dcap=4)
    dev = rt.snapshots["g"]
    pins = counter("tpu_pins")
    for M, s in ((REF, ref_st), (PORT, st)):
        _write(s, M, 0, 12, spread=1)     # 12 rows over a 4-row plane
    go_both(ref_rt, ref_st, rt, st, [1, 2, 3], ["knows"], "out", 2)
    new = rt.snapshots["g"]
    assert new is not dev and dev.retired and counter("tpu_pins") == pins + 1
    assert new.delta is not None and new.delta.host.total_edges() == 0
    fresh = GpuRuntime(device="cpu")
    assert text_rows(rt.traverse(st, "g", [1, 2, 3], ["knows"], "out",
                                 2)[0]) == \
        text_rows(fresh.traverse(st, "g", [1, 2, 3], ["knows"], "out", 2)[0])


def test_broken_log_and_log_gap_rebuild(ref_flags):
    ref_rt, ref_st, rt, st = _delta_pair(ref_flags)
    pairs = ((REF, ref_st), (PORT, st))
    # a log broken by REPARTITION: the dense layout changed
    for M, s in pairs:
        s.repartition("g", 4)
    pins = counter("tpu_pins")
    go_both(ref_rt, ref_st, rt, st, [1, 2, 3], ["knows"], "out", 2)
    assert rt.snapshots["g"].num_parts == 4
    assert counter("tpu_pins") == pins + 1
    # a log broken by its key cap
    for M, s in pairs:
        s.space("g").delta_log.cap = 2
        _write(s, M, 0, 3)
    dev = rt.snapshots["g"]
    go_both(ref_rt, ref_st, rt, st, [1, 2, 3], ["knows"], "out", 2)
    assert rt.snapshots["g"] is not dev and counter("tpu_pins") == pins + 2
    # a gap: the log was lost and re-watched after more writes, so its
    # floor lies past the plane's epoch
    dev = rt.snapshots["g"]
    for M, s in pairs:
        _write(s, M, 10, 2)
        s.space("g").delta_log = None
        _write(s, M, 20, 2)
        s.delta_watch("g")
    go_both(ref_rt, ref_st, rt, st, [1, 2, 3], ["knows"], "out", 2)
    assert rt.snapshots["g"] is not dev and counter("tpu_pins") == pins + 3


def test_write_to_a_split_pin_rebuilds(ref_flags):
    ref_flags(tpu_degree_split_threshold=8, tpu_delta_max_edges=DCAP)
    ref_st, st = hubby(REF), hubby(PORT)
    ref_rt = ref_runtime()
    rt = GpuRuntime(device="cpu", degree_split_threshold=8,
                    delta_max_edges=DCAP)
    dev = rt.pin(st, "g")
    assert dev.num_hubs > 0 and dev.delta is None
    for M, s in ((REF, ref_st), (PORT, st)):
        _write(s, M, 0, 5, src=7)
    go_both(ref_rt, ref_st, rt, st, [3, 7, 44], ["knows"], "out", 2)
    assert rt.snapshots["g"] is not dev and rt.snapshots["g"].num_hubs > 0


def test_compaction_past_the_watermark(ref_flags):
    ref_rt, ref_st, rt, st = _delta_pair(ref_flags, wm=0.1)
    dev, ref_dev = rt.snapshots["g"], ref_rt.snapshots["g"]
    done = counter("tpu_compactions")
    for M, s in ((REF, ref_st), (PORT, st)):
        _write(s, M, 0, 20)
    # the pins apply the writes and start the compactions; a run racing a
    # swap would find its snapshot retired, so nothing runs until joined
    assert ref_rt.pin(ref_st, "g") is ref_dev and rt.pin(st, "g") is dev
    for d in (dev, ref_dev):
        t = getattr(d, "_compact_thread", None)
        assert t is not None
        t.join(timeout=60)
    assert counter("tpu_compactions") == done + 1
    new = rt.snapshots["g"]
    assert new is not dev and dev.retired
    assert new.delta is not None and new.delta.host.total_edges() == 0 \
        and new.delta.host.total_tombs() == 0
    go_both(ref_rt, ref_st, rt, st, [1, 2, 3], ["knows"], "out", 2)
    fresh = GpuRuntime(device="cpu")
    assert text_rows(rt.traverse(st, "g", [1, 2, 3], ["knows"], "out",
                                 2)[0]) == \
        text_rows(fresh.traverse(st, "g", [1, 2, 3], ["knows"], "out", 2)[0])


def test_failing_compaction_leaves_the_old_snapshot_serving(ref_flags,
                                                            monkeypatch):
    ref_rt, ref_st, rt, st = _delta_pair(ref_flags)
    rt.delta_compact_watermark = 0.1
    dev = rt.snapshots["g"]
    done = counter("tpu_compactions")

    def broken(*a, **kw):
        raise RuntimeError("export failed")

    monkeypatch.setattr(port_runtime, "build_snapshot", broken)
    for M, s in ((REF, ref_st), (PORT, st)):
        _write(s, M, 0, 20)
    assert rt.pin(st, "g") is dev
    dev._compact_thread.join(timeout=60)
    assert rt.snapshots["g"] is dev and not dev.retired
    assert not dev._compacting and counter("tpu_compactions") == done
    go_both(ref_rt, ref_st, rt, st, [1, 2, 3], ["knows"], "out", 2)


# ---------------------------------------------------------------------------
# the bench's stand-in cannot be exported
# ---------------------------------------------------------------------------


def _bench_store(dcap=16, cap=65536):
    arrs = D.make_social_arrays(300, 4, seed=3)
    snap = D.snapshot_from_arrays(arrs, parts=2, space="s")
    store = D.SnapshotStore(snap, arrs)
    store.delta_watch("s", cap=cap)
    rt = GpuRuntime(device="cpu", delta_max_edges=dcap,
                    delta_compact_watermark=0.01)
    rt.pin_prebuilt(snap)
    return store, rt


def test_snapshot_store_raises_where_the_reference_rebuilds():
    assert not GpuRuntime.exportable(D.SnapshotStore(
        D.snapshot_from_arrays(D.make_social_arrays(50, 2, seed=1),
                               parts=2, space="s")))
    assert GpuRuntime.exportable(port_store.GraphStore())
    # overflow: named, and the half-applied mirror is unpinned
    store, rt = _bench_store(dcap=2)
    for d in range(1, 6):
        store.insert_edge(0, 100 + d, {"w": 1, "f": .5, "city": "ada"})
    with pytest.raises(GpuUnavailable, match="DeltaOverflow.*SnapshotStore "
                       "cannot be exported"):
        rt.pin(store, "s")
    assert "s" not in rt.snapshots
    with pytest.raises(GpuUnavailable, match="none is pinned"):
        rt.pin(store, "s")


def test_snapshot_store_never_compacts():
    store, rt = _bench_store()
    dev = rt.snapshots["s"]
    for d in range(1, 6):
        store.insert_edge(0, 100 + d, {"w": 1, "f": .5, "city": "ada"})
    assert rt.pin(store, "s") is dev
    assert dev.delta.host.fill_ratio() >= rt.delta_compact_watermark
    assert getattr(dev, "_compact_thread", None) is None


# ---------------------------------------------------------------------------
# the algo plane over a store-built snapshot and the store's own SpaceData
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("func,params", [
    ("wcc", {}), ("sssp", {"src": 3}), ("sssp", {"src": 3, "weight": "f"}),
    ("pagerank", {"max_iter": 20, "tol": 0.0})])
def test_run_algorithm_on_a_store_built_snapshot(func, params):
    from nebula_tpu.algo import engine as ref_engine
    from nebula_tpu.graphstore.csr import build_snapshot as ref_build

    from nebula_tpu_torch.algo import engine as port_engine
    ref_st, st = twins(31)
    want, winfo = ref_engine.run_algorithm(
        func, {**params, "mode": "device"}, ref_build(ref_st, "g"),
        ref_st.space("g"), rt=ref_runtime())
    got, info = port_engine.run_algorithm(
        func, {**params, "mode": "device"}, build_snapshot(st, "g"),
        st.space("g"), rt=GpuRuntime(device="cpu"))
    assert info == winfo and info["mode"] == "device" and got
    assert [r[0] for r in got] == [r[0] for r in want]
    if func == "pagerank":
        assert max(abs(a[1] - b[1]) for a, b in zip(got, want)) <= 1e-8
    else:
        assert got == want
