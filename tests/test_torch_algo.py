"""The port's graph-analytics plane (`CALL algo.*`) against the JAX
reference, on the CPU.

Step level: each plain step (`pagerank_step_plain`, `wcc_step_plain`,
`sssp_step_plain`) and its wrapper's CPU branch against the reference's
jitted `nebula_tpu.algo.kernels.*_step`, on inputs made from a numpy
seed.  Run level: the port's `run_algorithm(..., rt=GpuRuntime(device=
"cpu"), mode="device")` against the reference's `run_algorithm(...,
rt=TpuRuntime(make_mesh(4)), mode="device")` on the reference store of
tests/unit/test_algo.py (80 vertices, 4 parts, NULL weights, a second
edge type, a dangling and an isolated vertex), carried over with
`snapshot_from_fields`, tags included; unsplit and degree-split.

Tolerances: WCC and SSSP exact (integer labels; float64 sums of the
same two operands, then an exact min), in rows and in iterations.
PageRank steps within 1e-12 with the same moved count (the port adds
each segment up directly, the reference differences one cumsum);
PageRank runs within 1e-8, the
reference's documented bar (tools/algo_bench.py:35).  Host mode runs the
same numpy oracles on both sides, so it is exact.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.algo import engine as ref_engine
from nebula_tpu.algo import kernels as ref_kernels
from nebula_tpu.core.value import NULL
from nebula_tpu.graphstore.csr import build_snapshot
from nebula_tpu.graphstore.schema import PropDef, PropType
from nebula_tpu.graphstore.store import GraphStore
from nebula_tpu.tpu import TpuRuntime, make_mesh

from nebula_tpu_torch.algo import engine as port_engine
from nebula_tpu_torch.algo import kernels as AK
from nebula_tpu_torch.algo.graph import build_algo_graph
from nebula_tpu_torch.gpu import GpuRuntime
from nebula_tpu_torch.graphstore import csr as port_csr
from nebula_tpu_torch.graphstore.csr import snapshot_from_fields
from nebula_tpu_torch.tools.algo_bench import run_suite

P = 4
PAGERANK_TOL = 1e-8      # run level, the reference's bar
STEP_TOL = 1e-12         # one step
SPLIT_THRESHOLD = 4      # degree above which the port's split makes hubs


def algo_store(seed=0, n=80, avg_deg=4, spacename="ag",
               neg_weight=False):
    """Seeded random graph with a non-negative int weight prop (w),
    occasionally-NULL weights, a second edge type, and an isolated
    + dangling vertex so the corner paths (no out-edges, no edges at
    all) are always exercised.  (A copy of tests/unit/test_algo.py's.)"""
    rng = random.Random(seed)
    st = GraphStore()
    st.create_space(spacename, partition_num=P, vid_type="INT64")
    st.catalog.create_tag(spacename, "person", [
        PropDef("age", PropType.INT64)])
    st.catalog.create_edge(spacename, "knows", [
        PropDef("w", PropType.INT64)])
    st.catalog.create_edge(spacename, "likes", [
        PropDef("w", PropType.INT64)])
    for v in range(n):
        st.insert_vertex(spacename, v, "person", {"age": v})
    lo = -5 if neg_weight else 0
    for v in range(n - 2):          # n-2: dangling, n-1: isolated
        for _ in range(rng.randint(0, avg_deg * 2)):
            d = rng.randrange(n - 1)
            w = rng.randint(lo, 9) if rng.random() > 0.1 else NULL
            st.insert_edge(spacename, v, "knows", d, rng.randint(0, 1),
                           {"w": w})
        if rng.random() > 0.6:
            st.insert_edge(spacename, v, "likes", rng.randrange(n - 1),
                           0, {"w": rng.randint(0, 9)})
    return st


def _fields(snap):
    """Plain arrays and lists out of a reference CsrSnapshot, tags
    included."""
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
        "tags": {n: {"present": t.present, "props": dict(t.props),
                     "prop_types": {c: ty.name
                                    for c, ty in t.prop_types.items()}}
                 for n, t in snap.tags.items()},
    }


class _SD:
    """The port's vid → dense id map of a carried snapshot (-1 when
    absent, as the reference store's `dense_id`)."""

    def __init__(self, dense_to_vid):
        self._d = {v: d for d, v in enumerate(dense_to_vid)
                   if v is not None}

    def dense_id(self, vid):
        return self._d.get(vid, -1)


@pytest.fixture(scope="module")
def ref_rt():
    return TpuRuntime(make_mesh(P))


@pytest.fixture(scope="module")
def port_rt():
    return GpuRuntime(device="cpu")


def _case(seed, **kw):
    st = algo_store(seed, **kw)
    ref_snap = build_snapshot(st, "ag")
    carried = snapshot_from_fields(_fields(ref_snap))
    return st, ref_snap, carried


@pytest.fixture(scope="module")
def cases():
    out = {}
    for seed in (1, 2, 3, 4):
        st, ref_snap, carried = _case(seed)
        split = port_csr.degree_split(carried, SPLIT_THRESHOLD)
        assert split.hub_dense is not None and split.hub_dense.size
        out[seed] = dict(st=st, ref_snap=ref_snap, carried=carried,
                         split=split, sd=_SD(carried.dense_to_vid))
    return out


# -- the snapshot carries tags ----------------------------------------------


def test_tags_carried_over(cases):
    c = cases[1]
    (name, ref_t), = c["ref_snap"].tags.items()
    t = c["carried"].tags[name]
    np.testing.assert_array_equal(t.present, ref_t.present)
    np.testing.assert_array_equal(t.props["age"], ref_t.props["age"])
    assert t.prop_types == {"age": port_csr.PropType.INT64}
    assert c["split"].tags is c["carried"].tags     # split passes them on
    assert c["carried"].hbm_bytes() > sum(
        b.indptr.nbytes + b.nbr.nbytes + b.rank.nbytes
        + sum(a.nbytes for a in b.props.values())
        for b in c["carried"].blocks.values())


@pytest.mark.parametrize("bad", ["present", "prop"])
def test_tag_shapes_checked(cases, bad):
    f = _fields(cases[1]["ref_snap"])
    t = f["tags"]["person"]
    if bad == "present":
        t["present"] = t["present"][:, :-1]
    else:
        t["props"]["age"] = t["props"]["age"][:-1]
    with pytest.raises(ValueError, match="tag person"):
        snapshot_from_fields(f)


def test_isolated_tagged_vertex_is_a_vertex(cases):
    """Vertex 79 has a tag and no edge: only the tags keep it."""
    c = cases[1]
    keys = [("knows", "out"), ("likes", "out")]
    g = build_algo_graph(c["carried"], keys)
    d79 = c["sd"].dense_id(79)
    assert g.vmask[d79]
    untagged = snapshot_from_fields({**_fields(c["ref_snap"]), "tags": {}})
    assert not build_algo_graph(untagged, keys).vmask[d79]


# -- step level --------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _edges(rng, n, E):
    edst = np.sort(rng.integers(0, n, E)).astype(np.int64)
    esrc = rng.integers(0, n, E).astype(np.int64)
    starts = np.searchsorted(edst, np.arange(n + 1, dtype=np.int64))
    return esrc, edst, starts


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("E", [1, 700])
def test_pagerank_step_matches_reference(seed, E):
    rng = np.random.default_rng(seed)
    n = 96
    esrc, edst, starts = _edges(rng, n, E)
    vmask = rng.random(n) < 0.9
    outdeg = np.bincount(esrc, minlength=n).astype(np.float64)
    out_inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0)
    dmask = vmask & (outdeg == 0)
    rank = np.where(vmask, rng.random(n) / n, 0.0)
    nv, damping, tol = float(vmask.sum()), 0.85, 1e-3
    ref = ref_kernels.pagerank_step(n, damping, tol)(
        jnp.asarray(rank), jnp.asarray(esrc.astype(np.int32)),
        jnp.asarray(starts), jnp.asarray(out_inv[esrc]),
        jnp.asarray(dmask), jnp.asarray(vmask), nv)
    args = (_t(rank), _t(esrc.astype(np.int32)), _t(starts),
            _t(out_inv[esrc]), _t(dmask), _t(vmask), nv, damping, tol)
    for fn in (AK.pagerank_step_plain, AK.pagerank_step):
        new, delta, active = fn(*args)
        assert new.dtype == torch.float64 and new.shape == (n,)
        assert active.dtype == torch.int64 and active.dim() == 0
        np.testing.assert_allclose(new.numpy(), np.asarray(ref[0]),
                                   rtol=0, atol=STEP_TOL)
        assert abs(float(delta) - float(ref[1])) <= STEP_TOL
        assert int(active) == int(ref[2])


def test_pagerank_step_without_edges():
    """No edges: every real vertex gets the base rank.  (The reference's
    jitted step cannot gather from an empty cumsum; its auto mode then
    falls back to the oracle.)"""
    rng = np.random.default_rng(5)
    n = 40
    vmask = rng.random(n) < 0.8
    rank = np.where(vmask, rng.random(n), 0.0)
    base = (1.0 - 0.85 + 0.85 * rank[vmask].sum()) / vmask.sum()
    want = np.where(vmask, base, 0.0)
    for fn in (AK.pagerank_step_plain, AK.pagerank_step):
        new, delta, active = fn(
            _t(rank), torch.empty(0, dtype=torch.int32),
            _t(np.zeros(n + 1, np.int64)), torch.empty(0, dtype=torch.float64),
            _t(vmask), _t(vmask), float(vmask.sum()), 0.85, 0.0)
        np.testing.assert_allclose(new.numpy(), want, rtol=0, atol=STEP_TOL)
        assert abs(float(delta) - np.abs(want - rank).sum()) <= STEP_TOL
        assert int(active) == int((np.abs(want - rank) > 0).sum())


def _relax_inputs(seed, n=90, E=600, sssp=False):
    rng = np.random.default_rng(seed)
    esrc, edst, _ = _edges(rng, n, E)
    mask = rng.random(n) < 0.4
    if sssp:
        val = np.where(rng.random(n) < 0.3, np.inf,
                       rng.integers(0, 50, n).astype(np.float64))
        w = rng.integers(0, 10, E).astype(np.float64)
        w[rng.random(E) < 0.1] = 0.5
        return val, mask, esrc, edst, w
    val = np.where(rng.random(n) < 0.1, ref_kernels.BIG,
                   rng.permutation(n).astype(np.int64))
    return val, mask, esrc, edst, None


def _same(got, want):
    g, m, c = got
    np.testing.assert_array_equal(g.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(m.numpy(), np.asarray(want[1]))
    assert int(c) == int(want[2]) and c.dtype == torch.int64


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_wcc_step_matches_reference(seed):
    val, mask, esrc, edst, _ = _relax_inputs(seed)
    n = val.size
    want = ref_kernels.wcc_step(n)(
        jnp.asarray(val), jnp.asarray(mask),
        jnp.asarray(esrc.astype(np.int32)), jnp.asarray(edst.astype(np.int32)))
    args = (_t(val), _t(mask), _t(esrc.astype(np.int32)),
            _t(edst.astype(np.int32)))
    for fn in (AK.wcc_step_plain, AK.wcc_step):
        got = fn(*args)
        assert got[0].dtype == torch.int64
        _same(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_sssp_step_matches_reference(seed, weighted):
    val, mask, esrc, edst, w = _relax_inputs(seed, sssp=True)
    n = val.size
    jargs = [jnp.asarray(val), jnp.asarray(mask),
             jnp.asarray(esrc.astype(np.int32)),
             jnp.asarray(edst.astype(np.int32))]
    args = [_t(val), _t(mask), _t(esrc.astype(np.int32)),
            _t(edst.astype(np.int32))]
    if weighted:
        jargs.append(jnp.asarray(w))
        args.append(_t(w))
    want = ref_kernels.sssp_step(n, weighted)(*jargs)
    for fn in (AK.sssp_step_plain, AK.sssp_step):
        got = fn(*args)
        assert got[0].dtype == torch.float64
        _same(got, want)


@pytest.mark.parametrize("bad", [-1, 90])
def test_wrappers_check_edge_range_on_the_cpu(bad):
    val, mask, esrc, edst, w = _relax_inputs(0, sssp=True)
    edst = edst.astype(np.int32)
    edst[3] = bad
    e32 = _t(esrc.astype(np.int32))
    with pytest.raises(ValueError, match="outside"):
        AK.sssp_step(_t(val), _t(mask), e32, _t(edst), _t(w))
    with pytest.raises(ValueError, match="outside"):
        AK.wcc_step(_t(np.arange(90)), _t(mask), e32, _t(edst))
    with pytest.raises(ValueError, match="outside"):
        AK.pagerank_step(_t(val), _t(edst), _t(np.zeros(91, np.int64)),
                         _t(w), _t(mask), _t(mask), 1.0, 0.85, 0.0)


def test_wrappers_reject_bad_inputs_before_launch():
    m = dict(device="meta")
    i32 = torch.empty((5,), dtype=torch.int32, **m)
    with pytest.raises(ValueError, match="int64"):
        AK.wcc_step(torch.empty((4,), dtype=torch.int32, **m),
                    torch.empty((4,), dtype=torch.bool, **m), i32, i32)
    with pytest.raises(ValueError, match="shape"):
        AK.sssp_step(torch.empty((4,), dtype=torch.float64, **m),
                     torch.empty((3,), dtype=torch.bool, **m), i32, i32)
    with pytest.raises(ValueError, match="starts"):
        AK.pagerank_step(torch.empty((4,), dtype=torch.float64, **m), i32,
                         torch.empty((4,), dtype=torch.int64, **m),
                         torch.empty((5,), dtype=torch.float64, **m),
                         torch.empty((4,), dtype=torch.bool, **m),
                         torch.empty((4,), dtype=torch.bool, **m),
                         4.0, 0.85, 0.0)


# -- run level ---------------------------------------------------------------

RUNS = [("wcc", {}), ("sssp", {"src": 0}), ("sssp", {"src": 0, "weight": "w"}),
        ("sssp", {"src": 7, "direction": "both"}),
        ("pagerank", {"max_iter": 30, "tol": 0.0}),
        ("wcc", {"edge_types": "knows"})]


def _ref_run(c, func, params, rt, mode):
    return ref_engine.run_algorithm(func, {**params, "mode": mode},
                                    c["ref_snap"], c["st"].space("ag"),
                                    rt=rt)


def _assert_rows(func, got, want):
    if func != "pagerank":
        assert got == want
        return
    assert [r[0] for r in got] == [r[0] for r in want]
    assert max(abs(a[1] - b[1]) for a, b in zip(got, want)) <= PAGERANK_TOL


@pytest.mark.parametrize("layout", ["unsplit", "split"])
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("func,params", RUNS,
                         ids=[f"{f}-{'-'.join(map(str, p.values()))}"
                              for f, p in RUNS])
def test_device_run_matches_reference(cases, ref_rt, port_rt, seed,
                                      layout, func, params):
    c = cases[seed]
    snap = c["carried"] if layout == "unsplit" else c["split"]
    want, winfo = _ref_run(c, func, params, ref_rt, "device")
    got, info = port_engine.run_algorithm(
        func, {**params, "mode": "device"}, snap, c["sd"], rt=port_rt)
    assert info == {**winfo, "mode": "device"} and winfo["mode"] == "device"
    assert got
    _assert_rows(func, got, want)


@pytest.mark.parametrize("weight", [None, "w"])
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_split_layout_keeps_the_flat_edge_set(cases, seed, weight):
    """degree_split moves hub edges into hub rows: the flat edge list
    holds the same (src, dst, weight) multiset, so WCC and SSSP give
    identical rows and PageRank the same ranks up to summation order."""
    c = cases[seed]
    keys = [("knows", "out"), ("likes", "out")]
    a = build_algo_graph(c["carried"], keys, weight)
    b = build_algo_graph(c["split"], keys, weight)

    def triples(g):
        w = g.weight if g.weight is not None else np.zeros(g.n_edges)
        return sorted(zip(g.esrc.tolist(), g.edst.tolist(), w.tolist()))
    assert a.n_edges == b.n_edges and triples(a) == triples(b)
    assert (a.esrc != b.esrc).any()          # the order did change
    np.testing.assert_array_equal(a.vmask, b.vmask)
    for func, params in RUNS:
        x, _ = port_engine.run_algorithm(func, {**params, "mode": "device"},
                                         c["carried"], c["sd"],
                                         rt=GpuRuntime(device="cpu"))
        y, _ = port_engine.run_algorithm(func, {**params, "mode": "device"},
                                         c["split"], c["sd"],
                                         rt=GpuRuntime(device="cpu"))
        if func == "pagerank":
            assert [r[0] for r in x] == [r[0] for r in y]
            assert max(abs(p[1] - q[1]) for p, q in zip(x, y)) <= STEP_TOL
        else:
            assert x == y


@pytest.mark.parametrize("func,params", RUNS,
                         ids=[f"{f}-{'-'.join(map(str, p.values()))}"
                              for f, p in RUNS])
def test_host_mode_matches_reference(cases, func, params):
    c = cases[2]
    want, winfo = _ref_run(c, func, params, None, "host")
    for rt in (None, GpuRuntime(device="cpu")):
        got, info = port_engine.run_algorithm(
            func, {**params, "mode": "host"}, c["carried"], c["sd"], rt=rt)
        assert got == want and info == winfo and info["mode"] == "host"


def test_auto_mode_picks_device_with_a_runtime(cases, port_rt):
    c = cases[3]
    rows, info = port_engine.run_algorithm("wcc", {}, c["carried"], c["sd"],
                                           rt=port_rt)
    assert info["mode"] == "device"
    host, hinfo = port_engine.run_algorithm("wcc", {}, c["carried"],
                                            c["sd"])
    assert hinfo["mode"] == "host" and rows == host
    comp = dict(rows)
    assert len(rows) == 80 and comp[79] == 79     # isolated: own component


def test_auto_mode_device_error_propagates(cases, port_rt, monkeypatch):
    """An error on the device path is never answered by the oracle."""
    c = cases[3]

    def broken(*a, **k):
        raise RuntimeError("step failed")

    def oracle(*a, **k):
        raise AssertionError("oracle answered a device failure")

    monkeypatch.setattr(AK, "wcc_step", broken)
    monkeypatch.setattr(port_engine, "wcc_np", oracle)
    with pytest.raises(RuntimeError, match="step failed"):
        port_engine.run_algorithm("wcc", {"mode": "auto"}, c["carried"],
                                  c["sd"], rt=port_rt)


def test_deleted_vertex_excluded():
    st, _, _ = _case(6)
    st.delete_vertex("ag", 5)
    carried = snapshot_from_fields(_fields(build_snapshot(st, "ag")))
    rows, _ = port_engine.run_algorithm(
        "wcc", {}, carried, _SD(carried.dense_to_vid),
        rt=GpuRuntime(device="cpu"))
    assert 5 not in {r[0] for r in rows}
    assert 5 not in {r[1] for r in rows}


def test_pagerank_deterministic_and_a_distribution(cases, port_rt):
    c = cases[1]
    a, _ = port_engine.run_algorithm("pagerank", {"max_iter": 10, "tol": 0.0},
                                     c["carried"], c["sd"], rt=port_rt)
    b, _ = port_engine.run_algorithm("pagerank", {"max_iter": 10, "tol": 0.0},
                                     c["carried"], c["sd"], rt=port_rt)
    assert a == b
    assert abs(sum(r[1] for r in a) - 1.0) < 1e-6


class _Live:
    def __init__(self):
        self.ops = []

    def set_operator(self, text):
        self.ops.append(text)


def test_live_progress_and_iteration_times(cases, port_rt):
    c = cases[1]
    live, us = _Live(), []
    _, info = port_engine.run_algorithm(
        "pagerank", {"max_iter": 5, "tol": 0.0}, c["carried"], c["sd"],
        rt=port_rt, live=live, iter_us=us)
    assert info["iterations"] == 5 and len(us) == 5
    assert all(x >= 0 for x in us)
    assert live.ops[0].startswith("algo.pagerank[iter 1/5 active_frontier=")
    assert live.ops[-1].startswith("algo.pagerank[iter 5/5 ")
    live = _Live()
    port_engine.run_algorithm("wcc", {"mode": "host"}, c["carried"],
                              c["sd"], live=live)
    assert live.ops == ["algo.wcc[host oracle]"]


def test_device_edges_layout(cases, port_rt):
    c = cases[1]
    params, keys, g, _ = port_engine.prepare(
        "sssp", {"src": 0, "weight": "w"}, c["carried"], c["sd"])
    dev = port_engine._device_edges(port_rt, c["carried"], keys, "w", g)
    assert dev["esrc"].dtype == dev["edst"].dtype == torch.int32
    assert dev["starts"].dtype == torch.int64
    assert dev["starts"].shape == (g.n_slots + 1,)
    assert dev["vmask"].dtype == torch.bool
    assert dev["weight"].dtype == torch.float64
    order, esrc_s, edst_s, starts = g.by_dst()
    np.testing.assert_array_equal(dev["edst"].numpy(), edst_s)
    np.testing.assert_array_equal(dev["weight"].numpy(), g.weight[order])
    assert port_engine._device_edges(port_rt, c["carried"], keys, "w",
                                     g) is dev          # cached


def test_algo_dispatch_returns_result_and_micros(port_rt):
    res, us = port_rt.algo_dispatch("algo.test", lambda a, b: a + b, 2, 3)
    assert res == 5 and isinstance(us, int) and us >= 0


# -- error surfaces ---------------------------------------------------------


@pytest.mark.parametrize("func,params,frag", [
    ("pagerank", {"damping": 2.0}, "damping"),
    ("pagerank", {"damping": "x"}, "damping"),
    ("pagerank", {"tol": -1.0}, "tol"),
    ("pagerank", {"max_iter": -1}, "max_iter"),
    ("pagerank", {"max_iter": True}, "max_iter"),
    ("wcc", {"mode": "wat"}, "mode"),
    ("sssp", {"src": 0, "direction": "up"}, "direction"),
    ("sssp", {"src": 0, "weight": 5}, "weight"),
    ("wcc", {"edge_types": 5}, "edge_types"),
    ("wcc", {"edge_types": ["knows", 3]}, "edge_types"),
])
def test_resolve_params_errors(func, params, frag):
    with pytest.raises(port_engine.AlgoError, match=frag) as got:
        port_engine.resolve_params(func, params)
    with pytest.raises(ref_engine.AlgoError) as want:
        ref_engine.resolve_params(func, params)
    assert str(got.value) == str(want.value)


def test_resolve_params_defaults():
    p = port_engine.resolve_params("sssp", {"src": 3, "edge_types": "knows"})
    assert p == ref_engine.resolve_params("sssp", {"src": 3,
                                                   "edge_types": "knows"})
    assert p["edge_types"] == ["knows"] and p["mode"] == "auto"


def test_negative_weights_refused(port_rt):
    st, _, carried = _case(9, neg_weight=True)
    with pytest.raises(port_engine.AlgoError, match="non-negative"):
        port_engine.run_algorithm("sssp", {"src": 0, "weight": "w"}, carried,
                                  _SD(carried.dense_to_vid), rt=port_rt)


@pytest.mark.parametrize("src", [987654, "x"])
def test_sssp_unknown_source_is_empty(cases, port_rt, src):
    c = cases[1]
    rows, info = port_engine.run_algorithm("sssp", {"src": src},
                                           c["carried"], c["sd"], rt=port_rt)
    assert rows == [] and info["mode"] == "none"


def test_device_mode_without_runtime_raises(cases):
    c = cases[1]
    with pytest.raises(port_engine.AlgoError, match="no device runtime"):
        port_engine.run_algorithm("wcc", {"mode": "device"}, c["carried"],
                                  c["sd"])


@pytest.mark.parametrize("params,frag", [
    ({"edge_types": "nosuch"}, "no CSR block"),
    ({"src": 0, "weight": "nosuch"}, "no prop"),
])
def test_missing_blocks_and_props(cases, params, frag):
    c = cases[1]
    func = "sssp" if "src" in params else "wcc"
    with pytest.raises(port_engine.AlgoError, match=frag):
        port_engine.run_algorithm(func, params, c["carried"], c["sd"])


# -- the bench tool ---------------------------------------------------------


def test_algo_bench_suite_small():
    res = run_suite(persons=400, degree=4, parts=P, repeats=1,
                    runtime=GpuRuntime(device="cpu"))
    for algo in ("pagerank", "wcc", "sssp"):
        blk = res[algo]
        assert blk["rows_match"], (algo, blk)
        assert blk["device_s"] > 0 and blk["host_s"] > 0
        assert blk["iterations"] >= 1
    assert res["graph"]["persons"] == 400


def test_algo_bench_needs_a_card_by_default():
    from nebula_tpu_torch.gpu import GpuUnavailable
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(GpuUnavailable):
        run_suite(persons=50, degree=2, parts=P, repeats=1)
