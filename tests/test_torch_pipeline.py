"""The fused MATCH pipeline (`nebula_tpu_torch.gpu.pipeline`: the
`make_match_pipeline_rule` fusion rule, its segment compiler, the
`TpuMatchPipeline` executor and its columnar runner) and the device tag
tables against the JAX package's (`nebula_tpu.tpu.pipeline`,
`nebula_tpu.tpu.device.DeviceTag`), on the CPU.

- Every test of tests/unit/test_frame_pipeline.py runs on the port with
  the same body (`test_torch_engine.load_twin`), `TpuRuntime(make_mesh(P))`
  read as a port runtime of each of four layouts: unsplit, degree-split
  at 4, a delta plane of 64, and a mesh of 8 shard slots (the store's
  part count).  They hold the fused rows to the host engine's and to a
  brute-force oracle, as the unit tests do.
- Every statement of that file's QUERIES, on seeds 0-2, gives on the
  port's device engine the reference device engine's rows in order
  (its `TpuRuntime(make_mesh(8))`, all three of its fusion rules), the
  same plan, and the same runner stats (`hop_edges`, `frontier_sizes`).
- LDBC IC5 and IC9, as bench.py runs them, on `make_snb_interactive(300)`:
  rows equal to `ic5_numpy` / `ic9_numpy` and to the reference's device
  engine, plans equal, one fused node.
- The executor's outcomes: the host subplan answers a runtime
  `CannotCompile`, the injected `tpu:dispatch` failure, the overload
  shed and the device flag off, with the reference's counter labels; a
  kill between segments is the statement's error; a `SnapshotRetired`
  runs the program again; a `GpuUnavailable` or a CUDA error in a chain
  is the statement's error (ROADMAP divergence 12); PROFILE shows the
  segments.
- The device tag tables: the bytes and the columns of the reference's
  `DeviceTag` leaves on twin stores; every tensor equal to the host
  mirror after a vertex write folded in through the delta plane, locally
  and on a mesh; `pin_bytes` equal to the pin's `shard_hbm_bytes()` on
  1, 4 and 8 slots.
- `make_snb_interactive`'s arrays and its store's export equal the
  reference's.
Tolerance: exact.
"""
import numpy as np
import pytest
import torch

from nebula_tpu.bench import datagen as ref_datagen
from nebula_tpu.core import wire as ref_wire
from nebula_tpu.exec.engine import QueryEngine as RefQueryEngine
from nebula_tpu.graphstore import csr as ref_csr
from nebula_tpu.tpu import TpuRuntime, make_mesh as ref_make_mesh
from nebula_tpu.utils.failpoints import fail as ref_fail
from nebula_tpu.utils.stats import stats as ref_stats

from nebula_tpu_torch.bench import datagen as D
from nebula_tpu_torch.core import wire as port_wire
from nebula_tpu_torch.exec.engine import QueryEngine
from nebula_tpu_torch.gpu import GpuRuntime, GpuUnavailable, \
    SnapshotRetired, make_mesh
from nebula_tpu_torch.gpu.device import pin_bytes
from nebula_tpu_torch.gpu.exprjit import CannotCompile
from nebula_tpu_torch.graphstore import csr as port_csr
from nebula_tpu_torch.utils.config import get_config
from nebula_tpu_torch.utils.failpoints import fail
from nebula_tpu_torch.utils.stats import stats
from nebula_tpu_torch.utils.workload import dispatch_table

from test_torch_engine import (DEVICE_LAYOUTS, layout_runtime, load_twin,
                               run_twin, twin_cases)
from test_torch_graphstore import _assert_snapshots_equal
from test_torch_pin_store import PORT, REF, random_store
from test_torch_tck import canon_plan, ref_device_rules

CPU = torch.device("cpu")

# test_frame_pipeline.py imports test_tpu's store: each package's twin
for _pkg in ("ref", "port"):
    load_twin("tests/unit/test_tpu.py", _pkg, replace=((
        "from nebula_tpu.tpu import TpuRuntime, make_mesh, pin_snapshot",
        "from test_torch_engine import mesh_runtime as TpuRuntime, "
        "mesh_parts as make_mesh; from nebula_tpu.tpu import pin_snapshot"),)
        if _pkg == "port" else ())
TWIN = load_twin("tests/unit/test_frame_pipeline.py", "port", replace=(
    ("from test_tpu import", "from twin_port_test_tpu import"),
    ("from nebula_tpu.tpu import TpuRuntime, make_mesh",
     "from test_torch_engine import mesh_runtime as TpuRuntime, "
     "mesh_parts as make_mesh")))
REF_TWIN = load_twin("tests/unit/test_frame_pipeline.py", "ref", replace=(
    ("from test_tpu import", "from twin_ref_test_tpu import"),))
CASES = twin_cases(TWIN)


@pytest.mark.parametrize("layout", DEVICE_LAYOUTS)
@pytest.mark.parametrize("name,kw", [c[:2] for c in CASES],
                         ids=[c[2] for c in CASES])
def test_unit_twin(name, kw, layout):
    run_twin(TWIN, name, kw, {"rt": layout_runtime(layout)})


def test_every_unit_test_has_a_twin():
    names = {c[0] for c in CASES}
    assert names == {c[0] for c in twin_cases(REF_TWIN)} and len(names) == 7


def test_the_rules_run_in_the_references_order():
    from nebula_tpu.query import optimizer as ref_opt
    from nebula_tpu_torch.query import optimizer as port_opt
    assert [f.__name__ for f in port_opt.TPU_RULES] == \
        [f.__name__ for f in ref_opt.TPU_RULES] == \
        [f.__name__ for f in ref_device_rules()] == \
        ["make_tpu_rule", "make_match_agg_rule", "make_match_pipeline_rule"]


# -- statements against the reference's device engine -----------------------


class _Side:
    """One engine and its session on `space`."""

    def __init__(self, engine_cls, store, rt, wire, space="g"):
        self.eng = engine_cls(store, tpu_runtime=rt)
        self.sess = self.eng.new_session()
        self.wire = wire
        assert self.eng.execute(self.sess, f"USE {space}").error is None

    def run(self, q):
        """(rows as wire bytes, the runner's stats, the canonical plan);
        the statement must have run fused, with no host fallback."""
        q0 = self.eng.qctx
        q0.last_tpu_stats = q0.last_tpu_fallback = None
        rs = self.eng.execute(self.sess, q)
        assert rs.error is None, (q, rs.error)
        st = q0.last_tpu_stats
        assert st is not None and q0.last_tpu_fallback is None, \
            (q, q0.last_tpu_fallback)
        plan = self.eng.execute(self.sess, "EXPLAIN " + q)
        return ([self.wire.dumps(list(r)) for r in rs.data.rows],
                (list(st.hop_edges), list(st.frontier_sizes)),
                canon_plan(plan.data.rows[0][0]))


_REF = {}


def _reference(key, make_store, queries, space="g"):
    """{statement: (rows, stats, plan)} of the reference's device engine
    on `make_store()`, with its mesh of 8 and its three rules."""
    if key not in _REF:
        side = _Side(RefQueryEngine, make_store(),
                     TpuRuntime(ref_make_mesh(8)), ref_wire, space)
        _REF[key] = {q: side.run(q) for q in queries}
    return _REF[key]


@pytest.mark.parametrize("layout", DEVICE_LAYOUTS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queries_equal_the_reference_device_engine(seed, layout):
    want = _reference(("queries", seed),
                      lambda: REF_TWIN.random_store(seed), TWIN.QUERIES)
    port = _Side(QueryEngine, TWIN.random_store(seed),
                 layout_runtime(layout), port_wire)
    for q in TWIN.QUERIES:
        rows, st, plan = port.run(q)
        wrows, wst, wplan = want[q]
        assert "TpuMatchPipeline" in plan, q
        assert plan == wplan, q
        assert rows == wrows, (layout, q)
        assert st == wst, (layout, q)


# -- LDBC IC5 and IC9, as bench.py runs them --------------------------------

IC_PERSONS = 300
IC_ROOT, IC_MIN, IC_MAX = 5, 17_000, 19_000
IC5 = (f"MATCH (person:Person)-[:KNOWS*1..2]-(friend:Person) "
       f"WHERE id(person) == {IC_ROOT} AND id(friend) != {IC_ROOT} "
       f"WITH DISTINCT friend "
       f"MATCH (friend)<-[membership:HAS_MEMBER]-(forum:Forum) "
       f"WHERE membership.joinDate > {IC_MIN} "
       f"WITH DISTINCT friend, forum "
       f"OPTIONAL MATCH (friend)<-[:HAS_CREATOR]-(post:Post)"
       f"<-[:CONTAINER_OF]-(forum) "
       f"WITH forum, count(post) AS postCount "
       f"RETURN forum.Forum.title AS forumName, postCount "
       f"ORDER BY postCount DESC, forumName ASC LIMIT 20")
IC9 = (f"MATCH (root:Person)-[:KNOWS*1..2]-(friend:Person) "
       f"WHERE id(root) == {IC_ROOT} AND id(friend) != {IC_ROOT} "
       f"WITH DISTINCT friend "
       f"MATCH (friend)<-[:HAS_CREATOR]-(message) "
       f"WHERE message.creationDate < {IC_MAX} "
       f"RETURN id(friend) AS fid, id(message) AS mid, "
       f"message.creationDate AS d ORDER BY d DESC, mid ASC LIMIT 20")


@pytest.fixture(scope="module")
def snb():
    return D.make_snb_interactive(IC_PERSONS, parts=8)


@pytest.mark.parametrize("layout", DEVICE_LAYOUTS)
def test_ic5_and_ic9_equal_the_oracles_and_the_reference(snb, layout):
    st, arrs = snb
    want = _reference("ic", lambda: ref_datagen.make_snb_interactive(
        IC_PERSONS, parts=8)[0], (IC5, IC9), space="ic")
    port = _Side(QueryEngine, st, layout_runtime(layout), port_wire, "ic")
    oracles = {IC5: D.ic5_numpy(arrs, IC_ROOT, IC_MIN),
               IC9: D.ic9_numpy(arrs, IC_ROOT, IC_MAX)}
    for q, oracle in oracles.items():
        before = stats().snapshot().get("match_pipeline_fused", 0)
        rows, hops, plan = port.run(q)
        assert stats().snapshot().get("match_pipeline_fused", 0) \
            == before + 1
        rs = port.eng.execute(port.sess, q)
        assert [tuple(r) for r in rs.data.rows] == \
            [tuple(t) for t in oracle] and len(oracle) == 20, layout
        assert plan.count("TpuMatchPipeline") == 1, plan
        assert (rows, hops, plan) == want[q], layout


# -- the executor's outcomes ------------------------------------------------

FUSED = TWIN.QUERIES[0]
LABEL = "match_pipeline_fallback{{reason={},stage=execute}}"


def _pair(M, engine_cls, rt, seed=3, store=None):
    st = store if store is not None else random_store(M, seed)
    host = engine_cls(st)
    hs = host.new_session()
    host.execute(hs, "USE g")
    dev = engine_cls(st, tpu_runtime=rt)
    ds = dev.new_session()
    dev.execute(ds, "USE g")
    return (host, hs), (dev, ds)


def _fallback_counts(snapshot):
    return {k: v for k, v in snapshot.items()
            if k.startswith("match_pipeline_fallback")}


def _host_fallback(arm, disarm, q=FUSED, store_fn=None, reason=None):
    """Run `q` on both packages' device engines with `arm(pkg)` in
    effect: each answers the host engine's rows, and their fallback
    counters move under the same labels.  Returns the port's labels."""
    moved = {}
    for pkg, M, eng_cls, rt, snap in (
            ("ref", REF, RefQueryEngine, TpuRuntime(ref_make_mesh(8)),
             ref_stats),
            ("port", PORT, QueryEngine, layout_runtime("unsplit"), stats)):
        (h, hs), (d, ds) = _pair(M, eng_cls, rt, store=None if store_fn
                                 is None else store_fn(M))
        want = h.execute(hs, q)
        assert want.error is None
        assert "TpuMatchPipeline" in \
            d.execute(ds, "EXPLAIN " + q).data.rows[0][0]
        b = _fallback_counts(snap().snapshot())
        arm(pkg)
        try:
            d.qctx.last_tpu_stats = None
            got = d.execute(ds, q)
        finally:
            disarm(pkg)
        assert got.error is None, (pkg, got.error)
        assert got.data.rows == want.data.rows, pkg
        a = _fallback_counts(snap().snapshot())
        moved[pkg] = {k: a[k] - b.get(k, 0) for k in a
                      if a[k] != b.get(k, 0)}
    assert moved["port"] == moved["ref"], moved
    if reason is not None:
        assert moved["port"] == {LABEL.format(reason): 1}, moved
    return moved["port"]


def _mixed_attr_store(M):
    """random_store(3) with a second tag carrying `age` as a STRING: a
    tag-less `c.age` then merges two value kinds, which the runner
    cannot lay out as one column (a CannotCompile raised at run time)."""
    st = random_store(M, 3)
    st.catalog.create_tag("g", "robot", [M.PropDef("age",
                                                   M.PropType.STRING)])
    for v in range(0, 120, 7):
        st.insert_vertex("g", v, "robot", {"age": f"r{v}"})
    return st


def test_runtime_cannot_compile_answers_from_the_subplan():
    q = ("MATCH (a:person)-[:knows]->(b:person) WHERE id(a) IN [1,2,3] "
         "WITH DISTINCT b MATCH (b)-[:knows]->(c:person) "
         "RETURN id(b) AS x, c.age AS y ORDER BY x")
    _host_fallback(lambda pkg: None, lambda pkg: None, q=q,
                   store_fn=_mixed_attr_store,
                   reason="runtime:CannotCompile")


def test_injected_dispatch_failure_answers_from_the_subplan():
    """The twin of tests/unit/test_deadline_kill.py's
    test_device_dispatch_failure_falls_back_to_host_rows."""
    def arm(pkg):
        (ref_fail if pkg == "ref" else fail).arm(
            "tpu:dispatch", "-1*raise(injected dispatch failure)")
    _host_fallback(arm, lambda pkg: (ref_fail if pkg == "ref"
                                     else fail).reset(),
                   reason="runtime:FailpointError")


def test_overload_shed_answers_from_the_subplan():
    from nebula_tpu.utils.config import get_config as ref_get_config
    from nebula_tpu.utils.workload import dispatch_table as ref_table
    held = {}

    def arm(pkg):
        cfg, table = (ref_get_config(), ref_table) if pkg == "ref" \
            else (get_config(), dispatch_table)
        cfg.set_dynamic("tpu_dispatch_queue_cap", 1)
        held[pkg] = table().enter("held")     # one queued dispatch

    def disarm(pkg):
        cfg, table = (ref_get_config(), ref_table) if pkg == "ref" \
            else (get_config(), dispatch_table)
        table().exit(held.pop(pkg))
        with cfg.lock:
            cfg.dynamic_layer.pop("tpu_dispatch_queue_cap", None)

    shed0 = stats().snapshot().get("tpu_dispatch_queue_shed", 0)
    _host_fallback(arm, disarm, reason="overload")
    assert stats().snapshot().get("tpu_dispatch_queue_shed", 0) \
        == shed0 + 1


def test_device_flag_off_answers_from_the_subplan():
    from nebula_tpu.utils.config import get_config as ref_get_config

    def arm(pkg):
        (ref_get_config() if pkg == "ref" else get_config()).set_dynamic(
            "tpu_match_device", False)

    def disarm(pkg):
        cfg = ref_get_config() if pkg == "ref" else get_config()
        with cfg.lock:
            cfg.dynamic_layer.pop("tpu_match_device", None)

    _host_fallback(arm, disarm, reason="device-flag-off")


def test_kill_between_segments_is_the_statements_error():
    """The twin of tests/unit/test_deadline_kill.py's
    test_kill_query_between_pipeline_segments."""
    _, (dev, ds) = _pair(PORT, QueryEngine, layout_runtime("unsplit"))
    fired = {"n": 0}

    def decide(idx, key):
        fired["n"] += 1
        dev.kill_running()
        return None

    b = _fallback_counts(stats().snapshot())
    fail.arm_callable("tpu:dispatch", decide)
    try:
        r = dev.execute(ds, FUSED)
    finally:
        fail.reset()
    assert fired["n"] >= 1
    assert r.error is not None and "killed" in r.error, r.error
    assert _fallback_counts(stats().snapshot()) == b


@pytest.mark.parametrize("fault", [
    GpuUnavailable("the card was lost"),
    RuntimeError("CUDA error: an illegal memory access was encountered")])
def test_a_device_fault_in_a_chain_is_the_statements_error(fault):
    """ROADMAP divergence 12: where the reference answers a device fault
    from its subplan, the port's statement fails with it."""
    rt = layout_runtime("unsplit")
    _, (dev, ds) = _pair(PORT, QueryEngine, rt)

    def broken(*a, **k):
        raise fault

    rt.traverse_hops = broken
    b = _fallback_counts(stats().snapshot())
    r = dev.execute(ds, FUSED)
    assert r.error is not None and str(fault) in r.error, r.error
    assert _fallback_counts(stats().snapshot()) == b
    assert dev.qctx.last_tpu_fallback is None


def test_a_retired_snapshot_runs_the_program_again():
    rt = layout_runtime("plane")
    (host, hs), (dev, ds) = _pair(PORT, QueryEngine, rt)
    orig, raised = rt.traverse_hops, []

    def once(*a, **k):
        if not raised:
            raised.append(1)
            raise SnapshotRetired("swapped by a compaction")
        return orig(*a, **k)

    rt.traverse_hops = once
    f0 = stats().snapshot().get("match_pipeline_fused", 0)
    b = _fallback_counts(stats().snapshot())
    r = dev.execute(ds, FUSED)
    assert r.error is None, r.error
    assert raised and r.data.rows == host.execute(hs, FUSED).data.rows
    assert stats().snapshot().get("match_pipeline_fused", 0) == f0 + 1
    assert _fallback_counts(stats().snapshot()) == b


def test_a_store_without_dense_ids_is_no_device_fault():
    """`_Runner` on a store that serves no dense ids raises CannotCompile
    (the reference's TpuUnavailable there is answered from the subplan
    too)."""
    from nebula_tpu_torch.gpu.pipeline import _Runner

    class NoDense:
        def space(self, name):
            return object()

    qctx = type("Q", (), {"store": NoDense()})()
    with pytest.raises(CannotCompile, match="dense-id"):
        _Runner(qctx, None, layout_runtime("unsplit"), "g")


def test_profile_shows_the_segments():
    """The twin of tests/unit/test_telemetry.py's
    test_profile_fused_pipeline_segments."""
    _, (dev, ds) = _pair(PORT, QueryEngine, layout_runtime("unsplit"))
    plain = dev.execute(ds, FUSED)
    assert plain.error is None
    prof = dev.execute(ds, "PROFILE " + FUSED)
    assert prof.error is None
    assert "TpuMatchPipeline" in prof.plan_desc
    assert "segment:" in prof.plan_desc
    assert "segment:result" in prof.plan_desc
    assert sorted(map(tuple, prof.data.rows)) == \
        sorted(map(tuple, plain.data.rows))
    segs = dev.qctx.last_tpu_stats.segments
    assert [s["op"] for s in segs][-1] == "result"
    assert any(s.get("device_us") for s in segs if s["op"] == "chain")


# -- the device tag tables --------------------------------------------------


def _tag_leaves(tags):
    return [a for t in tags.values() for a in (t.present,
                                               *t.props.values())]


def _host_tag_columns(snap):
    return {(name, col): a for name, t in snap.tags.items()
            for col, a in (("present", t.present), *t.props.items())}


def _device_tag_columns(dev):
    """{(tag, column): the pinned tensor as numpy}, the shard slots'
    rows stacked in part order on a mesh."""
    if not dev.shards:
        return {(name, col): a.numpy() for name, t in dev.tags.items()
                for col, a in (("present", t.present), *t.props.items())}
    out = {}
    for sh in dev.shards:
        for name, t in sh.tags.items():
            for col, a in (("present", t.present), *t.props.items()):
                out.setdefault((name, col), []).append(a.numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


def _assert_device_tags_equal_host(dev):
    want = _host_tag_columns(dev.host)
    got = _device_tag_columns(dev)
    assert set(got) == set(want) and want
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=str(k))


def test_tag_tables_are_the_references():
    ref_st, _ = ref_datagen.make_snb_interactive(200, parts=8)
    st, _ = D.make_snb_interactive(200, parts=8)
    ref_dev = TpuRuntime(ref_make_mesh(1)).pin(ref_st, "ic")
    dev = GpuRuntime(device="cpu").pin(st, "ic")
    assert sorted(dev.tags) == sorted(ref_dev.tags) == \
        ["Comment", "Forum", "Person", "Post"]
    for name, rt_ in ref_dev.tags.items():
        t = dev.tags[name]
        assert list(t.props) == list(rt_.props)
        for a, b in zip((t.present, *t.props.values()),
                        (rt_.present, *rt_.props.values())):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tag_bytes = sum(t.numel() * t.element_size()
                    for t in _tag_leaves(dev.tags))
    assert tag_bytes == sum(np.asarray(a).nbytes
                            for a in _tag_leaves(ref_dev.tags)) > 0
    # the reference's ledger and the port's count the same leaves
    assert dev.hbm_bytes() == ref_dev.hbm_bytes()


@pytest.mark.parametrize("slots", [1, 8])
def test_a_vertex_write_puts_the_tag_columns_again(slots):
    rt = GpuRuntime(device="cpu", delta_max_edges=64) if slots == 1 else \
        GpuRuntime(mesh=make_mesh(slots, devices=[CPU] * slots),
                   delta_max_edges=64)
    st = random_store(PORT, 5)
    dev = rt.pin(st, "g")
    _assert_device_tags_equal_host(dev)
    avoided = stats().snapshot().get("tpu_repin_avoided", 0)
    st.insert_vertex("g", 3, "person", {"age": 99, "name": "zed"})
    st.delete_vertex("g", 4)
    st.insert_vertex("g", 200, "person", {"age": 7, "name": "new"})
    assert rt.pin(st, "g") is dev
    assert stats().snapshot().get("tpu_repin_avoided", 0) == avoided + 1
    host = _host_tag_columns(dev.host)
    P = dev.num_parts
    assert host[("person", "age")][3 % P, 3 // P] == 99
    _assert_device_tags_equal_host(dev)


@pytest.mark.parametrize("slots", [1, 4, 8])
def test_pin_bytes_counts_the_tag_tables(slots):
    st, _ = D.make_snb_interactive(120, parts=slots)
    rt = GpuRuntime(device="cpu", delta_max_edges=64) if slots == 1 else \
        GpuRuntime(mesh=make_mesh(slots, devices=[CPU] * slots),
                   delta_max_edges=64)
    dev = rt.pin(st, "ic")
    assert dev.host.tags
    per = dev.shard_hbm_bytes()
    assert pin_bytes(dev.host, rt.mesh, dev.delta.host.nbytes()) == per
    tags = sum(a.nbytes for a in _host_tag_columns(dev.host).values())
    assert sum(per.values()) == dev.hbm_bytes() == rt.hbm_bytes()
    tagless = pin_bytes(_tagless(dev.host), rt.mesh, dev.delta.host.nbytes())
    assert sum(per.values()) - sum(tagless.values()) == tags


def _tagless(snap):
    import copy
    out = copy.copy(snap)
    out.tags = {}
    return out


# -- the SNB interactive generator ------------------------------------------


def test_make_snb_interactive_is_the_references():
    ref_st, ref_arrs = ref_datagen.make_snb_interactive(150, parts=4,
                                                        seed=23)
    st, arrs = D.make_snb_interactive(150, parts=4, seed=23)
    assert sorted(arrs) == sorted(ref_arrs)
    for k, v in ref_arrs.items():
        if isinstance(v, np.ndarray):
            assert arrs[k].dtype == v.dtype, k
            np.testing.assert_array_equal(arrs[k], v, err_msg=k)
        else:
            assert arrs[k] == v, k
    _assert_snapshots_equal(port_csr.build_snapshot(st, "ic"),
                            ref_csr.build_snapshot(ref_st, "ic"))
    root = 5
    assert D.ic5_numpy(arrs, root, IC_MIN) == \
        ref_datagen.ic5_numpy(ref_arrs, root, IC_MIN)
    assert D.ic9_numpy(arrs, root, IC_MAX) == \
        ref_datagen.ic9_numpy(ref_arrs, root, IC_MAX)


def test_chip_smokes_ic_constants_are_the_references():
    """chip_smoke.py phase 15 holds the port's IC5 and IC9 plans and
    segment programs to constants: they are the reference's, and its
    statements are this file's."""
    import chip_smoke as C
    import nebula_tpu.tpu.pipeline as ref_pipeline
    qs = C.ic_statements()
    assert (qs["IC5"], qs["IC9"]) == (IC5, IC9)
    eng = RefQueryEngine(ref_datagen.make_snb_interactive(120, parts=8)[0],
                         tpu_runtime=TpuRuntime(ref_make_mesh(1)))
    sess = eng.new_session()
    eng.execute(sess, "USE ic")
    for name, q in qs.items():
        plan = eng.execute(sess, "EXPLAIN " + q).data.rows[0][0]
        assert C.canon_plan(plan) == canon_plan(plan) == C.IC_PLANS[name]
        (rs, progs) = C.pipeline_programs(
            ref_pipeline, lambda: eng.execute(sess, q))
        assert rs.error is None and len(progs) == 1
        assert C.program_digest(progs[0]) == C.IC_PROGRAMS[name]
