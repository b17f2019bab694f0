"""The GO fusion rule and its executor (`nebula_tpu_torch.gpu.traverse`:
`make_tpu_rule`, the `TpuTraverse` executor over `GpuRuntime.traverse`)
against the JAX package's (`nebula_tpu.tpu.traverse`), on the CPU.

- The GO halves of tests/unit/test_tpu.py run on the port with the same
  body (`test_torch_engine.load_twin`), each on three local CPU
  runtimes: unsplit, degree-split at 4, and with a delta plane of 64.
- The same statements, with nGQL writes between them on the plane's
  engine, give the same rows on the port's device engine as on the
  reference's device engine (`TpuRuntime(make_mesh(8))` on the virtual
  CPU mesh) and its host engine, by `core.wire` bytes as a multiset.
- Each refusal of the rule (carry, limit, sample, an m-to-n branch, a
  non-compilable filter, duplicate literal vids at one step, a
  non-yieldable column) gives the reference's device plan, with the
  reference's GO rule alone in its `optimizer.TPU_RULES`.
- Divergence 12 (ROADMAP): a device error in a fused GO, and in each
  device branch of MATCH, FIND PATH, GET SUBGRAPH, the fused MATCH
  aggregate and CALL algo.*, propagates as the statement's error; only
  `CannotCompile` takes the host path; `SnapshotRetired` reruns.
- MATCH, FIND PATH and GET SUBGRAPH ask the runtime in device mode, and
  CALL algo.* gives the oracle's rows (tests/test_torch_gpu_match.py,
  test_torch_match_agg.py and test_torch_algo_engine.py hold them
  whole).
Tolerance: exact.
"""
import pytest

from nebula_tpu.exec.engine import QueryEngine as RefQueryEngine
from nebula_tpu.core import wire as ref_wire
from nebula_tpu.tpu import TpuRuntime, make_mesh as ref_make_mesh

from nebula_tpu_torch.core import wire as port_wire
from nebula_tpu_torch.exec.engine import QueryEngine
from nebula_tpu_torch.exec.executors import EXECUTORS, ExecError
from nebula_tpu_torch.gpu import CannotCompile, GpuRuntime, GpuUnavailable
from nebula_tpu_torch.utils.stats import stats

from test_torch_engine import layout_runtime, load_twin, run_twin
from test_torch_tck import canon_plan

TWIN = load_twin("tests/unit/test_tpu.py", "port", replace=((
    "from nebula_tpu.tpu import TpuRuntime, make_mesh, pin_snapshot",
    "from test_torch_engine import flag_runtime as TpuRuntime, "
    "no_mesh as make_mesh; from nebula_tpu.tpu import pin_snapshot"),))
REF_TWIN = load_twin("tests/unit/test_tpu.py", "ref")

GO_TESTS = ["test_engine_fusion_end_to_end", "test_mton_and_piped_go_parity",
            "test_write_invalidates_snapshot", "test_not_compilable",
            "test_string_ordering_falls_back",
            "test_temporal_and_overflow_predicates_fall_back",
            "test_yield_fusion_columnar_parity",
            "test_non_yieldable_keeps_project",
            "test_over_all_direction_combos_parity"]

LAYOUTS = ("unsplit", "split", "plane")


_REF_RT = []


def ref_rt():
    if not _REF_RT:
        _REF_RT.append(TpuRuntime(ref_make_mesh(8)))
    return _REF_RT[0]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", GO_TESTS)
def test_go_half_of_test_tpu(name, layout):
    run_twin(TWIN, name, {}, {"rt": layout_runtime(layout)})


# -- rows against the reference's device engine -----------------------------

STATEMENTS = [
    "GO 3 STEPS FROM 3, 17, 44 OVER knows WHERE knows.w > 10 "
    "YIELD src(edge) AS s, dst(edge) AS d, knows.w AS w",
    "GO 1 TO 3 STEPS FROM 3 OVER knows YIELD src(edge), dst(edge)",
    "GO FROM 3 OVER knows YIELD dst(edge) AS d "
    "| GO FROM $-.d OVER knows YIELD $-.d, dst(edge)",
    'GO 2 STEPS FROM 3, 17 OVER knows WHERE knows.tag < "m" '
    "YIELD src(edge), rank(edge), dst(edge)",
    "GO 2 STEPS FROM 3, 17 OVER knows "
    "YIELD src(edge) AS s, dst(edge) AS d, rank(edge) AS r, "
    "type(edge) AS t, knows.w AS w, knows.tag AS g, 7 AS c",
    "GO 2 STEPS FROM 3, 17 OVER knows REVERSELY "
    "YIELD src(edge), dst(edge), knows.tag",
    "GO 3 STEPS FROM 3 OVER knows WHERE knows.w > 20 "
    "YIELD dst(edge), knows.w, knows.f",
    "GO 2 STEPS FROM 3 OVER knows YIELD dst(edge) AS d, $$.person.age AS a",
    "GO 2 STEPS FROM 3, 7 OVER * REVERSELY "
    "YIELD src(edge), dst(edge), rank(edge)",
    "GO 2 STEPS FROM 3, 7 OVER * BIDIRECT YIELD src(edge), dst(edge)",
    "GO 2 STEPS FROM 3 OVER knows, likes REVERSELY "
    "YIELD type(edge), dst(edge)",
    "GO 2 STEPS FROM 3, 17 OVER knows",
    "GO 3 STEPS FROM 3, 17 OVER knows BIDIRECT WHERE knows.f < 0.5 "
    "AND knows.w IS NOT NULL YIELD src(edge), dst(edge), knows.f",
]

WRITES = [
    'INSERT EDGE knows(w, f, tag) VALUES 3->90@7:(55, 0.25, "zz"), '
    '90->17@0:(60, 0.5, "ann"), 17->3@9:(5, 0.75, "bob")',
    "DELETE EDGE knows 3->90@7",
    "UPDATE EDGE ON knows 17->3@9 SET w = 99",
    'INSERT EDGE knows(w, f, tag) VALUES 44->5@3:(70, 0.125, "cid")',
]


class _Side:
    def __init__(self, engine_cls, store, rt, wire):
        self.eng = engine_cls(store, tpu_runtime=rt)
        self.sess = self.eng.new_session()
        self.wire = wire
        assert self.eng.execute(self.sess, "USE g").error is None

    def rows(self, q):
        rs = self.eng.execute(self.sess, q)
        assert rs.error is None, (q, rs.error)
        return list(rs.data.column_names), \
            sorted(self.wire.dumps(list(r)) for r in rs.data.rows)

    def plan(self, q):
        rs = self.eng.execute(self.sess, "EXPLAIN " + q)
        assert rs.error is None, (q, rs.error)
        return rs.data.rows[0][0]


def _stores(seed):
    return REF_TWIN.random_store(seed, extra_edge_type=True), \
        TWIN.random_store(seed, extra_edge_type=True)


_REF_ROWS = {}


def _reference_rows():
    """{(writes applied, statement): rows} of the reference's host
    engine, made once for the layouts; its device engine gives the same
    rows before the writes and after them all (each write re-pins it
    and compiles its programs anew: the stages between are held to the
    host engine alone)."""
    if not _REF_ROWS:
        ref_st, _ = _stores(21)
        ref_dev = _Side(RefQueryEngine, ref_st, ref_rt(), ref_wire)
        ref_host = _Side(RefQueryEngine, ref_st, None, ref_wire)
        for k in range(len(WRITES) + 1):
            for q in STATEMENTS:
                _REF_ROWS[k, q] = ref_host.rows(q)
                if k in (0, len(WRITES)):
                    assert ref_dev.rows(q) == _REF_ROWS[k, q], q
            if k < len(WRITES):
                rs = ref_host.eng.execute(ref_host.sess, WRITES[k])
                assert rs.error is None, (WRITES[k], rs.error)
    return _REF_ROWS


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_rows_equal_the_reference_device_engine(layout):
    """Every statement, then each nGQL write between statements: the
    port's device engine (each layout), the reference's device engine
    on its 8-device mesh and its host engine give the same rows; every
    fused statement ran on the port's device path."""
    want = _reference_rows()
    _, port_st = _stores(21)
    rt = layout_runtime(layout)
    port_dev = _Side(QueryEngine, port_st, rt, port_wire)
    pins = stats().snapshot().get("tpu_pins", 0)
    for k in range(len(WRITES) + 1):
        for q in STATEMENTS:
            port_dev.eng.qctx.last_tpu_stats = None
            port_dev.eng.qctx.last_tpu_fallback = None
            assert port_dev.rows(q) == want[k, q], (layout, k, q)
            fused = "TpuTraverse" in port_dev.plan(q)
            # last_tpu_stats is thread-local, and an m-to-n plan's
            # branches run on the scheduler's threads
            if fused and "tag <" not in q and " TO " not in q:
                assert port_dev.eng.qctx.last_tpu_stats is not None, q
                assert port_dev.eng.qctx.last_tpu_fallback is None, q
        if k < len(WRITES):
            rs = port_dev.eng.execute(port_dev.sess, WRITES[k])
            assert rs.error is None, (WRITES[k], rs.error)
    if layout == "plane":
        # the plane folded every write: one pin for the whole run
        assert stats().snapshot().get("tpu_pins", 0) == pins + 1
        assert rt.snapshots["g"].delta.host.total_edges() > 0


def test_a_filter_past_the_interpreter_limits_takes_the_host_path():
    """`CannotCompile` (divergence 5's program limits) is the one cause
    the executor answers from the host; it is recorded."""
    ref_st, port_st = _stores(22)
    where = " OR ".join(f"knows.w == {i}" for i in range(140))
    q = f"GO 2 STEPS FROM 3, 17 OVER knows WHERE {where} YIELD dst(edge)"
    port = _Side(QueryEngine, port_st, layout_runtime("unsplit"), port_wire)
    port.eng.qctx.last_tpu_fallback = None
    assert port.rows(q) == _Side(RefQueryEngine, ref_st, None,
                                 ref_wire).rows(q)
    assert "TpuTraverse" in port.plan(q)
    assert port.eng.qctx.last_tpu_fallback.startswith("CannotCompile")


# -- the rule's refusals against the reference's plans -----------------------

#: (statement, what stays of the host plan where the rule refuses)
REFUSALS = {
    "carry": ("GO FROM 3 OVER knows YIELD dst(edge) AS d, knows.w AS w "
              "| GO FROM $-.d OVER knows YIELD $-.w AS w0, dst(edge) AS d2",
              "ExpandAll"),
    "limit": ("GO 2 STEPS FROM 3 OVER knows YIELD dst(edge) AS d "
              "LIMIT [1, 2]", "ExpandAll"),
    "m-to-n branch": ("GO 2 TO 3 STEPS FROM 3 OVER knows "
                      "YIELD dst(edge) AS d", "ExpandAll"),
    "non-compilable filter": ('GO 2 STEPS FROM 3 OVER knows WHERE '
                              'knows.tag CONTAINS "a" YIELD dst(edge)',
                              "ExpandAll"),
    "duplicate literal vids": ("GO FROM 3, 3, 17 OVER knows "
                               "YIELD dst(edge) AS d", "ExpandAll"),
    "non-yieldable column": ("GO 2 STEPS FROM 3 OVER knows "
                             "YIELD dst(edge) AS d, $$.person.age AS a",
                             "Project#"),
}


def _ref_device_plan(eng, sess, q):
    import nebula_tpu.tpu.traverse as ref_traverse
    from nebula_tpu.query import optimizer as ref_opt
    saved = list(ref_opt.TPU_RULES)
    ref_opt.TPU_RULES[:] = [ref_traverse.make_tpu_rule]
    try:
        rs = eng.execute(sess, "EXPLAIN " + q)
    finally:
        ref_opt.TPU_RULES[:] = saved
    assert rs.error is None, (q, rs.error)
    return canon_plan(rs.data.rows[0][0])


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusal_matches_the_reference_plan(case):
    q, kept = REFUSALS[case]
    ref_st, port_st = _stores(23)
    ref = _Side(RefQueryEngine, ref_st, ref_rt(), ref_wire)
    port = _Side(QueryEngine, port_st, layout_runtime("unsplit"), port_wire)
    want = _ref_device_plan(ref.eng, ref.sess, q)
    got = canon_plan(port.plan(q))
    assert got == want, (case, got, want)
    assert kept in got, (case, got)
    assert port.rows(q) == _Side(RefQueryEngine, ref_st, None,
                                 ref_wire).rows(q), case


def _one_step_chain(PlanNode, **args):
    start = PlanNode("Start", deps=[], col_names=[])
    a = {"space": "g", "edge_types": ["knows"], "direction": "out",
         "src_col": None, "vids": [3, 17], "edge_filter": None,
         "limit": None, "sample": None, "carry": []}
    a.update(args)
    return PlanNode("ExpandAll", deps=[start], args=a,
                    col_names=["_src", "_edge", "_dst"])


@pytest.mark.parametrize("args", [{"sample": 2}, {"limit": 1},
                                  {"carry": ["x"]}, {}])
def test_rule_on_a_chain_node_matches_the_reference(args):
    """The refusals no statement reaches (the planner never sets an
    ExpandAll's `sample`): both rules on the same one-step chain."""
    from nebula_tpu.query.plan import PlanNode as RefPlanNode
    from nebula_tpu.tpu.traverse import make_tpu_rule as ref_rule
    from nebula_tpu_torch.gpu.traverse import make_tpu_rule as port_rule
    from nebula_tpu_torch.query.plan import PlanNode
    got = port_rule({})(_one_step_chain(PlanNode, **args))
    want = ref_rule({})(_one_step_chain(RefPlanNode, **args))
    assert (got is None) == (want is None) == bool(args)
    if got is not None:
        assert (got.kind, got.args, got.col_names) == \
            (want.kind, want.args, want.col_names)


# -- divergence 12: a device error propagates --------------------------------


def test_device_error_in_fused_go_propagates(monkeypatch):
    """Divergence 12: the reference answers a fused GO from the host
    after `TpuUnavailable` (tpu/traverse.py:167-174); the port's executor
    lets a `GpuUnavailable` (a CUDA error, a failed kernel build) be the
    statement's error, and records no fallback."""
    _, port_st = _stores(24)
    rt = layout_runtime("unsplit")
    port = _Side(QueryEngine, port_st, rt, port_wire)
    q = "GO 2 STEPS FROM 3, 17 OVER knows YIELD dst(edge) AS d"

    def broken(*a, **k):
        raise GpuUnavailable("the card fell off the bus")
    monkeypatch.setattr(rt, "traverse", broken)
    port.eng.qctx.last_tpu_fallback = None
    rs = port.eng.execute(port.sess, q)
    assert rs.error == "ExecutionError: the card fell off the bus"
    assert port.eng.qctx.last_tpu_fallback is None
    # the executor itself raises it
    assert "TpuTraverse" in port.plan(q)
    from nebula_tpu_torch.query.plan import PlanNode
    node = PlanNode("TpuTraverse", deps=[], args={
        "space": "g", "edge_types": ["knows"], "direction": "out",
        "vids": [3], "steps": 2, "edge_filter": None, "yields": None},
        col_names=["_src", "_edge", "_dst"])
    with pytest.raises(GpuUnavailable):
        EXECUTORS["TpuTraverse"](node, port.eng.qctx, None, "g")

    def refusing(*a, **k):
        raise CannotCompile("not expressible")
    monkeypatch.setattr(rt, "traverse", refusing)
    host = _Side(QueryEngine, port_st, None, port_wire)
    assert port.rows(q) == host.rows(q)
    assert port.eng.qctx.last_tpu_fallback == \
        "CannotCompile: not expressible"


def test_a_retired_snapshot_reruns_on_the_device(monkeypatch):
    """A compaction's swap or a rebuild retires the snapshot a run holds
    (`SnapshotRetired`): no fault, the executor runs the call again, up
    to `RETIRED_ATTEMPTS` runs, and takes no host path."""
    from nebula_tpu_torch.gpu import SnapshotRetired
    from nebula_tpu_torch.gpu.traverse import RETIRED_ATTEMPTS
    _, port_st = _stores(27)
    rt = layout_runtime("plane")
    port = _Side(QueryEngine, port_st, rt, port_wire)
    host = _Side(QueryEngine, port_st, None, port_wire)
    q = "GO 2 STEPS FROM 3, 17 OVER knows YIELD dst(edge) AS d"
    real, calls = rt.traverse, []

    def retire_first(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise SnapshotRetired("retired by a concurrent pin")
        return real(*a, **k)
    monkeypatch.setattr(rt, "traverse", retire_first)
    port.eng.qctx.last_tpu_fallback = None
    assert port.rows(q) == host.rows(q)
    assert len(calls) == 2 and port.eng.qctx.last_tpu_fallback is None

    def retire_always(*a, **k):
        calls.append(1)
        raise SnapshotRetired("retired by a concurrent pin")
    calls.clear()
    monkeypatch.setattr(rt, "traverse", retire_always)
    rs = port.eng.execute(port.sess, q)
    assert rs.error == "ExecutionError: retired by a concurrent pin"
    assert len(calls) == RETIRED_ATTEMPTS


def test_a_space_the_mesh_cannot_lay_out_takes_the_host_path():
    """A space of 4 parts on the 8-slot mesh: `MeshLayoutRefused`, both a
    `GpuUnavailable` (the runtime's callers) and a `CannotCompile` (the
    executor's host path), as the reference's mesh answers such a GO
    from the host."""
    import torch
    from nebula_tpu_torch.gpu import make_mesh
    from nebula_tpu_torch.gpu.device import MeshLayoutRefused
    from nebula_tpu_torch.graphstore.schema import PropDef, PropType
    from nebula_tpu_torch.graphstore.store import GraphStore
    st = GraphStore()
    st.create_space("g", partition_num=4, vid_type="INT64")
    st.catalog.create_edge("g", "knows", [PropDef("w", PropType.INT64)])
    for s_, d in ((1, 2), (2, 3), (3, 1), (2, 4)):
        st.insert_edge("g", s_, "knows", d, 0, {"w": s_ * 10 + d})
    rt = GpuRuntime(mesh=make_mesh(8, devices=[torch.device("cpu")] * 8))
    with pytest.raises(MeshLayoutRefused) as ex:
        rt.pin(st, "g")
    assert isinstance(ex.value, GpuUnavailable) and \
        isinstance(ex.value, CannotCompile)
    port = _Side(QueryEngine, st, rt, port_wire)
    q = "GO 2 STEPS FROM 1 OVER knows YIELD dst(edge) AS d, knows.w AS w"
    port.eng.qctx.last_tpu_fallback = None
    assert port.rows(q) == _Side(QueryEngine, st, None, port_wire).rows(q)
    assert port.eng.qctx.last_tpu_fallback.startswith("MeshLayoutRefused")


def test_reference_falls_back_on_a_device_error(monkeypatch):
    """The other half of divergence 12: the reference's executor answers
    from the host after `TpuUnavailable`."""
    from nebula_tpu.tpu.device import TpuUnavailable
    ref_st, _ = _stores(24)
    rt = TpuRuntime(ref_make_mesh(8))

    def broken(*a, **k):
        raise TpuUnavailable("no device")
    monkeypatch.setattr(rt, "traverse", broken)
    ref = _Side(RefQueryEngine, ref_st, rt, ref_wire)
    q = "GO 2 STEPS FROM 3, 17 OVER knows YIELD dst(edge) AS d"
    assert ref.rows(q) == _Side(RefQueryEngine, ref_st, None,
                                ref_wire).rows(q)
    assert ref.eng.qctx.last_tpu_fallback == "TpuUnavailable: no device"


# -- MATCH, FIND PATH, GET SUBGRAPH and CALL algo on the device ---------------

DEVICE_BRANCHES = [
    "MATCH (a:person)-[e:knows*1..2]->(b) WHERE id(a) == 3 "
    "RETURN id(b) AS b",
    "FIND SHORTEST PATH FROM 3 TO 17 OVER knows YIELD path AS p",
    "FIND ALL PATH FROM 3 TO 17 OVER knows UPTO 2 STEPS YIELD path AS p",
    "GET SUBGRAPH 1 STEPS FROM 3 OUT knows YIELD vertices AS v, "
    "edges AS e",
]


def _counting(monkeypatch, rt):
    """Count the runtime's device calls by method name."""
    calls = {}
    for name in ("traverse", "traverse_hops", "bfs", "algo_dispatch"):
        real = getattr(rt, name)

        def counted(*a, _name=name, _real=real, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(rt, name, counted)
    return calls


@pytest.mark.parametrize("q", DEVICE_BRANCHES)
def test_match_paths_and_subgraph_ask_the_runtime(q, monkeypatch):
    """Their device halves ask the runtime (the BFS for the shortest
    path, `traverse_hops` for the others), and the rows are the
    reference's device and host engines' and the port's host engine's,
    as a multiset."""
    ref_st, port_st = _stores(25)
    rt = layout_runtime("unsplit")
    calls = _counting(monkeypatch, rt)
    port = _Side(QueryEngine, port_st, rt, port_wire)
    port.eng.qctx.last_tpu_fallback = None
    got = port.rows(q)
    assert calls == ({"bfs": 1} if "SHORTEST" in q
                     else {"traverse_hops": 1}), calls
    assert port.eng.qctx.last_tpu_fallback is None
    assert got == _Side(QueryEngine, port_st, None, port_wire).rows(q)
    assert got == _Side(RefQueryEngine, ref_st, None, ref_wire).rows(q)
    assert got == _Side(RefQueryEngine, ref_st, ref_rt(), ref_wire).rows(q)


def test_call_algo_rows_equal_the_oracle(monkeypatch):
    """CALL algo.* runs on the runtime's step kernels (one dispatch an
    iteration), or by the numpy oracle without a runtime, with the
    reference's host engine's rows; a parameter the engine refuses is an
    `ExecError`."""
    ref_st, port_st = _stores(26)
    q = "CALL algo.wcc() YIELD vid, component"
    want = _Side(RefQueryEngine, ref_st, None, ref_wire).rows(q)
    for rt in (None, layout_runtime("unsplit")):
        calls = {} if rt is None else _counting(monkeypatch, rt)
        port = _Side(QueryEngine, port_st, rt, port_wire)
        assert port.rows(q) == want
        assert port.rows('CALL algo.wcc(mode="host") YIELD vid, '
                         'component') == want
        assert (calls.get("algo_dispatch", 0) > 0) == (rt is not None)
    from nebula_tpu_torch.query.plan import PlanNode
    node = PlanNode("CallAlgo", deps=[], args={
        "algo": "wcc", "space": "g", "params": {"mode": "nowhere"},
        "yield": [("vid", "vid")]}, col_names=["vid"])
    with pytest.raises(ExecError, match="mode must be one of"):
        EXECUTORS["CallAlgo"](node, port.eng.qctx, None, "g")


# -- divergence 12 on every device branch ------------------------------------

#: (statement, the runtime method its device branch calls)
BRANCH_CALLS = {
    "MATCH": ("MATCH (a:person)-[e:knows*1..2]->(b) WHERE id(a) IN [3, 17] "
              "RETURN id(b) AS b", "traverse_hops"),
    "FIND SHORTEST PATH": ("FIND SHORTEST PATH FROM 3 TO 17, 44 OVER knows "
                           "UPTO 4 STEPS YIELD path AS p", "bfs"),
    "FIND ALL PATH": ("FIND ALL PATH FROM 3 TO 17 OVER knows UPTO 2 STEPS "
                      "YIELD path AS p", "traverse_hops"),
    "FIND NOLOOP PATH": ("FIND NOLOOP PATH FROM 3 TO 17 OVER knows UPTO 3 "
                         "STEPS YIELD path AS p", "traverse_hops"),
    "GET SUBGRAPH": ("GET SUBGRAPH 2 STEPS FROM 3 OUT knows "
                     "YIELD vertices AS v, edges AS e", "traverse_hops"),
    "TpuMatchAgg": ("MATCH (a:person)-[e:knows*1..3]->(b) WHERE id(a) IN "
                    "[1, 2] RETURN count(*) AS c", "traverse_hops"),
    "CALL algo": ("CALL algo.pagerank(max_iter=5, tol=0.0)",
                  "algo_dispatch"),
}


@pytest.mark.parametrize("branch", sorted(BRANCH_CALLS))
def test_device_error_in_each_branch_propagates(branch, monkeypatch):
    """Divergence 12 on each device branch: a `GpuUnavailable` from the
    runtime is the statement's error and no fallback is recorded; a
    `CannotCompile` takes the host path, recorded (CALL algo.* has no
    host path on a device engine: divergence 4); a `SnapshotRetired`
    reruns the device call."""
    from nebula_tpu_torch.gpu import SnapshotRetired
    q, method = BRANCH_CALLS[branch]
    _, port_st = _stores(28)
    rt = layout_runtime("unsplit")
    port = _Side(QueryEngine, port_st, rt, port_wire)
    host = _Side(QueryEngine, port_st, None, port_wire)
    real = getattr(rt, method)
    if branch == "TpuMatchAgg":
        assert "TpuMatchAgg" in port.plan(q)

    def raising(exc):
        def call(*a, **k):
            raise exc
        return call
    monkeypatch.setattr(rt, method,
                        raising(GpuUnavailable("the card fell off the bus")))
    port.eng.qctx.last_tpu_fallback = None
    rs = port.eng.execute(port.sess, q)
    assert rs.error == "ExecutionError: the card fell off the bus", rs.error
    assert port.eng.qctx.last_tpu_fallback is None

    calls = []

    def retire_first(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise SnapshotRetired("retired by a concurrent pin")
        return real(*a, **k)
    monkeypatch.setattr(rt, method, retire_first)
    want = host.rows(q) if branch != "CALL algo" else None
    if want is not None:
        assert port.rows(q) == want
        assert len(calls) >= 2 and port.eng.qctx.last_tpu_fallback is None

        monkeypatch.setattr(rt, method,
                            raising(CannotCompile("not expressible")))
        assert port.rows(q) == want
        assert port.eng.qctx.last_tpu_fallback == \
            "CannotCompile: not expressible"
