"""The device halves of MATCH, FIND PATH and GET SUBGRAPH through the
port's engine (`exec.executors._traverse_device`, `gpu.paths.
find_shortest_device`, `exec.algorithms.find_path_device` and
`subgraph_device`) against the JAX package's, on the CPU.

- test_tpu.py's shortest-path, MATCH, SUBGRAPH, PATH and fuzz tests run
  on the port with the same body (`test_torch_engine.load_twin`), each
  on four CPU runtimes: unsplit, degree-split at 4, a delta plane of
  64, and a mesh of 8 shard slots (the store's part count).  They hold
  the device engine's rows to the host engine's as those tests require
  (a multiset for MATCH, byte-identical for SUBGRAPH and the sorted
  path rows) and check that the device path ran.
- The same statements give the reference's device engine's rows IN
  ORDER (its `TpuRuntime(make_mesh(8))` on the virtual CPU mesh, with
  its GO and MATCH-aggregate rules alone: the MATCH pipeline rule is
  ROADMAP A5b part 2), every statement on the port's device path.
- Each statement's optimized plan equals the reference's device plan
  with those two rules.
Tolerance: exact.
"""
import pytest

from nebula_tpu.core import wire as ref_wire
from nebula_tpu.exec.engine import QueryEngine as RefQueryEngine
from nebula_tpu.tpu import TpuRuntime, make_mesh as ref_make_mesh

from nebula_tpu_torch.core import wire as port_wire
from nebula_tpu_torch.exec.engine import QueryEngine

from test_torch_engine import (DEVICE_LAYOUTS, layout_runtime, load_twin,
                               run_twin, twin_cases)
from test_torch_tck import canon_plan, ref_device_rules

TWIN = load_twin("tests/unit/test_tpu.py", "port", replace=((
    "from nebula_tpu.tpu import TpuRuntime, make_mesh, pin_snapshot",
    "from test_torch_engine import mesh_runtime as TpuRuntime, "
    "mesh_parts as make_mesh; from nebula_tpu.tpu import pin_snapshot"),))
REF_TWIN = load_twin("tests/unit/test_tpu.py", "ref")

#: test_tpu.py's tests of the device halves this slice ports
DEVICE_TESTS = {
    "test_find_shortest_path_device_parity",
    "test_find_shortest_multi_src_dst_device_parity",
    "test_match_traverse_device_parity", "test_match_device_engages",
    "test_match_multi_etype_prop_pred_hybrid",
    "test_subgraph_device_parity", "test_subgraph_device_engages",
    "test_find_path_device_parity", "test_find_path_device_engages",
    "test_filtered_shortest_path_device_parity",
    "test_filtered_shortest_path_multi_etype_falls_back",
    "test_bfs_single_compile_at_static_bounds",
    "test_device_parity_fuzz",
}
CASES = [c for c in twin_cases(TWIN) if c[0] in DEVICE_TESTS]


@pytest.mark.parametrize("layout", DEVICE_LAYOUTS)
@pytest.mark.parametrize("name,kw", [c[:2] for c in CASES],
                         ids=[c[2] for c in CASES])
def test_device_half_of_test_tpu(name, kw, layout):
    run_twin(TWIN, name, kw, {"rt": layout_runtime(layout)})


def test_every_device_test_has_a_twin():
    assert {c[0] for c in CASES} == DEVICE_TESTS
    assert {c[0] for c in twin_cases(REF_TWIN)} >= DEVICE_TESTS


# -- rows in order against the reference's device engine --------------------

#: (statement, whether the host engine's rows come in the same order)
STATEMENTS = (
    [(q, False) for q in TWIN.MATCH_QS]
    + [(q, True) for q in TWIN.SUBGRAPH_QS + TWIN.PATH_QS]
    + [(q, True) for q in TWIN.SHORTEST_FILTER_QS[:2]]
    + [("FIND SHORTEST PATH FROM 1, 7 TO 40, 9 OVER knows BIDIRECT "
        "UPTO 5 STEPS YIELD path AS p", True),
       ("FIND SHORTEST PATH FROM 3 TO 44, 2 OVER knows REVERSELY "
        "UPTO 5 STEPS YIELD path AS p", True),
       ("MATCH (a:person)-[e:knows*1..3]->(b) WHERE id(a) IN [1, 2, 3] "
        "AND e.w > 20 RETURN id(a), id(b), size(e)", False),
       ("MATCH (a:person)-[e:knows*1..2]-(b) WHERE id(a) IN [4, 8] "
        "RETURN id(b), e", False)])


#: the parser reads `FROM 5 IN knows` as the vid expression `5 IN knows`
#: (NULL), in both packages: that statement has no start and never
#: reaches a runtime
NO_START = "GET SUBGRAPH 2 STEPS FROM 5 IN knows YIELD VERTICES AS v, " \
    "EDGES AS e"
assert NO_START in TWIN.SUBGRAPH_QS


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
            [self.wire.dumps(list(r)) for r in rs.data.rows]

    def plan(self, q):
        rs = self.eng.execute(self.sess, "EXPLAIN " + q)
        assert rs.error is None, (q, rs.error)
        return canon_plan(rs.data.rows[0][0])


_REF = {}


def _reference():
    """{statement: (device rows, host rows, device plan)} of the
    reference's engines on `random_store(21)`, with its GO and
    MATCH-aggregate rules alone."""
    if not _REF:
        from nebula_tpu.query import optimizer as ref_opt
        st = REF_TWIN.random_store(21)
        dev = _Side(RefQueryEngine, st, TpuRuntime(ref_make_mesh(8)),
                    ref_wire)
        host = _Side(RefQueryEngine, st, None, ref_wire)
        saved = list(ref_opt.TPU_RULES)
        ref_opt.TPU_RULES[:] = ref_device_rules()
        try:
            for q, _ in STATEMENTS:
                dev.eng.qctx.last_tpu_fallback = None
                _REF[q] = (dev.rows(q), host.rows(q), dev.plan(q))
                assert dev.eng.qctx.last_tpu_fallback is None \
                    or "CONTAINS" in q, q
        finally:
            ref_opt.TPU_RULES[:] = saved
    return _REF


@pytest.mark.parametrize("layout", DEVICE_LAYOUTS)
def test_rows_equal_the_reference_device_engine_in_order(layout):
    """Every statement on the port's device engine: the reference's
    device rows in order, the host engine's rows as its tests require,
    the runtime asked, no host fallback."""
    want = _reference()
    port = _Side(QueryEngine, TWIN.random_store(21), layout_runtime(layout),
                 port_wire)
    for q, same_order in STATEMENTS:
        port.eng.qctx.last_tpu_stats = None
        port.eng.qctx.last_tpu_fallback = None
        got = port.rows(q)
        dev_rows, host_rows, _ = want[q]
        assert got == dev_rows, (layout, q)
        if same_order:
            assert got == host_rows, (layout, q)
        else:
            assert sorted(got[1]) == sorted(host_rows[1]), (layout, q)
        assert (port.eng.qctx.last_tpu_stats is not None) \
            == (q != NO_START), (layout, q)
        assert port.eng.qctx.last_tpu_fallback is None, (layout, q)


def test_plans_equal_the_reference_device_plans():
    want = _reference()
    port = _Side(QueryEngine, TWIN.random_store(21),
                 layout_runtime("unsplit"), port_wire)
    for q, _ in STATEMENTS:
        assert port.plan(q) == want[q][2], q
