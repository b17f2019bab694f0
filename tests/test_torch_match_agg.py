"""The fused MATCH aggregate (`nebula_tpu_torch.gpu.match_agg`: the
`make_match_agg_rule` fusion rule, the `TpuMatchAgg` executor, its
device and host halves) and the vertex-predicate compiler
(`gpu.exprjit.compile_vertex_predicate_np`) against the JAX package's
(`nebula_tpu.tpu.match_agg`, `nebula_tpu.tpu.exprjit`), on the CPU.

- Every test of tests/unit/test_match_agg.py runs on the port with the
  same body (`test_torch_engine.load_twin`), on four CPU runtimes:
  unsplit, degree-split at 4, a delta plane of 64 and a mesh of 8 shard
  slots.  They hold the fused node's rows to the unfused host chain's
  as a multiset, as the unit tests do.
- The same statements give the reference's device engine's rows in
  order (`TpuRuntime(make_mesh(8))`, its three fusion rules), on the
  port's device path, and the same plans.
- The port's vertex-predicate masks equal the reference's on the same
  store, expression by expression.
Tolerance: exact.
"""
import numpy as np
import pytest

from nebula_tpu.core import wire as ref_wire
from nebula_tpu.exec.engine import QueryEngine as RefQueryEngine
from nebula_tpu.tpu import TpuRuntime, make_mesh as ref_make_mesh

from nebula_tpu_torch.core import wire as port_wire
from nebula_tpu_torch.exec.engine import QueryEngine

from test_torch_engine import (DEVICE_LAYOUTS, layout_runtime, load_twin,
                               run_twin, twin_cases)
from test_torch_tck import canon_plan, ref_device_rules

# test_match_agg.py imports test_tpu's store: each package's twin of it
for _pkg in ("ref", "port"):
    load_twin("tests/unit/test_tpu.py", _pkg, replace=((
        "from nebula_tpu.tpu import TpuRuntime, make_mesh, pin_snapshot",
        "from test_torch_engine import mesh_runtime as TpuRuntime, "
        "mesh_parts as make_mesh; from nebula_tpu.tpu import pin_snapshot"),)
        if _pkg == "port" else ())
TWIN = load_twin("tests/unit/test_match_agg.py", "port", replace=(
    ("from test_tpu import", "from twin_port_test_tpu import"),
    ("from nebula_tpu.tpu import TpuRuntime, make_mesh",
     "from test_torch_engine import mesh_runtime as TpuRuntime, "
     "mesh_parts as make_mesh")))
REF_TWIN = load_twin("tests/unit/test_match_agg.py", "ref", replace=(
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


# -- rows in order against the reference's device engine --------------------


def _outcome(eng, sess, wire, q):
    rs = eng.execute(sess, q)
    assert rs.error is None, (q, rs.error)
    rows = [wire.dumps(list(r)) for r in rs.data.rows]
    plan = eng.execute(sess, "EXPLAIN " + q)
    return rows, canon_plan(plan.data.rows[0][0])


_REF = {}


def _reference(seed):
    if seed not in _REF:
        from nebula_tpu.query import optimizer as ref_opt
        st = REF_TWIN.random_store(seed, n=150, avg_deg=4)
        eng = RefQueryEngine(st, tpu_runtime=TpuRuntime(ref_make_mesh(8)))
        sess = eng.new_session()
        eng.execute(sess, "USE g")
        saved = list(ref_opt.TPU_RULES)
        ref_opt.TPU_RULES[:] = ref_device_rules()
        try:
            _REF[seed] = [_outcome(eng, sess, ref_wire, q)
                          for q in REF_TWIN.QUERIES]
        finally:
            ref_opt.TPU_RULES[:] = saved
    return _REF[seed]


@pytest.mark.parametrize("layout", DEVICE_LAYOUTS)
def test_rows_and_plans_equal_the_reference_device_engine(layout):
    want = _reference(1)
    st = TWIN.random_store(1, n=150, avg_deg=4)
    eng = QueryEngine(st, tpu_runtime=layout_runtime(layout))
    sess = eng.new_session()
    eng.execute(sess, "USE g")
    for q, (rows, plan) in zip(TWIN.QUERIES, want):
        eng.qctx.last_tpu_stats = None
        eng.qctx.last_tpu_fallback = None
        got_rows, got_plan = _outcome(eng, sess, port_wire, q)
        assert got_plan == plan and "TpuMatchAgg" in plan, q
        assert got_rows == rows, (layout, q)
        assert eng.qctx.last_tpu_stats is not None, q
        assert eng.qctx.last_tpu_fallback is None, q


# -- the vertex-predicate compiler against the reference's ------------------

def _age(E):
    return E.LabelTagProp("v", "person", "age")


def _name(E):
    return E.LabelTagProp("v", "person", "name")


def _lits(E, *vals):
    return E.ListExpr([E.Literal(x) for x in vals])


#: case id → the expression, made from a package's `core.expr` module
VERTEX_PREDICATES = {
    "age > 40": lambda E: E.Binary(">", _age(E), E.Literal(40)),
    "name == ann": lambda E: E.Binary("==", _name(E), E.Literal("ann")),
    "hastag AND age <= 25": lambda E: E.Binary(
        "AND", E.FunctionCall("_hastag", [E.LabelExpr("v"),
                                          E.Literal("person")]),
        E.Binary("<=", _age(E), E.Literal(25))),
    "unknown tag IS NULL": lambda E: E.Unary(
        "IS_NULL", E.LabelTagProp("v", "nosuch", "p")),
    "name IN list": lambda E: E.Binary(
        "IN", _name(E), _lits(E, "bob", "dee", "zed")),
    "name NOT IN a list with NULL, never true": lambda E: E.Binary(
        "NOT IN", _name(E), _lits(E, "bob", None)),
    "merged attr OR name": lambda E: E.Binary(
        "OR", E.Binary(">=", E.AttributeExpr(E.LabelExpr("v"), "age"),
                       E.Literal(30)),
        E.Binary("==", _name(E), E.Literal("cid"))),
    "NOT mod XOR div": lambda E: E.Binary(
        "XOR", E.Unary("NOT", E.Binary("==", E.Binary(
            "%", _age(E), E.Literal(7)), E.Literal(3))),
        E.Binary(">", E.Binary("/", _age(E), E.Literal(3)), E.Literal(9))),
    "id IN list": lambda E: E.Binary(
        "IN", E.FunctionCall("id", [E.LabelExpr("v")]),
        _lits(E, 3, 17, 44, 999)),
    "id == OR negated age": lambda E: E.Binary(
        "OR", E.Binary("==", E.FunctionCall("id", [E.LabelExpr("v")]),
                       E.Literal(5)),
        E.Binary("<", E.Unary("-", _age(E)), E.Literal(-60))),
    "float arithmetic AND IS NOT NULL": lambda E: E.Binary(
        "AND", E.Binary(">", E.Binary("+", _age(E), E.Literal(0.5)),
                        E.Literal(20.25)),
        E.Unary("IS_NOT_NULL", _age(E))),
    "hastag of an unknown tag": lambda E: E.FunctionCall(
        "_hastag", [E.LabelExpr("v"), E.Literal("nosuch")]),
    "bitwise": lambda E: E.Binary(
        "==", E.Binary("&", _age(E), E.Literal(6)), E.Literal(2)),
}


@pytest.mark.parametrize("case", sorted(VERTEX_PREDICATES))
def test_vertex_predicate_masks_equal_the_reference(case):
    from nebula_tpu.core import expr as ref_expr
    from nebula_tpu.graphstore.csr import build_snapshot as ref_build
    from nebula_tpu.tpu import exprjit as ref_jit
    from nebula_tpu_torch.core import expr as port_expr
    from nebula_tpu_torch.gpu import exprjit as port_jit
    from nebula_tpu_torch.graphstore.csr import build_snapshot as port_build

    masks = []
    for E, jit, build, twin in (
            (ref_expr, ref_jit, ref_build, REF_TWIN),
            (port_expr, port_jit, port_build, TWIN)):
        st = twin.random_store(9, n=80, avg_deg=3)
        e = VERTEX_PREDICATES[case](E)
        assert jit.vertex_compilable(e, "v"), case
        snap = build(st, "g")
        dense = np.arange(snap.num_parts * snap.vmax, dtype=np.int64)
        masks.append(jit.compile_vertex_predicate_np(
            e, "v", snap, st.space("g"))(dense))
    assert masks[0].dtype == masks[1].dtype == bool
    assert np.array_equal(masks[0], masks[1]), case
    assert 0 < masks[1].sum() < masks[1].size \
        or "unknown" in case or "never" in case, case
