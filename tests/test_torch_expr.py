"""The port's expression interpreter (`nebula_tpu_torch.core.expr` with
`core.functions` and `core.aggregates`) against the JAX package's
`nebula_tpu.core`, on the CPU.

Every test of tests/unit/test_expr.py runs here once a package, with the
same body (`M` is the package's namespace).  Then every variable-free
expression in a standalone `YIELD` or `RETURN` of tests/tck/features
(temporal arithmetic, `duration`, `ST_*`, casts, lists, maps and the
rest) is parsed by each package's parser and evaluated by its own
interpreter: the results must have the same type name and text form,
and NULLs the same kind; where the reference raises, the port raises the
same exception class.  The expression is the case's id.  Tolerance:
exact.
"""
import types

import pytest

import nebula_tpu.core as ref_core
import nebula_tpu.core.expr as ref_expr
import nebula_tpu.query.ast as ref_ast
import nebula_tpu.query.parser as ref_parser

import nebula_tpu_torch.core as port_core
import nebula_tpu_torch.core.expr as port_expr
import nebula_tpu_torch.query.ast as port_ast
import nebula_tpu_torch.query.parser as port_parser

from test_torch_parser import tck_programs
from test_torch_value import same_value


def _ns(core, expr):
    ns = types.SimpleNamespace(**{k: getattr(core, k) for k in dir(core)
                                  if not k.startswith("__")})
    for k in dir(expr):
        if not k.startswith("__"):
            setattr(ns, k, getattr(expr, k))
    return ns


PKGS = {"ref": _ns(ref_core, ref_expr), "port": _ns(port_core, port_expr)}


@pytest.fixture(params=sorted(PKGS))
def M(request):
    return PKGS[request.param]


# ---------------------------------------------------------------------------
# the twins of tests/unit/test_expr.py
# ---------------------------------------------------------------------------


def ev(M, e, **kw):
    return e.eval(M.DictContext(**kw))


def L(M, v):
    return M.Literal(v)


def test_arithmetic_tree(M):
    e = M.Binary("+", M.Binary("*", L(M, 2), L(M, 3)), L(M, 4))
    assert ev(M, e) == 10
    assert M.to_text(e) == "((2 * 3) + 4)"


def test_relational(M):
    assert ev(M, M.Binary("<", L(M, 1), L(M, 2))) is True
    assert ev(M, M.Binary("==", L(M, "a"), L(M, "a"))) is True
    assert M.is_null(ev(M, M.Binary(">", L(M, 1), M.Literal(M.NULL))))


def test_in_contains(M):
    assert ev(M, M.Binary("IN", L(M, 2), M.ListExpr([L(M, 1), L(M, 2)]))) is True
    assert ev(M, M.Binary("IN", L(M, 5), M.ListExpr([L(M, 1), M.Literal(M.NULL)]))) is M.NULL
    assert ev(M, M.Binary("NOT IN", L(M, 5), M.ListExpr([L(M, 1)]))) is True
    assert ev(M, M.Binary("CONTAINS", L(M, "hello"), L(M, "ell"))) is True
    assert ev(M, M.Binary("STARTS WITH", L(M, "hello"), L(M, "he"))) is True
    assert ev(M, M.Binary("ENDS WITH", L(M, "hello"), L(M, "lo"))) is True
    assert ev(M, M.Binary("=~", L(M, "abc123"), L(M, "[a-z]+\\d+"))) is True


def test_short_circuit(M):
    # rhs would raise (unknown function) but must not be evaluated
    bad = M.FunctionCall("no_such_fn", [])
    assert ev(M, M.Binary("AND", L(M, False), bad)) is False
    assert ev(M, M.Binary("OR", L(M, True), bad)) is True


def test_props(M):
    ctx = M.DictContext(input_props={"x": 7},
                      src_props={"person": {"age": 30}},
                      edge_props={"since": 2010})
    assert M.InputProp("x").eval(ctx) == 7
    assert M.SrcProp("person", "age").eval(ctx) == 30
    assert M.EdgeProp("knows", "since").eval(ctx) == 2010
    assert M.is_null(M.InputProp("missing").eval(ctx))


def test_edge_reserved_props(M):
    e = M.Edge("a", "b", "knows", 3)
    ctx = M.DictContext(edge=e)
    assert M.EdgeProp("knows", "_src").eval(ctx) == "a"
    assert M.EdgeProp("knows", "_dst").eval(ctx) == "b"
    assert M.EdgeProp("knows", "_rank").eval(ctx) == 3
    assert M.EdgeProp("knows", "_type").eval(ctx) == "knows"


def test_subscript_slice(M):
    lst = M.ListExpr([L(M, 10), L(M, 20), L(M, 30)])
    assert ev(M, M.Subscript(lst, L(M, 1))) == 20
    assert ev(M, M.Subscript(lst, L(M, -1))) == 30
    assert M.is_null(ev(M, M.Subscript(lst, L(M, 9))))
    assert ev(M, M.Slice(lst, L(M, 1), None)) == [20, 30]
    m = M.MapExpr([("a", L(M, 1))])
    assert ev(M, M.Subscript(m, L(M, "a"))) == 1


def test_attribute(M):
    v = M.Vertex("a", [M.Tag("person", {"name": "Ann"})])
    ctx = M.DictContext(variables={"v": v})
    assert M.AttributeExpr(M.LabelExpr("v"), "name").eval(ctx) == "Ann"
    assert ev(M, M.AttributeExpr(M.MapExpr([("k", L(M, 5))]), "k")) == 5


def test_case(M):
    e = M.Case([(M.Binary(">", M.InputProp("x"), L(M, 0)), L(M, "pos"))], L(M, "neg"))
    assert ev(M, e, input_props={"x": 3}) == "pos"
    assert ev(M, e, input_props={"x": -3}) == "neg"
    e2 = M.Case([(L(M, 1), L(M, "one")), (L(M, 2), L(M, "two"))], L(M, "other"), condition=M.InputProp("x"))
    assert ev(M, e2, input_props={"x": 2}) == "two"


def test_list_comprehension(M):
    e = M.ListComprehension("x", M.ListExpr([L(M, 1), L(M, 2), L(M, 3), L(M, 4)]),
                          where=M.Binary(">", M.LabelExpr("x"), L(M, 2)),
                          mapping=M.Binary("*", M.LabelExpr("x"), L(M, 10)))
    assert ev(M, e) == [30, 40]


def test_predicate(M):
    lst = M.ListExpr([L(M, 1), L(M, 2), L(M, 3)])
    assert ev(M, M.PredicateExpr("all", "x", lst, M.Binary(">", M.LabelExpr("x"), L(M, 0)))) is True
    assert ev(M, M.PredicateExpr("any", "x", lst, M.Binary(">", M.LabelExpr("x"), L(M, 2)))) is True
    assert ev(M, M.PredicateExpr("none", "x", lst, M.Binary(">", M.LabelExpr("x"), L(M, 5)))) is True
    assert ev(M, M.PredicateExpr("single", "x", lst, M.Binary("==", M.LabelExpr("x"), L(M, 2)))) is True


def test_reduce(M):
    e = M.Reduce("acc", L(M, 0), "x", M.ListExpr([L(M, 1), L(M, 2), L(M, 3)]),
               M.Binary("+", M.LabelExpr("acc"), M.LabelExpr("x")))
    assert ev(M, e) == 6


def test_functions(M):
    assert ev(M, M.FunctionCall("abs", [L(M, -5)])) == 5
    assert ev(M, M.FunctionCall("upper", [L(M, "ab")])) == "AB"
    assert ev(M, M.FunctionCall("size", [M.ListExpr([L(M, 1), L(M, 2)])])) == 2
    assert ev(M, M.FunctionCall("substr", [L(M, "hello"), L(M, 1), L(M, 3)])) == "ell"
    assert ev(M, M.FunctionCall("coalesce", [M.Literal(M.NULL), L(M, 3)])) == 3
    assert ev(M, M.FunctionCall("reverse", [L(M, "abc")])) == "cba"
    assert ev(M, M.FunctionCall("reverse",
                           [M.ListExpr([L(M, 1), L(M, 2), L(M, 3)])])) == [3, 2, 1]
    import math as _m
    assert ev(M, M.FunctionCall("atan2", [L(M, 1.0), L(M, 2.0)])) == _m.atan2(1.0, 2.0)
    assert ev(M, M.FunctionCall("split", [L(M, "a,b"), L(M, ",")])) == ["a", "b"]
    assert ev(M, M.FunctionCall("round", [L(M, 2.5)])) == 3.0
    assert ev(M, M.FunctionCall("round", [L(M, -2.5)])) == -3.0


def test_cast(M):
    assert ev(M, M.TypeCast("int", L(M, "42"))) == 42
    assert ev(M, M.TypeCast("string", L(M, 4.0))) == "4.0"
    assert ev(M, M.TypeCast("float", L(M, 3))) == 3.0
    assert ev(M, M.TypeCast("bool", L(M, "true"))) is True


def test_graph_functions(M):
    v = M.Vertex("a", [M.Tag("person", {"name": "Ann"})])
    e = M.Edge("a", "b", "knows", 0, {"w": 1})
    ctx = M.DictContext(variables={"v": v, "e": e})
    assert M.FunctionCall("id", [M.LabelExpr("v")]).eval(ctx) == "a"
    assert M.FunctionCall("tags", [M.LabelExpr("v")]).eval(ctx) == ["person"]
    assert M.FunctionCall("type", [M.LabelExpr("e")]).eval(ctx) == "knows"
    assert M.FunctionCall("src", [M.LabelExpr("e")]).eval(ctx) == "a"
    assert M.FunctionCall("properties", [M.LabelExpr("e")]).eval(ctx) == {"w": 1}


def test_aggregate_apply(M):
    a = M.AggExpr("sum", M.InputProp("x"))
    assert a.apply([1, 2, M.NULL, 3]) == 6
    assert M.AggExpr("count", None).apply([1, M.NULL]) == 2  # count(*)
    assert M.AggExpr("count", M.InputProp("x")).apply([1, M.NULL]) == 1
    assert M.AggExpr("avg", M.InputProp("x")).apply([1, 2, 3]) == 2.0
    assert M.AggExpr("max", M.InputProp("x")).apply(["a", "c", "b"]) == "c"
    assert M.AggExpr("collect", M.InputProp("x")).apply([1, M.NULL, 2]) == [1, 2]
    assert M.AggExpr("sum", M.InputProp("x"), distinct=True).apply([1, 1, 2]) == 3


def test_split_conjuncts(M):
    e = M.Binary("AND", M.Binary("AND", L(M, 1), L(M, 2)), L(M, 3))
    assert len(M.split_conjuncts(e)) == 3


def test_unary_is_null(M):
    assert ev(M, M.Unary("IS_NULL", M.Literal(M.NULL))) is True
    assert ev(M, M.Unary("IS_NOT_NULL", L(M, 1))) is True
    assert ev(M, M.Unary("NOT", L(M, False))) is True
    assert ev(M, M.Unary("-", L(M, 5))) == -5


# ---------------------------------------------------------------------------
# the TCK features' constant expressions through both interpreters
# ---------------------------------------------------------------------------

# expression kinds that read a row, a variable or a graph element
_BOUND = frozenset({"input_prop", "var", "var_prop", "src_prop", "dst_prop",
                    "edge_prop", "vertex", "edge", "label_tag_prop",
                    "aggregate", "pattern_pred", "path_build"})


def _sentences(s, ast):
    if isinstance(s, ast.SeqSentence):
        for x in s.stmts:
            yield from _sentences(x, ast)
    else:
        yield s


def _columns(tree, ast):
    """The yield columns of each standalone YIELD / RETURN statement of a
    parsed program, in order."""
    out = []
    for s in _sentences(tree, ast):
        if isinstance(s, ast.YieldSentence) and s.where is None:
            out.append(s.yield_.columns)
        elif isinstance(s, ast.MatchSentence) and not s.clauses \
                and s.return_ is not None and s.return_.columns:
            out.append(s.return_.columns)
    return out


def _constant_cases():
    """(expression text, program text, statement, column) of every
    variable-free YIELD / RETURN column, each expression once."""
    cases = {}
    for _, text in tck_programs():
        try:
            tree = ref_parser.parse(text)
        except ref_parser.ParseError:
            continue
        for i, cols in enumerate(_columns(tree, ref_ast)):
            for j, c in enumerate(cols):
                if {n.kind for n in ref_expr.walk(c.expr)} & _BOUND:
                    continue
                cases.setdefault(ref_expr.to_text(c.expr), (text, i, j))
    return sorted((k,) + v for k, v in cases.items())


def _outcome(e, ctx):
    try:
        return "value", e.eval(ctx)
    except Exception as ex:   # noqa: BLE001 — the class is compared
        return "raise", type(ex).__name__


CONSTANTS = _constant_cases()


def test_the_features_hold_constant_expressions():
    assert len(CONSTANTS) > 200


@pytest.mark.parametrize("expr,text,stmt,col", CONSTANTS,
                         ids=[c[0] for c in CONSTANTS])
def test_tck_constant_expression_matches_reference(expr, text, stmt, col):
    want_e = _columns(ref_parser.parse(text), ref_ast)[stmt][col].expr
    got_e = _columns(port_parser.parse(text), port_ast)[stmt][col].expr
    assert port_expr.to_text(got_e) == expr
    kind, want = _outcome(want_e, ref_expr.DictContext())
    pkind, got = _outcome(got_e, port_expr.DictContext())
    assert pkind == kind
    if kind == "raise":
        assert got == want
    else:
        assert same_value(got, want), (got, want)
