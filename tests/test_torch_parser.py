"""The port's nGQL front end (`nebula_tpu_torch.query`: tokenizer, AST,
parser) against the JAX package's `nebula_tpu.query`, on the CPU.

Every test of tests/unit/test_parser.py runs here once a package, with
the same body (`M` is the package's namespace).  Then every query and
set-up step of tests/tck/features/*.feature (each a program of one or
more `;`-separated statements) is parsed by both parsers: either both
raise ParseError with the same message, or the two ASTs are equal under
a structural walk (same class names, same fields, every expression node
of the same class with the same `to_text` and the same children, every
value of the same type name and text form).  The statement is the case's
id.
"""
import dataclasses
import glob
import os
import types

import pytest

import nebula_tpu.core.expr as ref_expr
import nebula_tpu.query.ast as ref_ast
import nebula_tpu.query.parser as ref_parser

import nebula_tpu_torch.core.expr as port_expr
import nebula_tpu_torch.query.ast as port_ast
import nebula_tpu_torch.query.parser as port_parser

from tck.runner import parse_feature
from test_torch_value import same_value


def _ns(expr, ast, parser):
    ns = types.SimpleNamespace(**{k: getattr(expr, k) for k in dir(expr)
                                  if not k.startswith("__")})
    ns.A, ns.parse, ns.ParseError = ast, parser.parse, parser.ParseError
    return ns


PKGS = {"ref": _ns(ref_expr, ref_ast, ref_parser),
        "port": _ns(port_expr, port_ast, port_parser)}


@pytest.fixture(params=sorted(PKGS))
def M(request):
    return PKGS[request.param]


# ---------------------------------------------------------------------------
# the twins of tests/unit/test_parser.py
# ---------------------------------------------------------------------------


def test_go_basic(M):
    s = M.parse('GO FROM "a" OVER knows')
    assert isinstance(s, M.A.GoSentence)
    assert s.steps.m == 1 and s.steps.n == 1
    assert s.over.edges == ["knows"]
    assert s.from_.vids[0].value == "a"


def test_go_full(M):
    s = M.parse('GO 2 TO 4 STEPS FROM "a","b" OVER knows, likes REVERSELY '
              'WHERE knows.since > 2010 YIELD DISTINCT dst(edge) AS d, $$.person.age')
    assert s.steps.m == 2 and s.steps.n == 4
    assert s.over.direction == "in"
    assert s.over.edges == ["knows", "likes"]
    assert len(s.from_.vids) == 2
    assert s.yield_.distinct
    assert s.yield_.columns[0].alias == "d"
    assert M.to_text(s.where.filter) == "(knows.since > 2010)"


def test_go_over_star_pipe(M):
    s = M.parse('GO FROM "a" OVER * YIELD dst(edge) AS d | GO FROM $-.d OVER knows')
    assert isinstance(s, M.A.PipedSentence)
    assert s.left.over.is_all
    assert s.right.from_.ref is not None
    assert isinstance(s.right.from_.ref, M.InputProp)


def test_assignment_and_seq(M):
    s = M.parse('$var = GO FROM "a" OVER e YIELD dst(edge) AS d; YIELD $var.d')
    assert isinstance(s, M.A.SeqSentence)
    assert isinstance(s.stmts[0], M.A.AssignSentence)
    assert s.stmts[0].var == "var"


def test_ddl_space(M):
    s = M.parse("CREATE SPACE IF NOT EXISTS s1 (partition_num=4, replica_factor=1, "
              "vid_type=FIXED_STRING(20))")
    assert isinstance(s, M.A.CreateSpaceSentence)
    assert s.if_not_exists and s.partition_num == 4
    assert s.vid_type == "FIXED_STRING(20)"
    s2 = M.parse("DROP SPACE IF EXISTS s1")
    assert s2.if_exists


def test_ddl_tag(M):
    s = M.parse('CREATE TAG person(name string, age int64 NOT NULL DEFAULT 18, '
              'score double NULL)')
    assert isinstance(s, M.A.CreateSchemaSentence)
    assert not s.is_edge
    assert [p.name for p in s.props] == ["name", "age", "score"]
    assert s.props[1].nullable is False
    assert s.props[1].default.value == 18


def test_ddl_edge_and_index(M):
    s = M.parse("CREATE EDGE knows(since int64)")
    assert s.is_edge
    s2 = M.parse("CREATE TAG INDEX idx_name ON person(name)")
    assert isinstance(s2, M.A.CreateIndexSentence)
    assert s2.fields == ["name"]
    s3 = M.parse("REBUILD TAG INDEX idx_name")
    assert isinstance(s3, M.A.RebuildIndexSentence)


def test_alter(M):
    s = M.parse("ALTER TAG person ADD (city string), DROP (score)")
    assert s.adds[0].name == "city"
    assert s.drops == ["score"]


def test_insert_vertex(M):
    s = M.parse('INSERT VERTEX person(name, age) VALUES "a":("Ann", 30), "b":("Bob", 25)')
    assert isinstance(s, M.A.InsertVerticesSentence)
    assert len(s.rows) == 2
    assert s.rows[0].vid.value == "a"
    assert s.rows[1].values[1].value == 25


def test_insert_edge(M):
    s = M.parse('INSERT EDGE knows(since) VALUES "a"->"b"@3:(2010)')
    assert isinstance(s, M.A.InsertEdgesSentence)
    assert s.rows[0].rank == 3


def test_update_upsert(M):
    s = M.parse('UPDATE VERTEX ON person "a" SET age = age + 1 WHEN age > 10 YIELD name')
    assert isinstance(s, M.A.UpdateSentence)
    assert not s.insertable and s.when is not None
    s2 = M.parse('UPSERT EDGE ON knows "a"->"b" SET since = 2020')
    assert s2.insertable and s2.edge_key.rank == 0


def test_delete(M):
    s = M.parse('DELETE VERTEX "a", "b" WITH EDGE')
    assert isinstance(s, M.A.DeleteVerticesSentence) and s.with_edge
    s2 = M.parse('DELETE EDGE knows "a"->"b"@0, "b"->"c"')
    assert len(s2.keys) == 2
    s3 = M.parse('DELETE TAG person FROM "a"')
    assert s3.tags == ["person"]


def test_fetch(M):
    s = M.parse('FETCH PROP ON person "a", "b" YIELD properties(vertex)')
    assert isinstance(s, M.A.FetchVerticesSentence)
    assert s.tags == ["person"]
    s2 = M.parse('FETCH PROP ON * "a"')
    assert s2.tags == []
    s3 = M.parse('FETCH PROP ON knows "a"->"b" YIELD properties(edge)')
    assert isinstance(s3, M.A.FetchEdgesSentence)


def test_lookup(M):
    s = M.parse('LOOKUP ON person WHERE person.age > 20 YIELD id(vertex) AS id')
    assert isinstance(s, M.A.LookupSentence)
    assert s.schema_name == "person"


def test_match_basic(M):
    s = M.parse('MATCH (v:person{name:"Ann"})-[e:knows]->(v2) RETURN v2.person.age AS age')
    assert isinstance(s, M.A.MatchSentence)
    mc = s.clauses[0]
    assert isinstance(mc, M.A.MatchClauseAst)
    pat = mc.patterns[0]
    assert len(pat.nodes) == 2 and len(pat.edges) == 1
    assert pat.nodes[0].labels[0][0] == "person"
    assert pat.edges[0].types == ["knows"]
    assert pat.edges[0].direction == "out"


def test_match_varlen_and_direction(M):
    s = M.parse("MATCH p = (a)-[e:knows*1..3]->(b) WHERE id(a) == \"x\" "
              "RETURN p ORDER BY id(b) SKIP 1 LIMIT 5")
    pat = s.clauses[0].patterns[0]
    assert pat.alias == "p"
    assert pat.edges[0].min_hop == 1 and pat.edges[0].max_hop == 3
    assert s.return_.skip == 1 and s.return_.limit == 5
    s2 = M.parse("MATCH (a)<-[:knows]-(b) RETURN b")
    assert s2.clauses[0].patterns[0].edges[0].direction == "in"
    s3 = M.parse("MATCH (a)-[]-(b) RETURN b")
    assert s3.clauses[0].patterns[0].edges[0].direction == "both"


def test_match_with_unwind(M):
    s = M.parse("MATCH (v:person) WITH v.person.age AS age WHERE age > 10 "
              "UNWIND [1,2,3] AS x RETURN age, x")
    kinds = [type(c).__name__ for c in s.clauses]
    assert kinds == ["MatchClauseAst", "WithClauseAst", "UnwindClauseAst"]


def test_find_path(M):
    s = M.parse('FIND SHORTEST PATH FROM "a" TO "b" OVER * UPTO 4 STEPS YIELD path AS p')
    assert isinstance(s, M.A.FindPathSentence)
    assert s.kind == "shortest" and s.upto == 4
    s2 = M.parse('FIND ALL PATH WITH PROP FROM "a" TO "b","c" OVER knows')
    assert s2.kind == "all" and s2.with_prop


def test_subgraph(M):
    s = M.parse('GET SUBGRAPH WITH PROP 2 STEPS FROM "a" BOTH knows '
              'YIELD VERTICES AS nodes, EDGES AS relationships')
    assert isinstance(s, M.A.SubgraphSentence)
    assert s.steps == 2 and s.both_edges == ["knows"]


def test_yield_group_order_limit(M):
    s = M.parse('GO FROM "a" OVER e YIELD dst(edge) AS d, 1 AS one '
              '| GROUP BY $-.d YIELD $-.d, count(*) AS c '
              '| ORDER BY $-.c DESC | LIMIT 3, 10')
    seg = s
    assert isinstance(seg, M.A.PipedSentence)
    assert isinstance(seg.right, M.A.LimitSentence)
    assert seg.right.offset == 3 and seg.right.count == 10
    ob = seg.left.right
    assert isinstance(ob, M.A.OrderBySentence)
    assert not ob.factors[0].ascending
    gb = seg.left.left.right
    assert isinstance(gb, M.A.GroupBySentence)
    assert isinstance(gb.yield_.columns[1].expr, M.AggExpr)


def test_union(M):
    s = M.parse('GO FROM "a" OVER e UNION ALL GO FROM "b" OVER e')
    assert isinstance(s, M.A.SetOpSentence)
    assert s.op == "UNION ALL"


def test_explain_profile(M):
    s = M.parse('EXPLAIN GO FROM "a" OVER e')
    assert isinstance(s, M.A.ExplainSentence) and not s.profile
    s2 = M.parse('PROFILE GO FROM "a" OVER e')
    assert s2.profile


def test_show_describe(M):
    assert M.parse("SHOW SPACES").kind == "spaces"
    assert M.parse("SHOW TAGS").kind == "tags"
    assert M.parse("SHOW HOSTS").kind == "hosts"
    d = M.parse("DESCRIBE TAG person")
    assert d.kind == "tag" and d.name == "person"


def test_use(M):
    assert M.parse("USE nba").space == "nba"


def test_expr_precedence(M):
    s = M.parse("YIELD 1 + 2 * 3 == 7 AND NOT false AS x")
    e = s.yield_.columns[0].expr
    assert e.eval.__self__ is not None
    assert e.eval(M.DictContext()) is True


def test_complex_exprs(M):
    s = M.parse('YIELD [x IN range(1,5) WHERE x % 2 == 0 | x * 10] AS l, '
                'CASE WHEN 1 > 2 THEN "a" ELSE "b" END AS c, '
                'reduce(acc = 0, x IN [1,2,3] | acc + x) AS r')
    ctx = M.DictContext()
    cols = s.yield_.columns
    assert cols[0].expr.eval(ctx) == [20, 40]
    assert cols[1].expr.eval(ctx) == "b"
    assert cols[2].expr.eval(ctx) == 6


def test_errors(M):
    with pytest.raises(M.ParseError):
        M.parse("GO FROM")
    with pytest.raises(M.ParseError):
        M.parse("FROB 1")
    with pytest.raises(M.ParseError):
        M.parse('MATCH (a)-[e]->(b)')  # no RETURN
    with pytest.raises(M.ParseError):
        M.parse('GO FROM "a" OVER e YIELD')


def test_backquote_and_comments(M):
    s = M.parse('GO FROM "a" OVER `order` /* hi */ YIELD dst(edge) # trailing')
    assert s.over.edges == ["order"]


def test_src_dst_prop(M):
    s = M.parse('GO FROM "a" OVER e WHERE $^.person.age > $$.person.age')
    f = s.where.filter
    assert isinstance(f.lhs, M.SrcProp)
    assert M.to_text(f) == "($^.person.age > $$.person.age)"


def test_host_literal_and_zone_spellings(M):
    """Reference grammar spellings: "host":port two-token literals,
    quoted zone names, optional [INTO [NEW] ZONE], DIVIDE ZONE."""
    s = M.parse('ADD HOSTS "h1":9779, "h2:9779"')
    assert s.hosts == ["h1:9779", "h2:9779"] and s.zone == "default"
    s = M.parse('ADD HOSTS "h1":9779 INTO NEW ZONE "z1"')
    assert s.hosts == ["h1:9779"] and s.zone == "z1"
    s = M.parse('DROP HOSTS "h1":9779, "h2":9780')
    assert s.hosts == ["h1:9779", "h2:9780"]
    s = M.parse('DIVIDE ZONE "z" INTO "a" ("h1":1) "b" ("h2":2, "h3":3)')
    assert s.zone == "z"
    assert s.parts == [("a", ["h1:1"]), ("b", ["h2:2", "h3:3"])]
    s = M.parse('MERGE ZONE "a", b INTO "c"')
    assert s.zones == ["a", "b"] and s.into == "c"
    with pytest.raises(M.ParseError):
        M.parse('DIVIDE ZONE "z" INTO "a" ("h1":1)')   # needs >= 2 targets


def test_show_scope_spellings(M):
    for q, extra in [("SHOW LOCAL SESSIONS", "local"),
                     ("SHOW ALL SESSIONS", None),
                     ("SHOW LOCAL QUERIES", "local"),
                     ("SHOW ALL QUERIES", None)]:
        s = M.parse(q)
        assert s.kind in ("sessions", "queries") and s.extra == extra, q


def test_standalone_return(M):
    """RETURN as a statement head: MatchSentence with
    zero clauses; composes with UNION via the normal set-op grammar."""
    s = M.parse("RETURN 1 AS x, 2 + 3 AS y")
    assert isinstance(s, M.A.MatchSentence) and s.clauses == []
    assert [c.alias for c in s.return_.columns] == ["x", "y"]
    s = M.parse("RETURN 1 AS x UNION RETURN 2 AS x")
    assert isinstance(s, M.A.SetOpSentence)
    assert isinstance(s.left, M.A.MatchSentence) and s.left.clauses == []
    assert isinstance(s.right, M.A.MatchSentence)
    s = M.parse("RETURN DISTINCT 1 AS x ORDER BY x LIMIT 1")
    assert s.return_.distinct and s.return_.limit == 1


def test_pattern_predicate_parse(M):
    """(a)-[:knows]->() in expression position is a PatternPredExpr;
    parenthesized arithmetic backtracks to the expression read."""
    s = M.parse("MATCH (a:person) WHERE (a)-[:knows]->() RETURN id(a)")
    w = s.clauses[0].where
    assert isinstance(w, M.PatternPredExpr)
    assert w.text == "(a)-[:knows]->()"
    assert len(w.pattern.nodes) == 2 and len(w.pattern.edges) == 1
    # negated + incoming + var-len + both-direction spellings
    s = M.parse("MATCH (a) WHERE NOT (a)<-[:likes]-() RETURN id(a)")
    w = s.clauses[0].where
    assert isinstance(w, M.Unary) and w.op == "NOT"
    assert isinstance(w.operand, M.PatternPredExpr)
    assert w.operand.pattern.edges[0].direction == "in"
    s = M.parse("MATCH (a) WHERE (a)-[:e*2..4]->(:t{p: 1}) RETURN id(a)")
    ep = s.clauses[0].where.pattern.edges[0]
    assert (ep.min_hop, ep.max_hop) == (2, 4)
    assert s.clauses[0].where.text == "(a)-[:e*2..4]->(:t{p: 1})"
    s = M.parse("MATCH (a) WHERE (a)--(b) RETURN id(a)")
    assert s.clauses[0].where.pattern.edges[0].direction == "both"
    # exists() collapses to the bare pattern predicate
    s = M.parse("MATCH (a) WHERE exists((a)-[:knows]->()) RETURN id(a)")
    assert isinstance(s.clauses[0].where, M.PatternPredExpr)
    # arithmetic stays arithmetic
    s = M.parse("RETURN (1)-(2) AS d")
    e = s.return_.columns[0].expr
    assert isinstance(e, M.Binary) and e.op == "-"
    s = M.parse("MATCH (a) WHERE (a.person.age)-(1) > 0 RETURN id(a)")
    assert isinstance(s.clauses[0].where, M.Binary)


def test_bitwise_operators(M):
    """&/^ everywhere, | inside bracketed contexts only (it is the
    statement pipe / pattern-type separator elsewhere); reference/MySQL
    precedence: ^ above *, & above comparisons via additive, | lowest."""
    e = M.parse("RETURN 6 & 3 AS a").return_.columns[0].expr
    assert M.to_text(e) == "(6 & 3)"
    e = M.parse("RETURN (6 | 3) AS o").return_.columns[0].expr
    assert M.to_text(e) == "(6 | 3)"
    e = M.parse("RETURN 2 ^ 10 * 2 AS x").return_.columns[0].expr
    assert M.to_text(e) == "((2 ^ 10) * 2)"          # ^ binds above *
    e = M.parse("RETURN 1 + 2 & 3 AS x").return_.columns[0].expr
    assert M.to_text(e) == "((1 + 2) & 3)"           # & below additive
    e = M.parse("RETURN (1 | 2) == 3 AS c").return_.columns[0].expr
    assert M.to_text(e) == "((1 | 2) == 3)"
    # structural pipes survive: comprehension, reduce, statement pipe
    s = M.parse("RETURN [x IN [1,2] WHERE x > 0 | x * 2] AS l")
    assert s.return_.columns[0].alias == "l"
    s = M.parse("RETURN (reduce(acc = 0, x IN [1,2] | acc + x)) AS r")
    assert s.return_.columns[0].alias == "r"
    s = M.parse("YIELD 1 AS v | YIELD $-.v AS w")
    assert isinstance(s, M.A.PipedSentence)
    # multi-type patterns keep both spellings
    s = M.parse("MATCH (a)-[e:x|y]->(b) RETURN 1")
    assert s.clauses[0].patterns[0].edges[0].types == ["x", "y"]
    s = M.parse("MATCH (a)-[e:x|:y]->(b) RETURN 1")
    assert s.clauses[0].patterns[0].edges[0].types == ["x", "y"]


def test_unary_minus_xor_precedence(M):
    """Documented deviation (docs/COVERAGE.md): unary minus binds
    TIGHTER than `^` here — `-1 ^ 1` is `(-1) ^ 1` = -2, where the
    reference/MySQL precedence would give `-(1 ^ 1)` = 0.  This test
    pins the current behavior so any precedence change is deliberate.
    The port has no query engine yet, so the YIELD column is parsed and
    evaluated directly (the engine's answer for a constant YIELD)."""
    def yield_one(q):
        return M.parse(q).yield_.columns[0].expr.eval(M.DictContext())
    assert yield_one("YIELD -1 ^ 1") == -2
    # the parenthesized spelling recovers the reference meaning
    assert yield_one("YIELD -(1 ^ 1)") == 0


# ---------------------------------------------------------------------------
# every statement of the TCK features through both parsers
# ---------------------------------------------------------------------------

FEATURES = os.path.join(os.path.dirname(__file__), "tck", "features")


def tck_programs():
    """(feature, text) of every query and set-up step of the TCK
    features, each text once, in file order."""
    seen = {}
    for path in sorted(glob.glob(os.path.join(FEATURES, "*.feature"))):
        feature = os.path.basename(path)[:-len(".feature")]
        with open(path) as f:
            for scn in parse_feature(f.read()):
                for st in scn.steps:
                    if st.kind in ("exec", "query"):
                        seen.setdefault(st.text, feature)
    return [(f, t) for t, f in seen.items()]


def case_id(feature, text):
    return f"{feature}: {' '.join(text.split())}"


def _leaf_value(v):
    return type(v).__module__.startswith(("nebula_tpu.core.value",
                                          "nebula_tpu.core.geo"))


def same_tree(ref, port, at="ast"):
    """None when the reference's parse result and the port's are equal
    under the structural walk, else the first path where they differ."""
    if isinstance(ref, ref_expr.Expr):
        if type(port).__name__ != type(ref).__name__ \
                or port_expr.to_text(port) != ref_expr.to_text(ref):
            return at
        for klass in type(ref).__mro__:
            for slot in getattr(klass, "__slots__", ()):
                bad = same_tree(getattr(ref, slot), getattr(port, slot),
                                f"{at}.{slot}")
                if bad:
                    return bad
        return None
    if dataclasses.is_dataclass(ref) and not isinstance(ref, type):
        if type(port).__name__ != type(ref).__name__:
            return at
        for f in dataclasses.fields(ref):
            bad = same_tree(getattr(ref, f.name), getattr(port, f.name),
                            f"{at}.{f.name}")
            if bad:
                return bad
        return None
    if isinstance(ref, (list, tuple)):
        if type(port) is not type(ref) or len(port) != len(ref):
            return at
        for i, (a, b) in enumerate(zip(ref, port)):
            bad = same_tree(a, b, f"{at}[{i}]")
            if bad:
                return bad
        return None
    if isinstance(ref, dict):
        if not isinstance(port, dict) or list(port) != list(ref):
            return at
        for k in ref:
            bad = same_tree(ref[k], port[k], f"{at}[{k!r}]")
            if bad:
                return bad
        return None
    if _leaf_value(ref):
        return None if same_value(port, ref) else at
    if type(port) is not type(ref):
        return at
    if isinstance(ref, float) and ref != ref:
        return None if port != port else at
    return None if port == ref else at


def _parse(parser, text):
    try:
        return "ast", parser.parse(text)
    except parser.ParseError as ex:
        return "ParseError", str(ex)


TCK = tck_programs()


@pytest.mark.parametrize("feature,text", TCK,
                         ids=[case_id(f, t) for f, t in TCK])
def test_tck_statement_parses_as_reference(feature, text):
    kind, want = _parse(ref_parser, text)
    pkind, got = _parse(port_parser, text)
    assert pkind == kind
    if kind == "ParseError":
        assert got == want
    else:
        assert same_tree(want, got) is None


def test_structural_walk_sees_a_difference():
    """The walk is not vacuous: a changed literal, operator, field or
    node class is a difference."""
    text = 'GO 2 STEPS FROM "a" OVER e WHERE e.w > 3 YIELD dst(edge) AS d'
    want = ref_parser.parse(text)
    assert same_tree(want, port_parser.parse(text)) is None
    for other in ('GO 2 STEPS FROM "a" OVER e WHERE e.w > 4 YIELD dst(edge) AS d',
                  'GO 2 STEPS FROM "a" OVER e WHERE e.w >= 3 YIELD dst(edge) AS d',
                  'GO 3 STEPS FROM "a" OVER e WHERE e.w > 3 YIELD dst(edge) AS d',
                  'GO 2 STEPS FROM "a" OVER e WHERE e.w > 3 YIELD src(edge) AS d',
                  'GO 2 STEPS FROM "a" OVER e WHERE e.w > 3.0 YIELD dst(edge) AS d',
                  'GO 2 STEPS FROM "a" OVER e WHERE e.w > 3 YIELD dst(edge)'):
        assert same_tree(want, port_parser.parse(other)) is not None, other
