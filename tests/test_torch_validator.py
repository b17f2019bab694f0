"""The port's validator (`nebula_tpu_torch.query.validator`) against the
JAX package's `nebula_tpu.query.validator`, on the CPU.

Every query and set-up statement of tests/tck/features/*.feature goes
through both validators, with the schema catalog and the current space
that the reference's `QueryEngine` holds at that point of its scenario:
each scenario is replayed on a fresh reference engine (its DDL and USE
statements, which are all that change the catalog and the space), and
before each statement the engine's catalog is carried into the port
through the two packages' `schema_wire` (reference dumps, port loads).
Each package parses the statement with its own parser; both validators
must pass, or both must raise `ValidationError` with the same text.
The statements of tests/unit/test_validator.py (its three tests drive
`QueryEngine`, which the port does not have yet) are held the same way
against a catalog built through the catalog API.
"""
import glob
import os
import re
import types

import pytest

import nebula_tpu.graphstore.schema as ref_schema
import nebula_tpu.graphstore.schema_wire as ref_schema_wire
import nebula_tpu.query.parser as ref_parser
import nebula_tpu.query.validator as ref_validator
from nebula_tpu.exec.engine import QueryEngine

import nebula_tpu_torch.graphstore.schema as port_schema
import nebula_tpu_torch.graphstore.schema_wire as port_schema_wire
import nebula_tpu_torch.query.parser as port_parser
import nebula_tpu_torch.query.validator as port_validator

from tck.runner import parse_feature

FEATURES = os.path.join(os.path.dirname(__file__), "tck", "features")
FEATURE_PATHS = sorted(glob.glob(os.path.join(FEATURES, "*.feature")))

# the statements that change the catalog or the session's space: the
# replay runs these on the reference engine and only parses the rest
_SCHEMA_STMT = re.compile(
    r"^\s*(CREATE|ALTER|DROP|USE|CLEAR|ADD|REMOVE)\b", re.I)


def _outcome(parser, validator, stmt_text, catalog, space):
    """("parse error", msg), ("ok",) or (exception class, msg)."""
    try:
        stmt = parser.parse(stmt_text)
    except parser.ParseError as ex:
        return ("parse error", str(ex))
    pctx = types.SimpleNamespace(catalog=catalog, space=space)
    try:
        validator.validate(stmt, pctx)
    except Exception as ex:  # noqa: BLE001 — compared across packages
        return (type(ex).__name__, str(ex))
    return ("ok",)


def _check(text, ref_cat, port_cat, space, seen, where):
    key = (text, space, id(port_cat))
    if key in seen:
        return
    seen.add(key)
    want = _outcome(ref_parser, ref_validator, text, ref_cat, space)
    got = _outcome(port_parser, port_validator, text, port_cat, space)
    assert got == want, (where, text, space)
    return want


@pytest.mark.parametrize(
    "path", FEATURE_PATHS, ids=[os.path.basename(p)[:-len(".feature")]
                                for p in FEATURE_PATHS])
def test_tck_statements_validate_alike(path):
    with open(path) as f:
        scenarios = parse_feature(f.read())
    outcomes = []
    for scn in scenarios:
        eng = QueryEngine()
        sess = eng.new_session()
        port_cat, ver, seen = None, None, set()
        for step in scn.steps:
            if step.kind not in ("exec", "query"):
                continue
            for text in [s for s in step.text.split(";") if s.strip()]:
                cat = eng.qctx.catalog
                if port_cat is None or cat.version != ver:
                    port_cat = port_schema_wire.loads(
                        ref_schema_wire.dumps(cat))
                    ver = cat.version
                out = _check(text, cat, port_cat, sess.space, seen,
                             f"{scn.feature} / {scn.name}")
                if out:
                    outcomes.append(out[0])
                if _SCHEMA_STMT.match(text):
                    eng.execute(sess, text)
    assert outcomes and "ok" in outcomes


# the statements of tests/unit/test_validator.py
REJECTED = [
    'YIELD 1 + "x"',
    "YIELD NOT 5",
    'YIELD "a" < 1',
    "YIELD true AND 3",
    'YIELD -"s"',
    'YIELD ("a" + "b") * 2',
    'YIELD CASE WHEN 3 THEN 1 END',
    'GO FROM 1 OVER e WHERE e.w + "s" > 2 YIELD dst(edge)',
    'GO FROM 1 OVER e WHERE e.tag < 5 YIELD dst(edge)',
    "GO FROM 1 OVER e WHERE e.nosuch > 1 YIELD dst(edge)",
    'GO FROM 1 OVER e YIELD e.w + "x"',
]

ACCEPTED = [
    'YIELD 1 + 2 AS s, "a" + "b" AS c, 1 < 2.5 AS d',
    "YIELD [1, 2] + [3] AS l",
    'GO FROM 1 OVER e WHERE e.tag CONTAINS "x" YIELD dst(edge)',
    "GO FROM 1 OVER e WHERE e.w > 2 AND e.w < 9 YIELD dst(edge)",
    'YIELD CASE WHEN 1 > 2 THEN "a" ELSE "b" END AS c',
    "YIELD size([1,2]) + 1 AS n",
    "YIELD coalesce(1, \"x\") AS mixed",
    "GO FROM 1 OVER e WHERE e.w + 0.5 > 1 YIELD dst(edge) AS d",
]


def _catalog(S):
    c = S.Catalog()
    c.create_space("v", partition_num=2, vid_type="INT64")
    c.create_tag("v", "t", [S.PropDef("x", S.PropType.INT64),
                            S.PropDef("name", S.PropType.STRING)])
    c.create_edge("v", "e", [S.PropDef("w", S.PropType.INT64),
                             S.PropDef("tag", S.PropType.STRING)])
    return c


@pytest.mark.parametrize("q,verdict", [(q, "ValidationError")
                                       for q in REJECTED]
                         + [(q, "ok") for q in ACCEPTED])
def test_unit_statements_validate_alike(q, verdict):
    want = _outcome(ref_parser, ref_validator, q, _catalog(ref_schema), "v")
    got = _outcome(port_parser, port_validator, q, _catalog(port_schema),
                   "v")
    assert got == want and want[0] == verdict


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_deduce_api(pkg):
    """tests/unit/test_validator.py:test_deduce_api, once a package."""
    V, P = ((ref_validator, ref_parser) if pkg == "ref"
            else (port_validator, port_parser))
    parse_expression, Scope, deduce = P.parse_expression, V.Scope, V.deduce

    class _P:
        space = None
        catalog = None
    sc = Scope(_P())
    assert deduce(parse_expression("1 + 2"), sc) == "int"
    assert deduce(parse_expression("1 + 2.0"), sc) == "float"
    assert deduce(parse_expression('"a" + "b"'), sc) == "string"
    assert deduce(parse_expression("1 < 2"), sc) == "bool"
    assert deduce(parse_expression("upper(\"x\")"), sc) == "string"
    assert deduce(parse_expression("size([1])"), sc) == "int"
