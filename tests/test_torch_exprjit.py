"""The port's WHERE compiler (torch) against the reference's (jnp), mask
against mask.

The predicates are test_predicate_parity's set (tests/unit/test_tpu.py)
plus `/` and `%` on negative operands, division by zero and mixed
int/float arithmetic.  Each is parsed by the reference's parser, and the
tree is rebuilt node for node with the port's expression classes.  The
columns come from a numpy seed, with NULL sentinels (INT64_MIN, NaN) in
them.  Tolerance: exact — both sides compute the same boolean mask.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.core import expr as RE
from nebula_tpu.core.value import NullValue as RefNull
from nebula_tpu.graphstore.csr import StringPool as RefPool
from nebula_tpu.graphstore.schema import PropType as RefPropType
from nebula_tpu.query.parser import parse
from nebula_tpu.tpu import exprjit as ref_jit

from nebula_tpu_torch.core import expr as PE
from nebula_tpu_torch.core.value import NullKind, NullValue
from nebula_tpu_torch.gpu import exprjit as port_jit
from nebula_tpu_torch.graphstore.csr import INT_NULL
from nebula_tpu_torch.graphstore.csr import StringPool as PortPool
from nebula_tpu_torch.graphstore.schema import PropType

NAMES = ["ann", "bob", "cid", "dee"]

WHERES = [
    # test_predicate_parity's set
    "knows.w > 30",
    "knows.w >= 10 AND knows.w < 60",
    "knows.f < 0.5 OR knows.w == 7",
    "knows.tag == \"ann\"",
    "knows.tag != \"bob\" AND knows.w % 2 == 0",
    "knows.w IS NOT NULL AND knows.w * 2 + 1 > 21",
    "knows.w IN [1, 2, 3, 40, 41, 42, 43, 44]",
    "rank(edge) == 1",
    "id($$) == 9",
    "id($$) != 9 AND knows.w > 20",
    "id($$) IN [5, 9, 14, 999999]",
    "id($$) NOT IN [5, 9]",
    "id($^) == 3",
    "NOT (knows.w > 10)",
    "knows.w / 3 > 5",
    "(knows.w & 1) == 0",
    "(knows.w ^ 3) > 40",
    "(knows.w | 8) < 60",
    # negative operands: `/` truncates, `%` follows the dividend
    "(knows.w - 50) / 7 < -2",
    "(knows.w - 50) % 7 == -3",
    "knows.w / -3 > -5",
    "knows.w % -4 == 1",
    "-knows.w % 3 == -2",
    # division by zero is NULL, which drops the row
    "knows.w / (knows.w - 10) > 0",
    "(knows.w % (knows.w - 10)) IS NULL",
    # floats and int/float mixes
    "knows.f * 100 > knows.w",
    "knows.f % 0.3 < 0.1",
    "(knows.f - 0.5) % 0.3 < -0.1",
    "knows.w + 0.5 > 40",
    "knows.w IN [3, 7.0, NULL] OR knows.tag IN [\"cid\", \"zzz\"]",
    "knows.tag NOT IN [\"ann\"] XOR knows.f IS NULL",
    "knows.tag == \"not-in-pool\"",
]


def _to_port(x):
    """Rebuild a reference expression tree with the port's classes."""
    if isinstance(x, RE.Expr):
        cls = getattr(PE, type(x).__name__)
        node = object.__new__(cls)
        for slot in type(x).__slots__:
            setattr(node, slot, _to_port(getattr(x, slot)))
        return node
    if isinstance(x, list):
        return [_to_port(i) for i in x]
    if isinstance(x, RefNull):
        return NullValue(NullKind[x.kind.name])
    return x


def _columns(seed, n=400):
    rng = np.random.default_rng(seed)
    w = rng.integers(-5, 100, n).astype(np.int64)
    w[rng.random(n) < 0.1] = INT_NULL
    f = rng.random(n)
    f[rng.random(n) < 0.1] = np.nan
    tag = rng.integers(0, len(NAMES), n).astype(np.int64)
    tag[rng.random(n) < 0.1] = INT_NULL
    rank = rng.integers(0, 3, n).astype(np.int32)
    src = rng.integers(0, 20, n).astype(np.int32)
    dst = rng.integers(0, 20, n).astype(np.int32)
    return {"w": w, "f": f, "tag": tag, "_rank": rank, "_src": src,
            "_dst": dst}


def _vid_to_dense(v):
    return v if isinstance(v, int) and 0 <= v < 20 else -1


@pytest.mark.parametrize("where", WHERES)
def test_predicate_mask_matches_reference(where):
    stmt = parse(f"GO 2 STEPS FROM 3, 17 OVER knows WHERE {where} "
                 f"YIELD dst(edge)")
    ref_expr = stmt.where.filter
    port_expr = _to_port(ref_expr)
    assert PE.to_text(port_expr) == RE.to_text(ref_expr)
    assert ref_jit.compilable(ref_expr, ["knows"])
    assert port_jit.compilable(port_expr, ["knows"])
    ref_types = {"w": RefPropType.INT64, "f": RefPropType.DOUBLE,
                 "tag": RefPropType.STRING}
    port_types = {"w": PropType.INT64, "f": PropType.DOUBLE,
                  "tag": PropType.STRING}
    ref_pool, port_pool = RefPool(), PortPool()
    for s in NAMES:
        ref_pool.encode(s)
        port_pool.encode(s)
    ref_fn, ref_needed = ref_jit.compile_predicate(
        ref_expr, ref_types, ref_pool, vid_to_dense=_vid_to_dense)
    port_fn, port_needed = port_jit.compile_predicate(
        port_expr, port_types, port_pool, vid_to_dense=_vid_to_dense)
    assert port_needed == ref_needed
    for seed in (0, 1):
        cols = _columns(seed)
        want = np.asarray(ref_fn({k: jnp.asarray(v)
                                  for k, v in cols.items()}))
        pcols = {k: torch.from_numpy(v) for k, v in cols.items()}
        pcols["_rank"] = pcols["_rank"].long()    # as gpu/hop.py feeds it
        got = port_fn(pcols)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(
            np.broadcast_to(got.numpy(), want.shape), want)


@pytest.mark.parametrize("where", [
    "knows.tag CONTAINS \"a\"",
    "knows.tag =~ \"a.*\"",
    "id($$) + 1 == 3",
    "id($$) == id($^)",
])
def test_not_compilable_matches_reference(where):
    stmt = parse(f"GO FROM 1 OVER knows WHERE {where} YIELD dst(edge)")
    assert not ref_jit.compilable(stmt.where.filter, ["knows"])
    assert not port_jit.compilable(_to_port(stmt.where.filter), ["knows"])


def test_string_ordering_refused_at_compile():
    """Ordering on dictionary codes passes the structural gate but fails
    the typed compile in both packages (the statement stays on the host)."""
    stmt = parse('GO FROM 1 OVER knows WHERE knows.tag < "m" '
                 'YIELD dst(edge)')
    e = _to_port(stmt.where.filter)
    assert port_jit.compilable(e, ["knows"])
    fn, _ = port_jit.compile_predicate(e, {"tag": PropType.STRING},
                                       PortPool())
    with pytest.raises(port_jit.CannotCompile):
        fn({"tag": torch.zeros(3, dtype=torch.int64)})
