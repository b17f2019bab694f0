"""The port's lowered WHERE program (Queue B K4) against the reference's
`compile_predicate` (nebula_tpu/tpu/exprjit.py:201), mask against mask.

Both run on the same (P, emax) columns from a numpy seed — int64 with
INT64_MIN nulls, float64 with NaN, bool with INT64_MIN nulls, string
codes with INT64_MIN nulls — and the same expanded slots (src, dst,
rank, eidx, total with padding past total).  The reference gathers its
columns at eidx and evaluates its jnp mask; the port runs
`predicate_mask_plain` (gather, then the program's torch evaluator,
masked by slot < total), which is what `predicate_mask` runs on the
card.  One case per operator family of the program.  Tolerance: exact —
both sides compute the same boolean mask.
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
from nebula_tpu_torch.gpu import exprjit as X
from nebula_tpu_torch.gpu import kernels as K
from nebula_tpu_torch.graphstore.csr import INT_NULL
from nebula_tpu_torch.graphstore.csr import StringPool as PortPool
from nebula_tpu_torch.graphstore.schema import PropType

P, EMAX, EB = 4, 300, 240
NAMES = ["ann", "bob", "cid", "dee"]
TYPES = {"w": "INT64", "f": "DOUBLE", "b": "BOOL", "tag": "STRING"}

FAMILIES = {
    # column loads, literals and string-pool codes
    "load_int": "knows.w > 30",
    "load_float": "knows.f < 0.5",
    "load_bool": "knows.b",
    "bool_eq_literal": "knows.b == true",
    "load_string_code": "knows.tag == \"ann\"",
    "string_not_in_pool": "knows.tag != \"not-in-pool\"",
    "load_rank": "rank(edge) >= 1",
    "literal_only": "2 > 1",
    "null_literal": "knows.w + NULL > 1",
    # IS [NOT] NULL, NOT, unary minus
    "is_null_int": "knows.w IS NULL",
    "is_not_null_float": "knows.f IS NOT NULL",
    "is_null_bool": "knows.b IS NULL",
    "is_null_string": "knows.tag IS NOT NULL",
    "not": "NOT (knows.w > 10)",
    "not_bool_column": "NOT knows.b",
    "neg_int": "-knows.w < -40",
    "neg_float": "-knows.f > -0.5",
    # comparisons, with int/float promotion
    "cmp_int_float": "knows.w >= knows.f * 100",
    "cmp_ne_le": "knows.w != 7 AND knows.w <= 60",
    "cmp_float_le": "knows.f + 0.25 <= 0.75",
    "cmp_float_eq_ne": "knows.f == 0.5 OR knows.w + 0.0 != 3.0",
    # arithmetic: / truncates, % follows the dividend, zero divisor null
    "add_sub_mul": "knows.w * 2 + 1 - knows.w > 21",
    "div_int_negative": "(knows.w - 50) / 7 < -2",
    "div_by_negative": "knows.w / -3 > -5",
    "div_zero_is_null": "knows.w / (knows.w - 10) > 0",
    "div_float": "knows.f / (knows.f - 0.5) > 1.0",
    "mod_int_negative": "(knows.w - 50) % 7 == -3",
    "mod_by_negative": "knows.w % -4 == 1",
    "mod_zero_is_null": "(knows.w % (knows.w - 10)) IS NULL",
    "mod_float": "(knows.f - 0.5) % 0.3 < -0.1",
    # bitwise
    "bit_and": "(knows.w & 1) == 0",
    "bit_or": "(knows.w | 8) < 60",
    "bit_xor": "(knows.w ^ 3) > 40",
    # three-valued logic over nullable operands
    "and3": "knows.w > 50 AND knows.f < 0.5",
    "or3": "knows.w > 50 OR knows.f < 0.5",
    "xor3": "knows.w > 50 XOR knows.b",
    "kleene_mix": "(knows.b OR knows.w IS NULL) AND NOT (knows.f > 0.9)",
    "bool_literals": "(knows.b AND true) OR (false XOR knows.b) OR "
                     "(NOT true AND knows.w > 3)",
    # IN / NOT IN, with null items and mixed numeric items
    "in_int": "knows.w IN [1, 2, 3, 40, 41, 42]",
    "in_with_null": "knows.w IN [3, 7.0, NULL]",
    "not_in_with_null": "knows.w NOT IN [1, 2, NULL]",
    "in_float": "knows.f IN [0.5, 1]",
    "in_string_null": "knows.tag IN [\"cid\", \"zzz\", NULL]",
    "not_in_string": "knows.tag NOT IN [\"ann\"]",
    "in_bool": "knows.b IN [true]",
    # id() against dense-id lists
    "id_dst_in": "id($$) IN [5, 9, 14, 999999]",
    "id_dst_not_in": "id($$) NOT IN [5, 9]",
    "id_src_eq": "id($^) == 3",
    "id_dst_ne_and": "id($$) != 9 AND knows.w > 20",
    # a deep tree that needs several registers
    "deep": "((knows.w + 1) * (knows.w - 2)) / ((knows.w % 5) + "
            "(knows.w & 7)) > ((knows.w ^ 3) - (knows.w | 1))",
    # a non-bool value drops every row
    "non_bool_value": "knows.w + 1",
}


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


def _data(seed):
    """(P, EMAX) columns and (P, EB) slots; eidx ascends per part."""
    rng = np.random.default_rng(seed)
    shape = (P, EMAX)
    w = rng.integers(-5, 100, shape).astype(np.int64)
    w[rng.random(shape) < 0.1] = INT_NULL
    f = rng.random(shape)
    f[rng.random(shape) < 0.1] = np.nan
    b = rng.integers(0, 2, shape).astype(np.int64)
    b[rng.random(shape) < 0.1] = INT_NULL
    tag = rng.integers(0, len(NAMES), shape).astype(np.int64)
    tag[rng.random(shape) < 0.1] = INT_NULL
    total = rng.integers(0, EB + 1, P).astype(np.int32)
    total[0] = EB
    eidx = np.sort(rng.integers(0, EMAX, (P, EB)), axis=1).astype(np.int32)
    valid = np.arange(EB)[None, :] < total[:, None]
    eidx[~valid] = 0
    src = np.where(valid, rng.integers(0, 20, (P, EB)), -1).astype(np.int32)
    dst = np.where(valid, rng.integers(0, 20, (P, EB)), -1).astype(np.int32)
    rank = np.where(valid, rng.integers(0, 3, (P, EB)), 0).astype(np.int32)
    return ({"w": w, "f": f, "b": b, "tag": tag},
            dict(src=src, dst=dst, rank=rank, eidx=eidx, total=total))


def _vid_to_dense(v):
    return v if isinstance(v, int) and 0 <= v < 20 else -1


def _compile(where):
    stmt = parse(f"GO FROM 3 OVER knows WHERE {where} YIELD dst(edge)")
    ref_expr = stmt.where.filter
    ref_pool, port_pool = RefPool(), PortPool()
    for s in NAMES:
        ref_pool.encode(s)
        port_pool.encode(s)
    ref_fn, ref_needed = ref_jit.compile_predicate(
        ref_expr, {n: RefPropType[t] for n, t in TYPES.items()}, ref_pool,
        vid_to_dense=_vid_to_dense)
    prog, needed = X.compile_predicate(
        _to_port(ref_expr), {n: PropType[t] for n, t in TYPES.items()},
        port_pool, vid_to_dense=_vid_to_dense)
    assert needed == ref_needed
    return ref_fn, prog


def _ref_mask(ref_fn, cols, slots):
    el = slots["eidx"]
    c = {"_rank": jnp.asarray(slots["rank"]), "_src": jnp.asarray(
        slots["src"]), "_dst": jnp.asarray(slots["dst"])}
    for name, col in cols.items():
        c[name] = jnp.asarray(np.take_along_axis(col, el, axis=1))
    valid = np.arange(EB)[None, :] < slots["total"][:, None]
    return valid & np.broadcast_to(np.asarray(ref_fn(c)), valid.shape)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_program_mask_matches_reference(family):
    ref_fn, prog = _compile(FAMILIES[family])
    assert prog.error is None
    assert prog.n_regs <= X.MAX_REGS and len(prog.code) <= X.MAX_INSNS
    for seed in (0, 1):
        cols, slots = _data(seed)
        want = _ref_mask(ref_fn, cols, slots)
        t = {k: torch.from_numpy(v) for k, v in slots.items()}
        got = K.predicate_mask(
            prog, t["src"], t["dst"], t["rank"], t["eidx"], t["total"],
            [torch.from_numpy(cols[n]) for n in prog.columns])
        assert got.dtype == torch.bool and got.shape == (P, EB)
        np.testing.assert_array_equal(got.numpy(), want)
    if family == "non_bool_value":
        assert not want.any()


def test_families_cover_every_opcode():
    used = set()
    for where in FAMILIES.values():
        _, prog = _compile(where)
        used.update(insn[0] for insn in prog.code)
    assert used == set(range(X.OP_IN + 1))


def test_typing_failure_raises_when_the_program_runs():
    """As the reference raises from its mask function, not its compile."""
    _, prog = _compile("knows.tag < \"m\"")
    assert prog.error is not None
    cols, slots = _data(0)
    t = {k: torch.from_numpy(v) for k, v in slots.items()}
    with pytest.raises(X.CannotCompile):
        K.predicate_mask(prog, t["src"], t["dst"], t["rank"], t["eidx"],
                         t["total"], [])


def test_register_limit_raises(monkeypatch):
    """A program that needs more registers than the kernel's file is
    refused at compile time.  Within MAX_INSNS no predicate needs more
    than 6 of the 8 (see exprjit.MAX_REGS), so the check is shown on a
    smaller file: two comparisons under AND need 3 registers."""
    ref_fn, prog = _compile("knows.w > 1 AND knows.w < 5")
    assert prog.n_regs == 3
    monkeypatch.setattr(X, "MAX_REGS", 2)
    with pytest.raises(X.CannotCompile, match="registers"):
        _compile("knows.w > 1 AND knows.w < 5")


def test_instruction_budget_raises():
    long_in_chain = " OR ".join(f"knows.w == {i}" for i in range(40))
    with pytest.raises(X.CannotCompile, match="instructions"):
        _compile(long_in_chain)
