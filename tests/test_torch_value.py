"""The port's value model (`nebula_tpu_torch.core.value`, `core.geo`,
`core.wire`) against the JAX package's `nebula_tpu.core`, on the CPU.

Every test of tests/unit/test_value.py runs here once a package, with the
same body (`M` is the package's namespace).  A seeded sweep then builds
random values in the reference (ints near the int64 edges, floats with
NaN and infinities, strings, every NULL kind, EMPTY, DATE, TIME,
DATETIME and DURATION on both sides of 1970, lists, maps and geography
points), carries each into the port with `to_port`, and holds
`v_add`, `v_sub`, `v_lt`, `v_eq`, `total_order_key`, `type_name` and
`value_to_string` of the two packages equal: results compare by type
name, text form and NULL kind, an exception by its class.  Tolerance:
exact.

`to_port` is the carrier the other port tests use to compare the rows
of the two packages with `==`: it rebuilds a reference value from the
fields of its class in the port's class of the same name, and checks
that both print alike.
"""
import math
import random
import types

import numpy as np
import pytest

import nebula_tpu.core as ref_core
import nebula_tpu.core.geo as ref_geo
import nebula_tpu.core.value as ref_value
import nebula_tpu.core.wire as ref_wire

import nebula_tpu_torch.core as port_core
import nebula_tpu_torch.core.geo as port_geo
import nebula_tpu_torch.core.value as port_value
import nebula_tpu_torch.core.wire as port_wire


def _ns(core, value, geo, wire):
    ns = types.SimpleNamespace(**{k: getattr(core, k) for k in dir(core)
                                  if not k.startswith("__")})
    for k in dir(value):
        if not k.startswith("__"):
            setattr(ns, k, getattr(value, k))
    ns.geo, ns.wire, ns.value = geo, wire, value
    return ns


PKGS = {"ref": _ns(ref_core, ref_value, ref_geo, ref_wire),
        "port": _ns(port_core, port_value, port_geo, port_wire)}


@pytest.fixture(params=sorted(PKGS))
def M(request):
    return PKGS[request.param]


# ---------------------------------------------------------------------------
# the carrier: a reference value as the port's
# ---------------------------------------------------------------------------

_PORT_MODULES = {"nebula_tpu.core.value": port_value,
                 "nebula_tpu.core.geo": port_geo}


def _carry(v):
    if isinstance(v, ref_value.NullValue):
        return port_value.NullValue(port_value.NullKind[v.kind.name])
    if isinstance(v, ref_value.EmptyValue):
        return port_value.EMPTY
    if isinstance(v, list):
        return [_carry(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_carry(x) for x in v)
    if isinstance(v, set):
        return {_carry(x) for x in v}
    if isinstance(v, dict):
        return {k: _carry(x) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        if v.dtype != object:
            return v.copy()
        out = np.empty(v.shape, object)
        out[:] = [_carry(x) for x in v]
        return out
    mod = _PORT_MODULES.get(type(v).__module__)
    if mod is None:
        return v                          # bool, int, float, str, None
    if isinstance(v, ref_value.ColumnarDataSet):
        if v._cols is None:
            return port_value.DataSet(list(v.column_names), _carry(v.rows))
        return port_value.ColumnarDataSet(list(v.column_names),
                                          [_carry(c) for c in v._cols])
    cls = getattr(mod, type(v).__name__)
    out = object.__new__(cls)
    for klass in type(v).__mro__:
        for slot in getattr(klass, "__slots__", ()):
            setattr(out, slot, _carry(getattr(v, slot)))
    return out


def to_port(v):
    """The port's copy of a reference value (NULL kinds, temporal and
    graph values, geography, lists, maps, sets, data sets), checked to
    print as the reference value does."""
    out = _carry(v)
    assert port_value.value_to_string(out) == ref_value.value_to_string(v)
    assert port_value.type_name(out) == ref_value.type_name(v)
    return out


def same_value(got, want) -> bool:
    """A port value equals a reference value: type name, text form and,
    for a NULL, its kind."""
    if port_value.type_name(got) != ref_value.type_name(want):
        return False
    if port_value.value_to_string(got) != ref_value.value_to_string(want):
        return False
    if isinstance(want, ref_value.NullValue):
        return got.kind.name == want.kind.name
    return True


# ---------------------------------------------------------------------------
# the twins of tests/unit/test_value.py
# ---------------------------------------------------------------------------


def test_null_kinds_interned(M):
    assert M.NULL is not M.NULL_BAD_TYPE
    assert M.NULL == M.NULL_BAD_TYPE  # all nulls equal for dedup
    assert hash(M.NULL) == hash(M.NULL_DIV_BY_ZERO)
    assert repr(M.NULL_DIV_BY_ZERO) == "__DIV_BY_ZERO__"


def test_arithmetic_null_propagation(M):
    assert M.is_null(M.v_add(M.NULL, 1))
    assert M.is_null(M.v_mul(2, M.NULL))
    assert M.v_add(M.NULL_BAD_TYPE, 1) is M.NULL_BAD_TYPE


def test_division(M):
    assert M.v_div(7, 2) == 3
    assert M.v_div(-7, 2) == -3  # trunc toward zero, not floor
    assert M.v_div(7.0, 2) == 3.5
    assert M.v_div(1, 0) is M.NULL_DIV_BY_ZERO
    assert M.v_div(1.0, 0.0) is M.NULL_DIV_BY_ZERO
    assert M.v_mod(7, 3) == 1
    assert M.v_mod(-7, 3) == -1  # C-style remainder
    assert M.v_mod(5, 0) is M.NULL_DIV_BY_ZERO


def test_overflow(M):
    assert M.v_add(M.INT64_MAX, 1) is M.NULL_OVERFLOW
    assert M.v_mul(M.INT64_MAX, 2) is M.NULL_OVERFLOW
    assert M.v_add(M.INT64_MAX, 0) == M.INT64_MAX


def test_string_concat(M):
    assert M.v_add("a", "b") == "ab"
    assert M.v_add("a", 1) == "a1"
    assert M.v_add(1, "a") == "1a"
    assert M.v_add("x", True) == "xtrue"


def test_list_concat(M):
    assert M.v_add([1], [2, 3]) == [1, 2, 3]
    assert M.v_add([1], 2) == [1, 2]
    assert M.v_add(0, [1]) == [0, 1]


def test_bad_type_arith(M):
    assert M.v_sub("a", 1) is M.NULL_BAD_TYPE
    assert M.v_mul(True, 2) is M.NULL_BAD_TYPE  # bool is not numeric


def test_three_valued_logic(M):
    assert M.logical_and(True, M.NULL) is M.NULL
    assert M.logical_and(False, M.NULL) is False
    assert M.logical_or(True, M.NULL) is True
    assert M.logical_or(False, M.NULL) is M.NULL
    assert M.logical_not(M.NULL) is M.NULL
    assert M.logical_xor(True, M.NULL) is M.NULL
    assert M.logical_and(True, True) is True


def test_eq_semantics(M):
    assert M.v_eq(1, 1.0) is True
    assert M.v_eq(1, "1") is False  # cross-type == is false, not null
    assert M.is_null(M.v_eq(M.NULL, 1))
    assert M.is_null(M.v_eq(M.NULL, M.NULL))
    assert M.v_ne(1, 2) is True
    assert M.v_eq([1, 2], [1, 2]) is True
    assert M.v_eq([1, M.NULL], [1, 2]) is M.NULL


def test_lt_semantics(M):
    assert M.v_lt(1, 2.5) is True
    assert M.v_lt("a", "b") is True
    assert M.v_lt(1, "a") is M.NULL_BAD_TYPE
    assert M.is_null(M.v_lt(M.NULL, 1))
    assert M.v_lt([1, 2], [1, 3]) is True
    assert M.v_lt([1], [1, 0]) is True


def test_total_order(M):
    vals = [M.NULL, "b", 2, M.EMPTY, 1.5, "a", True]
    s = sorted(vals, key=M.total_order_key)
    assert s[0] is M.EMPTY
    assert s[-1] is M.NULL
    assert s[1] is True
    assert s[2:4] == [1.5, 2]
    assert s[4:6] == ["a", "b"]


def test_date_time_compare(M):
    assert M.v_lt(M.Date(2020, 1, 1), M.Date(2020, 1, 2)) is True
    assert M.v_eq(M.Time(1, 2, 3), M.Time(1, 2, 3)) is True
    assert M.v_lt(M.DateTime(2020, 1, 1), M.DateTime(2021, 1, 1)) is True


def test_date_plus_duration(M):
    d = M.v_add(M.Date(2020, 1, 31), M.Duration(months=1))
    assert d == M.Date(2020, 2, 29)  # clamped to month end (leap year)
    d2 = M.v_add(M.Date(2020, 1, 1), M.Duration(seconds=86400))
    assert d2 == M.Date(2020, 1, 2)


def test_vertex_edge_path(M):
    v1 = M.Vertex("a", [M.Tag("person", {"name": "Ann", "age": 30})])
    v2 = M.Vertex("b", [M.Tag("person", {"name": "Bob"})])
    assert v1.prop("person", "age") == 30
    assert M.is_null(v1.prop("person", "nope"))
    e = M.Edge("a", "b", "knows", 0, {"since": 2010})
    er = M.Edge("b", "a", "knows", 0, {"since": 2010}, etype=-1)
    assert e.key() == er.key()  # direction-insensitive identity
    p = M.Path(v1, [M.Step(v2, "knows", 0, {"since": 2010})])
    assert p.length() == 1
    assert [n.vid for n in p.nodes()] == ["a", "b"]
    assert p.relationships()[0].src == "a"
    assert not p.has_duplicate_vertices()


def test_dataset(M):
    ds = M.DataSet(["a", "b"], [[1, 2], [3, 4]])
    assert ds.column("b") == [2, 4]
    assert len(ds) == 2
    assert M.type_name(ds) == "dataset"


def test_columnar_wire_roundtrip(M):
    """Device-plane results ship columnar through the wire: numeric
    columns as raw buffers hoisted into binary RPC frames, base64 when
    serialized to a file, object columns per-value; materialized sets
    fall back to row form.  The transport is the JAX package's RPC
    server and client in both cases: the port's frames must be what it
    carries."""
    wire = M.wire
    d = np.arange(1000, dtype=np.int64) * 7
    w = np.linspace(0, 1, 1000)
    s = np.array([f"s{i}" for i in range(1000)], dtype=object)
    ds = M.ColumnarDataSet(["d", "w", "s"], [d, w, s])
    # file serialization: base64 fallback
    back = wire.loads(wire.dumps(ds))
    assert isinstance(back, M.ColumnarDataSet)
    assert np.array_equal(np.asarray(back._cols[0]), d)
    assert np.allclose(np.asarray(back._cols[1]), w)
    assert list(back._cols[2]) == list(s)
    # rpc framing: raw buffers ride out-of-band binary frames
    from nebula_tpu.cluster.rpc import RpcClient, RpcServer
    srv = RpcServer()
    srv.register("q", lambda p: {"data": wire.to_wire(
        M.ColumnarDataSet(["d", "w"], [d, w])), "note": "x"})
    srv.start()
    try:
        cl = RpcClient(srv.host, srv.port)
        r = cl.call("q")
        assert r["note"] == "x"          # plain JSON fields intact
        got = wire.from_wire(r["data"])
        assert isinstance(got, M.ColumnarDataSet)
        assert np.array_equal(np.asarray(got._cols[0]), d)
        assert np.allclose(np.asarray(got._cols[1]), w)
        # non-blob calls still use the plain JSON frame
        srv.register("plain", lambda p: {"v": [1, 2, 3]})
        assert cl.call("plain") == {"v": [1, 2, 3]}
    finally:
        srv.stop()
    # materialized → plain dataset tag (rows already exist)
    ds2 = M.ColumnarDataSet(["v"], [np.arange(3)])
    _ = ds2.rows
    assert wire.to_wire(ds2)["@t"] == "dataset"


# ---------------------------------------------------------------------------
# seeded sweep: the operators of both packages on random values
# ---------------------------------------------------------------------------

R = ref_value


def _rand_scalar(rng: random.Random):
    k = rng.randrange(14)
    if k == 0:
        return rng.choice([0, 1, -1, R.INT64_MAX, -R.INT64_MAX - 1,
                           R.INT64_MAX - rng.randrange(3)])
    if k == 1:
        return rng.randint(-10**6, 10**6)
    if k == 2:
        return rng.choice([0.0, -0.0, 1.5, -2.25, math.nan, math.inf,
                           -math.inf, rng.uniform(-1e6, 1e6)])
    if k == 3:
        return rng.choice(["", "a", "ab", "b", "zz", 'q"t', "1"])
    if k == 4:
        return rng.choice([True, False])
    if k == 5:
        return R.NullValue(rng.choice(list(R.NullKind)))
    if k == 6:
        return R.EMPTY
    if k == 7:   # DATE, both sides of 1970
        return R.Date(rng.choice([1900, 1969, 1970, 2000, 2024]),
                      rng.randint(1, 12), rng.randint(1, 28))
    if k == 8:
        return R.Time(rng.randint(0, 23), rng.randint(0, 59),
                      rng.randint(0, 59), rng.choice([0, 1, 999_999]))
    if k == 9:
        return R.DateTime(rng.choice([1901, 1969, 1970, 2024]),
                          rng.randint(1, 12), rng.randint(1, 28),
                          rng.randint(0, 23), rng.randint(0, 59),
                          rng.randint(0, 59), rng.randint(0, 999_999))
    if k == 10:
        return R.Duration(seconds=rng.randint(-10**6, 10**6),
                          microseconds=rng.randint(-10**6, 10**6),
                          months=rng.randint(-30, 30))
    if k == 11:
        return ref_geo.from_wkt(f"POINT({rng.randint(-180, 180)} "
                                f"{rng.randint(-90, 90)}.5)")
    if k == 12:
        return [_rand_scalar(rng) for _ in range(rng.randint(0, 3))]
    return {rng.choice("abc"): _rand_scalar(rng)
            for _ in range(rng.randint(0, 3))}


def _outcome(fn, *args):
    try:
        return ("value", fn(*args))
    except Exception as ex:   # noqa: BLE001 — the class is compared
        return ("raise", type(ex).__name__)


@pytest.mark.parametrize("seed", range(8))
def test_random_values_match_reference(seed):
    rng = random.Random(seed)
    vals = [_rand_scalar(rng) for _ in range(60)]
    pvals = [to_port(v) for v in vals]
    for v, pv in zip(vals, pvals):
        assert port_value.type_name(pv) == R.type_name(v)
        assert port_value.total_order_key(pv) == R.total_order_key(v)
    pairs = [(i, j) for i in range(len(vals)) for j in range(len(vals))]
    for i, j in rng.sample(pairs, 600):
        for op in ("v_add", "v_sub", "v_lt", "v_eq"):
            kind, want = _outcome(getattr(R, op), vals[i], vals[j])
            pkind, got = _outcome(getattr(port_value, op), pvals[i],
                                  pvals[j])
            tag = (op, R.value_to_string(vals[i]),
                   R.value_to_string(vals[j]))
            assert pkind == kind, tag
            assert got == want if kind == "raise" \
                else same_value(got, want), tag
    order = sorted(range(len(vals)), key=lambda i: R.total_order_key(vals[i]))
    porder = sorted(range(len(vals)),
                    key=lambda i: port_value.total_order_key(pvals[i]))
    assert porder == order


def test_carrier_keeps_graph_values():
    v1 = R.Vertex("a", [R.Tag("person", {"at": R.Date(1969, 7, 20)})])
    v2 = R.Vertex(2, [])
    p = R.Path(v1, [R.Step(v2, "knows", 3, {"g": ref_geo.from_wkt(
        "POINT(1 2)"), "n": R.NULL_BAD_TYPE}, etype=-4)])
    e = R.Edge("a", 2, "knows", 3, {"t": R.Time(1, 2, 3, 4)}, etype=4)
    got = to_port([p, e, {"d": R.DataSet(["x"], [[R.EMPTY]])}])
    assert isinstance(got[0], port_value.Path)
    assert isinstance(got[0].steps[0].props["g"], port_geo.Geography)
    assert got[0].steps[0].props["n"] is port_value.NULL_BAD_TYPE
    assert got[1] == port_value.Edge("a", 2, "knows", 3,
                                     {"t": port_value.Time(1, 2, 3, 4)},
                                     etype=4)
    assert got[2]["d"].rows == [[port_value.EMPTY]]
