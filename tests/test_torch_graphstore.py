"""The port's store plane (`nebula_tpu_torch.graphstore`: schema, store,
csr export, index, fulltext, engine, schema_wire) against the JAX
package's `nebula_tpu.graphstore`, on the CPU.

Every test of tests/unit/test_graphstore.py runs here once a package,
with the same body (`M` is the package's namespace); its REPARTITION
test drives the store's own API, since the port has no query engine
yet.  A seeded sweep of random operation sequences (DDL over every
PropType with defaults, TTL and ALTER, vertex and edge inserts, updates
and deletes, failing writes, REPARTITION) is applied to a reference and
a port store, and everything the store reads back must agree: values
are carried into the port with `test_torch_value.to_port` and compared
by type name, text form and NULL kind.  `build_snapshot` must equal the
reference's array by array (P in {1, 3, 8}, with and without the vmax
slack, pool and tag tables included); a checkpoint written by either
package must restore in the other; `DurableEngine` must recover; the
fulltext and index structures must scan alike.  Tolerance: exact.
"""
import random
import types

import numpy as np
import pytest

import nebula_tpu.core.value as ref_value
import nebula_tpu.core.wire as ref_wire
import nebula_tpu.graphstore.csr as ref_csr
import nebula_tpu.graphstore.fulltext as ref_fulltext
import nebula_tpu.graphstore.index as ref_index
import nebula_tpu.graphstore.schema as ref_schema
import nebula_tpu.graphstore.schema_wire as ref_schema_wire
import nebula_tpu.graphstore.store as ref_store
import nebula_tpu.core.geo as ref_geo
from nebula_tpu.core.geo import from_wkt as ref_from_wkt
from nebula_tpu.native.kernels import _numpy_coo_csr
from nebula_tpu.native.kernels import dst_sort_key as ref_dst_sort_key
from nebula_tpu.query.parser import parse_expression as ref_parse_expression

import nebula_tpu_torch.core.geo as port_geo
import nebula_tpu_torch.core.value as port_value
import nebula_tpu_torch.core.wire as port_wire
import nebula_tpu_torch.graphstore.csr as port_csr
import nebula_tpu_torch.graphstore.fulltext as port_fulltext
import nebula_tpu_torch.graphstore.index as port_index
import nebula_tpu_torch.graphstore.schema as port_schema
import nebula_tpu_torch.graphstore.schema_wire as port_schema_wire
import nebula_tpu_torch.graphstore.store as port_store
from nebula_tpu_torch.query.parser import parse_expression as \
    port_parse_expression

from test_torch_value import same_value, to_port


def _ns(value, geo, schema, store, csr, index, fulltext, schema_wire, wire,
        parse_expression):
    ns = types.SimpleNamespace()
    for mod in (value, schema, store, csr):
        for k in dir(mod):
            if not k.startswith("__"):
                setattr(ns, k, getattr(mod, k))
    ns.value, ns.geo, ns.schema, ns.store, ns.csr = \
        value, geo, schema, store, csr
    ns.index, ns.fulltext = index, fulltext
    ns.schema_wire, ns.wire = schema_wire, wire
    ns.parse_expression = parse_expression
    return ns


REF = _ns(ref_value, ref_geo, ref_schema, ref_store, ref_csr, ref_index, ref_fulltext,
          ref_schema_wire, ref_wire, ref_parse_expression)
PORT = _ns(port_value, port_geo, port_schema, port_store, port_csr, port_index,
           port_fulltext, port_schema_wire, port_wire, port_parse_expression)
PKGS = {"ref": REF, "port": PORT}


@pytest.fixture(params=sorted(PKGS))
def M(request):
    return PKGS[request.param]


def same(got, want, at="value"):
    """A port structure (rows, dicts, lists, tuples of values) equals a
    reference one: same shape, every leaf `same_value`."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), \
            (at, got, want)
        for k in want:
            same(got[k], want[k], f"{at}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), \
            (at, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{at}[{i}]")
    elif want is None:
        assert got is None, (at, got)
    else:
        assert same_value(got, want), (at, got, want)


# ---------------------------------------------------------------------------
# the twins of tests/unit/test_graphstore.py
# ---------------------------------------------------------------------------


def mk_store(M, parts=4):
    st = M.GraphStore()
    st.create_space("test", partition_num=parts, vid_type="FIXED_STRING(32)")
    st.catalog.create_tag("test", "person", [
        M.PropDef("name", M.PropType.STRING),
        M.PropDef("age", M.PropType.INT64),
    ])
    st.catalog.create_edge("test", "knows", [
        M.PropDef("since", M.PropType.INT64),
        M.PropDef("weight", M.PropType.DOUBLE),
    ])
    return st


def seed(st):
    people = [("a", "Ann", 30), ("b", "Bob", 25), ("c", "Cat", 41),
              ("d", "Dan", 19), ("e", "Eve", 33)]
    for vid, name, age in people:
        st.insert_vertex("test", vid, "person", {"name": name, "age": age})
    edges = [("a", "b", 2010, 1.0), ("a", "c", 2012, 0.5),
             ("b", "c", 2015, 2.0), ("c", "d", 2018, 1.5),
             ("d", "e", 2020, 3.0), ("e", "a", 2021, 0.1)]
    for s, d, y, w in edges:
        st.insert_edge("test", s, "knows", d, 0, {"since": y, "weight": w})
    return st


def test_schema_ddl(M):
    c = M.Catalog()
    c.create_space("s1", partition_num=2)
    c.create_tag("s1", "t", [M.PropDef("x", M.PropType.INT64)])
    with pytest.raises(M.SchemaError):
        c.create_tag("s1", "t", [])
    c.create_tag("s1", "t", [], if_not_exists=True)
    with pytest.raises(M.SchemaError):
        c.create_edge("s1", "t", [])  # name conflict with tag
    c.alter_tag("s1", "t", [M.PropDef("x", M.PropType.INT64),
                            M.PropDef("y", M.PropType.STRING)])
    assert c.get_tag("s1", "t").latest.version == 1
    assert len(c.get_tag("s1", "t").versions) == 2
    c.create_index("s1", "idx_x", "t", ["x"], is_edge=False)
    with pytest.raises(M.SchemaError):
        c.create_index("s1", "bad", "t", ["nope"], is_edge=False)


def test_defaults_and_nullability(M):
    st = M.GraphStore()
    st.create_space("s", partition_num=2)
    st.catalog.create_tag("s", "t", [
        M.PropDef("a", M.PropType.INT64, nullable=False, default=7,
                  has_default=True),
        M.PropDef("b", M.PropType.STRING, nullable=True),
        M.PropDef("c", M.PropType.INT64, nullable=False),
    ])
    with pytest.raises(M.SchemaError):
        st.insert_vertex("s", "v1", "t", {})  # c not null, no default
    st.insert_vertex("s", "v1", "t", {"c": 1})
    row = st.get_vertex("s", "v1")["t"]
    assert row["a"] == 7 and M.is_null(row["b"]) and row["c"] == 1
    with pytest.raises(M.SchemaError):
        st.insert_vertex("s", "v2", "t", {"c": "wrong type"})


def test_insert_and_get_neighbors(M):
    st = seed(mk_store(M))
    out = list(st.get_neighbors("test", ["a"], ["knows"], "out"))
    assert [(r[0], r[3]) for r in out] == [("a", "b"), ("a", "c")]
    assert out[0][4]["since"] == 2010
    inn = list(st.get_neighbors("test", ["c"], ["knows"], "in"))
    assert sorted((r[3]) for r in inn) == ["a", "b"]
    assert all(r[5] == -1 for r in inn)
    both = list(st.get_neighbors("test", ["c"], None, "both"))
    assert len(both) == 3  # out: d; in: a, b


def test_delete_vertex_cascades(M):
    st = seed(mk_store(M))
    st.delete_vertex("test", "c")
    assert st.get_vertex("test", "c") is None
    assert list(st.get_neighbors("test", ["a"], ["knows"], "out")) == [
        ("a", "knows", 0, "b", {"since": 2010, "weight": 1.0}, 1)]
    assert list(st.get_neighbors("test", ["d"], ["knows"], "in")) == []


def test_update(M):
    st = seed(mk_store(M))
    assert st.update_vertex("test", "a", "person", {"age": 31})
    assert st.get_vertex("test", "a")["person"]["age"] == 31
    assert st.update_edge("test", "a", "knows", "b", 0, {"since": 1999})
    assert st.get_edge("test", "a", "knows", "b")["since"] == 1999
    # in-plane mirror also updated
    inn = list(st.get_neighbors("test", ["b"], ["knows"], "in"))
    assert inn[0][4]["since"] == 1999
    assert not st.update_edge("test", "x", "knows", "y", 0, {"since": 1})


def test_dense_ids_encode_partition(M):
    st = seed(mk_store(M, parts=4))
    sd = st.space("test")
    for vid, d in sd.vid_to_dense.items():
        assert d % 4 == sd.part_of(vid)
        assert sd.dense_to_vid[d] == vid


def test_stable_hash(M):
    assert M.stable_vid_hash("abc") == M.stable_vid_hash("abc")
    assert M.stable_vid_hash(42) == 42
    assert port_store.stable_vid_hash("abc") == \
        ref_store.stable_vid_hash("abc")


def test_csr_snapshot_matches_store(M):
    st = seed(mk_store(M, parts=4))
    snap = M.build_snapshot(st, "test")
    sd = st.space("test")
    blk = snap.block("knows", "out")
    assert blk.total_edges() == 6
    # every vertex's CSR neighbors == store's get_neighbors dsts
    for vid, dense in sd.vid_to_dense.items():
        want = [sd.vid_to_dense[r[3]]
                for r in st.get_neighbors("test", [vid], ["knows"], "out")]
        got = list(M.neighbors_of(snap, blk, dense))
        assert got == want, (vid, got, want)
    # reversed block
    blk_in = snap.block("knows", "in")
    for vid, dense in sd.vid_to_dense.items():
        want = sorted(sd.vid_to_dense[r[3]]
                      for r in st.get_neighbors("test", [vid], ["knows"],
                                                "in"))
        got = sorted(M.neighbors_of(snap, blk_in, dense))
        assert got == want


def test_csr_props_and_strings(M):
    st = seed(mk_store(M, parts=2))
    st.insert_vertex("test", "f", "person", {"name": "Fox", "age": M.NULL})
    snap = M.build_snapshot(st, "test")
    tt = snap.tags["person"]
    sd = st.space("test")
    d = sd.vid_to_dense["f"]
    p, li = snap.owner(d), snap.local(d)
    assert tt.present[p, li]
    assert tt.props["age"][p, li] == M.INT_NULL  # null sentinel
    code = tt.props["name"][p, li]
    assert snap.pool.decode(int(code)) == "Fox"
    assert snap.pool.lookup("Fox") == code
    assert snap.pool.lookup("NotThere") == -2
    # edge prop column
    blk = snap.block("knows", "out")
    a = sd.vid_to_dense["a"]
    pa, la = snap.owner(a), snap.local(a)
    lo = int(blk.indptr[pa, la])
    assert blk.props["since"][pa, lo] == 2010
    assert blk.props["weight"][pa, lo] == 1.0


def test_expand_frontier_host(M):
    st = seed(mk_store(M, parts=4))
    snap = M.build_snapshot(st, "test")
    sd = st.space("test")
    blk = snap.block("knows", "out")
    f0 = np.array([sd.vid_to_dense["a"]], np.int32)
    f1 = M.expand_frontier_host(snap, blk, f0)
    assert sorted(sd.dense_to_vid[d] for d in f1) == ["b", "c"]
    f2 = M.expand_frontier_host(snap, blk, f1)
    assert sorted(sd.dense_to_vid[d] for d in f2) == ["c", "d"]


def test_epoch_bumps(M):
    st = mk_store(M)
    e0 = st.space("test").epoch
    st.insert_vertex("test", "z", "person", {"name": "Z", "age": 1})
    assert st.space("test").epoch > e0


def test_scan(M):
    st = seed(mk_store(M))
    assert len(list(st.scan_vertices("test"))) == 5
    assert len(list(st.scan_edges("test", "knows"))) == 6
    assert len(list(st.scan_vertices("test", tag="person"))) == 5


def _two_hops(st, space, src):
    first = [r[3] for r in st.get_neighbors(space, [src], ["E"], "out")]
    return sorted(r[3] for r in st.get_neighbors(space, first, ["E"], "out"))


def test_repartition_preserves_rows_and_indexes(M, tmp_path):
    """REPARTITION (the part split/merge task) through the store's API:
    rows, two-hop neighbours, index scans and durability must all
    survive a 2->8 re-home, and a cancelled run must leave the space
    untouched."""
    import threading

    store = M.GraphStore(data_dir=str(tmp_path / "db"))
    store.create_space("rp", partition_num=2, vid_type="INT64")
    store.catalog.create_tag("rp", "P", [M.PropDef("a", M.PropType.INT64)])
    store.catalog.create_edge("rp", "E", [M.PropDef("w", M.PropType.INT64)])
    store.catalog.create_index("rp", "pa", "P", ["a"], is_edge=False)
    for v in range(30):
        store.insert_vertex("rp", v, "P", {"a": v})
        store.insert_edge("rp", v, "E", (v + 1) % 30, 0, {"w": v})
    before = _two_hops(store, "rp", 0)
    rows = sorted(map(repr, store.scan_edges("rp", "E")))

    # cancelled BEFORE the swap: -1, space untouched
    tok = threading.Event()
    tok.set()
    assert store.repartition("rp", 4, cancel=tok) == -1
    assert store.space("rp").num_parts == 2

    assert store.repartition("rp", 8) >= 0
    assert store.space("rp").num_parts == 8
    assert _two_hops(store, "rp", 0) == before
    assert sorted(map(repr, store.scan_edges("rp", "E"))) == rows
    got = store.index_scan("rp", "pa", [], (25, M.index.MAX, False, True))
    assert sorted(got) == [26, 27, 28, 29]

    # durability: replay reproduces the new layout
    store.close()
    store2 = M.GraphStore(data_dir=str(tmp_path / "db"))
    try:
        assert store2.space("rp").num_parts == 8
        assert _two_hops(store2, "rp", 0) == before
        got = store2.index_scan("rp", "pa", [], (25, M.index.MAX, False,
                                                 True))
        assert sorted(got) == [26, 27, 28, 29]
    finally:
        store2.close()


# ---------------------------------------------------------------------------
# a seeded sweep of operation sequences on a reference and a port store
# ---------------------------------------------------------------------------

ALL_TYPES = [t.name for t in ref_schema.PropType]
LIVE_TS, DEAD_TS = 1 << 40, 5       # TTL columns: far future, long past


def _ref_val(t, rng):
    """A reference value of PropType name t (NULL now and then)."""
    if rng.random() < .08:
        return ref_value.NULL
    if t == "BOOL":
        return rng.random() < .5
    if t in ("INT64", "TIMESTAMP"):
        return rng.choice([rng.randint(-10, 100), 2 ** 62, -2 ** 62])
    if t == "INT32":
        return rng.randint(-2 ** 31, 2 ** 31 - 1)
    if t == "INT16":
        return rng.randint(-2 ** 15, 2 ** 15 - 1)
    if t == "INT8":
        return rng.randint(-128, 127)
    if t in ("FLOAT", "DOUBLE"):
        return rng.choice([rng.uniform(-5, 5), float(rng.randint(0, 9)),
                           rng.randint(0, 9)])      # an int coerces
    if t in ("STRING", "FIXED_STRING"):
        return rng.choice(["ann", "bob", "", "Zoë", "a b"])
    if t == "DATE":
        return ref_value.Date(rng.randint(1950, 2030), rng.randint(1, 12),
                              rng.randint(1, 28))
    if t == "TIME":
        return ref_value.Time(rng.randint(0, 23), rng.randint(0, 59),
                              rng.randint(0, 59), rng.randint(0, 999999))
    if t == "DATETIME":
        return ref_value.DateTime(rng.randint(1950, 2030),
                                  rng.randint(1, 12), rng.randint(1, 28),
                                  rng.randint(0, 23), rng.randint(0, 59),
                                  rng.randint(0, 59), rng.randint(0, 999999))
    if t == "DURATION":
        return ref_value.Duration(rng.randint(-10 ** 6, 10 ** 6),
                                  rng.randint(0, 999999), rng.randint(0, 30))
    if t == "GEOGRAPHY":
        return ref_from_wkt(rng.choice([
            f"POINT({rng.uniform(-9, 9):.3f} {rng.uniform(-9, 9):.3f})",
            "LINESTRING(0 0, 1 1, 2 0)"]))
    raise ValueError(t)


class _Twin:
    """One operation script, applied to a reference and a port store;
    every call's outcome (its result or its exception's class and text)
    must agree."""

    def __init__(self, rng, parts, vid_type):
        self.rng = rng
        self.stores = (REF.GraphStore(), PORT.GraphStore())
        self.int_vids = vid_type == "INT64"
        self.both("create_space", "s", partition_num=parts,
                  vid_type=vid_type)
        for st in self.stores:
            st.delta_watch("s")

    def close(self):
        for st in self.stores:
            st.close()

    def vid(self):
        v = self.rng.randrange(40)
        return v if self.int_vids else f"v{v}"

    def call(self, target, name, *args, **kw):
        """Run one method on both packages (args are reference values,
        carried into the port) and compare the outcomes."""
        out = []
        for i, M in enumerate((REF, PORT)):
            obj = target(M, self.stores[i])
            a = args if M is REF else tuple(_carry(x) for x in args)
            k = kw if M is REF else {n: _carry(x) for n, x in kw.items()}
            try:
                res = getattr(obj, name)(*a, **k)
                if isinstance(res, types.GeneratorType):
                    res = list(res)
                out.append(("ok", res))
            except Exception as ex:  # noqa: BLE001 — compared below
                out.append(("raise", f"{type(ex).__name__}: {ex}"))
        (rk, rv), (pk, pv) = out
        assert rk == pk, (name, args, out)
        if rk == "raise":
            assert rv == pv, (name, args)
        elif name not in ("create_space", "create_tag", "create_edge",
                          "alter_tag", "alter_edge", "create_index"):
            same(pv, rv, name)
        return rk

    def both(self, name, *args, **kw):
        return self.call(lambda M, st: st, name, *args, **kw)

    def cat(self, name, *args, **kw):
        return self.call(lambda M, st: st.catalog, name, *args, **kw)


def _carry(x):
    """A reference argument as the port's (PropDefs, values, lists)."""
    if isinstance(x, ref_schema.PropDef):
        return port_schema.PropDef(
            x.name, port_schema.PropType[x.ptype.name], x.nullable,
            to_port(x.default) if x.has_default else x.default,
            x.has_default, x.fixed_len, x.comment)
    if isinstance(x, list):
        return [_carry(v) for v in x]
    if isinstance(x, dict):
        return {k: _carry(v) for k, v in x.items()}
    if isinstance(x, (ref_value.NullValue, ref_value.Date, ref_value.Time,
                      ref_value.DateTime, ref_value.Duration)) \
            or type(x).__module__ == "nebula_tpu.core.geo":
        return to_port(x)
    return x


def _props(rng, types_, default_share=.5):
    out = []
    for i, t in enumerate(types_):
        pd = ref_schema.PropDef(f"p{i}_{t.lower()}", ref_schema.PropType[t],
                                fixed_len=8 if t == "FIXED_STRING" else 0)
        if rng.random() < default_share:
            v = _ref_val(t, rng)
            if not isinstance(v, ref_value.NullValue):
                pd.default, pd.has_default = v, True
        out.append(pd)
    return out


def _row(rng, props, share=.8):
    return {p.name: _ref_val(p.ptype.name, rng) for p in props
            if rng.random() < share}


def _compare_reads(tw, etypes, tags):
    """Every read the store offers, on both packages."""
    tw.both("stats", "s")
    tw.both("stats_detail", "s")
    for tag in [None] + tags:
        tw.both("scan_vertices", "s", tag)
    for et in [None] + etypes:
        tw.both("scan_edges", "s", et)
    for v in range(40):
        vid = v if tw.int_vids else f"v{v}"
        tw.both("get_vertex", "s", vid)
    vids = [tw.vid() for _ in range(8)]
    for direction in ("out", "in", "both"):
        tw.both("get_neighbors", "s", vids, None, direction)
        tw.both("get_neighbors", "s", vids, etypes[:1], direction,
                limit_per_src=2)
    for text in ("e1.w > 20", "e1.w IS NULL OR rank(edge) > 0"):
        rows = []
        for i, M in enumerate((REF, PORT)):
            rows.append(list(tw.stores[i].get_neighbors(
                "s", vids, ["e1"], "out",
                edge_filter=M.parse_expression(text), limit_per_src=3)))
        same(rows[1], rows[0], text)
    for s, et, r, d, _ in list(tw.stores[0].scan_edges("s"))[:20]:
        tw.both("get_edge", "s", s, et, d, r)
    for idx in ("i_w", "i_t"):
        tw.both("index_scan", "s", idx, [])
        tw.both("index_scan", "s", idx, [], (10, 60, True, False))
    recs = [st.delta_records("s") for st in tw.stores]
    if recs[0] is None:
        assert recs[1] is None
    else:
        assert sorted(map(repr, recs[1][0])) == \
            sorted(map(repr, recs[0][0]))
        assert recs[1][1:] == recs[0][1:]
    assert tw.stores[1].space("s").epoch == tw.stores[0].space("s").epoch


@pytest.mark.parametrize("sweep", range(6))
def test_random_operation_sequences_match_reference(sweep):
    rng = random.Random(1000 + sweep)
    tw = _Twin(rng, parts=rng.choice([1, 2, 3, 5]),
               vid_type="INT64" if sweep % 3 else "FIXED_STRING(8)")
    try:
        tag_props = _props(rng, ALL_TYPES)
        edge_props = [ref_schema.PropDef("w", ref_schema.PropType.INT64)] \
            + _props(rng, ["STRING", "DOUBLE", "DATETIME", "GEOGRAPHY",
                           "BOOL"])
        ttl_props = [ref_schema.PropDef("ts", ref_schema.PropType.INT64),
                     ref_schema.PropDef("x", ref_schema.PropType.STRING)]
        tw.cat("create_tag", "s", "t", tag_props)
        tw.cat("create_tag", "s", "tt", ttl_props, ttl_col="ts",
               ttl_duration=100)
        tw.cat("create_edge", "s", "e1", edge_props)
        tw.cat("create_edge", "s", "e2", ttl_props, ttl_col="ts",
               ttl_duration=100)
        tw.cat("create_index", "s", "i_w", "e1", ["w"], is_edge=True)
        tw.cat("create_index", "s", "i_t", "t",
               [tag_props[1].name], is_edge=False)
        for step in range(140):
            op = rng.random()
            if op < .25:
                tw.both("insert_vertex", "s", tw.vid(), "t",
                        _row(rng, tag_props))
            elif op < .32:
                tw.both("insert_vertex", "s", tw.vid(), "tt",
                        {"ts": rng.choice([LIVE_TS, DEAD_TS]), "x": "q"})
            elif op < .55:
                tw.both("insert_edge", "s", tw.vid(), "e1", tw.vid(),
                        rng.randint(0, 2), _row(rng, edge_props))
            elif op < .6:
                tw.both("insert_edge", "s", tw.vid(), "e2", tw.vid(), 0,
                        {"ts": rng.choice([LIVE_TS, DEAD_TS]), "x": "y"})
            elif op < .67:
                tw.both("update_vertex", "s", tw.vid(), "t",
                        _row(rng, tag_props, .3))
            elif op < .74:
                tw.both("update_edge", "s", tw.vid(), "e1", tw.vid(),
                        rng.randint(0, 2), _row(rng, edge_props, .4))
            elif op < .8:
                live = list(tw.stores[0].scan_edges("s", "e1"))
                if live:
                    s, _, r, d, _ = rng.choice(live)
                    tw.both("delete_edge", "s", s, "e1", d, r)
            elif op < .84:
                tw.both("delete_vertex", "s", tw.vid(),
                        with_edges=rng.random() < .7)
            elif op < .87:
                tw.both("delete_tag", "s", tw.vid(), ["t"])
            elif op < .9:
                # a failing write: a wrong type or a missing NOT NULL
                tw.both("insert_vertex", "s", tw.vid(), "t",
                        {tag_props[1].name: "not an int"})
            elif op < .92:
                tw.both("insert_edge", "s", tw.vid(), "nope", tw.vid(), 0,
                        {})
            elif op < .94 and step > 40:
                more = _props(rng, [rng.choice(ALL_TYPES)], default_share=1)
                more[0].name = f"added{step}"
                tag_props = tag_props + more
                tw.cat("alter_tag", "s", "t", tag_props)
            elif op < .95:
                tw.cat("alter_edge", "s", "e2", ttl_props, ttl_col="ts",
                       ttl_duration=rng.choice([100, 0]))
            elif op < .965:
                tw.both("repartition", "s", rng.choice([1, 2, 4, 7]))
            if step % 35 == 34:
                _compare_reads(tw, ["e1", "e2"], ["t", "tt"])
        tw.both("compact", "s")
        _compare_reads(tw, ["e1", "e2"], ["t", "tt"])
    finally:
        tw.close()


# ---------------------------------------------------------------------------
# build_snapshot, array by array
# ---------------------------------------------------------------------------


def _snapshot_store(M, parts, vid_type, seed_):
    """One seeded graph: ints or strings, a NULL here and there, a TTL'd
    edge type, a prop added by ALTER with a default, and two tags."""
    rng = random.Random(seed_)
    st = M.GraphStore()
    st.create_space("g", partition_num=parts, vid_type=vid_type)
    P = M.PropType
    st.catalog.create_tag("g", "person", [M.PropDef("age", P.INT64),
                                          M.PropDef("name", P.STRING)])
    st.catalog.create_tag("g", "place", [M.PropDef("at", P.DATE)])
    st.catalog.create_edge("g", "knows", [
        M.PropDef("w", P.INT64), M.PropDef("f", P.DOUBLE),
        M.PropDef("city", P.STRING), M.PropDef("when", P.DATETIME)])
    st.catalog.create_edge("g", "ttl", [M.PropDef("ts", P.INT64)],
                           ttl_col="ts", ttl_duration=100)
    vid = (lambda v: v) if vid_type == "INT64" else (lambda v: f"p{v:03d}")
    n = 70
    for v in range(n):
        st.insert_vertex("g", vid(v), "person",
                         {"age": rng.randint(0, 90) if rng.random() > .1
                          else M.NULL, "name": rng.choice(["a", "b", "c"])})
        if v % 3 == 0:
            st.insert_vertex("g", vid(v), "place",
                             {"at": M.Date(2000, 1 + v % 12, 1)})
    for v in range(n):
        for _ in range(rng.randint(0, 6)):
            st.insert_edge("g", vid(v), "knows", vid(rng.randrange(n + 5)),
                           rng.randint(0, 2),
                           {"w": rng.randint(0, 99), "f": rng.random(),
                            "city": rng.choice(["x", "y"]),
                            "when": M.DateTime(2020, 1, 1, v % 24, 0, 0, 0)})
        if v % 4 == 0:
            st.insert_edge("g", vid(v), "ttl", vid((v + 1) % n), 0,
                           {"ts": LIVE_TS if v % 8 else DEAD_TS})
    st.catalog.alter_edge("g", "knows", st.catalog.get_edge(
        "g", "knows").latest.props + [M.PropDef(
            "extra", P.INT64, default=41, has_default=True)])
    st.insert_edge("g", vid(1), "knows", vid(2), 9,
                   {"w": 1, "f": .5, "city": "z", "extra": 7,
                    "when": M.NULL})
    return st


def _assert_snapshots_equal(got, want):
    assert (got.space, got.epoch, got.num_parts, got.vmax) == \
        (want.space, want.epoch, want.num_parts, want.vmax)
    np.testing.assert_array_equal(got.num_vertices, want.num_vertices)
    assert got.dense_to_vid == want.dense_to_vid
    assert got.pool.strings == want.pool.strings
    assert sorted(got.blocks) == sorted(want.blocks)
    for k, b in want.blocks.items():
        g = got.blocks[k]
        for name in ("indptr", "nbr", "rank"):
            a, c = getattr(g, name), getattr(b, name)
            assert a.dtype == c.dtype, (k, name)
            np.testing.assert_array_equal(a, c, err_msg=f"{k} {name}")
        assert {n: t.name for n, t in g.prop_types.items()} == \
            {n: t.name for n, t in b.prop_types.items()}
        assert list(g.props) == list(b.props)
        for n in b.props:
            assert g.props[n].dtype == b.props[n].dtype, (k, n)
            np.testing.assert_array_equal(g.props[n], b.props[n],
                                          err_msg=f"{k} {n}")
    assert sorted(got.tags) == sorted(want.tags)
    for tg, t in want.tags.items():
        g = got.tags[tg]
        np.testing.assert_array_equal(g.present, t.present)
        assert list(g.props) == list(t.props)
        for n in t.props:
            assert g.props[n].dtype == t.props[n].dtype
            np.testing.assert_array_equal(g.props[n], t.props[n])


@pytest.mark.parametrize("vid_type", ["INT64", "FIXED_STRING(8)"])
@pytest.mark.parametrize("vmax_extra", [0, 5])
@pytest.mark.parametrize("parts", [1, 3, 8])
def test_build_snapshot_matches_reference(parts, vmax_extra, vid_type):
    ref = _snapshot_store(REF, parts, vid_type, 7 + parts)
    port = _snapshot_store(PORT, parts, vid_type, 7 + parts)
    want = ref_csr.build_snapshot(ref, "g", vmax_extra=vmax_extra)
    got = port_csr.build_snapshot(port, "g", vmax_extra=vmax_extra)
    _assert_snapshots_equal(got, want)
    # the export's restrictions: some edge types, props and directions
    kw = dict(edge_types=["knows"], tags=["person"], directions=("in",),
              edge_props={"knows": ["w", "city"]},
              tag_props={"person": ["name"]})
    _assert_snapshots_equal(port_csr.build_snapshot(port, "g", **kw),
                            ref_csr.build_snapshot(ref, "g", **kw))


@pytest.mark.parametrize("n,P,vmax", [(0, 3, 4), (1, 1, 1), (500, 4, 40),
                                      (2000, 8, 300)])
def test_coo_to_csr_matches_the_reference_numpy_twin(n, P, vmax):
    rng = np.random.default_rng(n + P)
    src = rng.integers(0, P * vmax, n)
    dst = np.where(rng.random(n) < .1, -1, rng.integers(0, P * vmax, n))
    rank = rng.integers(0, 3, n)
    key = rng.integers(0, 50, n)
    got = port_csr.build_coo_csr(src, dst, rank, key, P, vmax)
    if n == 0:
        from nebula_tpu.native.kernels import build_coo_csr
        want = build_coo_csr(src, dst, rank, key, P, vmax)
    else:
        emax = max(1, int(np.bincount(src % P, minlength=P).max()))
        want = _numpy_coo_csr(src, dst, rank, key, P, vmax, emax) + (emax,)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    vids = [f"s{x}" for x in rng.integers(0, 30, 12)]
    np.testing.assert_array_equal(port_csr.dst_sort_key(vids),
                                  ref_dst_sort_key(vids))


# ---------------------------------------------------------------------------
# checkpoints across packages, the journal, schema_wire
# ---------------------------------------------------------------------------


def _state(M, st, space="g"):
    """Everything a restored store must reproduce, comparable across
    packages (the port's values carried back to text forms)."""
    text = M.value.value_to_string
    verts = sorted((repr(v), t, {k: text(x) for k, x in p.items()})
                   .__repr__() for v, t, p in st.scan_vertices(space))
    edges = sorted((repr(s), e, r, repr(d), {k: text(x) for k, x in
                                             p.items()}).__repr__()
                   for s, e, r, d, p in st.scan_edges(space))
    sd = st.space(space)
    return (verts, edges, sd.num_parts, list(sd.dense_to_vid),
            sorted(t.name for t in st.catalog.tags(space)),
            sorted(e.name for e in st.catalog.edges(space)),
            sorted(i.name for i in st.catalog.indexes(space)),
            st.catalog.version)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_restores_in_the_other_package(writer, tmp_path):
    W, R = (REF, PORT) if writer == "ref" else (PORT, REF)
    src = _snapshot_store(W, 3, "INT64", 5)
    src.catalog.create_index("g", "iw", "knows", ["w"], is_edge=True)
    src.rebuild_index("g", "iw")
    src.checkpoint(str(tmp_path / "ck"))
    dst = R.GraphStore.from_checkpoint(str(tmp_path / "ck"))
    assert _state(R, dst) == _state(W, src)
    same_rows = [sorted(map(repr, st.index_scan("g", "iw", [], (10, 50, True,
                                                                True))))
                 for st in (src, dst)]
    assert same_rows[0] == same_rows[1]
    # the catalog alone, through both wires
    data = W.schema_wire.dumps(src.catalog)
    back = R.schema_wire.loads(data)
    assert R.schema_wire.dumps(back) == data


def test_durable_engine_recovers_in_both_packages(tmp_path):
    """`GraphStore(data_dir=...)`: journal replay after close, then a
    compaction (checkpoint + truncated journal) and more writes."""
    states = []
    for M in (REF, PORT):
        d = str(tmp_path / M.value.__name__)
        st = M.GraphStore(data_dir=d)
        st.create_space("g", partition_num=2, vid_type="INT64")
        st.catalog.create_tag("g", "t", [M.PropDef("a", M.PropType.INT64),
                                         M.PropDef("d", M.PropType.DATE)])
        st.catalog.create_edge("g", "e", [M.PropDef("w", M.PropType.INT64)])
        for v in range(12):
            st.insert_vertex("g", v, "t", {"a": v, "d": M.Date(2001, 2, v + 1)})
            st.insert_edge("g", v, "e", (v * 5) % 12, 0, {"w": v})
        st.delete_edge("g", 3, "e", 3, 0)
        st.close()
        st = M.GraphStore(data_dir=d)
        first = _state(M, st)
        st.compact_journal()
        st.update_vertex("g", 4, "t", {"a": 99})
        st.delete_vertex("g", 5)
        st.close()
        st = M.GraphStore(data_dir=d)
        states.append((first, _state(M, st)))
        st.close()
    assert states[1] == states[0]


# ---------------------------------------------------------------------------
# the fulltext and index structures
# ---------------------------------------------------------------------------


def test_analyze(M):
    assert M.fulltext.analyze("Boris Diaw-2010") == ["boris", "diaw", "2010"]
    assert M.fulltext.analyze("") == []


def test_levenshtein_band(M):
    lv = M.fulltext.levenshtein_leq
    assert lv("kitten", "sitten", 1)
    assert not lv("kitten", "sitting", 2)
    assert lv("kitten", "sitting", 3)
    assert not lv("abc", "xyz", 2)
    assert lv("", "ab", 2)


def test_index_data_ops(M):
    ft = M.fulltext.FulltextIndexData("f", "t", "name", False, 2, 1)
    ft.add(0, "Boris Diaw", 1)
    ft.add(1, "Bob", 2)
    ft.add(0, "Alice", 3)
    assert ft.search("PREFIX", "bo") == [1, 2]       # part order
    assert ft.search("WILDCARD", "*li*") == [3]
    assert ft.search("REGEXP", "^B.*w$") == [1]
    assert ft.search("FUZZY", "Alise") == [3]
    ft.remove(0, 1)
    assert ft.search("PREFIX", "bo") == [2]
    assert ft.count() == 2
    with pytest.raises(ValueError):
        ft.search("REGEXP", "(unclosed")


def test_fulltext_listener_through_the_store_matches_reference():
    """The store's fulltext hooks: a listener thread maintains the text
    index on writes, and `fulltext_search` drains it first."""
    got = []
    for M in (REF, PORT):
        st = M.GraphStore()
        try:
            st.create_space("f", partition_num=3, vid_type="INT64")
            st.catalog.create_tag("f", "player",
                                  [M.PropDef("name", M.PropType.STRING)])
            st.catalog.add_listener("f", "ELASTICSEARCH", "127.0.0.1:9200")
            st.catalog.create_fulltext_index("f", "ft", "player", "name",
                                             is_edge=False)
            for v, name in enumerate(["Boris Diaw", "Bob Marley", "Alice",
                                      "boxer", "Tim Duncan"]):
                st.insert_vertex("f", v, "player", {"name": name})
            st.delete_vertex("f", 3)
            st.update_vertex("f", 2, "player", {"name": "Alise Bo"})
            got.append([sorted(map(repr, st.fulltext_search("f", "ft", op,
                                                           q)))
                        for op, q in (("PREFIX", "bo"), ("WILDCARD", "*i*"),
                                      ("REGEXP", "^B.*"), ("FUZZY", "Alice"))])
        finally:
            st.close()
    assert got[1] == got[0]
    assert got[0][0]


def test_index_and_geo_index_scans(M):
    idx = M.index.IndexData("i", ["a", "b"], False, 2)
    rows = [({"a": 1, "b": "x"}, 10), ({"a": 1, "b": "y"}, 11),
            ({"a": 2, "b": M.NULL}, 12), ({"a": M.NULL, "b": "x"}, 13),
            ({"a": 3, "b": "z"}, 14)]
    for i, (row, e) in enumerate(rows):
        idx.add(i % 2, row, e)
    assert idx.count() == 5
    scan = lambda pre, rng=None: sorted(  # noqa: E731
        idx.scan(0, pre, rng) + idx.scan(1, pre, rng))
    assert scan([1]) == [10, 11]
    assert scan([1], ("x", "y", False, True)) == [11]
    assert scan([], (1, 2, True, True)) == [10, 11, 12]
    assert scan([], (2, M.index.MAX, False, True)) == [13, 14]
    idx.remove(1, rows[1][0], 11)
    assert scan([1]) == [10]
    _geo_hits(M)


def _geo_hits(M):
    geo = M.index.GeoIndexData("g", ["loc"], False, 1)
    pts = {1: "POINT(1 1)", 2: "POINT(1.0001 1.0001)", 3: "POINT(50 50)",
           4: "LINESTRING(0.9 0.9, 1.1 1.1)"}
    for e, w in pts.items():
        geo.add(0, {"loc": M.geo.from_wkt(w)}, e)
    geo.add(0, {"loc": "POINT(1 1.00005)"}, 6)    # WKT text keys alike
    geo.add(0, {"loc": M.NULL}, 5)
    q = M.geo.from_wkt("POLYGON((0.5 0.5, 1.5 0.5, 1.5 1.5, 0.5 1.5, "
                       "0.5 0.5))")
    hits = geo.scan_geo(0, M.geo.covering_ranges(q))
    assert {1, 2, 6} <= set(hits) and not {3, 5} & set(hits)
    assert len(hits) == len(set(hits))
    geo.remove(0, {"loc": M.geo.from_wkt(pts[4])}, 4)
    assert 4 not in geo.scan_geo(0, M.geo.covering_ranges(q))
    return hits


def test_geo_index_scans_match_reference():
    assert _geo_hits(PORT) == _geo_hits(REF)
