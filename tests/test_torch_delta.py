"""The port's delta plane against the JAX reference, on the CPU.

The merge kernel's plain version is held against the reference's jitted
`_merge_delta`, vmapped over the parts, on random inputs (no delta rows,
no tombstones, everything tombstoned, an empty frontier, inactive and
out-of-range sources, MAXI padding).  End to end, twin stores are built
from one seed and written by one script (each delta log has one
consumer, so each runtime gets its own store): the reference
`TpuRuntime(make_mesh(1))` (local mode) pins a reference `GraphStore`
with `tpu_delta_max_edges` set; `GpuRuntime(device="cpu",
delta_max_edges=...)` pins its twin, the port's own `GraphStore`, with
`pin(store, space)` (the reference's vmax slack and compaction flags
passed as its constructor arguments).  After every write group GO's
YIELD columns must equal the reference's in order, and so must
hop_edges and frontier_sizes; a fresh pin of the written store must
give the same columns; the BFS depths and per-level hop_edges must
equal the reference's.  Where the reference's apply gives up (an
overflow, a broken or gapped log, a write to a degree-split pin), the
port rebuilds and re-pins with the reference's columns; the bench's
`SnapshotStore`, which cannot be exported, still raises there.  DATE,
DATETIME, TIME, DURATION and GEOGRAPHY values encode and decode as the
reference's (before 1970 too), and logged writes of them reach the
plane.  A string first pooled by a write (fault C2, where the
reference's cached WHERE program goes stale) gives the port a fresh
pin's rows.  `_PortStore` and `_port_pin` (a reference store carried
into the port through `snapshot_from_fields` and a converting reader)
stay for the mesh and MATCH twins that import them.  Tolerance: exact —
the path moves integers and copies float64 values.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.core import expr as RE
from nebula_tpu.core.value import NULL as REF_NULL
from nebula_tpu.core.value import NullValue as RefNull
from nebula_tpu.graphstore import csr as ref_csr
from nebula_tpu.graphstore.schema import PropDef as RefPropDef
from nebula_tpu.graphstore.schema import PropType as RefPropType
from nebula_tpu.graphstore.store import GraphStore
from nebula_tpu.tpu import TpuRuntime, make_mesh
from nebula_tpu.tpu import hop as ref_hop
from nebula_tpu.utils.config import get_config

from nebula_tpu_torch.bench import datagen as D
from nebula_tpu_torch.core import expr as PE
from nebula_tpu_torch.core import value as PV
from nebula_tpu_torch.core.value import NULL
from nebula_tpu_torch.gpu import GpuRuntime, GpuUnavailable
from nebula_tpu_torch.gpu import kernels as K
from nebula_tpu_torch.gpu.hop import run_hops
from nebula_tpu_torch.graphstore import csr as port_csr
from nebula_tpu_torch.graphstore.csr import snapshot_from_fields
from nebula_tpu_torch.graphstore.delta import HostDelta
from nebula_tpu_torch.graphstore.schema import PropDef, PropType
from nebula_tpu_torch.graphstore.store import GraphStore as PortGraphStore

from test_torch_value import same_value, to_port

MAXI = np.iinfo(np.int32).max
N = 90                 # persons of the twin stores
DCAP = 64              # tpu_delta_max_edges of both runtimes
SEEDS = [1, 5, 9]


# ---------------------------------------------------------------------------
# the kernel: merge_delta_plain against the reference's _merge_delta
# ---------------------------------------------------------------------------


def _merge_inputs(seed, P, EB, Dcap, Tcap, case, vmax=16, emax=40):
    rng = np.random.default_rng(seed)
    total = rng.integers(0, EB + 1, P).astype(np.int32)
    total[0] = EB                       # part 0 has slots to tombstone
    j = np.arange(EB)
    ve = j[None, :] < total[:, None]
    eidx = np.sort(rng.integers(0, emax, (P, EB)), axis=1)
    s = {"src": np.where(ve, rng.integers(0, P * vmax, (P, EB)), -1),
         "dst": np.where(ve, rng.integers(0, P * vmax, (P, EB)), -1),
         "rk": np.where(ve, rng.integers(0, 3, (P, EB)), 0),
         "eidx": np.where(ve, eidx, 0)}
    s = {k: v.astype(np.int32) for k, v in s.items()}
    fbm = rng.random((P, vmax)) < 0.5
    if case == "empty_frontier":
        fbm[:] = False
    lo, hi = (-3, vmax + 3) if case == "inactive_sources" else (0, vmax)
    d = {"d_src": rng.integers(lo, hi, (P, Dcap)).astype(np.int32),
         "d_dst": rng.integers(0, P * vmax, (P, Dcap)).astype(np.int32),
         "d_rank": rng.integers(0, 3, (P, Dcap)).astype(np.int32),
         "d_valid": rng.random((P, Dcap)) < 0.7,
         "d_tomb": np.full((P, Tcap), MAXI, np.int32)}
    if Dcap and case != "empty_frontier":
        # each part's row 0 is live and its source on the frontier
        d["d_valid"][:, 0] = True
        fbm[np.arange(P), np.clip(d["d_src"][:, 0], 0, vmax - 1)] = True
    for p in range(P):
        live = np.unique(s["eidx"][p, :total[p]])
        if case == "all_tombstoned":
            pick = live
        else:
            pick = np.unique(np.concatenate([
                rng.choice(live, min(len(live), Tcap // 2), replace=False)
                if len(live) else np.empty(0, np.int64),
                rng.integers(0, emax, Tcap // 4)]))[:Tcap]
        d["d_tomb"][p, :len(pick)] = np.sort(pick)
    return s, total, ve, fbm, d


def _ref_merge(s, total, ve, fbm, d, P, emax):
    fn = jax.jit(jax.vmap(
        lambda dl, f, a, b, c, e, v, t, pid: ref_hop._merge_delta(
            dl, f, a, b, c, e, v, t, P, pid, emax)))
    out = fn({k: jnp.asarray(v) for k, v in d.items()}, jnp.asarray(fbm),
             *[jnp.asarray(s[k]) for k in ("src", "dst", "rk", "eidx")],
             jnp.asarray(ve), jnp.asarray(total),
             jnp.arange(P, dtype=jnp.int32))
    return [np.asarray(x) for x in out]


MERGE_CASES = {
    "random": (12, 8, 8),
    "no_delta_rows": (12, 0, 8),
    "no_tombstones": (12, 8, 0),
    "neither": (12, 0, 0),
    "all_tombstoned": (12, 8, 16),
    "empty_frontier": (12, 8, 8),
    "inactive_sources": (12, 8, 8),
    "no_base_slots": (0, 8, 4),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_merge_delta_plain_matches_reference(P, case):
    EB, Dcap, Tcap = MERGE_CASES[case]
    emax = 40
    s, total, ve, fbm, d = _merge_inputs(P * 31 + len(case), P, EB, Dcap,
                                         Tcap, case, emax=emax)
    want = _ref_merge(s, total, ve, fbm, d, P, emax)
    r_src, r_dst, r_rk, r_eidx, r_ve, r_total = want

    # the port's slots are (P, EB + Dcap): expand's base slots, then its
    # padding, which the merge overwrites
    def wide(a, fill):
        return torch.from_numpy(np.concatenate(
            [a, np.full((P, Dcap), fill, np.int32)], 1))

    src, dst, rk, eidx = (wide(s["src"], -1), wide(s["dst"], -1),
                          wide(s["rk"], 0), wide(s["eidx"], 0))
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    total_t = torch.from_numpy(total)
    valid, tot = K.merge_delta(src, dst, rk, eidx, total_t,
                               torch.from_numpy(fbm), t["d_src"], t["d_dst"],
                               t["d_rank"], t["d_valid"], t["d_tomb"], emax)
    assert valid.dtype == torch.bool and tot.dtype == torch.int32
    np.testing.assert_array_equal(valid.numpy(), r_ve)
    np.testing.assert_array_equal(tot.numpy(), r_total)
    np.testing.assert_array_equal(src.numpy(), r_src)
    np.testing.assert_array_equal(rk.numpy(), r_rk)
    np.testing.assert_array_equal(eidx.numpy(), r_eidx)
    # the one deliberate difference: a tombstoned base slot's dst is -1
    # (mark then drops it without a keep mask); the reference leaves it
    hit = np.zeros_like(r_ve)
    hit[:, :EB] = ve & ~r_ve[:, :EB]
    np.testing.assert_array_equal(dst.numpy(), np.where(hit, -1, r_dst))
    np.testing.assert_array_equal(total_t.numpy(), total)   # not written
    if case == "all_tombstoned":
        assert not r_ve[:, :EB].any() and total.any()
    if case == "empty_frontier":
        assert not r_ve[:, EB:].any() and (r_total == total).all()
    if case in ("random", "inactive_sources"):
        assert r_ve[:, EB:].any() and hit.any()


def test_merge_delta_is_idempotent_on_its_slots():
    """The slots are merged in place; a second merge of the same slots
    (a timing loop's repeat) gives the same arrays and total."""
    P, emax = 4, 40
    s, total, ve, fbm, d = _merge_inputs(5, P, 12, 8, 8, "random")
    src, dst, rk, eidx = [torch.from_numpy(np.concatenate(
        [s[k], np.full((P, 8), f, np.int32)], 1))
        for k, f in (("src", -1), ("dst", -1), ("rk", 0), ("eidx", 0))]
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    args = (torch.from_numpy(total), torch.from_numpy(fbm), t["d_src"],
            t["d_dst"], t["d_rank"], t["d_valid"], t["d_tomb"], emax)
    v1, t1 = K.merge_delta(src, dst, rk, eidx, *args)
    first = [a.clone() for a in (src, dst, rk, eidx)]
    v2, t2 = K.merge_delta(src, dst, rk, eidx, *args)
    assert torch.equal(v1, v2) and torch.equal(t1, t2)
    for a, b in zip(first, (src, dst, rk, eidx)):
        assert torch.equal(a, b)


def test_column_pairs_read_the_delta_half():
    """predicate_mask and compact_capture read a slot with eidx >= emax
    from the column's delta half at eidx - emax: the same values as a
    gather from the concatenated column, which the port never builds."""
    rng = np.random.default_rng(3)
    P, W, emax, dcap = 3, 10, 6, 4
    base = torch.from_numpy(rng.integers(0, 100, (P, emax)))
    delta = torch.from_numpy(rng.integers(100, 200, (P, dcap)))
    eidx = torch.from_numpy(rng.integers(0, emax + dcap, (P, W))
                            .astype(np.int32))
    cat = torch.cat([base, delta], 1)
    valid = torch.from_numpy(rng.random((P, W)) < 0.8)
    src = torch.zeros((P, W), dtype=torch.int32)
    from nebula_tpu_torch.gpu import exprjit as X
    from nebula_tpu_torch.graphstore.csr import StringPool
    prog, _ = X.compile_predicate(
        PE.Binary(">", PE.EdgeProp("e", "w"), PE.Literal(120)),
        {"w": PropType.INT64}, StringPool())
    got = K.predicate_mask(prog, src, src, src, eidx, valid, [base], [delta])
    want = valid & (torch.gather(cat, 1, eidx.long()) > 120)
    assert torch.equal(got, want) and got.any()
    *_, (pc,), kc = K.compact_capture(src, src, src, eidx, valid, [base],
                                      [delta])
    for p in range(P):
        k = int(kc[p])
        np.testing.assert_array_equal(
            pc[p, :k].numpy(), cat[p, eidx[p][valid[p]].long()].numpy())


# ---------------------------------------------------------------------------
# end to end: twin stores, one write script
# ---------------------------------------------------------------------------


@pytest.fixture()
def delta_cfg():
    """The reference's delta plane on at DCAP, compaction parked (the
    port's runtimes are built with the same watermark); every flag,
    the split threshold a test may set too, restored afterwards."""
    cfg = get_config()
    keys = ("tpu_delta_max_edges", "tpu_delta_compact_watermark",
            "tpu_init_edge_budget", "tpu_degree_split_threshold")
    cfg.set_dynamic_many({"tpu_delta_max_edges": DCAP,
                          "tpu_delta_compact_watermark": 2.0,
                          "tpu_init_edge_budget": 1 << 10})
    yield cfg
    with cfg.lock:
        for k in keys:
            cfg.dynamic_layer.pop(k, None)


def _store(parts, seed, port=False):
    """A twin store: the reference's GraphStore, or with `port` the
    port's own, filled by the same seeded script."""
    rng = random.Random(seed)
    Store, Def, T, null = ((PortGraphStore, PropDef, PropType, NULL) if port
                           else (GraphStore, RefPropDef, RefPropType,
                                 REF_NULL))
    st = Store()
    st.create_space("g", partition_num=parts, vid_type="INT64")
    st.catalog.create_tag("g", "person", [Def("age", T.INT64)])
    st.catalog.create_edge("g", "knows", [
        Def("w", T.INT64), Def("f", T.DOUBLE), Def("tag", T.STRING)])
    names = ["ann", "bob", "cid", "dee"]
    for v in range(N):
        st.insert_vertex("g", v, "person", {"age": rng.randint(0, 80)})
    for v in range(N):
        for _ in range(rng.randint(0, 8)):
            props = {"w": rng.randint(-5, 100) if rng.random() > .1
                     else null,
                     "f": rng.uniform(0, 1), "tag": rng.choice(names)}
            st.insert_edge("g", v, "knows", rng.randrange(N),
                           rng.randint(0, 2), props)
    return st


def _live(st):
    """(src, rank, dst, props) of every live edge, in scan order."""
    return [(s, r, d, dict(p)) for (s, _et, r, d, p)
            in st.scan_edges("g", "knows")]


class _Writer:
    """One write script, applied group by group to a store; run on both
    twins it makes the same writes, since the twins scan alike."""

    def __init__(self, st):
        self.st = st
        self.deleted = []

    def group(self, name):
        st = self.st
        if name == "inserts":
            for i in range(12):
                st.insert_edge("g", SEEDS[i % 3], "knows", (7 * i + 2) % N,
                               50 + i, {"w": 1000 + i, "f": .5,
                                        "tag": "zz"})
        elif name == "deletes":
            for s, r, d, p in [e for e in _live(st) if e[1] < 50][::9][:10]:
                st.delete_edge("g", s, "knows", d, r)
                self.deleted.append((s, r, d, p))
        elif name == "resurrect":
            for s, r, d, p in self.deleted[:6]:
                st.insert_edge("g", s, "knows", d, r, p)
        elif name == "overwrite":
            for s, r, d, p in [e for e in _live(st) if e[1] < 50][3::7][:10]:
                w = p.get("w")
                st.insert_edge("g", s, "knows", d, r,
                               {**p, "w": 77 if isinstance(
                                   w, (RefNull, PV.NullValue)) else w + 1})
        elif name == "mixed":
            for i in (0, 4, 8):
                st.delete_edge("g", SEEDS[i % 3], "knows", (7 * i + 2) % N,
                               50 + i)
            st.insert_edge("g", 2, "knows", 3, 60,
                           {"w": NULL if isinstance(st, PortGraphStore)
                            else REF_NULL, "f": .25, "tag": "zz"})
            st.insert_edge("g", SEEDS[0], "knows", 4, 61,
                           {"w": 5, "f": .75, "tag": "ann"})
        else:
            raise ValueError(name)


GROUPS = ("inserts", "deletes", "resurrect", "overwrite", "mixed")


class _PortSchema:
    def __init__(self, sv):
        self.props = [PropDef(pd.name, PropType[pd.ptype.name],
                              default=to_port(pd.default),
                              has_default=pd.has_default)
                      for pd in sv.props]


class _ConvReader:
    """The reference's LocalStoreReader with its values and schemas
    turned into the port's (test-only: the port never imports it)."""

    def __init__(self, inner):
        self.inner = inner

    def dense_of(self, vid):
        return self.inner.dense_of(vid)

    def edge_row(self, etype, src, dst, rank):
        row, sv = self.inner.edge_row(etype, src, dst, rank)
        return (None if row is None else
                {k: to_port(v) for k, v in row.items()},
                None if sv is None else _PortSchema(sv))

    def vertex_rows(self, vid):
        return {t: {k: to_port(v) for k, v in r.items()}
                for t, r in self.inner.vertex_rows(vid).items()}

    def tag_schema(self, tag):
        sv = self.inner.tag_schema(tag)
        return None if sv is None else _PortSchema(sv)


class _PortStore:
    """The twin GraphStore as the port's runtime reads it."""

    def __init__(self, st):
        self.st = st
        self.catalog = st.catalog

    def space(self, name):
        return self.st.space(name)

    def delta_records(self, space):
        return self.st.delta_records(space)

    def delta_trim(self, space, keys):
        self.st.delta_trim(space, keys)

    def delta_reader(self, space):
        return _ConvReader(self.st.delta_reader(space))


def _fields(snap):
    """Plain arrays (copies: the reference's delta mirror writes into its
    snapshot) out of a reference CsrSnapshot."""
    return {
        "space": snap.space, "epoch": snap.epoch,
        "num_parts": snap.num_parts, "vmax": snap.vmax,
        "num_vertices": np.array(snap.num_vertices),
        "dense_to_vid": list(snap.dense_to_vid),
        "pool": list(snap.pool.strings), "hub_dense": snap.hub_dense,
        "blocks": {k: {"indptr": b.indptr.copy(), "nbr": b.nbr.copy(),
                       "rank": b.rank.copy(),
                       "props": {n: a.copy() for n, a in b.props.items()},
                       "prop_types": {n: t.name
                                      for n, t in b.prop_types.items()}}
                   for k, b in snap.blocks.items()},
    }


def _port_pin(st, delta_max_edges=DCAP, **kw):
    """Watch the twin's writes, export it as the reference runtime would
    (with the vmax slack), and pin it into a port runtime."""
    st.delta_watch("g")
    slack = int(get_config().get("tpu_delta_vmax_slack"))
    snap = snapshot_from_fields(_fields(ref_csr.build_snapshot(
        st, "g", vmax_extra=slack)))
    rt = GpuRuntime(device="cpu", delta_max_edges=delta_max_edges, **kw)
    rt.pin_prebuilt(snap)
    return rt


def _store_pin(st, delta_max_edges=DCAP, **kw):
    """Pin a port twin store from the store itself, with the flags the
    reference runtime reads (`delta_cfg`): compaction parked.  The vmax
    slack is the port's DELTA_VMAX_SLACK, the reference flag's default."""
    rt = GpuRuntime(device="cpu", delta_max_edges=delta_max_edges,
                    delta_compact_watermark=float(get_config().get(
                        "tpu_delta_compact_watermark")), **kw)
    rt.pin(st, "g")
    return rt


def _yields(M):
    return [(M.FunctionCall("src", [M.EdgeExpr()]), "s"),
            (M.FunctionCall("rank", [M.EdgeExpr()]), "r"),
            (M.FunctionCall("dst", [M.EdgeExpr()]), "d"),
            (M.EdgeProp("knows", "w"), "w"),
            (M.EdgeProp("knows", "f"), "f"),
            (M.EdgeProp("knows", "tag"), "t")]


def _where(M):
    """A WHERE on delta-written props: the inserts write w >= 1000 and
    tag "zz"."""
    return M.Binary("OR", M.Binary(">", M.EdgeProp("knows", "w"),
                                   M.Literal(60)),
                    M.Binary("==", M.EdgeProp("knows", "tag"),
                             M.Literal("zz")))


def _cols(rows):
    return {n: np.asarray(rows.column_array(n)) for n in rows.column_names}


def _assert_cols_equal(got, want, tag):
    assert list(got) == list(want), tag
    for n in want:
        a, b = want[n], got[n]
        assert a.shape == b.shape, (tag, n, a.shape, b.shape)
        if a.dtype == object or b.dtype == object:
            assert [repr(x) for x in a] == [repr(x) for x in b], (tag, n)
        else:
            assert a.dtype == b.dtype, (tag, n)
            np.testing.assert_array_equal(a, b, err_msg=f"{tag} {n}")


def _go_both(ref_rt, ref_st, port_rt, port_st, steps, direction, filt, tag):
    ref_rows, ref_stats = ref_rt.traverse(
        ref_st, "g", SEEDS, ["knows"], direction, steps,
        edge_filter=_where(RE) if filt else None, yields=_yields(RE))
    rows, stats = port_rt.traverse(
        port_st, "g", SEEDS, ["knows"], direction, steps,
        edge_filter=_where(PE) if filt else None, yields=_yields(PE))
    assert len(rows) == len(ref_rows) > 0, tag
    _assert_cols_equal(_cols(rows), _cols(ref_rows), tag)
    assert stats.hop_edges == ref_stats.hop_edges, tag
    assert stats.frontier_sizes == ref_stats.frontier_sizes, tag
    return rows


@pytest.mark.parametrize("parts,direction,steps", [
    (1, "out", 2), (2, "out", 2), (4, "out", 2), (8, "out", 2),
    (2, "in", 2), (4, "both", 1), (8, "out", 3)])
def test_go_through_writes_matches_reference(delta_cfg, parts, direction,
                                             steps):
    ref_st = _store(parts, 20 + parts)
    port_st = _store(parts, 20 + parts, port=True)
    ref_rt = TpuRuntime(make_mesh(1))
    assert ref_rt.pin(ref_st, "g").delta is not None
    port_rt = _store_pin(port_st)
    dev = port_rt.snapshots["g"]
    assert dev.delta is not None
    base_bytes = dev.hbm_bytes()
    writers = (_Writer(ref_st), _Writer(port_st))
    for group in ("empty",) + GROUPS:
        if group != "empty":
            for w in writers:
                w.group(group)
        for filt in (False, True):
            rows = _go_both(ref_rt, ref_st, port_rt, port_st, steps,
                            direction, filt, f"{group} filt={filt}")
            # the full-rebuild oracle: a fresh pin of the written graph
            fresh = _store_pin(port_st, delta_max_edges=0)
            got, _ = fresh.traverse(
                port_st, "g", SEEDS, ["knows"], direction, steps,
                edge_filter=_where(PE) if filt else None, yields=_yields(PE))
            _assert_cols_equal(_cols(rows), _cols(got), f"rebuild {group}")
    # no re-pin: the same snapshot, its plane advanced to the store epoch
    assert port_rt.snapshots["g"] is dev
    assert dev.delta.applied_epoch == port_st.space("g").epoch
    assert dev.delta.host.total_edges() > 0 and \
        dev.delta.host.total_tombs() > 0
    assert dev.hbm_bytes() == base_bytes     # caps fixed at pin


@pytest.mark.parametrize("parts", [1, 4])
def test_bfs_through_writes_matches_reference(delta_cfg, parts):
    ref_st = _store(parts, 40 + parts)
    port_st = _store(parts, 40 + parts, port=True)
    ref_rt = TpuRuntime(make_mesh(1))
    ref_rt.pin(ref_st, "g")
    port_rt = _store_pin(port_st)
    writers = (_Writer(ref_st), _Writer(port_st))
    for group in ("empty",) + GROUPS:
        if group != "empty":
            for w in writers:
                w.group(group)
        for src in (SEEDS[0], 2):
            want, wst = ref_rt.bfs(ref_st, "g", [src], ["knows"], "out", 6)
            got, gst = port_rt.bfs(port_st, "g", [src], ["knows"], "out", 6)
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=group)
            assert gst.hop_edges == wst.hop_edges, group
    assert port_rt.snapshots["g"].delta.host.total_edges() > 0


def test_bfs_armed_plane_goes_top_down(delta_cfg):
    """Bottom-up is off while a plane is armed: no bfs_probe runs even
    where the level is dense, and the rows still equal a rebuild's."""
    port_st = _store(2, 7, port=True)
    port_rt = _store_pin(port_st)
    _Writer(port_st).group("inserts")
    K.reset_launch_counts()
    calls = []
    real = K.bfs_probe_plain
    K.bfs_probe_plain = lambda *a: calls.append(1) or real(*a)
    try:
        got, _ = port_rt.bfs(port_st, "g", [SEEDS[0]], ["knows"], "out", 6)
    finally:
        K.bfs_probe_plain = real
    assert not calls
    fresh = _store_pin(port_st, delta_max_edges=0)
    want, _ = fresh.bfs(port_st, "g", [SEEDS[0]], ["knows"], "out", 6)
    # the armed pin's vmax holds the slack; a pin without a plane has none
    np.testing.assert_array_equal(got[:, :want.shape[1]], want)
    assert (got[:, want.shape[1]:] == -1).all()


# ---------------------------------------------------------------------------
# the plane's edges: off switch, split snapshots, overflow, views, logs
# ---------------------------------------------------------------------------


def test_off_switch_results_unchanged(delta_cfg):
    """delta_max_edges=0 arms nothing and gives the same columns as an
    armed, empty plane; a write then re-pins the runtime without a plane
    (a rebuild from the store), with the rows of the one with a plane."""
    port_st = _store(4, 11, port=True)
    off, on = _store_pin(port_st, delta_max_edges=0), _store_pin(port_st)
    assert off.snapshots["g"].delta is None
    assert on.snapshots["g"].delta is not None
    for filt in (False, True):
        a, sa = off.traverse(port_st, "g", SEEDS, ["knows"], "out", 2,
                             edge_filter=_where(PE) if filt else None,
                             yields=_yields(PE))
        b, sb = on.traverse(port_st, "g", SEEDS, ["knows"], "out", 2,
                            edge_filter=_where(PE) if filt else None,
                            yields=_yields(PE))
        _assert_cols_equal(_cols(b), _cols(a), f"filt={filt}")
        assert sa.hop_edges == sb.hop_edges
    _Writer(port_st).group("inserts")
    dev = off.snapshots["g"]
    a, sa = off.traverse(port_st, "g", SEEDS, ["knows"], "out", 2,
                         yields=_yields(PE))
    b, sb = on.traverse(port_st, "g", SEEDS, ["knows"], "out", 2,
                        yields=_yields(PE))
    assert off.snapshots["g"] is not dev and dev.retired
    assert off.snapshots["g"].delta is None
    assert on.snapshots["g"].delta.host.total_edges() > 0
    _assert_cols_equal(_cols(a), _cols(b), "after the write")
    assert sa.hop_edges == sb.hop_edges


def _ref_rebuild_pair(seed, dcap=DCAP, split=0):
    """A reference store pinned by `TpuRuntime` (the delta flag at
    `dcap`, the split threshold at `split`) and its port twin pinned
    from the port's own store with the same settings."""
    cfg = get_config()
    cfg.set_dynamic_many({"tpu_delta_max_edges": dcap,
                          "tpu_degree_split_threshold": split})
    ref_st, port_st = _store(2, seed), _store(2, seed, port=True)
    ref_rt = TpuRuntime(make_mesh(1))
    ref_rt.pin(ref_st, "g")
    port_rt = _store_pin(port_st, delta_max_edges=dcap,
                         degree_split_threshold=split)
    return ref_rt, ref_st, port_rt, port_st


def test_split_snapshot_arms_no_plane(delta_cfg):
    """A degree-split pin arms no plane, so a write to it rebuilds and
    re-pins from the store (split again), as the reference does; GO
    gives the reference's columns."""
    ref_rt, ref_st, rt, port_st = _ref_rebuild_pair(13, split=3)
    dev = rt.snapshots["g"]
    assert dev.num_hubs > 0 and dev.delta is None
    for w in (_Writer(ref_st), _Writer(port_st)):
        w.group("inserts")
    _go_both(ref_rt, ref_st, rt, port_st, 2, "out", False, "split write")
    new = rt.snapshots["g"]
    assert new is not dev and dev.retired
    assert new.num_hubs > 0 and new.delta is None


def test_overflow_raises_and_unpins(delta_cfg):
    """12 rows over a 4-row plane: the apply overflows, and the runtime
    rebuilds and re-pins from the store (the reference's path), so GO
    and the BFS give the reference's answers on a fresh plane."""
    ref_rt, ref_st, rt, port_st = _ref_rebuild_pair(17, dcap=4)
    dev = rt.snapshots["g"]
    for w in (_Writer(ref_st), _Writer(port_st)):
        w.group("inserts")
    _go_both(ref_rt, ref_st, rt, port_st, 2, "out", False, "overflow")
    new = rt.snapshots["g"]
    assert new is not dev and dev.retired       # the half-applied mirror
    assert new.delta is not None and new.delta.host.total_edges() == 0
    want, _ = ref_rt.bfs(ref_st, "g", [1], ["knows"], "out", 3)
    got, _ = rt.bfs(port_st, "g", [1], ["knows"], "out", 3)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_view_grabbed_before_an_apply_decodes_as_before(delta_cfg):
    """An apply replaces the plane's tensors and mirrors: a run that
    grabbed its view before the apply still decodes against that view."""
    port_st = _store(2, 19, port=True)
    rt = _store_pin(port_st)
    _Writer(port_st).group("inserts")
    before, _ = rt.traverse(port_st, "g", SEEDS, ["knows"], "out", 2,
                            yields=_yields(PE))
    dev = rt.snapshots["g"]
    bk = [("knows", "out")]
    view, extras = rt._grab_delta(dev, bk, {"w", "f", "tag"})
    snap_np = {k: v.copy() for k, v in view[1][bk[0]]["np"].items()
               if k != "d_props"}
    _Writer(port_st).group("mixed")
    rt.pin(port_st, "g")                    # the apply
    assert dev.delta.view is not view
    for k, v in snap_np.items():
        np.testing.assert_array_equal(view[1][bk[0]]["np"][k], v)
    # re-run the hops against the OLD view and decode with it
    seeds = [port_st.space("g").dense_id(v) for v in SEEDS]
    res = run_hops(dev, [dev.blocks[bk[0]]], rt._seed_frontier(dev, seeds),
                   2, yield_cols=("f", "tag", "w"), deltas=extras)
    caps = []
    for cap in res["cap"]:
        got = {k: v.numpy() for k, v in cap.items() if k != "kcount"}
        got["kcount"] = cap["kcount"].numpy()
        caps.append(got)
    old = rt._materialize_yields(port_st, "g", dev, bk, caps, _yields(PE),
                                 view)
    _assert_cols_equal(_cols(old), _cols(before), "old view")
    after, _ = rt.traverse(port_st, "g", SEEDS, ["knows"], "out", 2,
                           yields=_yields(PE))
    assert len(after) != len(before) or any(
        not np.array_equal(_cols(after)[n], _cols(before)[n])
        for n in _cols(before) if _cols(before)[n].dtype != object)


def test_broken_log_and_log_gap_raise(delta_cfg):
    """A broken log (REPARTITION, or more keys than its cap) and a log
    gap (the log lost and re-watched after more writes) make the apply
    give up; the runtime rebuilds and re-pins from the store, as the
    reference does, and GO gives the reference's columns each time.
    (The bench's `SnapshotStore` still raises: the next test.)"""
    ref_rt, ref_st, rt, port_st = _ref_rebuild_pair(29)
    stores = (ref_st, port_st)
    pins = [rt.snapshots["g"]]
    for st in stores:
        st.repartition("g", 3)
    _go_both(ref_rt, ref_st, rt, port_st, 2, "out", False, "repartition")
    assert rt.snapshots["g"].num_parts == 3
    pins.append(rt.snapshots["g"])
    for st in stores:
        st.space("g").delta_log.cap = 2
        _Writer(st).group("inserts")
    _go_both(ref_rt, ref_st, rt, port_st, 2, "out", True, "cap")
    pins.append(rt.snapshots["g"])
    for st in stores:
        _Writer(st).group("deletes")
        st.space("g").delta_log = None
        _Writer(st).group("resurrect")
        st.delta_watch("g")                  # floor after the pin's epoch
    _go_both(ref_rt, ref_st, rt, port_st, 2, "out", False, "gap")
    pins.append(rt.snapshots["g"])
    assert len({id(d) for d in pins}) == 4
    assert all(d.retired for d in pins[:3])


def test_snapshot_store_broken_log_and_log_gap_raise():
    """The bench's `SnapshotStore` cannot be exported, so where the
    reference would rebuild, `pin` raises GpuUnavailable naming the
    cause: a log broken by its key cap, and a log gap."""
    arrs = D.make_social_arrays(300, 4, seed=3)
    snap = D.snapshot_from_arrays(arrs, parts=2, space="s")
    store = D.SnapshotStore(snap, arrs)
    store.delta_watch("s", cap=2)
    rt = GpuRuntime(device="cpu", delta_max_edges=16)
    rt.pin_prebuilt(snap)
    for d in (1, 2, 3):                        # 3 keys break a 2-key log
        store.insert_edge(0, 100 + d, {"w": 1, "f": .5, "city": "ada"})
    with pytest.raises(GpuUnavailable, match="broken"):
        rt.pin(store, "s")
    store2 = D.SnapshotStore(snap, arrs)
    store2.insert_edge(0, 200, {"w": 1, "f": .5, "city": "ada"})
    store2.delta_watch("s")                   # floor after the pin's epoch
    store2.insert_edge(0, 201, {"w": 1, "f": .5, "city": "ada"})
    rt2 = GpuRuntime(device="cpu", delta_max_edges=16)
    rt2.pin_prebuilt(snap)
    with pytest.raises(GpuUnavailable, match="gap"):
        rt2.pin(store2, "s")


# ---------------------------------------------------------------------------
# the bench store's write side and the value encode
# ---------------------------------------------------------------------------


def _bench_writes(store, arrs, rng, n_del, n_upd, n_ins, seeds):
    n = int(arrs["n"])
    pick = rng.permutation(store.writable_edges())[:n_del + n_upd]
    for i in pick[:n_del]:
        store.delete_edge(int(arrs["src"][i]), int(arrs["dst"][i]))
    for i in pick[n_del:]:
        store.update_edge(int(arrs["src"][i]), int(arrs["dst"][i]),
                          {"w": int((arrs["w"][i] + 1) % 100)})
    done = 0
    while done < n_ins:
        s = int(seeds[done % len(seeds)]) if done < n_ins // 4 \
            else int(rng.integers(n))
        d = int(rng.integers(n))
        if s == d or store.base_has(s, d) or store.edge_row(s, d):
            continue
        store.insert_edge(s, d, {"w": int(rng.integers(100)),
                                 "f": float(rng.random()),
                                 "city": D._NAMES[int(rng.integers(16))]})
        done += 1


@pytest.mark.parametrize("P", [1, 4])
def test_snapshot_store_writes_match_a_rebuild(P):
    """The bench's write mix through SnapshotStore: GO columns in order,
    and the BFS depths, equal a fresh pin of `mutated_arrays()`'s
    snapshot and the numpy oracles; hop_edges follows the reference's
    rule (base slots of frontier rows, deletes included, plus active
    delta rows)."""
    n = 1500
    arrs = D.make_social_arrays(n, 6, seed=5)
    snap = D.snapshot_from_arrays(arrs, parts=P, space="s")
    store = D.SnapshotStore(snap, arrs)
    store.delta_watch("s")
    rt = GpuRuntime(device="cpu", delta_max_edges=256)
    rt.pin_prebuilt(snap)
    seeds = np.unique(arrs["src"][:64])[:16].tolist()
    _bench_writes(store, arrs, np.random.default_rng(P), 60, 60, 180, seeds)
    rebuilt = D.snapshot_from_arrays(store.mutated_arrays(), parts=P,
                                     space="s")
    fresh = GpuRuntime(device="cpu")
    fresh.pin_prebuilt(rebuilt)
    fstore = D.SnapshotStore(rebuilt)
    ys = [(PE.FunctionCall("dst", [PE.EdgeExpr()]), "d"),
          (PE.EdgeProp("KNOWS", "w"), "w"),
          (PE.EdgeProp("KNOWS", "city"), "c")]
    for w_gt in (None, 50):
        f = None if w_gt is None else PE.Binary(
            ">", PE.EdgeProp("KNOWS", "w"), PE.Literal(w_gt))
        rows, st = rt.traverse(store, "s", seeds, ["KNOWS"], "out", 3,
                               edge_filter=f, yields=ys)
        want, _ = fresh.traverse(fstore, "s", seeds, ["KNOWS"], "out", 3,
                                 edge_filter=f, yields=ys)
        _assert_cols_equal(_cols(rows), _cols(want), f"w_gt={w_gt}")
        total, kept, d, w = D.host_csr_traverse(rebuilt, seeds, 3, w_gt=w_gt,
                                                materialize=True)
        assert len(rows) == kept
        # hop_edges: base degree of each hop's frontier + its delta rows
        ins = rt.snapshots["s"].delta.host.ins[("KNOWS", "out")]
        dsrc = np.asarray([li * P + p for p in range(P) for (li, _, _)
                           in ins[p]], np.int64)
        blk = snap.block("KNOWS", "out")
        deg = (blk.indptr[:, 1:] - blk.indptr[:, :-1]).T.reshape(-1)
        fr = np.unique(seeds)
        rb = rebuilt.block("KNOWS", "out")
        for h in range(3):
            assert st.hop_edges[h] == int(deg[fr].sum()) + int(
                np.isin(dsrc, fr).sum())
            o, lo = fr % P, fr // P
            nxt = [rb.nbr[o[i], rb.indptr[o[i], lo[i]]:
                          rb.indptr[o[i], lo[i] + 1]]
                   for i in range(fr.size)]
            fr = np.unique(np.concatenate(nxt)).astype(np.int64)
    dist, _ = rt.bfs(store, "s", [0], ["KNOWS"], "out", 6)
    hb = D.host_bfs(rebuilt, [0], 6)
    np.testing.assert_array_equal(dist.T.reshape(-1)[:n], hb)


def test_snapshot_store_refuses_parallel_edge_keys():
    arrs = {"n": 4, "src": np.array([0, 0, 1]), "dst": np.array([1, 1, 2]),
            "w": np.array([1, 2, 3]), "f": np.array([.1, .2, .3]),
            "city": np.array([0, 1, 2])}
    store = D.SnapshotStore(D.snapshot_from_arrays(arrs, parts=2), arrs)
    np.testing.assert_array_equal(store.writable_edges(), [2])
    np.testing.assert_array_equal(store.base_has([0, 1, 1], [1, 2, 3]),
                                  [True, True, False])
    with pytest.raises(ValueError, match="parallel"):
        store.delete_edge(0, 1)
    with pytest.raises(ValueError, match="rank 0"):
        store.insert_edge(1, 3, {"w": 1, "f": .5, "city": "ada"}, rank=2)
    store.update_edge(1, 2, {"w": 9})
    assert store.edge_row(1, 2) == {"w": 9, "f": .3, "city": "cid"}
    m = store.mutated_arrays()
    np.testing.assert_array_equal(m["src"], [0, 0, 1])
    np.testing.assert_array_equal(m["w"], [1, 2, 9])


@pytest.mark.parametrize("pt,v", [
    ("INT64", 7), ("INT64", -3), ("DOUBLE", 2.5), ("FLOAT", 3),
    ("BOOL", True), ("STRING", "bob"), ("TIMESTAMP", 1700000000),
    ("INT8", 5), ("INT64", None), ("DOUBLE", None), ("STRING", None)])
def test_encode_prop_matches_reference(pt, v):
    ref_pool, port_pool = ref_csr.StringPool(), port_csr.StringPool()
    for s in ("ada", "bob"):
        ref_pool.encode(s)
        port_pool.encode(s)
    rv = REF_NULL if v is None else v
    pv = NULL if v is None else v
    want = ref_csr.encode_prop(RefPropType[pt], rv, ref_pool)
    got = port_csr.encode_prop(PropType[pt], pv, port_pool)
    assert type(got) is type(want)
    assert got == want or (got != got and want != want)
    rd = RefPropDef("x", RefPropType[pt], default=rv, has_default=True)
    pd = PropDef("x", PropType[pt], default=pv, has_default=True)
    a = ref_csr._encode_default(rd, ref_pool)
    b = port_csr._encode_default(pd, port_pool)
    assert a == b or (a != a and b != b)


def _temporal_values():
    from nebula_tpu.core import geo as ref_geo
    from nebula_tpu.core import value as RV
    return {
        "DATE": [RV.Date(1970, 1, 1), RV.Date(1969, 12, 31),
                 RV.Date(1900, 3, 1), RV.Date(2024, 2, 29), REF_NULL],
        "TIME": [RV.Time(0, 0, 0, 0), RV.Time(23, 59, 59, 999_999),
                 RV.Time(12, 30, 5, 17), REF_NULL],
        "DATETIME": [RV.DateTime(1970, 1, 1), RV.DateTime(1969, 12, 31, 23,
                                                          59, 59, 999_999),
                     RV.DateTime(1901, 5, 6, 7, 8, 9, 10),
                     RV.DateTime(2024, 3, 9, 13, 4, 5, 123_456), REF_NULL],
        "DURATION": [RV.Duration(seconds=90, months=2), 7, -3, REF_NULL],
        "GEOGRAPHY": [ref_geo.from_wkt("POINT(1.5 -2.25)"),
                      ref_geo.from_wkt("LINESTRING(0 0, 1 1, 2 0)"),
                      ref_geo.from_wkt("POLYGON((0 0, 4 0, 4 4, 0 0))"),
                      REF_NULL],
    }


def _encode_outcome(csr, pt, v, pool):
    try:
        return "value", csr.encode_prop(pt, v, pool)
    except Exception as ex:   # noqa: BLE001 — the class is compared
        return "raise", type(ex).__name__


@pytest.mark.parametrize("pt", ["DATE", "TIME", "DATETIME", "DURATION",
                                "GEOGRAPHY"])
def test_values_the_port_cannot_represent_raise(pt):
    """Once a refusal (divergence 9: the port had no temporal or
    geography values); now each value, NULL and values before 1970
    included, encodes to the reference's word, the words decode to the
    reference's values one at a time and as a column, and a default of
    the type encodes as the reference's.  DURATION is what the reference
    makes of it: a Duration value has no int word, so its encode raises
    TypeError in both packages and its default encodes to None (NULL);
    an int written to the column is its own word, and a word decodes to
    the raw int."""
    ref_pool, port_pool = ref_csr.StringPool(), port_csr.StringPool()
    words = []
    for v in _temporal_values()[pt]:
        want = _encode_outcome(ref_csr, RefPropType[pt], v, ref_pool)
        got = _encode_outcome(port_csr, PropType[pt], to_port(v), port_pool)
        assert got == want and type(got[1]) is type(want[1]), v
        if want[0] == "value":
            words.append(want[1])
        rd = RefPropDef("x", RefPropType[pt], default=v, has_default=True)
        pd = PropDef("x", PropType[pt], default=to_port(v), has_default=True)
        assert port_csr._encode_default(pd, port_pool) == \
            ref_csr._encode_default(rd, ref_pool)
    assert port_pool.strings == ref_pool.strings
    if pt == "DURATION":
        assert words == [7, -3, port_csr.INT_NULL]
        assert _encode_outcome(port_csr, PropType[pt], to_port(
            _temporal_values()[pt][0]), port_pool) == ("raise", "TypeError")
    raw = np.asarray(words, np.int64)
    for w in words:
        assert same_value(port_csr.decode_prop(PropType[pt], w, port_pool),
                          ref_csr.decode_prop(RefPropType[pt], w, ref_pool))
    got = port_csr.decode_prop_column(PropType[pt], raw, port_pool)
    want = ref_csr.decode_prop_column(RefPropType[pt], raw, ref_pool)
    assert got == to_port(want) and len(got) == len(words)
    assert all(same_value(a, b) for a, b in zip(got, want))
    got_np = port_csr.decode_prop_column_np(PropType[pt], raw, port_pool)
    want_np = ref_csr.decode_prop_column_np(RefPropType[pt], raw, ref_pool)
    assert got_np.dtype == want_np.dtype
    assert [repr(x) for x in got_np] == [repr(x) for x in want_np]


def _dated_store(parts, seed, port=False):
    """A GraphStore (the reference's, or with `port` the port's own)
    whose edges carry DATE, DATETIME, TIME and GEOGRAPHY props (values on
    both sides of 1970, NULLs among them)."""
    if port:
        from nebula_tpu_torch.core import geo as ref_geo
        from nebula_tpu_torch.core import value as RV
        Store, Def, T = PortGraphStore, PropDef, PropType
    else:
        from nebula_tpu.core import geo as ref_geo
        from nebula_tpu.core import value as RV
        Store, Def, T = GraphStore, RefPropDef, RefPropType
    rng = random.Random(seed)
    st = Store()
    st.create_space("g", partition_num=parts, vid_type="INT64")
    st.catalog.create_tag("g", "person", [Def("age", T.INT64)])
    st.catalog.create_edge("g", "knows", [
        Def("w", T.INT64), Def("d", T.DATE), Def("d2", T.DATE),
        Def("t", T.DATETIME), Def("tm", T.TIME), Def("g", T.GEOGRAPHY)])

    def props(k):
        def maybe(v):
            return RV.NULL if rng.random() < .05 else v
        return {"w": k,
                "d": maybe(RV.Date(1969 + k % 3, 1 + k % 12, 1 + k % 28)),
                "d2": maybe(RV.Date(1969 + (k * 7) % 3, 1 + (k * 5) % 12,
                                    1 + (k * 3) % 28)),
                "t": maybe(RV.DateTime(1969 + k % 2, 12, 31, 23, 59,
                                       k % 60, (k * 7919) % 1_000_000)),
                "tm": maybe(RV.Time(k % 24, (k * 7) % 60, k % 60, k)),
                # the writes' keys (1000 and up) make points of their own
                "g": maybe(ref_geo.from_wkt(
                    f"POINT({k % 7} {k % 5 + 10 * (k // 1000)}.5)"))}
    for v in range(N):
        st.insert_vertex("g", v, "person", {"age": v})
    for v in range(N):
        for _ in range(rng.randint(0, 6)):
            st.insert_edge("g", v, "knows", rng.randrange(N),
                           rng.randint(0, 2), props(rng.randrange(500)))
    return st, props


def _dated_yields(M):
    return [(M.EdgeProp("knows", n), n) for n in ("d", "t", "tm", "g")]


def _dated_where(M):
    return M.Binary("<", M.EdgeProp("knows", "d"), M.EdgeProp("knows", "d2"))


@pytest.mark.parametrize("parts,steps", [(1, 1), (4, 2)])
def test_temporal_and_geography_writes_match_reference(delta_cfg, parts,
                                                       steps):
    """Logged writes of DATE, DATETIME, TIME and GEOGRAPHY values (new
    points among them, so the pool grows) reach the plane the merge
    kernel reads: GO's yields, unfiltered and WHERE d < d2, equal the
    reference's after each group, and a fresh pin's of the written
    store."""
    (ref_st, props), (port_st, port_props) = (
        _dated_store(parts, 60 + parts),
        _dated_store(parts, 60 + parts, port=True))
    ref_rt = TpuRuntime(make_mesh(1))
    assert ref_rt.pin(ref_st, "g").delta is not None
    port_rt = _store_pin(port_st)
    dev = port_rt.snapshots["g"]
    pool0 = len(dev.host.pool)
    for group in range(3):
        for i in range(8):
            key = 1000 + 31 * i + group
            for st, row in ((ref_st, props(key)),
                            (port_st, port_props(key))):
                st.insert_edge("g", SEEDS[i % 3], "knows",
                               (5 * i + group) % N, 50 + group, row)
        for filt in (False, True):
            tag = f"group {group} filt={filt}"
            want, wst = ref_rt.traverse(
                ref_st, "g", SEEDS, ["knows"], "out", steps,
                edge_filter=_dated_where(RE) if filt else None,
                yields=_dated_yields(RE))
            got, gst = port_rt.traverse(
                port_st, "g", SEEDS, ["knows"], "out", steps,
                edge_filter=_dated_where(PE) if filt else None,
                yields=_dated_yields(PE))
            assert len(got) == len(want) > 0, tag
            _assert_cols_equal(_cols(got), _cols(want), tag)
            for n in got.column_names:
                assert got.column(n) == to_port(want.column(n)), (tag, n)
            assert gst.hop_edges == wst.hop_edges, tag
            fresh = _store_pin(port_st, delta_max_edges=0)
            rows, _ = fresh.traverse(
                port_st, "g", SEEDS, ["knows"], "out", steps,
                edge_filter=_dated_where(PE) if filt else None,
                yields=_dated_yields(PE))
            _assert_cols_equal(_cols(got), _cols(rows), f"rebuild {tag}")
    assert port_rt.snapshots["g"] is dev
    assert dev.delta.host.total_edges() > 0
    assert len(dev.host.pool) > pool0           # new points were pooled


def test_string_first_pooled_by_a_write_matches_a_fresh_pin(delta_cfg):
    """A write that first brings a string into the pool, then GO 1 STEP,
    MATCH (`traverse_hops`) and the 1-step BFS WHERE knows.tag == "zz":
    the port's rows, frames and depths equal a fresh pin's of the
    written store.  (The port compiles the WHERE program for every
    statement, so its string constant is looked up in the pool as it
    is then.  The reference caches the compiled program under the base
    snapshot's epoch and the filter's text; on this script it answers
    0 rows, 0 frame edges and no vertex at depth 1 after the write,
    where its own fresh pin answers 1, 1 and 1.)"""
    port_st = _store(4, 20, port=True)
    port_rt = _store_pin(port_st)
    where = PE.Binary("==", PE.EdgeProp("knows", "tag"), PE.Literal("zz"))

    def run(rt):
        rows, _ = rt.traverse(port_st, "g", SEEDS, ["knows"], "out", 1,
                              edge_filter=where, yields=_yields(PE))
        frames, _ = rt.traverse_hops(port_st, "g", SEEDS, ["knows"], "out",
                                     1, edge_filter=where)
        dist, _ = rt.bfs(port_st, "g", SEEDS, ["knows"], "out", 1,
                         edge_filter=where)
        return rows, frames, np.asarray(dist)

    rows, frames, dist = run(port_rt)
    assert len(rows) == 0 and frames[0].n == 0
    assert int((dist == 1).sum()) == 0
    port_st.insert_edge("g", SEEDS[0], "knows", 3, 70,
                        {"w": 1, "f": .5, "tag": "zz"})
    rows, frames, dist = run(port_rt)
    assert port_rt.snapshots["g"].delta.host.total_edges() > 0
    f_rows, f_frames, f_dist = run(_store_pin(port_st, delta_max_edges=0))
    assert len(rows) == len(f_rows) == 1
    _assert_cols_equal(_cols(rows), _cols(f_rows), "GO")
    assert frames[0].n == f_frames[0].n == 1
    assert [repr(e) for e in frames[0].edges] == \
        [repr(e) for e in f_frames[0].edges]
    # the armed pin's vmax holds the slack; a pin without a plane has none
    np.testing.assert_array_equal(dist[:, :f_dist.shape[1]], f_dist)
    assert (dist[:, f_dist.shape[1]:] == -1).all()
    assert int((dist == 1).sum()) == 1


def test_host_delta_block_arrays_match_reference(delta_cfg):
    """The port's HostDelta, fed through the converting reader, builds
    the same padded arrays as the reference's after the whole script."""
    from nebula_tpu.graphstore.delta import HostDelta as RefHostDelta
    ref_st, twin = _store(4, 23), _store(4, 23)
    for st in (ref_st, twin):
        st.delta_watch("g")
    snap = ref_csr.build_snapshot(ref_st, "g")
    ref_hd = RefHostDelta(snap, DCAP)
    port_hd = HostDelta(snapshot_from_fields(_fields(
        ref_csr.build_snapshot(twin, "g"))), DCAP)
    writers = (_Writer(ref_st), _Writer(twin))
    for group in GROUPS:
        for w in writers:
            w.group(group)
        for st, hd, wrap in ((ref_st, ref_hd, lambda r: r),
                             (twin, port_hd, _ConvReader)):
            keys, _, _ = st.delta_records("g")
            hd.apply(wrap(st.delta_reader("g")), keys)
            st.delta_trim("g", keys)
    for bk in snap.blocks:
        a, b = ref_hd.block_arrays(bk), port_hd.block_arrays(bk)
        for k in ("d_src", "d_dst", "d_rank", "d_valid", "d_tomb"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{bk} {k}")
        for n in a["d_props"]:
            np.testing.assert_array_equal(a["d_props"][n], b["d_props"][n])
    assert ref_hd.nbytes() == port_hd.nbytes()
    assert ref_hd.fill_ratio() == port_hd.fill_ratio()


@pytest.mark.parametrize("spans", ["narrow", "wide", "base_unsorted"])
def test_canonical_perm_is_the_stable_lexsort(spans):
    """The merge that restores canonical order equals the stable lexsort
    of (local src, rank, dst key): packed keys when they fit in 62 bits,
    the lexsort itself when they do not or the base is out of order."""
    from nebula_tpu_torch.gpu.runtime import _canonical_perm
    rng = np.random.default_rng(len(spans))
    hi = {"narrow": (4, 3, 6), "wide": (10**6, 2**40, 10**9),
          "base_unsorted": (4, 3, 6)}[spans]
    for _ in range(300):
        nb, nd = int(rng.integers(1, 40)), int(rng.integers(1, 10))
        base = np.stack([rng.integers(0, h, nb) for h in hi])
        base = base[:, np.lexsort(base[::-1])]
        if spans == "base_unsorted":
            base = base[:, ::-1]
        rows = np.concatenate(
            [base, np.stack([rng.integers(0, h, nd) for h in hi])], 1)
        is_delta = np.r_[np.zeros(nb, bool), np.ones(nd, bool)]
        got = _canonical_perm(rows[0], rows[1], rows[2], is_delta)
        np.testing.assert_array_equal(
            got, np.lexsort((rows[2], rows[1], rows[0])))
