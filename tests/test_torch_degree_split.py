"""The supernode degree-split in the port against the JAX reference.

`degree_split` (graphstore/csr.py) array for array against the
reference's, `extend_hubs_plain` (K8's semantics) against
`hop._extend_fbm_local`, `expand` with hub rows — their bits from the
tail columns, or read from the owners' rows through the owner tables
whatever the tail holds — against `hop._expand_block(...,
hub_dense=...)` over `_extend_fbm_local` under `jax.vmap`, solo and
lanes, and GO N STEPS with the split active:
the reference `TpuRuntime` pinned with `tpu_degree_split_threshold` set
and the port's `GpuRuntime(device="cpu", degree_split_threshold=...)`,
every column equal in order, hop_edges and frontier_sizes equal.  The
graph is make_social_arrays(2000, 8), P = 8, whose Zipf tails give a
few vertices hundreds of edges.  Tolerance: exact — the path moves
integers and copies float64 values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.bench import datagen as ref_datagen
from nebula_tpu.core import expr as RE
from nebula_tpu.graphstore import csr as ref_csr
from nebula_tpu.tpu import TpuRuntime, make_mesh
from nebula_tpu.tpu import hop as ref_hop
from nebula_tpu.utils.config import get_config

from nebula_tpu_torch.bench import datagen as port_datagen
from nebula_tpu_torch.core import expr as PE
from nebula_tpu_torch.gpu import GpuRuntime
from nebula_tpu_torch.gpu import kernels as K
from nebula_tpu_torch.graphstore import csr as port_csr
from nebula_tpu_torch.graphstore.csr import snapshot_from_fields

P = 8
THRESHOLD = 64


def _fields(snap):
    """Plain arrays and lists out of a reference CsrSnapshot."""
    return {
        "space": snap.space, "epoch": snap.epoch,
        "num_parts": snap.num_parts, "vmax": snap.vmax,
        "num_vertices": np.asarray(snap.num_vertices),
        "dense_to_vid": list(snap.dense_to_vid),
        "pool": list(snap.pool.strings),
        "hub_dense": snap.hub_dense,
        "blocks": {k: {"indptr": b.indptr, "nbr": b.nbr, "rank": b.rank,
                       "props": dict(b.props),
                       "prop_types": {n: t.name
                                      for n, t in b.prop_types.items()}}
                   for k, b in snap.blocks.items()},
    }


@pytest.fixture(scope="module")
def graph():
    arrs = ref_datagen.make_social_arrays(2000, 8)
    ref_snap = ref_datagen.snapshot_from_arrays(arrs, parts=P)
    carried = snapshot_from_fields(_fields(ref_snap))
    cfg = get_config()
    cfg.set_dynamic("tpu_degree_split_threshold", THRESHOLD)
    try:
        ref_rt = TpuRuntime(make_mesh(1))
        # one bucket that fits every case: one XLA compile per case
        ref_rt.init_eb = 1 << 13
        ref_rt.pin_prebuilt(ref_snap)
    finally:
        cfg.set_dynamic("tpu_degree_split_threshold", 0)
    port_rt = GpuRuntime(device="cpu", degree_split_threshold=THRESHOLD)
    port_rt.pin_prebuilt(carried)
    hubs = port_rt.snapshots["snb"].host.hub_dense
    # the usual 16 seeds plus two hubs, whose edges reach every part
    seeds = sorted(set(np.unique(arrs["src"][:64])[:16].tolist())
                   | {int(hubs[0]), int(hubs[-1])})
    return dict(ref_snap=ref_snap, carried=carried, ref_rt=ref_rt,
                port_rt=port_rt, seeds=seeds,
                ref_store=ref_datagen.SnapshotStore(ref_snap),
                port_store=port_datagen.SnapshotStore(carried))


def _assert_split_equal(ref, port):
    if ref.hub_dense is None:
        assert port.hub_dense is None
    else:
        assert port.hub_dense.dtype == ref.hub_dense.dtype
        np.testing.assert_array_equal(port.hub_dense, ref.hub_dense)
    assert (ref.num_parts, ref.vmax) == (port.num_parts, port.vmax)
    assert sorted(ref.blocks) == sorted(port.blocks)
    for k, rb in ref.blocks.items():
        pb = port.blocks[k]
        for name in ("indptr", "nbr", "rank"):
            a, b = getattr(rb, name), getattr(pb, name)
            assert a.dtype == b.dtype and a.shape == b.shape, (k, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{k} {name}")
        for n in rb.props:
            assert rb.props[n].dtype == pb.props[n].dtype
            np.testing.assert_array_equal(rb.props[n], pb.props[n])


@pytest.mark.parametrize("threshold, max_hubs, hubs", [
    (10 ** 6, 1024, "none"),       # no vertex exceeds it
    (THRESHOLD, 1024, "few"),
    (12, 16, "capped"),            # more candidates than max_hubs
])
def test_degree_split_matches_reference(graph, threshold, max_hubs, hubs):
    ref = ref_csr.degree_split(graph["ref_snap"], threshold,
                               max_hubs=max_hubs)
    port = port_csr.degree_split(graph["carried"], threshold,
                                 max_hubs=max_hubs)
    _assert_split_equal(ref, port)
    if hubs == "none":
        assert port is graph["carried"]
    elif hubs == "few":
        assert 0 < len(port.hub_dense) < max_hubs
    else:
        assert len(port.hub_dense) == max_hubs
        lens = [b.indptr[:, 1:] - b.indptr[:, :-1]
                for b in graph["carried"].blocks.values()]
        deg = np.maximum.reduce([x.T.reshape(-1) for x in lens])
        assert (deg > threshold).sum() > max_hubs


def test_pinned_split_is_the_reference_split(graph):
    dev = graph["port_rt"].snapshots["snb"]
    ref_dev = graph["ref_rt"].snapshots["snb"]
    _assert_split_equal(ref_dev.host, dev.host)
    H = len(dev.host.hub_dense)
    assert dev.num_hubs == H > 0
    hubs = dev.host.hub_dense
    for name, want in (("hub_dense", hubs), ("hub_owner", hubs % P),
                       ("hub_local", hubs // P)):
        t = getattr(dev, name)
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), want)
    # the hub tables and the tag tables count in the pinned bytes: the
    # host's count holds the tag tables, the pin's the hub tables too
    assert dev.hbm_bytes() == sum(
        t.numel() * t.element_size() for t in dev._leaves())
    assert dev.hbm_bytes() == dev.host.hbm_bytes() + 12 * H


@pytest.mark.parametrize("seed", [0, 1])
def test_extend_hubs_matches_reference(graph, seed):
    rng = np.random.default_rng(seed)
    vmax = graph["carried"].vmax
    hubs = np.sort(rng.choice(P * vmax, 24, replace=False))
    fbm = rng.random((P, vmax)) < 0.3
    owner, local = (hubs % P).astype(np.int32), (hubs // P).astype(np.int32)
    want = np.asarray(ref_hop._extend_fbm_local(
        jnp.asarray(fbm), jnp.asarray(owner), jnp.asarray(local), P))
    buf = torch.zeros((P, vmax + len(hubs)), dtype=torch.bool)
    buf[:, :vmax] = torch.from_numpy(fbm)
    got = K.extend_hubs_plain(buf, torch.from_numpy(owner),
                              torch.from_numpy(local), vmax)
    assert got is buf
    np.testing.assert_array_equal(got.numpy(), want)


def _ref_expand_split(hb, fbm, hubs, P, vmax, EB):
    """The reference's expansion of one degree-split block from the
    (P, vmax) ownership bitmap: `_extend_fbm_local`, then `_expand_block`
    over every part (vmapped), as tpu/hop.py:518 runs it."""
    hubs = np.asarray(hubs)
    efbm = ref_hop._extend_fbm_local(
        jnp.asarray(fbm), jnp.asarray((hubs % P).astype(np.int32)),
        jnp.asarray((hubs // P).astype(np.int32)), P)
    hd = jnp.asarray(hubs.astype(np.int32))
    ref = jax.vmap(lambda ip, nb, r, f, pid: ref_hop._expand_block(
        ip, nb, r, f, EB, P, pid, vmax_local=vmax, hub_dense=hd))(
        jnp.asarray(hb.indptr), jnp.asarray(hb.nbr), jnp.asarray(hb.rank),
        efbm, jnp.arange(P, dtype=jnp.int32))
    return [np.asarray(x) for x in ref]


def _split_frontier(rng, hubs, lead, vmax, active):
    """A random (lead..., P, vmax) ownership bitmap with the `active`
    hubs' owner bits set."""
    fbm = rng.random(lead + (P, vmax)) < 0.05
    fbm[..., hubs % P, hubs // P] = False
    fbm[..., active % P, active // P] = True
    return fbm


_HUB_SOURCES = ("tail filled", "owners, tail zero", "owners, tail junk")


@pytest.mark.parametrize("hub_source", _HUB_SOURCES)
@pytest.mark.parametrize("direction", ["out", "in"])
@pytest.mark.parametrize("seed", [0, 1])
def test_expand_hub_rows_match_reference(graph, direction, seed,
                                         hub_source):
    """The hub rows' bits from the tail columns `extend_hubs_plain` fills,
    or through the owner tables (the single-device route) with the tail
    columns zero or junk: every slot equals the reference's."""
    dev = graph["port_rt"].snapshots["snb"]
    hb = dev.host.blocks[("KNOWS", direction)]
    hubs = dev.host.hub_dense
    vmax, H = dev.vmax, len(hubs)
    rng = np.random.default_rng(seed)
    fbm = _split_frontier(rng, hubs, (), vmax, hubs[:3])
    buf = torch.zeros((P, vmax + H), dtype=torch.bool)
    buf[:, :vmax] = torch.from_numpy(fbm)
    kw = {}
    if hub_source == "tail filled":
        K.extend_hubs_plain(buf, dev.hub_owner, dev.hub_local, vmax)
    else:
        kw = dict(hub_owner=dev.hub_owner, hub_local=dev.hub_local)
        if hub_source == "owners, tail junk":
            # the opposite of every hub's bit: a scan that reads the tail
            # gets every hub row wrong
            junk = ~torch.from_numpy(fbm[hubs % P, hubs // P])
            buf[:, vmax:] = junk[None, :]
    src, dst, rk, eidx, total = K.expand(
        torch.from_numpy(hb.indptr), torch.from_numpy(hb.nbr),
        torch.from_numpy(hb.rank), buf, dev.hub_dense, **kw)
    EB = src.shape[1]
    ref = _ref_expand_split(hb, fbm, hubs, P, vmax, EB)
    np.testing.assert_array_equal(total.numpy(), ref[5])
    assert EB == int(ref[5].max()) and not ref[6].any()
    for i, (name, got) in enumerate((("src", src), ("dst", dst),
                                     ("rank", rk), ("eidx", eidx))):
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), ref[i], err_msg=name)
    # hub rows really ran: some slot's source is a hub expanded outside
    # its owner part
    s = src.numpy()
    part = np.broadcast_to(np.arange(P)[:, None], s.shape)
    assert ((s >= 0) & (s % P != part)).any()


@pytest.mark.parametrize("direction", ["out", "in"])
@pytest.mark.parametrize("seed", [0, 1])
def test_expand_hub_owner_lanes_match_reference(graph, direction, seed):
    """An (L, P, vmax + H) lane stack whose lanes activate different hubs
    (one lane none), the tail columns junk: each lane reads its own
    owner rows, and its slots equal the reference's solo expansion of
    that lane, at the stack's shared width."""
    dev = graph["port_rt"].snapshots["snb"]
    hb = dev.host.blocks[("KNOWS", direction)]
    hubs = dev.host.hub_dense
    vmax, H = dev.vmax, len(hubs)
    rng = np.random.default_rng(seed + 10)
    actives = [hubs[:1], hubs[1:4], hubs[:0], hubs[-2:]]
    fbm = np.stack([_split_frontier(rng, hubs, (), vmax, a)
                    for a in actives])
    buf = torch.from_numpy(rng.random((len(actives), P, vmax + H)) < 0.5)
    buf[..., :vmax] = torch.from_numpy(fbm)
    src, dst, rk, eidx, total = K.expand(
        torch.from_numpy(hb.indptr), torch.from_numpy(hb.nbr),
        torch.from_numpy(hb.rank), buf, dev.hub_dense,
        hub_owner=dev.hub_owner, hub_local=dev.hub_local)
    EB = src.shape[-1]
    hub_src = set(hubs.tolist())
    seen = []
    for lane, active in enumerate(actives):
        ref = _ref_expand_split(hb, fbm[lane], hubs, P, vmax, EB)
        np.testing.assert_array_equal(total[lane].numpy(), ref[5])
        for i, (name, got) in enumerate((("src", src), ("dst", dst),
                                         ("rank", rk), ("eidx", eidx))):
            np.testing.assert_array_equal(got[lane].numpy(), ref[i],
                                          err_msg=f"lane {lane} {name}")
        # a lane expands no hub that it did not activate
        got_hubs = set(src[lane].numpy().ravel().tolist()) & hub_src
        assert got_hubs <= set(active.tolist()), lane
        seen.append(got_hubs)
    assert seen[1] and not seen[2]


@pytest.mark.parametrize("parts, pid", [(8, 3), (None, 1), (16, 0)])
def test_expand_owner_tables_refuse_a_shard_slot(graph, parts, pid):
    """Owner tables name rows of every part: with a shard slot's part
    offset (its CSR row alone) expand raises ValueError, on the CPU as
    on the card."""
    dev = graph["port_rt"].snapshots["snb"]
    hb = dev.host.blocks[("KNOWS", "out")]
    H = dev.num_hubs
    n = 1 if parts == 8 else P
    buf = torch.zeros((n, dev.vmax + H), dtype=torch.bool)
    with pytest.raises(ValueError, match="owner tables"):
        K.expand(torch.from_numpy(hb.indptr[:n]),
                 torch.from_numpy(hb.nbr[:n]),
                 torch.from_numpy(hb.rank[:n]), buf, dev.hub_dense,
                 parts=parts, pid=pid, hub_owner=dev.hub_owner,
                 hub_local=dev.hub_local)
    with pytest.raises(ValueError, match="come together"):
        K.expand(torch.from_numpy(hb.indptr), torch.from_numpy(hb.nbr),
                 torch.from_numpy(hb.rank),
                 torch.zeros((P, dev.vmax + H), dtype=torch.bool),
                 dev.hub_dense, hub_owner=dev.hub_owner)


def _yields(M):
    return [(M.FunctionCall("dst", [M.EdgeExpr()]), "d"),
            (M.FunctionCall("src", [M.EdgeExpr()]), "s"),
            (M.EdgeProp("KNOWS", "w"), "w")]


_FILTERS = {
    "none": None,
    "w_gt_50": lambda M: M.Binary(">", M.EdgeProp("KNOWS", "w"),
                                  M.Literal(50)),
    "mixed": lambda M: M.Binary(
        "OR", M.Binary("<", M.EdgeProp("KNOWS", "f"), M.Literal(0.25)),
        M.Binary("==", M.Binary("%", M.EdgeProp("KNOWS", "w"),
                                M.Literal(3)), M.Literal(0))),
}


@pytest.mark.parametrize("filt", sorted(_FILTERS))
@pytest.mark.parametrize("direction", ["out", "in", "both"])
@pytest.mark.parametrize("steps", [1, 2, 3])
def test_split_go_matches_reference(graph, steps, direction, filt):
    mk = _FILTERS[filt]
    ref_rows, ref_st = graph["ref_rt"].traverse(
        graph["ref_store"], "snb", graph["seeds"], ["KNOWS"], direction,
        steps, edge_filter=mk(RE) if mk else None, yields=_yields(RE))
    rows, st = graph["port_rt"].traverse(
        graph["port_store"], "snb", graph["seeds"], ["KNOWS"], direction,
        steps, edge_filter=mk(PE) if mk else None, yields=_yields(PE))
    assert rows.column_names == ref_rows.column_names
    assert len(rows) == len(ref_rows) > 0
    for name in rows.column_names:
        a = np.asarray(ref_rows.column_array(name))
        b = np.asarray(rows.column_array(name))
        assert a.dtype == b.dtype, name
        # equal IN ORDER: hub slots follow the local rows in each part
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert st.hop_edges == ref_st.hop_edges
    assert st.frontier_sizes == ref_st.frontier_sizes
    assert st.result_edges == ref_st.result_edges == len(rows)


def test_split_go_matches_unsplit_oracle(graph):
    """The oracle reads the UNSPLIT snapshot (a hub's own row is empty
    in the split one); the edges are the same, so rows agree
    lexsorted and the traversed-edge counts agree exactly."""
    for w_gt in (None, 50):
        filt = None if w_gt is None else PE.Binary(
            ">", PE.EdgeProp("KNOWS", "w"), PE.Literal(w_gt))
        rows, st = graph["port_rt"].traverse(
            graph["port_store"], "snb", graph["seeds"], ["KNOWS"], "out", 3,
            edge_filter=filt, yields=_yields(PE))
        total, kept, d, w = port_datagen.host_csr_traverse(
            graph["carried"], graph["seeds"], 3, w_gt=w_gt,
            materialize=True)
        assert st.edges_traversed() == total and len(rows) == kept
        dd = np.asarray(rows.column_array("d"), np.int64)
        ww = np.asarray(rows.column_array("w"), np.int64)
        a, b = np.lexsort((ww, dd)), np.lexsort((w, d))
        np.testing.assert_array_equal(dd[a], d[b])
        np.testing.assert_array_equal(ww[a], w[b])
