"""The port's device BFS (FIND SHORTEST PATH's device half) against the JAX
reference, on the CPU.

One social graph (make_social_arrays(2000, 8), P = 8) is built by the
reference and carried into the port with `snapshot_from_fields`.  The
reference `TpuRuntime(make_mesh(1))` runs in local mode, so its BFS is
the direction-optimizing single-chip program; the port's
`GpuRuntime(device="cpu")` runs the same BFS through the kernels' plain
versions.  A split fixture pins both sides with the degree-split
threshold set.  Checked: the (P, vmax) depth array element for element
and `stats.hop_edges` level for level (the switch decides hop_edges, not
dist), for out / in / both, unsplit and split, unfiltered and under three
WHERE filters, including both endpoint forms under bottom-up; the numpy
oracle `host_bfs`; the two new kernels' plain versions against the
reference's expressions.  Tolerance: exact — everything is integers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.bench import datagen as ref_datagen
from nebula_tpu.core import expr as RE
from nebula_tpu.core.value import NullValue as RefNull
from nebula_tpu.query.parser import parse
from nebula_tpu.tpu import TpuRuntime, make_mesh
from nebula_tpu.tpu import hop as ref_hop
from nebula_tpu.utils.config import get_config

from nebula_tpu_torch.bench import datagen as port_datagen
from nebula_tpu_torch.core import expr as PE
from nebula_tpu_torch.core.value import NullKind, NullValue
from nebula_tpu_torch.gpu import GpuRuntime, GpuUnavailable
from nebula_tpu_torch.gpu import bfs as port_bfs
from nebula_tpu_torch.gpu import kernels as K
from nebula_tpu_torch.gpu import runtime as port_runtime
from nebula_tpu_torch.graphstore.csr import snapshot_from_fields

P = 8
THRESHOLD = 64
STEPS = 6
FILTERS = ("KNOWS.w > 50", "id($$) != 7", "id($^) NOT IN [3, 9]")


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


def _to_port(x):
    """Rebuild a reference expression tree with the port's classes."""
    if isinstance(x, RE.Expr):
        node = object.__new__(getattr(PE, type(x).__name__))
        for slot in type(x).__slots__:
            setattr(node, slot, _to_port(getattr(x, slot)))
        return node
    if isinstance(x, list):
        return [_to_port(i) for i in x]
    if isinstance(x, RefNull):
        return NullValue(NullKind[x.kind.name])
    return x


def _filter(where):
    """(reference Expr, port Expr) of a GO WHERE clause."""
    ref = parse(f"GO FROM 1 OVER KNOWS WHERE {where} YIELD dst(edge)"
                ).where.filter
    return ref, _to_port(ref)


def _pair(n_persons, threshold=0, degree=8):
    """A reference runtime and a port runtime with the same graph pinned
    (degree-split at `threshold` on both sides when > 0)."""
    arrs = ref_datagen.make_social_arrays(n_persons, degree)
    ref_snap = ref_datagen.snapshot_from_arrays(arrs, parts=P)
    carried = snapshot_from_fields(_fields(ref_snap))
    cfg = get_config()
    cfg.set_dynamic("tpu_degree_split_threshold", threshold)
    try:
        ref_rt = TpuRuntime(make_mesh(1))
        assert ref_rt.local_mode            # the direction-optimizing leg
        # one bucket that fits every case: one XLA compile per program
        ref_rt.init_eb = 1 << 13
        ref_rt.pin_prebuilt(ref_snap)
    finally:
        cfg.set_dynamic("tpu_degree_split_threshold", 0)
    port_rt = GpuRuntime(device="cpu", degree_split_threshold=threshold)
    port_rt.pin_prebuilt(carried)
    return dict(arrs=arrs, ref_snap=ref_snap, carried=carried,
                ref_rt=ref_rt, port_rt=port_rt,
                ref_store=ref_datagen.SnapshotStore(ref_snap),
                port_store=port_datagen.SnapshotStore(carried))


@pytest.fixture(scope="module")
def graphs():
    g = {"unsplit": _pair(2000), "split": _pair(2000, THRESHOLD)}
    hubs = g["split"]["port_rt"].snapshots["snb"].host.hub_dense
    assert hubs is not None and len(hubs)
    src = g["unsplit"]["arrs"]["src"]
    seeds = np.unique(src[:64])[:16].tolist()
    g["seeds"] = {"one": [seeds[0]], "three": seeds[:3],
                  "forty": list(range(40))}
    # a hub among the seeds of every split case
    hub = int(hubs[0])
    g["split_seeds"] = {"one": [hub], "three": [hub] + seeds[:2],
                        "forty": sorted(set(range(40)) | {hub})}
    return g


def _run(g, srcs, direction, steps=STEPS, ref_filter=None,
         port_filter=None):
    rd, rst = g["ref_rt"].bfs(g["ref_store"], "snb", srcs, ["KNOWS"],
                              direction, steps, edge_filter=ref_filter)
    pd, pst = g["port_rt"].bfs(g["port_store"], "snb", srcs, ["KNOWS"],
                               direction, steps, edge_filter=port_filter)
    return np.asarray(rd, np.int32), rst, pd, pst


def _assert_same(rd, rst, pd, pst):
    assert isinstance(pd, np.ndarray) and pd.dtype == np.int32
    assert pd.shape == rd.shape
    np.testing.assert_array_equal(pd, rd)
    assert pst.hop_edges == [int(x) for x in rst.hop_edges]
    assert pst.frontier_sizes == list(rst.frontier_sizes) == []
    assert pst.steps == rst.steps
    assert pst.retries == 0


def _branches(dist, steps, n_phantom):
    """Which levels the reference's switch sends bottom-up, derived from
    its depth array: the frontier entering level L is dist == L-1 and the
    unvisited set dist < 0 or dist >= L, over P*vmax slots."""
    out = []
    for level in range(1, steps + 1):
        front = int((dist == level - 1).sum())
        unvis = int(((dist < 0) | (dist >= level)).sum())
        out.append(front * 8 > unvis - n_phantom)
    return out


def _n_phantom(g):
    snap = g["carried"]
    return snap.num_parts * snap.vmax - int(np.sum(snap.num_vertices))


@pytest.mark.parametrize("seeds", ["one", "three", "forty"])
@pytest.mark.parametrize("direction", ["out", "in", "both"])
@pytest.mark.parametrize("layout", ["unsplit", "split"])
def test_bfs_matches_reference(graphs, layout, direction, seeds):
    g = graphs[layout]
    srcs = graphs["split_seeds" if layout == "split" else "seeds"][seeds]
    rd, rst, pd, pst = _run(g, srcs, direction)
    _assert_same(rd, rst, pd, pst)
    assert len(pst.hop_edges) == len(pst.e_cap) == STEPS
    assert (pd >= 0).sum() > len(srcs)


@pytest.mark.parametrize("direction", ["out", "both"])
@pytest.mark.parametrize("layout", ["unsplit", "split"])
def test_bfs_goes_bottom_up(graphs, layout, direction):
    """The cases above take the bottom-up branch: derived from the
    reference's depth array with the reference's switch, and equal to the
    branches the port's level loop took."""
    g = graphs[layout]
    srcs = graphs["split_seeds" if layout == "split" else "seeds"]["three"]
    rd, rst, pd, pst = _run(g, srcs, direction)
    _assert_same(rd, rst, pd, pst)
    want = _branches(rd, STEPS, _n_phantom(g))
    assert any(want)
    rt, dev = g["port_rt"], g["port_rt"].snapshots["snb"]
    keys = rt._blocks_for(["KNOWS"], direction)
    rev = {"out": "in", "in": "out"}
    res = port_bfs.run_bfs(
        dev, [dev.blocks[k] for k in keys],
        [dev.blocks[(et, rev[d])] for et, d in keys],
        rt._seed_frontier(dev, srcs), STEPS, n_phantom=_n_phantom(g))
    assert res["bottom_up"] == want
    np.testing.assert_array_equal(res["dist"].numpy(), rd)
    np.testing.assert_array_equal(res["hop_edges"].sum(0).numpy(),
                                  pst.hop_edges)


def test_bfs_switch_subtracts_phantom_slots():
    """A graph whose parts hold unequal vertex counts: 9 vertices in 8
    parts of vmax 2 leave 7 padding slots, which stay unreached, count as
    unvisited, and are subtracted by the switch — on these seeds it sends
    levels bottom-up that it would keep top-down without them."""
    g = _pair(9, degree=2)
    n_phantom = _n_phantom(g)
    assert n_phantom == 7
    for srcs, direction in (([2], "out"), ([3], "in")):
        rd, rst, pd, pst = _run(g, srcs, direction)
        _assert_same(rd, rst, pd, pst)
        assert (pd[1:, 1] == -1).all()          # dense ids 9-15
        assert _branches(rd, STEPS, n_phantom) != _branches(rd, STEPS, 0)


@pytest.mark.parametrize("where", FILTERS)
@pytest.mark.parametrize("layout", ["unsplit", "split"])
def test_filtered_bfs_matches_reference(graphs, layout, where):
    """The WHERE mask applies at every level; under bottom-up the
    predicate's id($^) is the frontier side, the reverse slot's dst.
    From vertex 0 (a hub of the split layout), levels 2-5 go bottom-up,
    unfiltered 7 and 9 are reached at level 2 and 3 and 9 are on the
    frontier of a bottom-up level, so each endpoint form filters edges
    that only a bottom-up level expands."""
    g = graphs[layout]
    ref_f, port_f = _filter(where)
    srcs = graphs["split_seeds" if layout == "split" else "seeds"]["one"]
    assert srcs == [0]
    rd, rst, pd, pst = _run(g, srcs, "out", ref_filter=ref_f,
                            port_filter=port_f)
    _assert_same(rd, rst, pd, pst)
    rd0, _, _, _ = _run(g, srcs, "out")
    bu = _branches(rd0, STEPS, _n_phantom(g))
    assert bu[1] and bu[2]
    assert [int(rd0[v % P, v // P]) for v in (3, 7, 9)] == [1, 2, 2]
    assert not np.array_equal(rd0, rd)       # the filter changed dist


def test_host_bfs_matches_reference_and_device(graphs):
    g = graphs["unsplit"]
    snap = g["carried"]
    nv = len(snap.dense_to_vid)
    vv = np.arange(nv)
    for srcs in graphs["seeds"].values():
        want = ref_datagen.host_bfs(g["ref_snap"], srcs, 5)
        got = port_datagen.host_bfs(snap, srcs, 5)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        # read as bench.py:605-609 reads the device result
        dist, _ = g["port_rt"].bfs(g["port_store"], "snb", srcs, ["KNOWS"],
                                   "out", 5)
        np.testing.assert_array_equal(dist[vv % P, vv // P], got)


def test_seed_without_edges_reports_zero_levels(graphs):
    g = graphs["unsplit"]
    arrs = g["arrs"]
    no_in = np.nonzero(np.bincount(arrs["dst"], minlength=arrs["n"])
                       == 0)[0]
    assert no_in.size
    rd, rst, pd, pst = _run(g, [int(no_in[0])], "in")
    _assert_same(rd, rst, pd, pst)
    assert pst.hop_edges == [0] * STEPS
    assert (pd >= 0).sum() == 1


def test_no_valid_seed_is_all_unreached(graphs):
    g = graphs["unsplit"]
    rd, rst, pd, pst = _run(g, [-5, 10 ** 9], "out")
    _assert_same(rd, rst, pd, pst)
    assert (pd == -1).all()


def test_out_of_range_seed_raises_before_any_kernel(graphs, monkeypatch):
    g = graphs["unsplit"]
    snap = g["carried"]

    class Store(port_datagen.SnapshotStore):
        def space(self, name):
            sd = super().space(name)

            class SD:
                epoch = sd.epoch

                @staticmethod
                def dense_id(v):
                    return snap.num_parts * snap.vmax if v == -7 \
                        else sd.dense_id(v)
            return SD()

    def no_kernel(*a, **k):
        raise AssertionError("a kernel ran")

    monkeypatch.setattr(port_runtime, "mark", no_kernel)
    monkeypatch.setattr(port_bfs, "bfs_level", no_kernel)
    with pytest.raises(ValueError, match="out of range"):
        g["port_rt"].bfs(Store(snap), "snb", [1, -7], ["KNOWS"], "out", 3)


def test_default_device_without_cuda_raises(graphs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    g = graphs["unsplit"]
    with pytest.raises(GpuUnavailable):
        GpuRuntime().bfs(g["port_store"], "snb", [1], ["KNOWS"], "out", 3)


# ---------------------------------------------------------------------------
# the two new kernels' plain versions against the reference's expressions
# ---------------------------------------------------------------------------


def _probe_inputs(seed, vmax=50, H=3, EB=40):
    """Slots as expand makes them from a split reverse block: padding past
    total (src = nbr = -1), hub-row src ids owned by other parts,
    duplicated src ids with mixed keep; a frontier in the first vmax
    columns of a (P, vmax + H) buffer."""
    rng = np.random.default_rng(seed)
    n = P * vmax
    total = rng.integers(0, EB + 1, P).astype(np.int32)
    total[0] = EB
    valid = np.arange(EB)[None, :] < total[:, None]
    # own rows: local ids of part p; hub rows: any part's hub ids
    hubs = rng.choice(n, H, replace=False)
    own = rng.integers(0, vmax, (P, EB)) * P + np.arange(P)[:, None]
    src = np.where(rng.random((P, EB)) < 0.2, hubs[rng.integers(0, H,
                                                                (P, EB))],
                   own)
    src[:, 1::7] = src[:, ::7][:, :src[:, 1::7].shape[1]]  # duplicates
    src = np.where(valid, src, -1).astype(np.int32)
    nbr = np.where(valid, rng.integers(0, n, (P, EB)), -1).astype(np.int32)
    keep = valid & (rng.random((P, EB)) < 0.7)
    buf = np.zeros((P, vmax + H), bool)
    buf[:, :vmax] = rng.random((P, vmax)) < 0.3
    buf[:, vmax:] = True          # hub columns the probe must not read
    return src, nbr, keep, total, buf, vmax


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_keep", [True, False])
def test_bfs_probe_plain_matches_reference(seed, with_keep):
    src, nbr, keep, total, buf, vmax = _probe_inputs(seed)
    valid = np.arange(src.shape[1])[None, :] < total[:, None]
    k = keep if with_keep else valid
    # frontier.py:136-141 on the reference's (P, vmax) frontier
    fbm = jnp.asarray(buf[:, :vmax])
    nb = jnp.asarray(nbr)
    member = fbm[nb % P, nb // P] & jnp.asarray(k)
    blk = jax.vmap(lambda s, m: ref_hop._mark(s, m, P, vmax))(
        jnp.asarray(src), member)
    want = np.asarray(blk.any(axis=0))
    tbuf = torch.from_numpy(buf)
    out_buf = torch.zeros((P, vmax + 2), dtype=torch.bool)
    out_buf[:, vmax:] = True
    got = K.bfs_probe(torch.from_numpy(src), torch.from_numpy(nbr),
                      torch.from_numpy(keep) if with_keep else None,
                      torch.from_numpy(total), tbuf[:, :vmax],
                      out_buf[:, :vmax])
    assert got.data_ptr() == out_buf.data_ptr()
    np.testing.assert_array_equal(out_buf[:, :vmax].numpy(), want)
    assert out_buf[:, vmax:].all()            # the tail is left alone
    assert want.any() and not want.all()


def test_bfs_probe_plain_never_clears_and_ors():
    src = torch.tensor([[3, 3, 3, 11]], dtype=torch.int32).expand(P, 4) \
        .contiguous()
    nbr = torch.tensor([[0, 8, 1, 0]], dtype=torch.int32).expand(P, 4) \
        .contiguous()
    keep = torch.tensor([[True, False, True, True]]).expand(P, 4) \
        .contiguous()
    total = torch.tensor([4] + [0] * (P - 1), dtype=torch.int32)
    fbm = torch.zeros((P, 2), dtype=torch.bool)
    fbm[0, 0] = True                      # vertex 0 on the frontier
    out = torch.zeros((P, 2), dtype=torch.bool)
    out[5, 0] = True                      # an earlier block's mark
    K.bfs_probe(src, nbr, keep, total, fbm, out)
    want = torch.zeros((P, 2), dtype=torch.bool)
    want[3, 0] = want[3, 1] = want[5, 0] = True
    assert torch.equal(out, want)


@pytest.mark.parametrize("level", [0, 1, 4])
def test_bfs_level_plain_matches_reference(level):
    rng = np.random.default_rng(level)
    vmax, H = 37, 4
    dist = np.where(rng.random((P, vmax)) < 0.4,
                    rng.integers(0, max(level, 1), (P, vmax)), -1
                    ).astype(np.int32)
    if level == 0:
        dist[:] = -1
    cand = np.zeros((P, vmax + H), bool)
    cand[:, :vmax] = rng.random((P, vmax)) < 0.3
    cand[:, vmax:] = True
    # tpu/bfs.py:153-159, 170-172
    jd = jnp.asarray(dist)
    new = jnp.asarray(cand[:, :vmax]) & (jd < 0)
    want_dist = np.asarray(jnp.where(new, level, jd))
    want_counts = [int(new.sum()), int((want_dist < 0).sum())]
    td = torch.from_numpy(dist.copy())
    fbuf = torch.ones((P, vmax + H), dtype=torch.bool)
    ubuf = torch.ones((P, vmax + H), dtype=torch.bool)
    counts = K.bfs_level(torch.from_numpy(cand)[:, :vmax], td, level,
                         fbuf[:, :vmax], ubuf[:, :vmax])
    assert counts.dtype == torch.int64 and counts.tolist() == want_counts
    assert td.dtype == torch.int32
    np.testing.assert_array_equal(td.numpy(), want_dist)
    np.testing.assert_array_equal(fbuf[:, :vmax].numpy(), np.asarray(new))
    np.testing.assert_array_equal(ubuf[:, :vmax].numpy(), want_dist < 0)
    assert fbuf[:, vmax:].all() and ubuf[:, vmax:].all()
    assert want_counts[0] > 0
