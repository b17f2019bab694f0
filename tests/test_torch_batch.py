"""Multi-lane batched GO in the port against the JAX reference, on the CPU.

Three levels, one social graph (make_social_arrays(2000, 8), P = 8, the
reference snapshot carried into the port through `snapshot_from_fields`):

  * the lanes program: the port's `run_hops` over an (L, P, vmax + H)
    frontier stack (the kernels' plain versions) against the reference's
    `build_traverse_fn_lanes` (jax.vmap of the hop program over a lane
    axis) with L = 4, on unsplit, degree-split and delta-armed snapshots
    (writes pending), with and without WHERE — and each lane against the
    solo `run_hops` of its own seeds;
  * the runtime: concurrent `GpuRuntime(device="cpu").traverse` calls
    from threads form ONE batch whose statements each get the rows,
    hop_edges and WorkCounters of their solo runs, and the rows of the
    reference `TpuRuntime.traverse` under the reference's own batching;
  * the batch former's contract, at the runtime level: the solo fast
    path, the failpoint, kill and deadline mid-form, a 1-lane group, the
    off switch, delta views, the dispatch gate.

Tolerance: exact — the path moves integers and copies float64 values.
Every thread is joined with a timeout, so nothing can hang the suite.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.bench import datagen as ref_datagen
from nebula_tpu.core import expr as RE
from nebula_tpu.graphstore import csr as ref_csr
from nebula_tpu.graphstore.delta import HostDelta as RefHostDelta
from nebula_tpu.graphstore.schema import PropDef as RefPropDef
from nebula_tpu.graphstore.schema import PropType as RefPropType
from nebula_tpu.tpu import TpuRuntime, make_mesh
from nebula_tpu.tpu import hop as ref_hop
from nebula_tpu.tpu.batch import batch_former as ref_batch_former
from nebula_tpu.tpu.exprjit import compile_predicate as ref_compile
from nebula_tpu.utils.config import get_config as ref_get_config
from nebula_tpu.utils.workload import live_registry as ref_live_registry

from nebula_tpu_torch.bench import datagen as D
from nebula_tpu_torch.core import expr as PE
from nebula_tpu_torch.gpu import GpuRuntime, GpuUnavailable
from nebula_tpu_torch.gpu import kernels as K
from nebula_tpu_torch.gpu import runtime as GR
from nebula_tpu_torch.gpu.batch import BatchFormer, batch_former
from nebula_tpu_torch.gpu.exprjit import compile_predicate
from nebula_tpu_torch.gpu.hop import run_hops
from nebula_tpu_torch.graphstore.csr import snapshot_from_fields
from nebula_tpu_torch.utils.cancel import DeadlineExceeded, QueryKilled, \
    use_cancel
from nebula_tpu_torch.utils.config import get_config
from nebula_tpu_torch.utils.failpoints import fail
from nebula_tpu_torch.utils.stats import WorkCounters, stats, use_work
from nebula_tpu_torch.utils.workload import live_registry

P = 8
SPLIT = 64                      # degree-split threshold of the split cases
DCAP = 256                      # delta capacity of the delta-armed cases
REF_EB = 1 << 13                # reference slot budget: nothing overflows
JOIN_S = 60                     # every thread joins within this


def _fields(snap):
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


def _writes(store, arrs, seeds, rng, n=120):
    """A delta batch through the port's SnapshotStore: deletes and w
    overwrites of base edges, and inserts (a quarter from the seeds)."""
    pick = rng.permutation(store.writable_edges())[:n // 2]
    for i in pick[:n // 4]:
        store.delete_edge(int(arrs["src"][i]), int(arrs["dst"][i]))
    for i in pick[n // 4:]:
        store.update_edge(int(arrs["src"][i]), int(arrs["dst"][i]),
                          {"w": int((arrs["w"][i] + 7) % 100)})
    done, N = 0, int(arrs["n"])
    while done < n // 2:
        s = int(seeds[done % len(seeds)]) if done < n // 8 \
            else int(rng.integers(N))
        d = int(rng.integers(N))
        if s == d or store.base_has(s, d) or store.edge_row(s, d):
            continue
        store.insert_edge(s, d, {"w": int(rng.integers(100)),
                                 "f": float(rng.random()),
                                 "city": D._NAMES[int(rng.integers(16))]})
        done += 1


class _RefSchema:
    """A port edge schema as the reference's HostDelta reads it."""

    def __init__(self, sv):
        self.props = [RefPropDef(pd.name, RefPropType[pd.ptype.name],
                                 default=pd.default,
                                 has_default=pd.has_default)
                      for pd in sv.props]


class _RefReader:
    """The port store's delta reader with its schemas turned into the
    reference's: the reference's own HostDelta applies the same writes
    from it (the values are plain ints, floats and strings)."""

    def __init__(self, inner):
        self.inner = inner

    def dense_of(self, vid):
        return self.inner.dense_of(vid)

    def edge_row(self, etype, src, dst, rank):
        row, sv = self.inner.edge_row(etype, src, dst, rank)
        return row, None if sv is None else _RefSchema(sv)

    def vertex_rows(self, vid):
        return self.inner.vertex_rows(vid)

    def tag_schema(self, tag):
        return None


@pytest.fixture(scope="module")
def graph():
    arrs = ref_datagen.make_social_arrays(2000, 8)
    ref_snap = ref_datagen.snapshot_from_arrays(arrs, parts=P)
    carried = snapshot_from_fields(_fields(ref_snap))
    seeds = np.unique(arrs["src"][:64])[:16].tolist()
    rts = {}
    rts["unsplit"] = GpuRuntime(device="cpu")
    rts["unsplit"].pin_prebuilt(carried)
    rts["split"] = GpuRuntime(device="cpu", degree_split_threshold=SPLIT)
    rts["split"].pin_prebuilt(carried)
    # the delta-armed snapshot: its own carried copy (the plane's mirror
    # writes into its snapshot), writes logged after the pin, applied by
    # the next pin and left pending in the plane
    dsnap = snapshot_from_fields(_fields(ref_snap))
    dstore = D.SnapshotStore(dsnap, D.make_social_arrays(2000, 8))
    dstore.delta_watch("snb")
    rts["delta"] = GpuRuntime(device="cpu", delta_max_edges=DCAP)
    rts["delta"].pin_prebuilt(dsnap)
    _writes(dstore, dstore._arrs, seeds, np.random.default_rng(3))
    # the reference's own inputs, prepared apart from the port's: its
    # degree split, and its HostDelta over its own snapshot, fed the same
    # logged writes
    ref_delta = RefHostDelta(ref_datagen.snapshot_from_arrays(arrs, parts=P),
                             DCAP)
    ref_delta.apply(_RefReader(dstore.delta_reader("snb")),
                    dstore.delta_records("snb")[0])
    refs = {"unsplit": (ref_snap, None),
            "split": (ref_csr.degree_split(ref_snap, SPLIT), None),
            "delta": (ref_snap, ref_delta)}
    rts["delta"].pin(dstore, "snb")
    assert rts["delta"].snapshots["snb"].delta.host.total_edges() > 0
    store = D.SnapshotStore(carried)
    return dict(arrs=arrs, ref_snap=ref_snap, carried=carried, seeds=seeds,
                rts=rts, refs=refs, stores={"unsplit": store, "split": store,
                                 "delta": dstore})


@pytest.fixture()
def clean():
    """Batching off, no armed failpoint and no forming group before and
    after; every flag this file sets restored, in both packages."""
    for f in (batch_former(), ref_batch_former()):
        f.reset()
    fail.reset()
    yield
    fail.reset()
    for f in (batch_former(), ref_batch_former()):
        f.reset()
    for cfg in (get_config(), ref_get_config()):
        with cfg.lock:
            for k in ("batch_max_lanes", "batch_wait_us"):
                cfg.dynamic_layer.pop(k, None)


@pytest.fixture()
def company():
    """Two dummy live statements in each package's registry, so the batch
    formers' concurrency hint is true whatever the threads' arrival
    order (tests/unit/test_batch.py:67-80)."""
    regs = (live_registry(), ref_live_registry())
    for reg in regs:
        for qid in (-101, -102):
            reg.register(qid=qid, session=0, user="t", stmt="dummy",
                         kind="Go")
    yield
    for reg in regs:
        for qid in (-101, -102):
            reg.deregister(qid)


def _batching(lanes, wait_us):
    get_config().set_dynamic_many({"batch_max_lanes": lanes,
                                   "batch_wait_us": wait_us})


def _where(M):
    return M.Binary(">", M.EdgeProp("KNOWS", "w"), M.Literal(50))


def _yields(M):
    return [(M.FunctionCall("dst", [M.EdgeExpr()]), "d"),
            (M.FunctionCall("src", [M.EdgeExpr()]), "s"),
            (M.EdgeProp("KNOWS", "w"), "w"),
            (M.EdgeProp("KNOWS", "f"), "f")]


def _cols(rows):
    return {n: np.asarray(rows.column_array(n)) for n in rows.column_names}


def _assert_rows_equal(got, want, tag):
    g, w = _cols(got), _cols(want)
    assert list(g) == list(w), tag
    for n in w:
        assert g[n].dtype == w[n].dtype, (tag, n)
        # equal IN ORDER: the capture order is part of the contract
        np.testing.assert_array_equal(g[n], w[n], err_msg=f"{tag} {n}")


def _threads(fns, timeout=JOIN_S):
    """Run each fn on its own thread; returns (results, errors) by index.
    Fails the test if a thread outlives the timeout."""
    out, errs = {}, {}

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as ex:  # noqa: BLE001 — reported per thread
            errs[i] = ex

    ths = [threading.Thread(target=run, args=(i, fn), daemon=True)
           for i, fn in enumerate(fns)]
    for t in ths:
        t.start()
    deadline = time.monotonic() + timeout
    for t in ths:
        t.join(max(deadline - time.monotonic(), 0.0))
    alive = [i for i, t in enumerate(ths) if t.is_alive()]
    if alive:
        batch_former().reset()
        pytest.fail(f"threads {alive} did not finish in {timeout} s")
    return out, errs


def _wait_for(pred, timeout=10.0, msg="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        got = pred()
        if got:
            return got
        time.sleep(0.005)
    pytest.fail(f"timed out waiting for {msg}")


def _counter(name):
    return stats().snapshot().get(name, 0)


# ---------------------------------------------------------------------------
# the lanes program against the reference's build_traverse_fn_lanes
# ---------------------------------------------------------------------------

LANES = [[0, 1, 2, 3], [4, 5], [6], [7, 8, 9, 10, 11, 12, 13, 14, 15]]


def _lane_seeds(seeds):
    return [[seeds[i] for i in idx] for idx in LANES]


def _port_lanes(graph, layout, steps, filt, lane_seeds):
    """The port's lane run of `lane_seeds` (plain kernels): (res, solo
    results per lane, block keys, yield cols)."""
    rt = graph["rts"][layout]
    dev = rt.snapshots["snb"]
    bks = [("KNOWS", "out")]
    pred = None
    if filt:
        pred, _ = compile_predicate(
            _where(PE), dev.blocks[bks[0]].prop_types, dev.pool,
            vid_to_dense=graph["stores"][layout].space("snb").dense_id,
            device=rt.device)
    ycols = ("f", "w")
    names = set(ycols) | (set(pred.columns) if pred else set())
    _, extras = rt._grab_delta(dev, bks, names)
    blocks = [dev.blocks[bk] for bk in bks]
    fr = rt._seed_frontier_lanes(dev, lane_seeds)
    res = run_hops(dev, blocks, fr, steps, pred=pred, yield_cols=ycols,
                   deltas=extras)
    solos = [run_hops(dev, blocks, rt._seed_frontier(dev, s), steps,
                      pred=pred, yield_cols=ycols, deltas=extras)
             for s in lane_seeds]
    return rt, dev, res, solos, bks, ycols, extras


def _ref_lanes(graph, layout, steps, filt, lane_seeds, bk):
    """The reference's lanes program on the reference's own arrays: its
    snapshot, its degree split and its HostDelta (never the port's host
    mirror)."""
    snap, hd = graph["refs"][layout]
    rb = snap.blocks[bk]
    pred, pred_cols = None, []
    if filt:
        pred, pred_cols = ref_compile(
            _where(RE), rb.prop_types, snap.pool,
            vid_to_dense=lambda v: int(v))
    ycols = ("f", "w")
    names = {n for n in pred_cols if not n.startswith("_")} | set(ycols)
    blk = {"indptr": jnp.asarray(rb.indptr), "nbr": jnp.asarray(rb.nbr),
           "rank": jnp.asarray(rb.rank),
           "props": {n: jnp.asarray(rb.props[n]) for n in names}}
    if hd is not None:
        npd = hd.block_arrays(bk)
        for k in ("d_src", "d_dst", "d_rank", "d_valid", "d_tomb"):
            blk[k] = jnp.asarray(npd[k])
        blk["d_props"] = {n: jnp.asarray(npd["d_props"][n]) for n in names}
    fn = ref_hop.build_traverse_fn_lanes(
        P, (REF_EB,) * steps, steps, 1, pred=pred, pred_cols=pred_cols,
        capture=True, yield_cols=ycols, hub_dense=snap.hub_dense)
    fr = np.zeros((len(lane_seeds), P, snap.vmax), bool)
    for i, s in enumerate(lane_seeds):
        d = np.asarray(s)
        fr[i, d % P, d // P] = True
    out = fn((blk,), jnp.asarray(fr))
    assert not np.asarray(out["ovf_expand"]).any()
    return {k: (np.asarray(v) if not isinstance(v, dict)
                else {kk: np.asarray(vv) for kk, vv in v.items()})
            for k, v in out.items()}


def _assert_cap_equal(got, want, lane, tag):
    """One lane of a port block capture (dict of (L, P, W) tensors or
    (P, W) for a solo one) against another, kept prefixes only."""
    def lane_of(c, k):
        v = c[k]
        v = v.numpy() if torch.is_tensor(v) else v
        return v if lane is None else v[lane]
    kc_g, kc_w = lane_of(got, "kcount"), lane_of(want, "kcount")
    np.testing.assert_array_equal(kc_g, kc_w, err_msg=f"{tag} kcount")
    for k in got:
        if k == "kcount":
            continue
        a, b = lane_of(got, k), lane_of(want, k)
        for p in range(P):
            np.testing.assert_array_equal(a[p, :kc_g[p]], b[p, :kc_w[p]],
                                          err_msg=f"{tag} {k} part {p}")


@pytest.mark.parametrize("filt", [False, True], ids=["all", "w_gt_50"])
@pytest.mark.parametrize("layout", ["unsplit", "split", "delta"])
def test_lanes_program_matches_reference(graph, layout, filt):
    steps = 3
    lane_seeds = _lane_seeds(graph["seeds"])
    rt, dev, res, solos, bks, ycols, extras = _port_lanes(
        graph, layout, steps, filt, lane_seeds)
    assert (layout == "split") == (dev.num_hubs > 0)
    assert (layout == "delta") == (extras[0] is not None)
    ref = _ref_lanes(graph, layout, steps, filt, lane_seeds, bks[0])
    L = len(lane_seeds)
    np.testing.assert_array_equal(res["hop_edges"].numpy(), ref["hop_edges"])
    np.testing.assert_array_equal(res["frontier_sizes"].numpy(),
                                  ref["frontier_sizes"])
    cap = res["cap"][0]
    kc = cap["kcount"].numpy()
    np.testing.assert_array_equal(kc, ref["kcount"][:, :, 0])
    assert kc.shape == (L, P) and kc.sum() > 0
    for k in ("src", "dst", "rank", "eidx", "prop:w", "prop:f"):
        got = cap[k].numpy()
        want = ref["cap"][k][:, :, 0]
        for lane in range(L):
            for p in range(P):
                n = kc[lane, p]
                np.testing.assert_array_equal(
                    got[lane, p, :n], want[lane, p, :n],
                    err_msg=f"{layout} {k} lane {lane} part {p}")
    if layout == "delta":
        # some lane captured delta rows (virtual eidx past emax)
        emax = dev.blocks[bks[0]].nbr.shape[1]
        assert (cap["eidx"].numpy() >= emax).any()


@pytest.mark.parametrize("filt", [False, True], ids=["all", "w_gt_50"])
@pytest.mark.parametrize("layout", ["unsplit", "split", "delta"])
def test_each_lane_equals_its_solo_run(graph, layout, filt):
    lane_seeds = _lane_seeds(graph["seeds"])
    _, _, res, solos, *_ = _port_lanes(graph, layout, 3, filt, lane_seeds)
    for lane, solo in enumerate(solos):
        np.testing.assert_array_equal(res["hop_edges"][lane].numpy(),
                                      solo["hop_edges"].numpy())
        np.testing.assert_array_equal(res["frontier_sizes"][lane].numpy(),
                                      solo["frontier_sizes"].numpy())
        _assert_cap_equal({k: v[lane] for k, v in res["cap"][0].items()},
                          solo["cap"][0], None, f"{layout} lane {lane}")
    # the shared slot width is each hop's widest lane
    assert res["e_cap"] == [max(s["e_cap"][h] for s in solos)
                            for h in range(3)]


@pytest.mark.parametrize("layout", ["unsplit", "split", "delta"])
def test_one_lane_is_the_solo_path(graph, layout):
    """L = 1: every output, padding included, equals the solo run's."""
    seeds = [graph["seeds"][:5]]
    _, _, res, solos, *_ = _port_lanes(graph, layout, 3, True, seeds)
    solo = solos[0]
    for k in ("hop_edges", "frontier_sizes"):
        assert torch.equal(res[k][0], solo[k])
    assert res["e_cap"] == solo["e_cap"]
    for k, v in res["cap"][0].items():
        assert torch.equal(v[0], solo["cap"][0][k]), k


def test_lane_seed_build_marks_each_lane(graph):
    rt = graph["rts"]["split"]
    dev = rt.snapshots["snb"]
    lane_seeds = [[3, 17], [], [5, 5, 1999]]
    fr = rt._seed_frontier_lanes(dev, lane_seeds)
    assert fr.shape == (3, P, dev.vmax + dev.num_hubs)
    for lane, s in enumerate(lane_seeds):
        assert torch.equal(fr[lane], rt._seed_frontier(dev, s))


def test_compact_keeps_nothing_past_the_extent():
    """compact_capture's extent: a slot at or past its row's extent is
    not kept whatever keep says, and its row is padded from kcount on."""
    src = torch.arange(18, dtype=torch.int32).view(3, 6)
    keep = torch.tensor([[True] * 6, [True, False] * 3, [True] * 6])
    ext = torch.tensor([2, 5, 0], dtype=torch.int32)
    col = torch.arange(100, 118, dtype=torch.int64).view(3, 6)
    eidx = torch.arange(6, dtype=torch.int32).repeat(3, 1)
    cs, cd, cr, ce, (pc,), kc = K.compact_capture(src, src, src, eidx, keep,
                                                  [col], extent=ext)
    assert kc.tolist() == [2, 3, 0]
    assert cs.tolist() == [[0, 1, -1, -1, -1, -1], [6, 8, 10, -1, -1, -1],
                           [-1] * 6]
    assert ce.tolist() == [[0, 1, 0, 0, 0, 0], [0, 2, 4, 0, 0, 0], [0] * 6]
    assert pc.tolist() == [[100, 101, 0, 0, 0, 0], [106, 108, 110, 0, 0, 0],
                           [0] * 6]


@pytest.mark.parametrize("layout", ["unsplit", "split", "delta"])
def test_fetch_takes_each_lane_at_its_own_width(graph, layout):
    """The fetch moves each lane's kept prefix at that lane's own width
    (its widest part), never the widest lane's, and each lane's host
    capture equals its solo run's."""
    rt = graph["rts"][layout]
    dev = rt.snapshots["snb"]
    seeds = graph["seeds"]
    lanes = [seeds[:8], seeds[8:9], [], seeds[9:11]]
    blocks = [dev.blocks[("KNOWS", "out")]]
    _, extras = rt._grab_delta(dev, [("KNOWS", "out")], {"w"})
    res, _ = rt._run(dev, blocks, lanes, 2, None, True, ("w",), None,
                     extras, attribute=False)
    widths = []
    for lane, seeds_l in enumerate(lanes):
        (cap,) = res["cap"][lane]
        k = int(cap["kcount"].max())
        widths.append(k)
        solo, _ = rt._run(dev, blocks, [seeds_l], 2, None, True, ("w",),
                          None, extras)
        assert set(cap) == set(solo["cap"][0][0])
        for name, a in cap.items():
            assert a.shape == ((P,) if name == "kcount" else (P, k)), name
            np.testing.assert_array_equal(a, solo["cap"][0][0][name],
                                          err_msg=f"lane {lane} {name}")
    assert widths[2] == 0 and widths[0] > widths[1] > 0


# ---------------------------------------------------------------------------
# the runtime: concurrent traverse calls share one run
# ---------------------------------------------------------------------------

STMT_SEEDS = [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [10, 11], [12, 13],
              [14, 15]]


def _stmt(rt, store, seeds, filt, steps=3):
    def go():
        wc = WorkCounters()
        with use_work(wc):
            rows, st = rt.traverse(store, "snb", seeds, ["KNOWS"], "out",
                                   steps, edge_filter=_where(PE) if filt
                                   else None, yields=_yields(PE))
        return rows, st, wc.as_dict()
    return go


def _solo_truth(rt, store, seed_sets, filt):
    return [_stmt(rt, store, s, filt)() for s in seed_sets]


@pytest.mark.parametrize("layout,filt", [("unsplit", False),
                                         ("unsplit", True),
                                         ("split", True), ("delta", True)])
def test_concurrent_statements_form_one_batch(graph, clean, company, layout,
                                              filt):
    rt, store = graph["rts"][layout], graph["stores"][layout]
    sets = [[graph["seeds"][i] for i in s] for s in STMT_SEEDS]
    truth = _solo_truth(rt, store, sets, filt)
    assert all(t[2]["device_dispatches"] == 1 for t in truth)
    _batching(8, 2_000_000)
    formed, runs = _counter("tpu_batches_formed"), _counter("tpu_kernel_runs")
    out, errs = _threads([_stmt(rt, store, s, filt) for s in sets])
    assert not errs, errs
    assert _counter("tpu_batches_formed") == formed + 1
    assert _counter("tpu_kernel_runs") == runs + 1
    for i in range(len(sets)):
        rows, st, wc = out[i]
        t_rows, t_st, t_wc = truth[i]
        _assert_rows_equal(rows, t_rows, f"{layout} statement {i}")
        assert st.hop_edges == t_st.hop_edges
        assert st.frontier_sizes == t_st.frontier_sizes
        assert st.result_edges == t_st.result_edges == len(rows)
        # the deterministic work counters: those of the solo run
        assert wc == t_wc


def test_batched_rows_match_the_reference_batched(graph, clean, company):
    """The reference TpuRuntime under its own batching (8 statements, one
    lanes launch) gives the port's batched rows."""
    ref_rt = TpuRuntime(make_mesh(1))
    ref_rt.init_eb = REF_EB
    ref_rt.pin_prebuilt(graph["ref_snap"])
    ref_store = ref_datagen.SnapshotStore(graph["ref_snap"])
    rt, store = graph["rts"]["unsplit"], graph["stores"]["unsplit"]
    sets = [[graph["seeds"][i] for i in s] for s in STMT_SEEDS]
    ref_get_config().set_dynamic_many({"batch_max_lanes": 8,
                                       "batch_wait_us": 5_000_000})
    from nebula_tpu.utils.stats import stats as ref_stats

    def ref_go(s):
        return lambda: ref_rt.traverse(ref_store, "snb", s, ["KNOWS"], "out",
                                       3, edge_filter=_where(RE),
                                       yields=_yields(RE))

    formed = ref_stats().snapshot().get("tpu_batches_formed", 0)
    ref_out, errs = _threads([ref_go(s) for s in sets], timeout=300)
    assert not errs, errs
    assert ref_stats().snapshot().get("tpu_batches_formed", 0) == formed + 1
    _batching(8, 2_000_000)
    out, errs = _threads([_stmt(rt, store, s, True) for s in sets])
    assert not errs, errs
    for i in range(len(sets)):
        rows, st, _ = out[i]
        ref_rows, ref_st = ref_out[i]
        _assert_rows_equal(rows, ref_rows, f"statement {i}")
        assert st.hop_edges == ref_st.hop_edges
        assert st.frontier_sizes == ref_st.frontier_sizes


# ---------------------------------------------------------------------------
# the former's contract, at the runtime level
# ---------------------------------------------------------------------------


def test_lone_statement_skips_the_window(graph, clean):
    """No concurrent company: the statement runs solo at once, whatever
    the window."""
    rt, store = graph["rts"]["unsplit"], graph["stores"]["unsplit"]
    (t_rows, _, _), = _solo_truth(rt, store, [graph["seeds"][:2]], True)
    _batching(8, 30_000_000)
    formed = _counter("tpu_batches_formed")
    t0 = time.monotonic()
    rows, _, _ = _stmt(rt, store, graph["seeds"][:2], True)()
    assert time.monotonic() - t0 < 10.0
    assert _counter("tpu_batches_formed") == formed
    assert batch_former().forming() == {}
    _assert_rows_equal(rows, t_rows, "lone")


def test_concurrency_hint_reads_only_the_live_registry(clean):
    """Divergence from the reference (batch.py:170-181): the hint has no
    admission-controller half until the port has one."""
    reg = live_registry()
    base = len(reg)
    assert base <= 1
    assert BatchFormer._concurrency_hint() is False
    reg.register(qid=-201, session=0, user="t", stmt="x", kind="Go")
    reg.register(qid=-202, session=0, user="t", stmt="x", kind="Go")
    try:
        assert BatchFormer._concurrency_hint() is True
    finally:
        reg.deregister(-201)
        reg.deregister(-202)
    assert BatchFormer._concurrency_hint() is False


def test_batch_form_failpoint_runs_solo(graph, clean, company):
    rt, store = graph["rts"]["unsplit"], graph["stores"]["unsplit"]
    sets = [[graph["seeds"][i] for i in s] for s in STMT_SEEDS[:3]]
    truth = _solo_truth(rt, store, sets, False)
    _batching(8, 2_000_000)
    fail.arm("tpu:batch_form", "-1*raise(no batch)")
    formed, runs = _counter("tpu_batches_formed"), _counter("tpu_kernel_runs")
    out, errs = _threads([_stmt(rt, store, s, False) for s in sets])
    assert not errs, errs
    assert _counter("tpu_batches_formed") == formed
    assert _counter("tpu_kernel_runs") == runs + 3
    assert fail.hit_count("tpu:batch_form") == 3
    for i in range(3):
        _assert_rows_equal(out[i][0], truth[i][0], f"statement {i}")


@pytest.mark.parametrize("how", ["kill", "deadline"])
def test_cancel_mid_form_detaches_only_that_lane(graph, clean, company, how):
    rt, store = graph["rts"]["unsplit"], graph["stores"]["unsplit"]
    sets = [[graph["seeds"][i] for i in s] for s in STMT_SEEDS[:3]]
    truth = _solo_truth(rt, store, sets, True)
    # the window outlasts the cancel; the group never fills (8 lanes)
    _batching(8, 1_500_000)
    kill = threading.Event()
    ctx = (use_cancel(kill=kill) if how == "kill"
           else use_cancel(deadline=time.monotonic() + 0.4))

    def cancelled():
        with ctx:
            return _stmt(rt, store, sets[0], True)()

    formed = _counter("tpu_batches_formed")
    fns = [cancelled] + [_stmt(rt, store, s, True) for s in sets[1:]]
    if how == "kill":
        def killer():
            _wait_for(lambda: sum(batch_former().forming().values()) == 3,
                      msg="three enrolled")
            kill.set()
        fns.append(killer)
    out, errs = _threads(fns)
    want = QueryKilled if how == "kill" else DeadlineExceeded
    assert isinstance(errs.pop(0, None), want)
    assert not errs, errs
    # the other two shared one launch, with their own rows
    assert _counter("tpu_batches_formed") == formed + 1
    for i in (1, 2):
        _assert_rows_equal(out[i][0], truth[i][0], f"statement {i}")


def test_one_lane_group_runs_solo(graph, clean, company):
    rt, store = graph["rts"]["unsplit"], graph["stores"]["unsplit"]
    (t_rows, t_st, t_wc), = _solo_truth(rt, store, [graph["seeds"][:2]], True)
    _batching(8, 100_000)
    formed, runs = _counter("tpu_batches_formed"), _counter("tpu_kernel_runs")
    rows, st, wc = _stmt(rt, store, graph["seeds"][:2], True)()
    assert _counter("tpu_batches_formed") == formed
    assert _counter("tpu_kernel_runs") == runs + 1
    _assert_rows_equal(rows, t_rows, "one lane")
    assert st.hop_edges == t_st.hop_edges and wc == t_wc


@pytest.mark.parametrize("lanes", [0, 1])
def test_flag_off_never_consults_the_former(graph, clean, company,
                                            monkeypatch, lanes):
    rt, store = graph["rts"]["unsplit"], graph["stores"]["unsplit"]
    (t_rows, t_st, t_wc), = _solo_truth(rt, store, [graph["seeds"][:2]], True)

    def boom(*a, **k):
        raise AssertionError("the former was consulted")

    monkeypatch.setattr(BatchFormer, "submit", boom)
    _batching(lanes, 2_000_000)
    out, errs = _threads([_stmt(rt, store, graph["seeds"][:2], True)
                          for _ in range(3)])
    assert not errs, errs
    for rows, st, wc in out.values():
        _assert_rows_equal(rows, t_rows, f"flag {lanes}")
        assert st.hop_edges == t_st.hop_edges and wc == t_wc


def test_different_delta_views_never_share_a_launch(clean, company):
    """Two statements grabbed before a delta apply share one launch; one
    grabbed after it forms its own group and reads the write."""
    arrs = D.make_social_arrays(1500, 6, seed=5)
    snap = D.snapshot_from_arrays(arrs, parts=4, space="s")
    store = D.SnapshotStore(snap, arrs)
    store.delta_watch("s")
    rt = GpuRuntime(device="cpu", delta_max_edges=64)
    rt.pin_prebuilt(snap)
    seeds = np.unique(arrs["src"][:64])[:6].tolist()
    ys = [(PE.FunctionCall("dst", [PE.EdgeExpr()]), "d"),
          (PE.EdgeProp("KNOWS", "w"), "w")]

    def go(s):
        return lambda: rt.traverse(store, "s", s, ["KNOWS"], "out", 1,
                                   yields=ys)[0]

    before = [go(seeds[:2])(), go(seeds[2:4])()]
    _batching(8, 1_500_000)
    formed = _counter("tpu_batches_formed")
    results = {}

    def early(i, s):
        def run():
            results[i] = go(s)()
        return run

    ths = [threading.Thread(target=early(i, s), daemon=True)
           for i, s in enumerate([seeds[:2], seeds[2:4]])]
    for t in ths:
        t.start()
    _wait_for(lambda: sum(batch_former().forming().values()) == 2,
              msg="two enrolled")
    # a write from a seed, applied while the two wait in their group
    src = seeds[4]
    dst = next(d for d in range(1500)
               if d != src and not store.base_has(src, d))
    store.insert_edge(src, dst, {"w": 77, "f": 0.5, "city": "eve"})
    rt.pin(store, "s")
    late = go(seeds[4:6])()          # its own group, the write visible
    for t in ths:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in ths)
    assert len(results) == 2
    assert _counter("tpu_batches_formed") == formed + 1
    for i in range(2):
        _assert_rows_equal(results[i], before[i], f"early {i}")
    d = np.asarray(late.column_array("d"))
    assert dst in d.tolist()


def test_forming_window_rearms_while_a_write_holds_the_gate(graph, clean,
                                                            company):
    rt, store = graph["rts"]["unsplit"], graph["stores"]["unsplit"]
    sets = [[graph["seeds"][i] for i in s] for s in STMT_SEEDS[:2]]
    truth = _solo_truth(rt, store, sets, False)
    _batching(8, 50_000)
    formed = _counter("tpu_batches_formed")
    rearms = _counter("tpu_batch_gate_rearms")
    rt._gate.acquire_write()
    released = False
    try:
        res = {}

        def run(i):
            def f():
                res[i] = _stmt(rt, store, sets[i], False)()
            return f

        ths = [threading.Thread(target=run(i), daemon=True) for i in (0, 1)]
        for t in ths:
            t.start()
        _wait_for(lambda: _counter("tpu_batch_gate_rearms") >= rearms + 2,
                  msg="re-armed windows")
        # still forming, both enrolled: the hold did not launch the group
        assert sum(batch_former().forming().values()) == 2
        rt._gate.release_write()
        released = True
        for t in ths:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in ths)
    finally:
        if not released:
            rt._gate.release_write()
    assert _counter("tpu_batches_formed") == formed + 1
    for i in (0, 1):
        _assert_rows_equal(res[i][0], truth[i][0], f"statement {i}")


def test_delta_apply_in_pin_waits_for_an_inflight_read(clean, monkeypatch):
    arrs = D.make_social_arrays(1500, 6, seed=5)
    snap = D.snapshot_from_arrays(arrs, parts=4, space="s")
    store = D.SnapshotStore(snap, arrs)
    store.delta_watch("s")
    rt = GpuRuntime(device="cpu", delta_max_edges=64)
    rt.pin_prebuilt(snap)
    dev = rt.snapshots["s"]
    seeds = np.unique(arrs["src"][:64])[:4].tolist()
    ys = [(PE.FunctionCall("dst", [PE.EdgeExpr()]), "d")]
    want = rt.traverse(store, "s", seeds, ["KNOWS"], "out", 2, yields=ys)[0]
    inside, go_on = threading.Event(), threading.Event()
    real = GR.run_hops

    def held(*a, **k):
        inside.set()
        assert go_on.wait(JOIN_S)
        return real(*a, **k)

    monkeypatch.setattr(GR, "run_hops", held)
    res = {}

    def reader():
        res["rows"] = rt.traverse(store, "s", seeds, ["KNOWS"], "out", 2,
                                  yields=ys)[0]

    def writer():
        rt.pin(store, "s")
        res["applied"] = time.monotonic()

    r = threading.Thread(target=reader, daemon=True)
    r.start()
    assert inside.wait(JOIN_S)
    dst = next(d for d in range(1500) if d != seeds[0]
               and not store.base_has(seeds[0], d))
    store.insert_edge(seeds[0], dst, {"w": 1, "f": 0.0, "city": "eve"})
    epoch0 = dev.delta.applied_epoch
    w = threading.Thread(target=writer, daemon=True)
    w.start()
    time.sleep(0.3)
    # the apply waits on the gate's write side while the read is held
    assert w.is_alive() and "applied" not in res
    assert dev.delta.applied_epoch == epoch0 and rt._gate.write_held()
    t_release = time.monotonic()
    go_on.set()
    r.join(JOIN_S)
    w.join(JOIN_S)
    assert not r.is_alive() and not w.is_alive()
    assert res["applied"] >= t_release
    assert dev.delta.applied_epoch == store.space("s").epoch > epoch0
    _assert_rows_equal(res["rows"], want, "the read grabbed before")


def test_retired_snapshot_is_not_run(graph):
    """A snapshot a later pin replaced raises under the gate."""
    rt = GpuRuntime(device="cpu")
    dev = rt.pin_prebuilt(graph["carried"])
    rt.pin_prebuilt(graph["carried"])
    assert dev.retired and not rt.snapshots["snb"].retired
    for lanes in ([[0]], [[0], [1]]):         # solo, and a batch's run
        with pytest.raises(GpuUnavailable, match="retired"):
            rt._run(dev, [dev.blocks[("KNOWS", "out")]], lanes, 1, None,
                    True, (), None, [None], attribute=len(lanes) == 1)

