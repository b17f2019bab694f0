"""One workload of the port's device plane on a 4-part mesh, run the same
way by each rank of a process group (tests/test_torch_mesh2.py spawns
them) and by the in-process mesh it is held against.  It imports torch
and the port only, so a rank starts without JAX.

`run(mesh_fn)` builds every runtime on `mesh_fn()` and returns plain
results (numpy arrays, lists, wire bytes):

  go     GO 3 STEPS WHERE KNOWS.w > 50 on the degree-split social
         snapshot: its columns and its stats' facts;
  hops   MATCH's every-hop expansion (traverse_hops) of the same seeds
         under the same WHERE: each frame's arrays and the facts;
  bfs    the BFS from the first seed, 5 levels: dist and the facts;
  batch  around a GO asked with batching on and company registered:
         the batch former's enrolments and the batched-GO counters;
  ic     LDBC IC5 and IC9 through a device QueryEngine on
         make_snb_interactive(IC_PERSONS, parts=4) with a delta plane,
         before and after chip_smoke's `ic_writes` (folded through the
         plane): each statement's rows as wire bytes and its runner's
         (hop_edges, frontier_sizes), and the pin counters.
"""
import numpy as np

PERSONS, DEGREE, THRESHOLD, STEPS = 600, 6, 24, 3
IC_PERSONS, IC_SEED, IC_DELTA_CAP = 300, 15, 4096
FRAME_KEYS = ("src", "dst", "rank", "key_et", "key_s", "key_d")


def facts(st):
    """The facts of a TraverseStats that every rank must agree on."""
    return {"hop_edges": list(st.hop_edges),
            "frontier_sizes": list(st.frontier_sizes),
            "e_cap": [int(x) for x in st.e_cap], "shards": st.shards,
            "exchange_bytes": st.exchange_bytes}


def social():
    """The social arrays, their 4-part snapshot and the seeds (two hubs
    of the split layout among them), as tests/test_torch_sharded.py's
    graphs fixture picks them."""
    from nebula_tpu_torch.bench import datagen as D
    from nebula_tpu_torch.graphstore.csr import degree_split
    arrs = D.make_social_arrays(PERSONS, DEGREE)
    snap = D.snapshot_from_arrays(arrs, parts=4)
    hubs = degree_split(snap, THRESHOLD).hub_dense
    seeds = sorted(set(np.unique(arrs["src"][:64])[:16].tolist())
                   | {int(hubs[0]), int(hubs[-1])})
    return arrs, snap, seeds


def where(M):
    return M.Binary(">", M.EdgeProp("KNOWS", "w"), M.Literal(50))


def yields(M):
    return [(M.FunctionCall("dst", [M.EdgeExpr()]), "d"),
            (M.FunctionCall("src", [M.EdgeExpr()]), "s"),
            (M.FunctionCall("rank", [M.EdgeExpr()]), "r"),
            (M.EdgeProp("KNOWS", "w"), "w"),
            (M.EdgeProp("KNOWS", "f"), "f")]


def cols(rows):
    return {n: np.asarray(rows.column_array(n)) for n in rows.column_names}


def frames(fr):
    return [{k: np.asarray(getattr(f, k), np.int64) for k in FRAME_KEYS}
            | {"edges": [repr(e) for e in f.edges]} for f in fr]


def run(mesh_fn):
    import chip_smoke as C
    from nebula_tpu_torch.bench import datagen as D
    from nebula_tpu_torch.core import expr as E
    from nebula_tpu_torch.core import wire
    from nebula_tpu_torch.exec.engine import QueryEngine
    from nebula_tpu_torch.gpu import GpuRuntime
    from nebula_tpu_torch.gpu.batch import batch_former
    from nebula_tpu_torch.utils.config import get_config
    from nebula_tpu_torch.utils.stats import stats
    from nebula_tpu_torch.utils.workload import live_registry

    out = {}
    _, snap, seeds = social()
    store = D.SnapshotStore(snap)
    rt = GpuRuntime(mesh=mesh_fn(), degree_split_threshold=THRESHOLD)
    rt.pin_prebuilt(snap)
    rows, st = rt.traverse(store, "snb", seeds, ["KNOWS"], "out", STEPS,
                           edge_filter=where(E), yields=yields(E))
    out["go"] = (cols(rows), facts(st))
    fr, st = rt.traverse_hops(store, "snb", seeds, ["KNOWS"], "out", STEPS,
                              edge_filter=where(E))
    out["hops"] = (frames(fr), facts(st))
    dist, st = rt.bfs(store, "snb", seeds[:1], ["KNOWS"], "out", 5)
    out["bfs"] = (np.asarray(dist), facts(st))

    # batching on, with company: a process group's runtime runs solo
    cfg = get_config()
    for qid in (-401, -402):
        live_registry().register(qid=qid, session=0, user="t",
                                 stmt="dummy", kind="Go")
    cfg.set_dynamic_many({"batch_max_lanes": 4, "batch_wait_us": 50_000})
    former = batch_former()
    submits = []
    submit = former.submit
    former.submit = lambda *a, **k: submits.append(1) or submit(*a, **k)
    s0 = stats().snapshot()
    try:
        rows, st = rt.traverse(store, "snb", seeds, ["KNOWS"], "out",
                               STEPS, edge_filter=where(E),
                               yields=yields(E))
    finally:
        del former.submit
        with cfg.lock:
            for k in ("batch_max_lanes", "batch_wait_us"):
                cfg.dynamic_layer.pop(k, None)
        for qid in (-401, -402):
            live_registry().deregister(qid)
    s1 = stats().snapshot()
    out["batch"] = {k: s1.get(k, 0) - s0.get(k, 0)
                    for k in ("tpu_batches_formed", "tpu_kernel_runs")}
    out["batch"]["submits"] = len(submits)
    out["batch_go"] = (cols(rows), facts(st))

    # IC5 and IC9 through the engine, before and after folded writes
    ic_store, arrs = D.make_snb_interactive(IC_PERSONS, parts=4)
    rt_ic = GpuRuntime(mesh=mesh_fn(), delta_max_edges=IC_DELTA_CAP)
    eng = QueryEngine(ic_store, tpu_runtime=rt_ic)
    sess = eng.new_session()
    assert eng.execute(sess, "USE ic").error is None
    qs = C.ic_statements()
    top = [arrs["f0"] + int(t[0][len("forum"):])
           for t in D.ic5_numpy(arrs, C.IC_ROOT, C.IC_MIN_DATE)]
    writes = C.ic_writes(arrs, top, IC_SEED)[0]
    out["ic"] = {}
    for when in ("before", "after"):
        if when == "after":
            p0 = stats().snapshot()
            for q in writes:
                rs = eng.execute(sess, q)
                assert rs.error is None, (q, rs.error)
        for name in ("IC5", "IC9"):
            eng.qctx.last_tpu_stats = eng.qctx.last_tpu_fallback = None
            rs = eng.execute(sess, qs[name])
            assert rs.error is None, (name, rs.error)
            ts = eng.qctx.last_tpu_stats
            assert ts is not None and eng.qctx.last_tpu_fallback is None
            out["ic"][f"{name} {when}"] = (
                [wire.dumps(list(r)) for r in rs.data.rows],
                (list(ts.hop_edges), list(ts.frontier_sizes)))
    p1 = stats().snapshot()
    out["ic_pins"] = {k: p1.get(k, 0) - p0.get(k, 0)
                      for k in ("tpu_pins", "tpu_repin_avoided")}
    out["ic_writes"] = writes
    return out
