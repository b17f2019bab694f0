"""The port's cluster plane (`nebula_tpu_torch.cluster`: metad, storaged
and graphd over the RPC and Raft) against the JAX package's unit tests,
on the CPU, and the graphd's device plane over it.

Every test of tests/unit/test_cluster.py, test_meta_client.py and
test_raft.py runs on the port with the same body
(`test_torch_engine.TwinFiles`: the unit file's own source with
`nebula_tpu` read as `nebula_tpu_torch`; module-scoped fixtures shared
between a file's tests, as pytest shares them).  One text is replaced:
test_cluster.py's device tests build `TpuRuntime(make_mesh())`, read as
`GpuRuntime(device="cpu")`, the port's graphd runtime on the CPU.  The
reference's own run of each file is the file itself.

Then the port's own cases: the reference's slow-marked
`test_cluster_delta_fast_path` (tests/unit/test_delta.py) and
test_result_cache.py's two cluster cases on the port's cluster; `test_cluster_device_plane`'s five statements and a FIND
SHORTEST PATH on a device graphd against a host graphd, with the pin
taken from `build_csr_snapshot` and a write folded without a re-export;
a failed export answered from the host; and the export's vmax slack
following the runtime's `delta_max_edges` with the flag at 0; and a
space dropped and created again under its name, pinned again.
Tolerance: exact (rows as multisets, as the unit tests compare them).
"""
import pytest

from test_torch_engine import TwinFiles, run_twin
import test_torch_engine_delta

DEVICE_RT = (
    "    from nebula_tpu.tpu.device import make_mesh\n"
    "    from nebula_tpu.tpu.runtime import TpuRuntime\n\n"
    "    rt = TpuRuntime(make_mesh())",
    "    from nebula_tpu.tpu import GpuRuntime\n\n"
    "    rt = GpuRuntime(device=\"cpu\")")

SUITE = TwinFiles({
    "tests/unit/test_cluster.py": ((DEVICE_RT,), ()),
    "tests/unit/test_meta_client.py": ((), ()),
    "tests/unit/test_raft.py": ((), ()),
})


@pytest.fixture(scope="module", autouse=True)
def _close_suite():
    yield
    SUITE.close()


@pytest.mark.parametrize(**SUITE.params())
def test_unit_twin(rel, name, kw, tmp_path, tmp_path_factory, monkeypatch):
    SUITE.run(rel, name, kw, {"tmp_path": tmp_path, "monkeypatch": monkeypatch,
                              "tmp_path_factory": tmp_path_factory})


def test_every_unit_test_has_a_twin():
    SUITE.check_lists()
    assert len({c[:2] for c in SUITE.cases}) == 20 + 6 + 12


def test_cluster_delta_fast_path_on_the_port(tmp_path, monkeypatch):
    """tests/unit/test_delta.py's slow-marked cluster case, unmarked here:
    writes through the graphd's store ride the dirty-key log into the
    pinned plane without a re-export."""
    run_twin(test_torch_engine_delta.MOD, "test_cluster_delta_fast_path",
             {}, {"tmp_path": tmp_path, "monkeypatch": monkeypatch})


# -- the graphd's device plane over the cluster ------------------------------

#: test_cluster_device_plane's five statements (tests/unit/test_cluster.py),
#: and one FIND SHORTEST PATH
DEVICE_QUERIES = [
    "GO 2 STEPS FROM 1 OVER KNOWS YIELD dst(edge) AS d, KNOWS.w AS w",
    "GO FROM 1, 4 OVER KNOWS WHERE KNOWS.w > 6 YIELD dst(edge) AS d",
    "MATCH (a:Person)-[e:KNOWS*1..2]->(b) WHERE id(a) == 1 "
    "RETURN id(b), size(e)",
    "GET SUBGRAPH 2 STEPS FROM 1 OUT KNOWS YIELD VERTICES AS v, "
    "EDGES AS e",
    "FIND ALL PATH FROM 1 TO 4 OVER KNOWS UPTO 3 STEPS YIELD path AS p",
    "FIND SHORTEST PATH FROM 1 TO 4 OVER KNOWS UPTO 4 STEPS "
    "YIELD path AS p",
]
SETUP = ["USE dv", "CREATE TAG Person(name string)",
         "CREATE EDGE KNOWS(w int)",
         'INSERT VERTEX Person(name) VALUES 1:("a"), 2:("b"), 3:("c"), '
         '4:("d"), 5:("e")',
         "INSERT EDGE KNOWS(w) VALUES 1->2:(5), 2->3:(50), 3->4:(9), "
         "1->3:(80), 4->1:(7), 2->5:(11)"]
WRITES = ["INSERT EDGE KNOWS(w) VALUES 5->4:(12), 1->5:(3)",
          "DELETE EDGE KNOWS 2->3@0",
          'INSERT VERTEX Person(name) VALUES 6:("f")',
          "INSERT EDGE KNOWS(w) VALUES 1->6:(21), 6->4:(8)"]


def _open(tmp_path, name, rt):
    from nebula_tpu_torch.cluster.launcher import LocalCluster
    c = LocalCluster(n_meta=1, n_storage=2, n_graph=1,
                     data_dir=str(tmp_path / name), tpu_runtime=rt)
    cl = c.client()
    r = cl.execute("CREATE SPACE dv(partition_num=8, replica_factor=1, "
                   "vid_type=INT64)")
    assert r.error is None, r.error
    c.reconcile_storage()
    for q in SETUP:
        r = cl.execute(q)
        assert r.error is None, f"{q} -> {r.error}"
    return c, cl


def _rows(cl, q, typed=False):
    """The rows a client decoded, as a sorted list of reprs; `typed` adds
    each value's type name, so that a device value that crossed the wire
    as another type than the host's value (a numpy scalar) differs."""
    r = cl.execute(q)
    assert r.error is None, f"{q} -> {r.error}"
    if typed:
        return sorted(repr([(type(v).__name__, v) for v in row])
                      for row in r.data.rows)
    return sorted(repr(x) for x in r.data.rows)


def _counting(obj, name):
    calls = []
    orig = getattr(obj, name)

    def wrapped(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)
    setattr(obj, name, wrapped)
    return calls


@pytest.fixture()
def host_and_device(tmp_path):
    from nebula_tpu_torch.gpu import GpuRuntime
    rt = GpuRuntime(device="cpu", delta_max_edges=64)
    host, hcl = _open(tmp_path, "host", None)
    dev, dcl = _open(tmp_path, "device", rt)
    try:
        yield rt, (host, hcl), (dev, dcl)
    finally:
        dev.stop()
        host.stop()


def test_device_graphd_serves_rows_equal_to_the_host_graphd(host_and_device):
    """Each statement's rows on a device graphd equal a host graphd's; the
    space was pinned from the storageds' export (`build_csr_snapshot`),
    GO plans `TpuTraverse`, and the writes fold into the plane: the
    snapshot object stays, `tpu_repin_avoided` rises, the rows equal the
    host's after the same writes, and a forced re-export gives them
    too."""
    from nebula_tpu_torch.utils.stats import stats
    rt, (_h, hcl), (dev, dcl) = host_and_device
    store = dev.graphds[0].store
    exports = _counting(store, "build_csr_snapshot")
    for q in DEVICE_QUERIES:
        assert _rows(dcl, q, True) == _rows(hcl, q, True), q
    assert len(exports) == 1 and exports[0][0] == ("dv",)
    assert exports[0][1] == {"vmax_extra": 64}
    assert "dv" in rt.snapshots and rt.snapshots["dv"].delta is not None
    prof = dcl.execute("PROFILE " + DEVICE_QUERIES[0])
    assert prof.error is None and "TpuTraverse" in prof.plan_desc
    snap = rt.snapshots["dv"]
    avoided = stats().snapshot().get("tpu_repin_avoided", 0)
    for q in WRITES:
        assert dcl.execute(q).error is None, q
        assert hcl.execute(q).error is None, q
    for q in DEVICE_QUERIES:
        assert _rows(dcl, q, True) == _rows(hcl, q, True), q
    assert rt.snapshots["dv"] is snap and len(exports) == 1
    assert stats().snapshot().get("tpu_repin_avoided", 0) > avoided
    rt.pin(store, "dv", force=True)
    assert rt.snapshots["dv"] is not snap and len(exports) == 2
    for q in DEVICE_QUERIES:
        assert _rows(dcl, q) == _rows(hcl, q), q


def test_a_failed_export_is_answered_from_the_host(host_and_device):
    """An export that fails over RPC (here every `storage.export_part`
    dispatch raises) is no device fault: the fused GO is answered from
    the host path with the host graphd's rows, and the cause is in
    `last_tpu_fallback`."""
    from nebula_tpu_torch.utils.failpoints import fail
    rt, (_h, hcl), (dev, _dcl) = host_and_device
    eng = dev.graphds[0].engine
    s = eng.new_session()
    assert eng.execute(s, "USE dv").error is None
    q = DEVICE_QUERIES[0]
    fail.arm_callable("rpc:server_dispatch", lambda _i, key: (
        ("raise", "export down") if key == "storage.export_part" else None))
    try:
        r = eng.execute(s, q)
    finally:
        fail.reset()
    assert r.error is None, r.error
    assert sorted(repr(x) for x in r.data.rows) == _rows(hcl, q)
    assert "ExportFailed" in (eng.qctx.last_tpu_fallback or "")
    assert "dv" not in rt.snapshots
    eng.qctx.last_tpu_fallback = None
    r = eng.execute(s, q)                 # the export back: the device
    assert r.error is None and eng.qctx.last_tpu_fallback is None
    assert "dv" in rt.snapshots


def test_export_slack_follows_the_runtime_with_the_flag_off(tmp_path):
    """With `tpu_delta_max_edges` at 0, a runtime with its own plane still
    pins the export with the vmax slack (the reference's rule reads only
    the flag), so a vertex inserted after the pin gets a row and rides
    the plane."""
    from nebula_tpu_torch.gpu import GpuRuntime
    from nebula_tpu_torch.gpu.runtime import DELTA_VMAX_SLACK
    from nebula_tpu_torch.utils.config import get_config
    from nebula_tpu_torch.utils.stats import stats
    assert int(get_config().get("tpu_delta_max_edges")) == 0
    rt = GpuRuntime(device="cpu", delta_max_edges=32)
    c, cl = _open(tmp_path, "slack", rt)
    try:
        assert _rows(cl, "GO FROM 1 OVER KNOWS YIELD dst(edge) AS d") == \
            ["[2]", "[3]"]
        store = c.graphds[0].store
        bare = store.build_csr_snapshot("dv")
        assert rt.snapshots["dv"].vmax == bare.vmax + DELTA_VMAX_SLACK
        snap = rt.snapshots["dv"]
        avoided = stats().snapshot().get("tpu_repin_avoided", 0)
        for q in ['INSERT VERTEX Person(name) VALUES 7:("g")',
                  "INSERT EDGE KNOWS(w) VALUES 1->7:(4)"]:
            assert cl.execute(q).error is None, q
        assert _rows(cl, "GO FROM 1 OVER KNOWS YIELD dst(edge) AS d") == \
            ["[2]", "[3]", "[7]"]
        assert rt.snapshots["dv"] is snap
        assert stats().snapshot().get("tpu_repin_avoided", 0) > avoided
    finally:
        c.stop()


def test_a_space_created_again_under_its_name_is_pinned_again(tmp_path):
    """A space dropped and created again under the same name reaches the
    same epoch after the same writes; the pin cache keys on the metad's
    space id (`_SpaceView.uid`), so the device graphd exports the new
    space instead of serving the old one's pin."""
    from nebula_tpu_torch.gpu import GpuRuntime
    rt = GpuRuntime(device="cpu")
    c, cl = _open(tmp_path, "again", rt)
    try:
        q = "GO FROM 1 OVER KNOWS YIELD dst(edge) AS d, KNOWS.w AS w"
        assert _rows(cl, q) == ["[2, 5]", "[3, 80]"]
        old = rt.snapshots["dv"]
        assert cl.execute("DROP SPACE dv").error is None
        r = cl.execute("CREATE SPACE dv(partition_num=8, replica_factor=1, "
                       "vid_type=INT64)")
        assert r.error is None, r.error
        c.reconcile_storage()
        for stmt in SETUP[:-1] + [SETUP[-1].replace("1->2:(5)", "1->2:(6)")]:
            assert cl.execute(stmt).error is None, stmt
        assert _rows(cl, q) == ["[2, 6]", "[3, 80]"]
        assert rt.snapshots["dv"] is not old
    finally:
        c.stop()


@pytest.mark.parametrize("name", [
    "test_dedup_replayed_write_bumps_epoch_once",
    "test_cached_hot_read_survives_storage_outage"])
def test_result_cache_cluster_cases_on_the_port(name, tmp_path, monkeypatch):
    """tests/unit/test_result_cache.py's two slow-marked cluster cases,
    unmarked here, on the port's cluster."""
    import test_torch_engine as TE
    run_twin(TE.MODS["tests/unit/test_result_cache.py", "port"], name, {},
             {"tmp_path": tmp_path, "monkeypatch": monkeypatch})


def test_raft_timing_flags(tmp_path):
    """A Raft member built without timings takes them from
    `raft_election_timeout_ms` (the lower end; the upper is twice it)
    and `raft_heartbeat_interval_ms`.  Unset, they are the reference's
    constructor defaults; set, every group built after follows them and
    its lease window with them; timings named in the call win."""
    from nebula_tpu.cluster.raft import LoopbackTransport as RefTransport
    from nebula_tpu.cluster.raft import RaftPart as RefPart
    from nebula_tpu_torch.cluster.raft import LoopbackTransport, RaftPart
    from nebula_tpu_torch.utils.config import get_config

    def member(cls, tr, sub, **kw):
        return cls("g", "a", ["a"], tr(), str(tmp_path / sub),
                   apply_cb=lambda i, d: None, **kw)

    ref = member(RefPart, RefTransport, "ref")
    port = member(RaftPart, LoopbackTransport, "port")
    assert (port.eto, port.hb) == (ref.eto, ref.hb) == ((0.15, 0.30), 0.05)
    cfg = get_config()
    try:
        cfg.set_dynamic("raft_election_timeout_ms", 2000.0)
        cfg.set_dynamic("raft_heartbeat_interval_ms", 200.0)
        slow = member(RaftPart, LoopbackTransport, "slow")
        assert (slow.eto, slow.hb) == ((2.0, 4.0), 0.2)
        named = member(RaftPart, LoopbackTransport, "named",
                       election_timeout=(0.15, 0.30), heartbeat_interval=0.05)
        assert (named.eto, named.hb) == ((0.15, 0.30), 0.05)
    finally:
        with cfg.lock:
            cfg.dynamic_layer.pop("raft_election_timeout_ms", None)
            cfg.dynamic_layer.pop("raft_heartbeat_interval_ms", None)
    for m in (ref, port, slow, named):
        m.wal.close()
