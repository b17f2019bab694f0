"""`CALL algo.*` through the port's engine (`algo.engine.run_call_algo`,
`_host_snapshot`, `_iterate`'s per-iteration contract, and the CallAlgo
executor) against the JAX package's, on the CPU.

Every test of tests/unit/test_algo.py that goes through the engine runs
on the port with the same body (`test_torch_engine.load_twin`): the
statement surface (EXPLAIN, yields, validation errors), the device rows
against the numpy oracles (WCC and SSSP exact, PageRank within 1e-8),
kill and deadline between iterations, SHOW QUERIES progress, the
analytic admission class, flight capture, the `algo_*` metrics, and
`test_find_shortest_path_regression` (FIND SHORTEST PATH over the BFS
on a mesh of 4 slots and on one device).  Each runs on four CPU
runtimes: unsplit, degree-split at 4, a delta plane of 64 and a mesh of
4 shard slots (the store's part count; the algorithm runs on the first
slot's device).

Left out: `test_algo_bench_suite_small` drives the bench tool, whose
port tests/test_torch_algo.py holds.  Marked slow there:
`test_oracle_parity_larger_sweep`.

With pending writes on the plane, `_host_snapshot` re-pins before it
hands the adjacency out: the rows equal a host engine's on the written
store, and `tpu_pins` rises by one.
"""
import pytest

from nebula_tpu_torch.exec.engine import QueryEngine
from nebula_tpu_torch.utils.stats import stats

from test_torch_engine import (DEVICE_LAYOUTS, layout_runtime, load_twin,
                               run_twin, twin_cases)

TWIN = load_twin("tests/unit/test_algo.py", "port", replace=((
    "from nebula_tpu.tpu import TpuRuntime, make_mesh",
    "from test_torch_engine import mesh_runtime as TpuRuntime, "
    "mesh_parts as make_mesh"),))
REF_TWIN = load_twin("tests/unit/test_algo.py", "ref")
LEAVE_OUT = {"test_algo_bench_suite_small"}
CASES = twin_cases(TWIN, leave_out=LEAVE_OUT)


@pytest.mark.parametrize("layout", DEVICE_LAYOUTS)
@pytest.mark.parametrize("name,kw", [c[:2] for c in CASES],
                         ids=[c[2] for c in CASES])
def test_unit_twin(name, kw, layout, tmp_path, monkeypatch):
    run_twin(TWIN, name, kw, {"rt": layout_runtime(layout, TWIN.P),
                              "tmp_path": tmp_path,
                              "monkeypatch": monkeypatch})


def test_every_engine_test_has_a_twin():
    names = {c[0] for c in CASES}
    assert names == {c[0] for c in twin_cases(REF_TWIN)} - LEAVE_OUT
    assert len(names) == 26


def _rows(eng, sess, q):
    rs = eng.execute(sess, q)
    assert rs.error is None, (q, rs.error)
    return rs.data.rows


def test_pending_writes_repin_before_the_algorithm_reads():
    """A plane holding writes: the statement forces one re-pin, and its
    rows are a host engine's over the written store."""
    st = TWIN.algo_store(3)
    rt = layout_runtime("plane")
    dev = QueryEngine(st, tpu_runtime=rt)
    host = QueryEngine(st)
    ds, hs = dev.new_session(), host.new_session()
    for e, s in ((dev, ds), (host, hs)):
        assert e.execute(s, "USE ag").error is None
    q = 'CALL algo.sssp(src=0, weight="w")'
    assert _rows(dev, ds, q) == _rows(host, hs, q)
    assert dev.execute(ds, "INSERT EDGE knows(w) VALUES 0->79@0:(1), "
                       "79->3@0:(2)").error is None
    assert dev.execute(ds, "GO FROM 0 OVER knows YIELD dst(edge)"
                       ).error is None         # folds into the plane
    assert rt.snapshots["ag"].delta.host.total_edges() > 0
    pins = stats().snapshot().get("tpu_pins", 0)
    got = _rows(dev, ds, q)
    assert got == _rows(host, hs, q) and [79, 1.0] in got
    assert stats().snapshot().get("tpu_pins", 0) == pins + 1
    assert rt.snapshots["ag"].delta.host.total_edges() == 0
    for algo in ("wcc()", "pagerank(max_iter=20, tol=0.0)"):
        d, h = _rows(dev, ds, f"CALL algo.{algo}"), \
            _rows(host, hs, f"CALL algo.{algo}")
        assert [r[0] for r in d] == [r[0] for r in h]
        assert max(abs(a[1] - b[1]) for a, b in zip(d, h)) <= 1e-8 \
            if algo.startswith("pagerank") else d == h
    assert stats().snapshot().get("tpu_pins", 0) == pins + 1
