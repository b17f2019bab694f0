"""The port's per-dispatch accounting against the JAX package's, and the
twins of the observability unit tests, on the CPU.

Each device dispatch of `GpuRuntime` (a GO, MATCH's every-hop run, a
batched pair, a BFS) leaves what the reference's `_escalate_locked` and
`_escalate_lanes` leave (nebula_tpu/tpu/runtime.py:1674-1748,
:1312-1358): one kernel-ledger record with the same kernel name, steps
and, for a batched run, lane count (the first entry of `shape`), the
same rise of `tpu_edges_traversed`, and the `tpu_dispatch_us{kernel}`
histogram and `tpu_hbm_high_water_bytes` gauge.  The rest of `shape` is
the port's own slot widths (there is no bucket ladder: a result-neutral
difference), `compiled` is false and `retries` 0.  The stores are twins
built by one script in each package (`test_torch_pin_store.twins`).

Then every test of tests/unit/test_durability.py, test_memtracker.py,
test_flight.py and test_insights.py runs on the port with the same body
(`test_torch_engine.TwinFiles`).  Replaced in test_flight.py's
`test_device_dispatch_feeds_ledger_and_profile`: its runtime,
`TpuRuntime(make_mesh())`, read as `GpuRuntime(device="cpu")`, and its
assert that PROFILE's text holds `'compiles':` — the port compiles
nothing, and `TraverseStats` has no `compiles` slot — which keeps its
`'hbm_bytes':` half.  Nothing is left out.  Tolerance: exact.
"""
import pytest

from nebula_tpu.utils.flight import kernel_ledger as ref_kernel_ledger
from nebula_tpu.utils.stats import stats as ref_stats

from nebula_tpu_torch.gpu import GpuRuntime
from nebula_tpu_torch.utils.flight import kernel_ledger
from nebula_tpu_torch.utils.stats import stats

from test_torch_batch import _threads, clean, company  # noqa: F401
from test_torch_engine import TwinFiles
from test_torch_pin_store import ref_runtime, twins

SEEDS = [1, 2, 3, 5, 8]

#: one dispatch each, run the same way on either runtime
DISPATCHES = {
    "go": lambda rt, st: rt.traverse(st, "g", SEEDS, ["knows"], "out", 3),
    "match": lambda rt, st: rt.traverse_hops(st, "g", SEEDS, ["knows"],
                                             "out", 2),
    "bfs": lambda rt, st: rt.bfs(st, "g", [1], ["knows"], "both", 5),
}


@pytest.fixture(scope="module")
def pair():
    ref_st, st = twins(seed=4)
    ref_rt, rt = ref_runtime(), GpuRuntime(device="cpu")
    ref_rt.pin(ref_st, "g")
    rt.pin(st, "g")
    return ref_rt, ref_st, rt, st


def _measure(ledger, metrics, fn):
    """(the ledger's records, the rise of tpu_edges_traversed) of fn()."""
    ledger().clear()
    e0 = metrics().snapshot().get("tpu_edges_traversed", 0)
    fn()
    return ledger().list(), \
        metrics().snapshot().get("tpu_edges_traversed", 0) - e0


def _check_port_record(rec, kernel):
    assert rec["compiled"] is False and rec["retries"] == 0
    assert rec["shape"] and rec["hbm_bytes"] > 0 and rec["shards"] == 1
    snap = stats().snapshot()
    assert snap.get(f"tpu_dispatch_us{{kernel={kernel}}}.count", 0) > 0
    assert snap.get("tpu_hbm_high_water_bytes", 0) >= rec["hbm_bytes"]


@pytest.mark.parametrize("what", sorted(DISPATCHES))
def test_a_solo_dispatch_leaves_the_references_record(pair, what):
    ref_rt, ref_st, rt, st = pair
    fn = DISPATCHES[what]
    want, want_edges = _measure(ref_kernel_ledger, ref_stats,
                                lambda: fn(ref_rt, ref_st))
    got, got_edges = _measure(kernel_ledger, stats, lambda: fn(rt, st))
    assert len(want) == len(got) == 1, (want, got)
    for k in ("kernel", "steps", "shards", "exchange_bytes"):
        assert got[0][k] == want[0][k], (k, got[0], want[0])
    assert got_edges == want_edges > 0
    _check_port_record(got[0], want[0]["kernel"])


def test_a_batched_pair_leaves_one_record_with_its_lane_count(
        pair, clean, company):  # noqa: F811
    from nebula_tpu.utils.config import get_config as ref_get_config
    from nebula_tpu_torch.utils.config import get_config
    ref_rt, ref_st, rt, st = pair
    sets = [[1, 2], [3, 5, 8]]
    out = {}
    for pkg, cfg, ledger, metrics, r, s in (
            ("ref", ref_get_config(), ref_kernel_ledger, ref_stats,
             ref_rt, ref_st),
            ("port", get_config(), kernel_ledger, stats, rt, st)):
        cfg.set_dynamic_many({"batch_max_lanes": 2,
                              "batch_wait_us": 5_000_000})
        formed = metrics().snapshot().get("tpu_batches_formed", 0)

        def both(r=r, s=s):
            res, errs = _threads([
                lambda seeds=seeds: r.traverse(s, "g", seeds, ["knows"],
                                               "out", 2)
                for seeds in sets], timeout=300)
            assert not errs, errs
            return res

        out[pkg] = _measure(ledger, metrics, both)
        assert metrics().snapshot().get("tpu_batches_formed", 0) == \
            formed + 1, pkg
    (want, want_edges), (got, got_edges) = out["ref"], out["port"]
    assert len(want) == len(got) == 1, (want, got)
    assert got[0]["kernel"] == want[0]["kernel"] == "traverse"
    assert got[0]["steps"] == want[0]["steps"] == 2
    assert got[0]["shape"][0] == want[0]["shape"][0] == 2
    assert got_edges == want_edges > 0
    _check_port_record(got[0], "traverse")


# -- the twins of the observability unit tests --------------------------------

FLIGHT_REPLACE = (
    ("    from nebula_tpu.tpu.device import make_mesh\n"
     "    from nebula_tpu.tpu.runtime import TpuRuntime\n",
     "    from nebula_tpu.tpu import GpuRuntime\n"),
    ("QueryEngine(tpu_runtime=TpuRuntime(make_mesh()))",
     'QueryEngine(tpu_runtime=GpuRuntime(device="cpu"))'),
    ("    assert \"'compiles':\" in r.plan_desc \\\n"
     "        and \"'hbm_bytes':\" in r.plan_desc, r.plan_desc",
     "    assert \"'hbm_bytes':\" in r.plan_desc, r.plan_desc"),
)
SUITE = TwinFiles({
    "tests/unit/test_durability.py": ((), ()),
    "tests/unit/test_memtracker.py": ((), ()),
    "tests/unit/test_flight.py": (FLIGHT_REPLACE, ()),
    "tests/unit/test_insights.py": ((), ()),
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
    assert len({c[:2] for c in SUITE.cases}) == 10 + 3 + 12 + 15
