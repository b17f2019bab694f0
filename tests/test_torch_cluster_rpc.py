"""The port's cluster plane against the JAX package's unit tests of the
RPC (frames, pipelining, breakers, failpoints), the read path (leases,
follower and bounded-stale reads) and Raft group commit, on the CPU.

Every test of tests/unit/test_rpc_pipeline.py, test_failpoints.py,
test_read_path.py and test_group_commit.py runs on the port with the
same body (`test_torch_engine.TwinFiles`: the unit file's own source
with `nebula_tpu` read as `nebula_tpu_torch`; module-scoped and autouse
fixtures as pytest runs them).  No text is replaced.  Left out on both
sides, as tier-1 leaves it out: test_read_path.py's
`test_leader_hint_write_back_one_walk_per_failover`, marked slow there.
The reference's own run of each file is the file itself.  Tolerance:
exact, as the unit tests assert it.
"""
import pytest

from test_torch_engine import TwinFiles

SUITE = TwinFiles({
    "tests/unit/test_rpc_pipeline.py": ((), ()),
    "tests/unit/test_failpoints.py": ((), ()),
    "tests/unit/test_read_path.py": ((), ()),
    "tests/unit/test_group_commit.py": ((), ()),
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
    assert len({c[:2] for c in SUITE.cases}) == 12 + 22 + 13 + 12
