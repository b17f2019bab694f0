"""The port's cluster plane against the JAX package's unit tests of
exactly-once writes, the metad's repair supervisor, BALANCE,
authentication and persistence, on the CPU.

Every test of tests/unit/test_exactly_once.py, test_repair.py,
test_balance.py, test_auth.py and test_persistence.py runs on the port
with the same body (`test_torch_engine.TwinFiles`: the unit file's own
source with `nebula_tpu` read as `nebula_tpu_torch`; module-scoped and
autouse fixtures as pytest runs them).  No text is replaced and no test
is left out.  The reference's own run of each file is the file itself.
Tolerance: exact, as the unit tests assert it.
"""
import pytest

from test_torch_engine import TwinFiles

SUITE = TwinFiles({
    "tests/unit/test_exactly_once.py": ((), ()),
    "tests/unit/test_repair.py": ((), ()),
    "tests/unit/test_balance.py": ((), ()),
    "tests/unit/test_auth.py": ((), ()),
    "tests/unit/test_persistence.py": ((), ()),
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
    assert len({c[:2] for c in SUITE.cases}) == 9 + 8 + 4 + 16 + 9
