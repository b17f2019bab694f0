"""The engine-driven tests of tests/unit/test_delta.py on the port: the
delta plane under writes, rebuilds and compaction, with rows held to a
fresh rebuild and to the port's host engine, and an INSERT through
`QueryEngine(tpu_runtime=...)` read back by the next GO with no re-pin.

Each runs the unit test's own body (`test_torch_engine.load_twin`) with
`nebula_tpu` read as `nebula_tpu_torch` and the runtime built by
`test_torch_engine.flag_runtime`: a CPU `GpuRuntime` whose delta
capacity and watermark come from the same flags the reference's
`TpuRuntime` reads.  The reference's own run of these bodies is
tests/unit/test_delta.py.  Tolerance: exact.

Left out here: `test_cluster_delta_fast_path`, marked slow there; it
drives a cluster, and tests/test_torch_cluster.py runs it on the port's.
"""
import sys

import pytest

from test_torch_engine import ROOT, load_twin, run_twin, twin_cases

sys.path.insert(0, str(ROOT / "tests" / "unit"))   # test_tpu.norm_edge

MOD = load_twin("tests/unit/test_delta.py", "port", replace=(
    ("from nebula_tpu.tpu import TpuRuntime, make_mesh",
     "from test_torch_engine import flag_runtime as TpuRuntime, "
     "no_mesh as make_mesh"),
    ("from nebula_tpu.tpu.device import TpuUnavailable",
     "from nebula_tpu_torch.gpu.device import GpuUnavailable as "
     "TpuUnavailable"),
))
CASES = twin_cases(MOD)


@pytest.mark.parametrize("name,kw", [c[:2] for c in CASES],
                         ids=[c[2] for c in CASES])
def test_delta_twin(name, kw, tmp_path, monkeypatch):
    run_twin(MOD, name, kw,
             {"tmp_path": tmp_path, "monkeypatch": monkeypatch})


def test_the_six_engine_driven_tests_are_here():
    assert sorted({c[0] for c in CASES}) == sorted([
        "test_interleaved_writes_parity",
        "test_full_fill_and_overflow_fall_back",
        "test_off_switch_is_byte_identical",
        "test_compaction_swap_under_concurrent_traversal",
        "test_kill_during_compaction_aborts_cleanly",
        "test_read_your_writes_through_engine"])
