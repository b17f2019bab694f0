"""Batched GO statements through the port's engine, and
`GpuRuntime.set_mesh`, against the JAX package's unit tests, on the CPU.

Every test of tests/unit/test_batch.py runs on the port with the same
body (`test_torch_engine.load_twin`): forming and per-lane de-mux, the
solo path, the `tpu:batch_form` failpoint, one dispatch slot a batch,
KILL and deadline mid-form and mid-flight, the SHOW QUERIES Batch
column, the flags, the forming window behind a held write gate, and a
re-shard mid-form.  `TpuRuntime(make_mesh(n))` is read as a port runtime
on the CPU (`test_torch_engine.mesh_runtime`), and `set_mesh(make_mesh(4))`
as `set_mesh` onto four CPU shard slots.  Two lines of the unit file are
replaced (see `REPLACE`): its unused import of the two-axis `make_mesh2`
(ROADMAP A10b) is dropped, and the re-shard's mesh is laid on the CPU.
In the re-shard test the group the re-pin retired gets its rows from a
run on the new pin (`SnapshotRetired` runs the statement again, the
port's divergence 12), where the reference answers from the host.
Tolerance: exact.
"""
import pytest
import torch

from nebula_tpu_torch.gpu import make_mesh

from test_torch_engine import load_twin, run_twin, twin_cases

REPLACE = (
    ("from nebula_tpu.tpu import TpuRuntime, make_mesh          # noqa: E402",
     "from test_torch_engine import mesh_runtime as TpuRuntime, "
     "mesh_parts as make_mesh  # noqa: E402"),
    ("    from nebula_tpu.tpu import make_mesh2\n\n", ""),
    ("rt.set_mesh(make_mesh(4))", "rt.set_mesh(cpu_mesh(4))"),
)
TWIN = load_twin("tests/unit/test_batch.py", "port", replace=REPLACE)
TWIN.cpu_mesh = lambda n: make_mesh(n, devices=[torch.device("cpu")] * n)
REF_TWIN = load_twin("tests/unit/test_batch.py", "ref")
CASES = twin_cases(TWIN)


@pytest.mark.parametrize("name,kw", [c[:2] for c in CASES],
                         ids=[c[2] for c in CASES])
def test_unit_twin(name, kw, monkeypatch):
    run_twin(TWIN, name, kw, {"monkeypatch": monkeypatch})


def test_every_unit_test_has_a_twin():
    names = {c[0] for c in CASES}
    assert names == {c[0] for c in twin_cases(REF_TWIN)} and len(names) == 11


def test_set_mesh_retires_every_pin_and_bumps_the_epoch():
    rt = TWIN.TpuRuntime(1)
    eng = TWIN.device_engine(rt)
    s = eng.new_session()
    eng.execute(s, "USE bt")
    want = sorted(map(repr, eng.execute(
        s, TWIN.GO_TMPL.format(seed=1)).data.rows))
    old = rt.snapshots["bt"]
    key0 = rt._mesh_key()
    rt.set_mesh(TWIN.cpu_mesh(4))
    assert old.retired and not rt.snapshots
    assert rt._mesh_key() == (1, 4, key0[2] + 1) and not rt.local_mode
    rs = eng.execute(s, TWIN.GO_TMPL.format(seed=1))
    assert rs.error is None, rs.error
    assert sorted(map(repr, rs.data.rows)) == want
    assert len(rt.snapshots["bt"].shards) == 4
    assert eng.qctx.last_tpu_stats.shards == 4
