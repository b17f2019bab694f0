"""The port's query engine (`nebula_tpu_torch.exec` and `.query`: plan,
planner, optimizer, scheduler, executors, `QueryEngine`, the plan and
result caches) against the JAX package's, on the CPU.

Every test of tests/unit/test_engine.py, test_plan.py,
test_plan_cache.py and test_result_cache.py runs here once a package
with the same body: `load_twin` executes the unit test file's own
source a second time with `nebula_tpu` read as `nebula_tpu_torch`, and
`run_twin` gives each test its fixtures (the module's own, `tmp_path`
and `monkeypatch`).  Tolerance: exact, as the unit tests assert it.

Left out, each with the ROADMAP item that brings it:
- test_result_cache.py's `test_dedup_replayed_write_bumps_epoch_once`
  and `test_cached_hot_read_survives_storage_outage` drive a cluster
  (`cluster/`, A11); they are marked slow there as well.
"""
import contextlib
import inspect
import re
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def load_twin(relpath: str, pkg: str, replace=()):
    """The test module at `relpath` (from the repo root), executed as
    written (`pkg` "ref") or with every `nebula_tpu` import read as the
    port's (`pkg` "port"; `nebula_tpu.tpu` is the port's `gpu`).
    `replace` adds (old, new) text pairs applied to the copy first, one
    line for one line."""
    path = ROOT / relpath
    src = path.read_text()
    for old, new in replace:
        assert old in src, (relpath, old)
        src = src.replace(old, new)
    if pkg == "port":
        src = src.replace("nebula_tpu.tpu", "nebula_tpu_torch.gpu")
        src = re.sub(r"\bnebula_tpu\b(?!_torch)", "nebula_tpu_torch", src)
    name = f"twin_{pkg}_{path.stem}"
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def _marks(fn):
    return list(getattr(fn, "pytestmark", []))


def twin_cases(mod, leave_out=()):
    """(test name, parametrize kwargs, id) for every test function of
    `mod` but those in `leave_out` and those marked slow."""
    out = []
    for name, fn in vars(mod).items():
        if not name.startswith("test_") or not inspect.isfunction(fn) \
                or name in leave_out:
            continue
        marks = _marks(fn)
        if any(m.name == "slow" for m in marks):
            continue
        combos = [({}, name)]
        for m in marks:
            if m.name != "parametrize":
                continue
            argnames, values = m.args[0], m.args[1]
            argnames = [a.strip() for a in argnames.split(",")] \
                if isinstance(argnames, str) else list(argnames)
            nxt = []
            for kw, cid in combos:
                for i, v in enumerate(values):
                    vals = v if len(argnames) > 1 else (v,)
                    nxt.append((dict(kw, **dict(zip(argnames, vals))),
                                f"{cid}[{i}]"))
            combos = nxt
        out.extend((name, kw, cid) for kw, cid in combos)
    return out


def _fixture_function(obj):
    get = getattr(obj, "_get_wrapped_function", None)
    if get is not None:
        return get()
    if getattr(obj, "_pytestfixturefunction", None) is not None:
        return obj.__wrapped__
    return None


def run_twin(mod, name, kwargs, builtins):
    """Call `mod.<name>` with `kwargs` and its fixtures: the module's own
    (function scope, generators torn down in reverse order) and the
    pytest fixtures named in `builtins`."""
    fn = getattr(mod, name)
    cache = dict(builtins)
    with contextlib.ExitStack() as stack:
        def resolve(arg):
            if arg in cache:
                return cache[arg]
            f = _fixture_function(getattr(mod, arg))
            assert f is not None, f"{name}: no fixture {arg!r}"
            val = f(**{p: resolve(p)
                       for p in inspect.signature(f).parameters})
            if inspect.isgenerator(val):
                gen = val
                val = next(gen)
                stack.callback(next, gen, None)
            cache[arg] = val
            return val

        fn(**{p: kwargs[p] if p in kwargs else resolve(p)
              for p in inspect.signature(fn).parameters})


UNIT = ("tests/unit/test_engine.py", "tests/unit/test_plan.py",
        "tests/unit/test_plan_cache.py", "tests/unit/test_result_cache.py")
MODS = {(rel, pkg): load_twin(rel, pkg)
        for rel in UNIT for pkg in ("ref", "port")}
CASES = [(rel, pkg, name, kw, cid)
         for rel in UNIT for pkg in ("ref", "port")
         for name, kw, cid in twin_cases(MODS[rel, pkg])]


@pytest.mark.parametrize(
    "rel,pkg,name,kw", [c[:4] for c in CASES],
    ids=[f"{Path(c[0]).stem}::{c[4]}-{c[1]}" for c in CASES])
def test_unit_twin(rel, pkg, name, kw, tmp_path, monkeypatch):
    run_twin(MODS[rel, pkg], name, kw,
             {"tmp_path": tmp_path, "monkeypatch": monkeypatch})


def test_every_unit_test_has_a_twin():
    for rel in UNIT:
        ref = {c[0] for c in twin_cases(MODS[rel, "ref"])}
        port = {c[0] for c in twin_cases(MODS[rel, "port"])}
        assert ref == port and ref, rel


def flag_runtime(_mesh=None):
    """A CPU `GpuRuntime` configured from the port's flags, as the JAX
    package's `TpuRuntime` reads its own: `tpu_delta_max_edges` and
    `tpu_delta_compact_watermark` become the constructor's
    `delta_max_edges` and `delta_compact_watermark`.  The mesh argument
    of a `TpuRuntime(make_mesh(P))` call is dropped: the port's local
    runtime holds all P parts of the store on one device."""
    from nebula_tpu_torch.gpu import GpuRuntime
    from nebula_tpu_torch.utils.config import get_config
    cfg = get_config()
    return GpuRuntime(
        device="cpu",
        delta_max_edges=cfg.get("tpu_delta_max_edges"),
        delta_compact_watermark=cfg.get("tpu_delta_compact_watermark"))


def no_mesh(parts):
    return None


#: the port's CPU runtimes the device-branch twins run on: the three local
#: layouts and a mesh of shard slots (as many as the store's parts)
DEVICE_LAYOUTS = ("unsplit", "split", "plane", "mesh")


def layout_runtime(layout: str, parts: int = 8):
    """A CPU `GpuRuntime` of one layout: "unsplit"; "split", degree-split
    at 4; "plane", a delta plane of 64; "mesh", `parts` shard slots on
    the CPU."""
    import torch
    from nebula_tpu_torch.gpu import GpuRuntime, make_mesh
    if layout == "mesh":
        return GpuRuntime(mesh=make_mesh(
            parts, devices=[torch.device("cpu")] * parts))
    return GpuRuntime(device="cpu", **{
        "unsplit": {}, "split": {"degree_split_threshold": 4},
        "plane": {"delta_max_edges": 64}}[layout])


def mesh_parts(parts):
    """Stands for the reference's `make_mesh(parts)` beside
    `mesh_runtime`: the mesh is the part count."""
    return parts


def mesh_runtime(parts=None):
    """Stands for the reference's `TpuRuntime(make_mesh(parts))`: a CPU
    mesh of `parts` shard slots, or one local CPU device for one part."""
    return layout_runtime("unsplit") if not parts or parts == 1 \
        else layout_runtime("mesh", parts)
