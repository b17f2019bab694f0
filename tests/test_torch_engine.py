"""The port's query engine (`nebula_tpu_torch.exec` and `.query`: plan,
planner, optimizer, scheduler, executors, `QueryEngine`, the plan and
result caches) against the JAX package's, on the CPU.

Every test of tests/unit/test_engine.py, test_plan.py,
test_plan_cache.py and test_result_cache.py runs here once a package
with the same body: `load_twin` executes the unit test file's own
source a second time with `nebula_tpu` read as `nebula_tpu_torch`, and
`run_twin` gives each test its fixtures (the module's own, `tmp_path`
and `monkeypatch`).  Tolerance: exact, as the unit tests assert it.

Left out here: test_result_cache.py's
`test_dedup_replayed_write_bumps_epoch_once` and
`test_cached_hot_read_survives_storage_outage`, marked slow there; they
drive a cluster, and tests/test_torch_cluster.py runs them on the port's.
`TwinFiles` and `run_twin(..., scope=)` serve the cluster twins
(tests/test_torch_cluster*.py), whose fixtures are module-scoped.
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


class TwinScope:
    """The module-scoped fixture values of one twin module, kept from one
    of its tests to the next as pytest keeps them, and torn down by
    `close()` in reverse order."""

    def __init__(self):
        self.values = {}
        self.stack = contextlib.ExitStack()

    def close(self):
        self.stack.close()
        self.values.clear()


def _fixture_scope(obj) -> str:
    marker = getattr(obj, "_fixture_function_marker", None) \
        or getattr(obj, "_pytestfixturefunction", None)
    return getattr(marker, "scope", "function") or "function"


def _autouse_fixtures(mod):
    return [n for n, obj in vars(mod).items()
            if _fixture_function(obj) is not None and getattr(
                getattr(obj, "_fixture_function_marker", None)
                or getattr(obj, "_pytestfixturefunction", None),
                "autouse", False)]


def run_twin(mod, name, kwargs, builtins, scope=None):
    """Call `mod.<name>` with `kwargs` and its fixtures: the module's own
    (function scope, generators torn down in reverse order) and the
    pytest fixtures named in `builtins`.  With a `TwinScope`, the
    module's autouse fixtures run too, and its module-scoped fixtures
    are taken from (or made into) the scope, as pytest shares them
    between the tests of one file."""
    fn = getattr(mod, name)
    cache = dict(builtins)
    with contextlib.ExitStack() as stack:
        def resolve(arg):
            if arg in cache:
                return cache[arg]
            obj = getattr(mod, arg)
            f = _fixture_function(obj)
            assert f is not None, f"{name}: no fixture {arg!r}"
            shared = scope is not None and _fixture_scope(obj) != "function"
            if shared and arg in scope.values:
                cache[arg] = scope.values[arg]
                return cache[arg]
            val = f(**{p: resolve(p)
                       for p in inspect.signature(f).parameters})
            if inspect.isgenerator(val):
                gen = val
                val = next(gen)
                (scope.stack if shared else stack).callback(next, gen, None)
            if shared:
                scope.values[arg] = val
            cache[arg] = val
            return val

        if scope is not None:
            for arg in _autouse_fixtures(mod):
                resolve(arg)
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


def no_mesh(parts=None):
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


class TwinFiles:
    """The port-side twins of several unit test files, one test a case:
    `spec` maps each file (from the repo root) to its `replace` pairs and
    its `leave_out` names.  The reference's own run of each file is the
    file itself, in tier-1; `check_lists` holds each twin's case list to
    the reference module's, `leave_out` aside.  Module-scoped fixtures
    live in one `TwinScope` a file, closed when the next file's first
    case runs and by `close()`."""

    def __init__(self, spec):
        self.spec = spec
        self.mods = {rel: load_twin(rel, "port", replace=rep)
                     for rel, (rep, _lo) in spec.items()}
        self.refs = {rel: load_twin(rel, "ref") for rel in spec}
        self.cases = [
            (rel, name, kw, f"{Path(rel).stem}::{cid}")
            for rel, (_rep, lo) in spec.items()
            for name, kw, cid in twin_cases(self.mods[rel], leave_out=lo)]
        self._rel, self._scope = None, None

    def params(self):
        return dict(argnames="rel,name,kw",
                    argvalues=[c[:3] for c in self.cases],
                    ids=[c[3] for c in self.cases])

    def run(self, rel, name, kw, builtins):
        if rel != self._rel:
            self.close()
            self._rel, self._scope = rel, TwinScope()
        run_twin(self.mods[rel], name, kw, builtins, scope=self._scope)

    def close(self):
        if self._scope is not None:
            self._scope.close()
        self._rel, self._scope = None, None

    def check_lists(self):
        for rel, (_rep, lo) in self.spec.items():
            ref = {c[0] for c in twin_cases(self.refs[rel])}
            port = {c[1] for c in self.cases if c[0] == rel}
            assert set(lo) <= ref, (rel, set(lo) - ref)
            assert ref and port == ref - set(lo), (rel, ref ^ port)
