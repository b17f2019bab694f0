"""The TCK replayed on the JAX package's host engine and on the port's
engines: its host engine, its device engine over `make_mesh(8,
devices=[cpu] * 8)` as tests/tck/test_tck.py lays the reference's, and
its device engine on one local CPU device (`GpuRuntime(device="cpu")`,
the layout of one H100), which serves every space whatever its part
count.

Every scenario of tests/tck/features runs statement by statement on all
four, each on its own fresh engine; after every statement the outcomes
must be equal: the error's text (its class is its prefix), the column
names, and the rows by each package's `core.wire` bytes, in order where
the scenario's next check says "in order", as a multiset otherwise.
EXPLAIN text is compared with its node ids (`#12`) and numbered names
renumbered in order of first appearance.  Three kinds of statement
name the engine instance, and are compared without it: SHOW [LOCAL]
SESSIONS and SHOW [LOCAL] QUERIES with their session ids, clocks, plan
ids and timings masked; SHOW TRACES, whose store is shared by every
engine of a package in the process, by its columns, whether it has
rows and whether a GO statement's trace is among them.

Device mode: the port's EXPLAIN of every statement that holds a GO, and
every EXPLAIN statement of the scenarios, is held to the reference's
device plan, made by the reference's engine with the device flag on and
all three of its fusion rules in `optimizer.TPU_RULES` (`make_tpu_rule`,
`make_match_agg_rule`, `make_match_pipeline_rule`), so a
`TpuTraverse`, `TpuMatchAgg` or `TpuMatchPipeline` node stands exactly
where the reference's does.  MATCH, FIND PATH,
GET SUBGRAPH run their device halves on the device engines, and their rows are held like any other: no scenario that
compares rows in order reads a statement whose device rows come in
another order than the host's.  On the 8-slot mesh a space of another
part count is a layout the runtime cannot express (`MeshLayoutRefused`,
a `CannotCompile`), so its statements take the host path there, as the
reference's do on its mesh; the local engine runs them all on its
device path.

No scenario is left out: none needs a module this slice leaves out.
Tolerance: exact.
"""
import glob
import os
import re

import pytest

from tck.runner import _JOB_STMT, parse_feature

FEATURES = os.path.join(os.path.dirname(__file__), "tck", "features")
ALL_FEATURES = sorted(os.path.basename(p)[:-len(".feature")]
                      for p in glob.glob(os.path.join(FEATURES,
                                                      "*.feature")))

def scenarios(features):
    out = []
    for f in features:
        with open(os.path.join(FEATURES, f + ".feature")) as fh:
            out.extend(parse_feature(fh.read()))
    return out


def scenario_ids(scns):
    return [f"{s.feature}::{s.name}".replace(" ", "_") for s in scns]


# -- the three engines -------------------------------------------------------

_RUNTIMES = {}


def port_device_runtime(layout: str):
    """The port's device runtime of one layout, shared by the scenarios
    as tests/tck/test_tck.py shares the reference's: "mesh", eight shard
    slots on the CPU; "local", one CPU device."""
    if layout not in _RUNTIMES:
        import torch
        from nebula_tpu_torch.gpu import GpuRuntime, make_mesh
        _RUNTIMES[layout] = GpuRuntime(
            mesh=make_mesh(8, devices=[torch.device("cpu")] * 8)) \
            if layout == "mesh" else GpuRuntime(device="cpu")
    return _RUNTIMES[layout]


class _Engine:
    """One engine and its session, with its package's wire and its
    job-settling hook (as tests/tck/runner.py settles the reference's)."""

    def __init__(self, pkg: str, layout=None):
        if pkg == "ref":
            from nebula_tpu.core import wire
            from nebula_tpu.exec.engine import QueryEngine
            rt = None
        else:
            from nebula_tpu_torch.core import wire
            from nebula_tpu_torch.exec.engine import QueryEngine
            rt = None if layout is None else port_device_runtime(layout)
        self.pkg, self.layout, self.wire = pkg, layout, wire
        self.eng = QueryEngine(tpu_runtime=rt)
        self.sess = self.eng.new_session()

    def execute(self, stmt):
        rs = self.eng.execute(self.sess, stmt)
        if rs.error is None and _JOB_STMT.search(stmt):
            mgr = getattr(self.eng.qctx.store, "_job_manager", None)
            if mgr is not None:
                assert mgr.wait(timeout=60.0), "admin jobs did not settle"
        return rs

    def ref_device_plan(self, stmt):
        """The reference engine's EXPLAIN of `stmt` as its device engine
        plans it, with its three fusion rules."""
        from nebula_tpu.query import optimizer as ref_opt
        assert self.pkg == "ref"
        saved_rules, saved_rt = list(ref_opt.TPU_RULES), \
            self.eng.qctx.tpu_runtime
        ref_opt.TPU_RULES[:] = ref_device_rules()
        self.eng.qctx.tpu_runtime = object()   # EXPLAIN never runs it
        try:
            return self.eng.execute(self.sess, stmt)
        finally:
            ref_opt.TPU_RULES[:] = saved_rules
            self.eng.qctx.tpu_runtime = saved_rt


def ref_device_rules():
    """The reference's fusion rules, all three, in its order: GO's, the
    MATCH aggregate's and the MATCH pipeline's (the port has each)."""
    import nebula_tpu.tpu.match_agg as ref_match_agg
    import nebula_tpu.tpu.pipeline as ref_pipeline
    import nebula_tpu.tpu.traverse as ref_traverse
    return [ref_traverse.make_tpu_rule, ref_match_agg.make_match_agg_rule,
            ref_pipeline.make_match_pipeline_rule]


_NUMBERED = re.compile(r"(#|\bn|_)(\d+)\b")


def canon_plan(text: str) -> str:
    """Renumber plan node ids and numbered names in order of first
    appearance, so two engines' EXPLAIN texts compare."""
    seen = {}

    def sub(m):
        key = (m.group(1), m.group(2))
        seen.setdefault(key, len([k for k in seen if k[0] == m.group(1)]))
        return f"{m.group(1)}{seen[key]}"
    return _NUMBERED.sub(sub, text)


#: statements whose rows name the engine instance: its session ids and
#: clocks, its plan ids and timings.  Those columns are masked.
_INSTANCE_COLUMNS = {
    "SESSIONS": {"SessionId", "CreateTime", "UpdateTime"},
    "QUERIES": {"SessionId", "ExecutionPlanId", "Operator", "DurationUs",
                "QueueUs", "DeviceUs", "HostUs", "MemoryBytes"},
}
_INSTANCE = re.compile(r"^\s*SHOW\s+(?:LOCAL\s+)?(SESSIONS|QUERIES)\s*$",
                       re.I)
#: SHOW TRACES reads a store shared by every engine of its package in the
#: process, so two packages' rows differ by history: its outcome is the
#: columns and whether a GO statement's trace is among the rows.
_TRACES = re.compile(r"^\s*SHOW\s+TRACES\s*$", re.I)


def outcome(e: _Engine, rs, ordered: bool, explain: bool, stmt=""):
    if rs.error is not None:
        return ("error", rs.error)
    cols = list(rs.data.column_names)
    data = [list(r) for r in rs.data.rows]
    if _TRACES.match(stmt):
        return ("traces", cols, bool(data),
                any("query:Go" in r for r in data))
    m = _INSTANCE.match(stmt)
    if m:
        masked = _INSTANCE_COLUMNS[m.group(1).upper()]
        data = [[None if c in masked else v for c, v in zip(cols, r)]
                for r in data]
    rows = [e.wire.dumps(r) for r in data]
    if explain:
        rows = [canon_plan(r.decode()) for r in rows]
    if not ordered:
        rows = sorted(rows)
    return ("rows", cols, rows)


_GO = re.compile(r"\bGO\b", re.I)
#: the statements whose device halves this slice ports, by first word
_DEVICE_KIND = re.compile(r"^\s*(MATCH|FIND|GET)\b", re.I)


def _is_explain(stmt):
    return re.match(r"^\s*EXPLAIN\b", stmt, re.I) is not None


def has_go(stmt: str) -> bool:
    """A statement holding a GO sentence (quoted text does not count)."""
    bare = re.sub(r'"(?:[^"\\]|\\.)*"|\'(?:[^\'\\]|\\.)*\'', '""', stmt)
    return _GO.search(bare) is not None


def replay(scn, counts=None):
    """Run one scenario on the four engines; raise AssertionError at the
    first statement whose outcomes differ.  `counts` (a dict), when
    given, adds up the statements, the GO statements and the fused
    ones of the device plans, and per device engine the MATCH, FIND
    PATH and GET SUBGRAPH statements that ran on its runtime."""
    ref = _Engine("ref")
    host = _Engine("port")
    devs = [_Engine("port", "mesh"), _Engine("port", "local")]
    steps = scn.steps
    for i, step in enumerate(steps):
        if step.kind not in ("exec", "query"):
            continue
        nxt = next((s for s in steps[i + 1:] if s.kind not in
                    ("exec", "query")), None)
        ordered = nxt is not None and nxt.kind == "expect" and nxt.ordered
        for stmt in [s for s in step.text.split(";") if s.strip()]:
            where = f"[{scn.feature} / {scn.name}] {stmt!r}"
            explain = _is_explain(stmt)
            want = outcome(ref, ref.execute(stmt), ordered, explain, stmt)
            got = outcome(host, host.execute(stmt), ordered, explain, stmt)
            assert got == want, \
                f"{where}: port host {got!r} != reference {want!r}"
            want_plan = None
            if explain:
                want_plan = outcome(ref, ref.ref_device_plan(stmt), ordered,
                                    explain, stmt)
            for dev in devs:
                dev.eng.qctx.last_tpu_stats = None
                got = outcome(dev, dev.execute(stmt), ordered, explain,
                              stmt)
                kind = _DEVICE_KIND.match(stmt)
                if counts is not None and kind and not explain \
                        and dev.eng.qctx.last_tpu_stats is not None:
                    key = (dev.layout, kind.group(1).upper())
                    counts[key] = counts.get(key, 0) + 1
                assert got == (want_plan if explain else want), \
                    f"{where}: port device ({dev.layout}) {got!r} != " \
                    f"reference {'device plan ' if explain else ''}" \
                    f"{want_plan if explain else want!r}"
            if counts is not None:
                counts["statements"] = counts.get("statements", 0) + 1
            if has_go(stmt) and not explain:
                _hold_go_plan(ref, devs, stmt, where, counts)


def _hold_go_plan(ref, devs, stmt, where, counts):
    q = "EXPLAIN " + re.sub(r"^\s*PROFILE\s+", "", stmt, flags=re.I)
    want = outcome(ref, ref.ref_device_plan(q), True, True)
    for dev in devs:
        got = outcome(dev, dev.execute(q), True, True)
        assert got == want, \
            f"{where}: port device ({dev.layout}) plan {got!r} != " \
            f"reference device plan {want!r}"
    if counts is not None and want[0] == "rows":
        counts["go"] = counts.get("go", 0) + 1
        counts["fused"] = counts.get("fused", 0) + int(
            any("TpuTraverse" in r for r in want[2]))


SCENARIOS = scenarios(ALL_FEATURES)


@pytest.mark.parametrize("scn", SCENARIOS, ids=scenario_ids(SCENARIOS))
def test_scenario(scn):
    replay(scn)


def test_go_plans_fuse_in_device_mode():
    """The replay holds device-mode GO plans at all: over the GO
    features some statements fuse into a TpuTraverse node and some do
    not, each where the reference's rule decides."""
    counts = {}
    for scn in scenarios(["go", "go_advanced"]):
        replay(scn, counts)
    assert counts["go"] > 20, counts
    assert 0 < counts["fused"] < counts["go"], counts


def test_match_paths_and_subgraph_run_on_the_device_engines():
    """The replay reaches the device halves: on both device engines
    MATCH, FIND PATH and GET SUBGRAPH statements of their features ran
    on the runtime (`last_tpu_stats` set) on the local engine, and MATCH
    statements on the mesh (the path features' spaces have another part
    count than its 8 slots)."""
    counts = {}
    for scn in scenarios(["match", "match_aggregate_fused", "match_paths",
                          "path_subgraph", "paths_advanced"]):
        replay(scn, counts)
    for kind in ("MATCH", "FIND", "GET"):
        assert counts.get(("local", kind), 0) > 0, (kind, counts)
    assert counts.get(("mesh", "MATCH"), 0) > 0, counts


# -- the cluster TCK on the port's device graphd ------------------------------

def cluster_tck():
    """tests/tck/test_tck_cluster.py on the port: its own source, with its
    runner (tests/tck/runner.py, read the same way) and `nebula_tpu`
    read as `nebula_tpu_torch`; its cluster's graphd gets a device
    runtime on the CPU, `GpuRuntime(device="cpu")`."""
    from test_torch_engine import load_twin
    load_twin("tests/tck/runner.py", "port")     # twin_port_runner
    return load_twin("tests/tck/test_tck_cluster.py", "port", replace=(
        ("from .runner import parse_feature, run_scenario",
         "from twin_port_runner import parse_feature, run_scenario"),
        ("    from nebula_tpu.cluster.launcher import LocalCluster\n",
         "    from nebula_tpu.cluster.launcher import LocalCluster\n"
         "    from nebula_tpu.tpu import GpuRuntime\n"),
        ("                     data_dir=str(tmp_path))",
         "                     data_dir=str(tmp_path),\n"
         "                     tpu_runtime=GpuRuntime(device=\"cpu\"))"),
    ))


#: the cluster TCK's features in four shares, so that pytest-xdist's
#: `--dist loadfile` runs them on four workers (tests/test_torch_tck_
#: cluster_{0,1,2,3}.py); a share a feature, dealt by descending size
CLUSTER_SHARES = 4


def cluster_share(k: int):
    by_size = sorted(ALL_FEATURES, key=lambda f: (-os.path.getsize(
        os.path.join(FEATURES, f + ".feature")), f))
    return sorted(by_size[k::CLUSTER_SHARES])
