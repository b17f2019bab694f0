"""Import hygiene of the port: `nebula_tpu_torch` imports torch and
numpy, never JAX and nothing of the reference package `nebula_tpu`.

The runtime check runs in a subprocess, because tests/conftest.py imports
jax into every test process; the static check reads every module's
imports."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "nebula_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield path, ".".join(parts)


def test_port_modules_exist():
    names = {m for _, m in _modules()}
    for m in ("nebula_tpu_torch.core.value", "nebula_tpu_torch.core.expr",
              "nebula_tpu_torch.graphstore.schema",
              "nebula_tpu_torch.graphstore.csr",
              "nebula_tpu_torch.graphstore.delta",
              "nebula_tpu_torch.bench.datagen",
              "nebula_tpu_torch.gpu.device", "nebula_tpu_torch.gpu.exprjit",
              "nebula_tpu_torch.gpu.hop", "nebula_tpu_torch.gpu.runtime",
              "nebula_tpu_torch.gpu.kernels", "nebula_tpu_torch.algo",
              "nebula_tpu_torch.algo.graph", "nebula_tpu_torch.algo.oracles",
              "nebula_tpu_torch.algo.kernels", "nebula_tpu_torch.algo.engine",
              "nebula_tpu_torch.tools.algo_bench",
              "nebula_tpu_torch.utils.config",
              "nebula_tpu_torch.utils.failpoints",
              "nebula_tpu_torch.utils.cancel", "nebula_tpu_torch.utils.stats",
              "nebula_tpu_torch.utils.workload",
              "nebula_tpu_torch.gpu.batch", "nebula_tpu_torch.gpu.mesh",
              "nebula_tpu_torch.core", "nebula_tpu_torch.core.geo",
              "nebula_tpu_torch.core.aggregates",
              "nebula_tpu_torch.core.functions",
              "nebula_tpu_torch.core.wire",
              "nebula_tpu_torch.graphstore.index",
              "nebula_tpu_torch.graphstore.fulltext",
              "nebula_tpu_torch.query", "nebula_tpu_torch.query.tokenizer",
              "nebula_tpu_torch.query.ast", "nebula_tpu_torch.query.parser",
              "nebula_tpu_torch.query.validator",
              "nebula_tpu_torch.utils.racecheck",
              "nebula_tpu_torch.utils.trace",
              "nebula_tpu_torch.utils.memtracker",
              "nebula_tpu_torch.graphstore.schema_wire",
              "nebula_tpu_torch.graphstore.engine",
              "nebula_tpu_torch.graphstore.store",
              "nebula_tpu_torch.cluster", "nebula_tpu_torch.cluster.wal",
              "nebula_tpu_torch.cluster.pushdown",
              "nebula_tpu_torch.exec", "nebula_tpu_torch.exec.context",
              "nebula_tpu_torch.query.plan", "nebula_tpu_torch.query.planner",
              "nebula_tpu_torch.query.optimizer",
              "nebula_tpu_torch.exec.frame",
              "nebula_tpu_torch.exec.permissions",
              "nebula_tpu_torch.exec.jobs", "nebula_tpu_torch.exec.algorithms",
              "nebula_tpu_torch.exec.executors",
              "nebula_tpu_torch.exec.scheduler", "nebula_tpu_torch.exec.engine",
              "nebula_tpu_torch.gpu.traverse",
              "nebula_tpu_torch.gpu.paths", "nebula_tpu_torch.gpu.match_agg",
              "nebula_tpu_torch.gpu.pipeline",
              "nebula_tpu_torch.utils.consistency",
              "nebula_tpu_torch.utils.epochs", "nebula_tpu_torch.utils.flight",
              "nebula_tpu_torch.utils.insights",
              "nebula_tpu_torch.utils.admission", "nebula_tpu_torch.utils.slo"):
        assert m in names, m


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = [m for _, m in _modules()]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'"
        " or k.startswith(('jax.', 'jaxlib')) or k == 'nebula_tpu'"
        " or k.startswith('nebula_tpu.'))\n"
        "print(json.dumps({'bad': bad, 'torch': 'torch' in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "torch": True}


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax_or_the_reference():
    scripts = [ROOT / "chip_smoke.py"]
    for path in [p for p, _ in _modules()] + scripts:
        tree = ast.parse(path.read_text(), filename=str(path))
        for name in _imported_names(tree):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "nebula_tpu"), \
                f"{path.relative_to(ROOT)} imports {name}"
