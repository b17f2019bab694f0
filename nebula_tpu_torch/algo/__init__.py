"""The graph-analytics plane, `CALL algo.*`: PageRank, WCC and SSSP.

The port of `nebula_tpu/algo/` on one CUDA device.  Whole-graph
iterative algorithms run as vertex programs: dense per-vertex state
arrays and one edge-propagate/combine/apply step per iteration, each a
hand-written CUDA kernel (Queue B K12-K14), with termination decided on
the host between iterations.

  * `__init__.py` — the algorithm registry (a copy of the reference's):
    names, parameters, defaults, yield columns.  Pure Python.
  * `graph.py`    — the flat, destination-sorted edge form of a
    CsrSnapshot (numpy).
  * `oracles.py`  — the numpy host oracles: power iteration,
    union-find, Dijkstra.  Host mode and the parity contract.
  * `kernels.py`  — the three step wrappers and their plain versions.
  * `engine.py`   — `run_algorithm`, the entry point: graph
    preparation, the device loop on a GpuRuntime, row assembly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

#: sentinel default marking a parameter the caller MUST supply
REQUIRED = object()


@dataclass(frozen=True)
class AlgoSpec:
    """One algorithm's statement surface: its parameter schema and the
    columns its YIELD may project."""
    name: str
    yield_cols: Tuple[str, ...]
    params: Dict[str, Any] = field(default_factory=dict)   # name → default
    description: str = ""


#: parameters every algorithm accepts
_COMMON = {
    # edge types to traverse; None = every edge type in the space.
    # A string names one type; a list of strings names several.
    "edge_types": None,
    # execution mode: auto (device when a runtime serves the space,
    # host oracle otherwise), device (error when unavailable), host
    "mode": "auto",
    # iteration cap; 0 = the algorithm's own default
    "max_iter": 0,
}

ALGORITHMS: Dict[str, AlgoSpec] = {
    "pagerank": AlgoSpec(
        name="pagerank",
        yield_cols=("vid", "rank"),
        params={**_COMMON, "damping": 0.85, "tol": 1e-6},
        description="dense SpMV-style rank push over out-edges with "
                    "dangling-mass correction; rows (vid, rank) "
                    "ordered by vid"),
    "wcc": AlgoSpec(
        name="wcc",
        yield_cols=("vid", "component"),
        params=dict(_COMMON),
        description="weakly connected components by min-label "
                    "hooking / label propagation over both edge "
                    "directions; component = vid of the smallest "
                    "dense id in the component"),
    "sssp": AlgoSpec(
        name="sssp",
        yield_cols=("vid", "distance"),
        params={**_COMMON, "src": REQUIRED, "weight": None,
                "direction": "out"},
        description="single-source shortest paths by weighted frontier "
                    "relaxation; weight names a numeric edge prop "
                    "(NULL weighs 1.0), absent = hop count; rows only "
                    "for reached vertices"),
}

#: iteration caps applied when max_iter=0 (the statement default)
DEFAULT_MAX_ITER = {"pagerank": 20, "wcc": 10_000, "sssp": 100_000}

_MODES = ("auto", "device", "host")
_DIRECTIONS = ("out", "in", "both")


def validate_call(func: str, param_names, yield_names) -> None:
    """Static checks shared by the validator and the engine: known
    algorithm, known parameter names, required parameters present,
    known yield columns.  Raises ValueError with a user-facing
    message."""
    spec = ALGORITHMS.get(func)
    if spec is None:
        known = ", ".join(sorted(ALGORITHMS))
        raise ValueError(f"unknown algorithm `algo.{func}' "
                         f"(known: {known})")
    for p in param_names:
        if p not in spec.params:
            known = ", ".join(sorted(spec.params))
            raise ValueError(f"unknown parameter `{p}' for "
                             f"algo.{func} (known: {known})")
    for p, dflt in spec.params.items():
        if dflt is REQUIRED and p not in param_names:
            raise ValueError(f"algo.{func} requires parameter `{p}'")
    for y in yield_names:
        if y not in spec.yield_cols:
            known = ", ".join(spec.yield_cols)
            raise ValueError(f"algo.{func} cannot YIELD `{y}' "
                             f"(columns: {known})")
