"""The device plane on one CUDA device or a mesh of shard slots (or, for
tests, the CPU)."""
from .device import DeviceSnapshot, GpuUnavailable, SnapshotRetired, \
    make_mesh, make_mesh2, pin_snapshot
from .exprjit import CannotCompile
from .runtime import GpuRuntime, HopFrame, TraverseStats, \
    join_frontier_trails, trail_distinct_keep
# imported for their effect: register the TpuTraverse, TpuMatchAgg and
# TpuMatchPipeline executors and their fusion rules in
# query.optimizer.TPU_RULES in the reference's order
# (nebula_tpu/tpu/__init__.py): GO, then the MATCH aggregate, then the
# MATCH pipeline, which MUST follow match_agg
from . import traverse  # noqa: F401
from . import match_agg  # noqa: F401
from . import pipeline  # noqa: F401

__all__ = ["CannotCompile", "DeviceSnapshot", "GpuRuntime",
           "GpuUnavailable", "HopFrame", "SnapshotRetired", "TraverseStats",
           "join_frontier_trails", "make_mesh", "make_mesh2", "pin_snapshot",
           "trail_distinct_keep"]
