"""The device plane on one CUDA device or a mesh of shard slots (or, for
tests, the CPU)."""
from .device import DeviceSnapshot, GpuUnavailable, SnapshotRetired, \
    make_mesh, pin_snapshot
from .exprjit import CannotCompile
from .runtime import GpuRuntime, HopFrame, TraverseStats, \
    join_frontier_trails, trail_distinct_keep
# imported for its effect: registers the TpuTraverse executor and the GO
# fusion rule in query.optimizer.TPU_RULES
from . import traverse  # noqa: F401

__all__ = ["CannotCompile", "DeviceSnapshot", "GpuRuntime",
           "GpuUnavailable", "HopFrame", "SnapshotRetired", "TraverseStats",
           "join_frontier_trails", "make_mesh", "pin_snapshot",
           "trail_distinct_keep"]
