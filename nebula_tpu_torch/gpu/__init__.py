"""The device plane on one CUDA device or a mesh of shard slots (or, for
tests, the CPU)."""
from .device import DeviceSnapshot, GpuUnavailable, make_mesh, pin_snapshot
from .exprjit import CannotCompile
from .runtime import GpuRuntime, HopFrame, TraverseStats, \
    join_frontier_trails, trail_distinct_keep

__all__ = ["CannotCompile", "DeviceSnapshot", "GpuRuntime",
           "GpuUnavailable", "HopFrame", "TraverseStats",
           "join_frontier_trails", "make_mesh", "pin_snapshot",
           "trail_distinct_keep"]
