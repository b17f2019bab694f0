"""The device plane on one CUDA device (or, for tests, the CPU)."""
from .device import DeviceSnapshot, GpuUnavailable, pin_snapshot
from .exprjit import CannotCompile
from .runtime import GpuRuntime, HopFrame, TraverseStats, \
    join_frontier_trails, trail_distinct_keep

__all__ = ["CannotCompile", "DeviceSnapshot", "GpuRuntime",
           "GpuUnavailable", "HopFrame", "TraverseStats",
           "join_frontier_trails", "pin_snapshot", "trail_distinct_keep"]
