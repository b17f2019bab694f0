"""The device plane on one CUDA device (or, for tests, the CPU)."""
from .device import DeviceSnapshot, GpuUnavailable, pin_snapshot
from .exprjit import CannotCompile
from .runtime import GpuRuntime, TraverseStats

__all__ = ["CannotCompile", "DeviceSnapshot", "GpuRuntime",
           "GpuUnavailable", "TraverseStats", "pin_snapshot"]
