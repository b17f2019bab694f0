"""nebula_tpu_torch — the PyTorch/CUDA port of nebula_tpu's device plane.

A second package beside `nebula_tpu/` (the JAX reference).  It imports
`torch` and `numpy` and nothing of JAX or of `nebula_tpu`: every host
helper it needs is its own copy.  This slice runs the north-star GO
path — pin a CSR snapshot, seed a frontier bitmap, expand N hops
through hand-written CUDA kernels, compact the final hop and gather
its YIELD columns — through `gpu.runtime.GpuRuntime.traverse`.
"""
