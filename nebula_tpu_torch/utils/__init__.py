"""Host utilities of the port: its own copies of the reference's
`nebula_tpu/utils` modules that the batched dispatch needs (config flags,
failpoints, cancellation, metrics and work counters, the live workload
registry and dispatch table)."""
