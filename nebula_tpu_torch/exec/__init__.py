"""The execution layer's contexts (`context`, a copy of the JAX package's
`exec/context.py`).  The executors, the scheduler and the engine are the
next slice's."""
