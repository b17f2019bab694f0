"""Execution layer: executors, scheduler, engine, host algorithms.

Copies of `nebula_tpu/exec/`.  The fused device node `TpuTraverse`
registers its executor from `nebula_tpu_torch.gpu`."""
from .context import (ExecutionContext, QueryContext, ResultSet, RowContext,
                      row_dict)
from .engine import QueryEngine, Session, quick_engine
from .executors import EXECUTORS, ExecError, executor, run_node
from .scheduler import ProfileStats, Scheduler
