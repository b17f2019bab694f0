"""Query layer: tokenizer, parser, AST, validator, plan, planner,
optimizer.

Copies of `nebula_tpu/query/`.  The device fusion rule registers itself
in `optimizer.TPU_RULES` from `nebula_tpu_torch.gpu`.
"""
from .parser import ParseError, parse
from .plan import ExecutionPlan, PlanNode, transform_plan, walk_plan
from .planner import PlannerContext, QueryError, plan_statement
from .optimizer import RULES, optimize, register_rule
from .validator import ValidationError, validate
