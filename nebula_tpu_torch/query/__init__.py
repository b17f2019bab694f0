"""Query layer: the nGQL tokenizer, AST, parser and validator.

Copies of `nebula_tpu/query/{tokenizer,ast,parser,validator}.py`.  Plan,
planner and optimizer wait for the executors.
"""
from .parser import ParseError, parse
from .validator import ValidationError, validate
