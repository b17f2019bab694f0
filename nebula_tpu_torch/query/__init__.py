"""Query layer: the nGQL tokenizer, AST and parser.

Copies of `nebula_tpu/query/{tokenizer,ast,parser}.py`.  The validator
needs the schema catalog and waits for the store; plan, planner and
optimizer wait for the executors.
"""
from .parser import ParseError, parse
