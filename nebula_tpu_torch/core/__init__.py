"""Core value model + nGQL semantics (pure Python): copies of
`nebula_tpu/core`'s modules, with the same exports.

The oracle layer for the whole framework: exact null semantics,
three-valued logic, expression evaluation, builtin + aggregate functions.
"""
from .value import (EMPTY, NULL, NULL_BAD_DATA, NULL_BAD_TYPE,
                    NULL_DIV_BY_ZERO, NULL_NAN, NULL_OUT_OF_RANGE,
                    NULL_OVERFLOW, NULL_UNKNOWN_PROP, DataSet, Date, DateTime,
                    Duration, Edge, EmptyValue, NullKind, NullValue, Path,
                    Step, Tag, Time, Vertex, hashable_key, is_empty, is_null,
                    total_order_key, type_name, value_to_string)
from .expr import (AggExpr, AttributeExpr, Binary, Case, DictContext, EdgeExpr,
                   EdgeProp, Expr, ExprContext, ExprEvalError, FunctionCall,
                   InputProp, LabelExpr, LabelTagProp, ListComprehension,
                   ListExpr, Literal, MapExpr, PathBuild, PredicateExpr,
                   Reduce, SetExpr, Slice, SrcProp, Subscript, TypeCast,
                   Unary, VarExpr, VarProp, VertexExpr, DstProp,
                   collect_aggregates, find_kinds, has_aggregate,
                   join_conjuncts, rewrite, split_conjuncts, to_text, walk)
from .functions import FUNCTIONS, cast_value
from .aggregates import apply_aggregate
