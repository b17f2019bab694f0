"""The port's copy of `nebula_tpu/query/validator.py`, whole.

Validator layer: semantic checks + static type deduction.

The reference validates every sentence BEFORE planning — a Validator
subclass per sentence resolves schema references and runs type deduction
over expressions (DeduceTypeVisitor), so `YIELD 1 + "x"` is a
SemanticError at validation, not a per-row BAD_TYPE at execution
(reference: src/graph/validator + DeduceTypeVisitor).  Same split
here: the engine runs
`validate(stmt, pctx)` between parse and plan; the planner's inline
checks remain as defense in depth.

Deduction is CONSERVATIVE over a small lattice: a type is reported only
when provable from literals, schema property types, and function
signatures; anything data-dependent deduces to UNKNOWN and is admitted
(runtime three-valued semantics take over, exactly like the reference's
Value::Type::__EMPTY__ escape).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..core import expr as E
from ..graphstore.schema import PropType, SchemaError

UNKNOWN = "unknown"
NUMERIC = {"int", "float"}

# conservative return types for builtins whose result type is fixed
_FN_RETURNS = {
    "abs": UNKNOWN, "floor": "float", "ceil": "float", "sqrt": "float",
    "exp": "float", "log": "float", "log2": "float", "log10": "float",
    "sin": "float", "cos": "float", "tan": "float", "round": "float",
    "radians": "float", "degrees": "float",
    "size": "int", "length": "int", "rank": "int", "typeid": "int",
    "hash": "int", "tointeger": "int", "toint": "int",
    "tofloat": "float", "toboolean": "bool", "tostring": "string",
    "lower": "string", "upper": "string", "tolower": "string",
    "toupper": "string", "trim": "string", "ltrim": "string",
    "rtrim": "string", "substr": "string", "substring": "string",
    "left": "string", "right": "string", "replace": "string",
    "concat": "string", "type": "string", "md5": "string",
    "sha1": "string", "sha256": "string",
    "split": "list", "keys": "list", "labels": "list", "tags": "list",
    "nodes": "list", "relationships": "list", "range": "list",
    "st_distance": "float", "st_x": "float", "st_y": "float",
    "st_astext": "string", "st_dwithin": "bool", "st_intersects": "bool",
    "st_covers": "bool", "st_coveredby": "bool", "st_isvalid": "bool",
}

_PT_KIND = {
    PropType.BOOL: "bool", PropType.FLOAT: "float",
    PropType.DOUBLE: "float", PropType.STRING: "string",
    PropType.FIXED_STRING: "string", PropType.DATE: "date",
    PropType.TIME: "time", PropType.DATETIME: "datetime",
    PropType.DURATION: "duration", PropType.GEOGRAPHY: "geography",
}


class ValidationError(Exception):
    pass


class Scope:
    """What names mean inside the statement being validated."""

    def __init__(self, pctx, edge_types=None, match_aliases=None):
        self.pctx = pctx
        self.edge_types = set(edge_types or ())
        self.match_aliases = dict(match_aliases or {})


def _lit_type(v: Any) -> str:
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "float"
    if isinstance(v, str):
        return "string"
    if v is None:
        return UNKNOWN
    return UNKNOWN


def deduce(e: E.Expr, scope: Scope) -> str:
    """Static type of `e`, or UNKNOWN when not provable."""
    k = e.kind
    if k == "literal":
        return _lit_type(e.value)
    if k in ("list", "set"):
        for item in e.items:
            deduce(item, scope)
        return "list" if k == "list" else "set"
    if k == "map":
        for _, item in e.items:
            deduce(item, scope)
        return "map"
    if k == "edge_prop":
        return _edge_prop_type(e.edge, e.name, scope)
    if k == "attribute":
        # raw parse of `etype.prop` in a GO WHERE: attribute-of-label
        # (the planner canonicalizes later; deduce from schema now)
        if isinstance(e.obj, E.LabelExpr) and e.obj.name in scope.edge_types:
            return _edge_prop_type(e.obj.name, e.attr, scope)
        if isinstance(e.obj, E.Expr):
            deduce(e.obj, scope)
        return UNKNOWN
    if k in ("src_prop", "dst_prop"):
        return _tag_prop_type(e.tag, e.name, scope)
    if k == "unary":
        t = deduce(e.operand, scope)
        if e.op in ("IS_NULL", "IS_NOT_NULL", "IS_EMPTY", "IS_NOT_EMPTY"):
            return "bool"
        if e.op == "NOT":
            if t not in (UNKNOWN, "bool"):
                raise ValidationError(f"NOT over {t}")
            return "bool"
        if e.op in ("-", "+"):
            if t not in (UNKNOWN, "int", "float"):
                raise ValidationError(f"unary {e.op} over {t}")
            return t
        return UNKNOWN
    if k == "binary":
        return _binary_type(e, scope)
    if k == "function":
        for a in e.args:
            deduce(a, scope)
        if e.name.lower() in ("coalesce", "head", "last"):
            return UNKNOWN
        return _FN_RETURNS.get(e.name.lower(), UNKNOWN)
    if k == "aggregate":
        if e.arg is not None:
            deduce(e.arg, scope)
        if e.func in ("count",):
            return "int"
        if e.func in ("avg", "std"):
            return "float"
        if e.func in ("collect", "collect_set"):
            return "list"
        return UNKNOWN
    if k == "case":
        if e.condition is not None:
            deduce(e.condition, scope)
        outs = set()
        for w, t in e.whens:
            wt = deduce(w, scope)
            if e.condition is None and wt not in (UNKNOWN, "bool"):
                raise ValidationError(f"CASE WHEN condition is {wt}")
            outs.add(deduce(t, scope))
        if e.default is not None:
            outs.add(deduce(e.default, scope))
        return outs.pop() if len(outs) == 1 else UNKNOWN
    if k in ("subscript", "slice"):
        deduce(e.obj, scope)
        return UNKNOWN
    if k in ("list_comprehension", "predicate", "reduce"):
        return ("list" if k == "list_comprehension"
                else "bool" if k == "predicate" else UNKNOWN)
    return UNKNOWN


def _binary_type(e, scope: Scope) -> str:
    lt, rt = deduce(e.lhs, scope), deduce(e.rhs, scope)
    op = e.op
    if op in ("AND", "OR", "XOR"):
        for t in (lt, rt):
            if t not in (UNKNOWN, "bool"):
                raise ValidationError(f"{op} over {t}")
        return "bool"
    if op in ("==", "!=", "IS", "IS NOT"):
        return "bool"
    if op in ("<", "<=", ">", ">="):
        if UNKNOWN not in (lt, rt) and lt != rt \
                and not (lt in NUMERIC and rt in NUMERIC):
            raise ValidationError(f"comparison {lt} {op} {rt}")
        return "bool"
    if op in ("IN", "NOT IN", "CONTAINS", "NOT CONTAINS",
              "STARTS WITH", "ENDS WITH", "NOT STARTS WITH",
              "NOT ENDS WITH", "=~"):
        return "bool"
    if op in ("+",):
        if UNKNOWN in (lt, rt):
            return UNKNOWN
        if lt == "string" and rt == "string":
            return "string"
        if lt in NUMERIC and rt in NUMERIC:
            return "float" if "float" in (lt, rt) else "int"
        if lt == "list" or rt == "list":
            return "list"
        if {lt, rt} & {"date", "time", "datetime", "duration"}:
            return UNKNOWN          # temporal arithmetic: runtime rules
        raise ValidationError(f"`+' over {lt} and {rt}")
    if op in ("-", "*", "/", "%"):
        for t in (lt, rt):
            if t not in (UNKNOWN, "int", "float", "duration", "date",
                         "time", "datetime"):
                raise ValidationError(f"`{op}' over {t}")
        if lt in NUMERIC and rt in NUMERIC:
            return "float" if "float" in (lt, rt) else "int"
        return UNKNOWN
    return UNKNOWN


def _edge_prop_type(edge: Optional[str], name: str, scope: Scope) -> str:
    if name.startswith("_"):
        return {"_rank": "int", "_type": "string"}.get(name, UNKNOWN)
    pctx = scope.pctx
    if not pctx.space or edge in (None, "__edge__"):
        return UNKNOWN
    try:
        sv = pctx.catalog.get_edge(pctx.space, edge).latest
    except SchemaError:
        return UNKNOWN          # planner raises the schema error itself
    pd = sv.prop(name)
    if pd is None:
        raise ValidationError(f"edge `{edge}' has no property `{name}'")
    return _PT_KIND.get(pd.ptype, "int")


def _tag_prop_type(tag: str, name: str, scope: Scope) -> str:
    pctx = scope.pctx
    if not pctx.space:
        return UNKNOWN
    try:
        sv = pctx.catalog.get_tag(pctx.space, tag).latest
    except SchemaError:
        return UNKNOWN
    pd = sv.prop(name)
    if pd is None:
        raise ValidationError(f"tag `{tag}' has no property `{name}'")
    return _PT_KIND.get(pd.ptype, "int")


# ---------------------------------------------------------------------------
# per-statement validators (reference: one Validator subclass per
# sentence — GoValidator, MatchValidator, ...).  Each entry checks the
# STRUCTURAL semantics of its
# sentence (step ranges, schema references, prop-name conformance)
# before the generic expression type deduction runs.  Registered by
# sentence class; statements without an entry only get type deduction.
# ---------------------------------------------------------------------------

_SENTENCE_VALIDATORS: Dict[type, Any] = {}


def _svalidator(cls):
    def deco(fn):
        _SENTENCE_VALIDATORS[cls] = fn
        return fn
    return deco


def _has_edge(pctx, name: str) -> bool:
    try:
        pctx.catalog.get_edge(pctx.space, name)
        return True
    except SchemaError:
        return False


def _has_tag(pctx, name: str) -> bool:
    try:
        pctx.catalog.get_tag(pctx.space, name)
        return True
    except SchemaError:
        return False


def _check_steps(m, n):
    if m is not None and m < 0:
        raise ValidationError(f"step number {m} is negative")
    if m is not None and n is not None and n < m:
        raise ValidationError(
            f"upper bound steps {n} must be greater than or equal to "
            f"lower bound {m}")


def _register_sentence_validators():
    from . import ast as A

    @_svalidator(A.GoSentence)
    def v_go(stmt, pctx):
        if stmt.steps is not None:
            _check_steps(stmt.steps.m, stmt.steps.n)
        if pctx.space and stmt.over is not None and not stmt.over.is_all:
            for et in stmt.over.edges or ():
                if not _has_edge(pctx, et):
                    raise ValidationError(f"edge `{et}' not found")

    @_svalidator(A.FetchVerticesSentence)
    def v_fetch_v(stmt, pctx):
        if not pctx.space:
            return
        for t in stmt.tags:
            if t != "*" and not _has_tag(pctx, t):
                raise ValidationError(f"tag `{t}' not found")

    @_svalidator(A.FetchEdgesSentence)
    def v_fetch_e(stmt, pctx):
        if pctx.space and not _has_edge(pctx, stmt.etype):
            raise ValidationError(f"edge `{stmt.etype}' not found")

    @_svalidator(A.LookupSentence)
    def v_lookup(stmt, pctx):
        if pctx.space and not (_has_tag(pctx, stmt.schema_name)
                               or _has_edge(pctx, stmt.schema_name)):
            raise ValidationError(
                f"schema `{stmt.schema_name}' not found")

    @_svalidator(A.FindPathSentence)
    def v_find_path(stmt, pctx):
        if stmt.upto is not None and stmt.upto < 0:
            raise ValidationError(
                f"UPTO {stmt.upto} STEPS is negative")
        if pctx.space and stmt.over is not None and not stmt.over.is_all:
            for et in stmt.over.edges or ():
                if not _has_edge(pctx, et):
                    raise ValidationError(f"edge `{et}' not found")

    @_svalidator(A.CallAlgoSentence)
    def v_call_algo(stmt, pctx):
        # the registry is import-light on purpose (no jax): the
        # validator statically vets module/func/params/yields before
        # any engine machinery is touched
        from ..algo import validate_call
        if stmt.module != "algo":
            raise ValidationError(
                f"unknown procedure module `{stmt.module}' "
                f"(only `algo' is served)")
        ynames = []
        if stmt.yield_ is not None:
            for c in stmt.yield_.columns:
                if c.expr.kind != "label":
                    raise ValidationError(
                        "CALL ... YIELD takes bare output column "
                        "names (optionally aliased with AS)")
                ynames.append(c.expr.name)
        try:
            validate_call(stmt.func, list(stmt.params), ynames)
        except ValueError as ex:
            raise ValidationError(str(ex)) from None
        for name, e in stmt.params.items():
            try:
                e.eval(E.DictContext())
            except Exception:  # noqa: BLE001 — non-constant param
                raise ValidationError(
                    f"parameter `{name}' must be a constant "
                    f"expression") from None
        et = stmt.params.get("edge_types")
        if et is not None and pctx.space:
            try:
                v = et.eval(E.DictContext())
            except Exception:  # noqa: BLE001 — reported above
                v = None
            names = [v] if isinstance(v, str) else \
                (v if isinstance(v, list) else [])
            for n in names:
                if isinstance(n, str) and not _has_edge(pctx, n):
                    raise ValidationError(f"edge `{n}' not found")

    @_svalidator(A.SubgraphSentence)
    def v_subgraph(stmt, pctx):
        if stmt.steps is not None and stmt.steps < 0:
            raise ValidationError(f"step number {stmt.steps} is negative")
        if pctx.space:
            for et in (tuple(stmt.in_edges or ())
                       + tuple(stmt.out_edges or ())
                       + tuple(stmt.both_edges or ())):
                if et != "*" and not _has_edge(pctx, et):
                    raise ValidationError(f"edge `{et}' not found")

    @_svalidator(A.MatchSentence)
    def v_match(stmt, pctx):
        # Pattern predicates `WHERE (a)-[:e]->()` are legal only in a
        # MATCH clause's WHERE; their patterns get the same structural
        # checks as inline patterns.  Anywhere else (WITH WHERE, RETURN
        # columns) they are a semantic error (reference: MatchValidator
        # rejects PatternExpression outside a filter).
        def preds_in(e):
            return [x for x in E.walk(e) if x.kind == "pattern_pred"] \
                if e is not None else []

        def screen(e):
            if preds_in(e):
                raise ValidationError(
                    "pattern predicate is only supported in a MATCH "
                    "WHERE clause")

        def screen_proj(cl):
            for c in getattr(cl, "columns", None) or []:
                screen(c.expr)
            for f in getattr(cl, "order_by", None) or []:
                screen(f.expr)

        for cl in getattr(stmt, "clauses", ()) or ():
            if isinstance(cl, A.MatchClauseAst):
                continue
            if isinstance(cl, A.UnwindClauseAst):
                screen(cl.expr)
                continue
            screen(getattr(cl, "where", None))
            screen_proj(cl)
        ret = getattr(stmt, "return_", None)
        if ret is not None:
            screen_proj(ret)
        for cl in getattr(stmt, "clauses", ()) or ():
            pat = list(getattr(cl, "patterns", None) or ())
            for pe in preds_in(getattr(cl, "where", None)):
                pat.append(pe.pattern)
            for pp in pat or ():
                for ep in getattr(pp, "edges", ()) or ():
                    if ep.min_hop < 0:
                        raise ValidationError(
                            f"hop lower bound {ep.min_hop} is negative")
                    if ep.max_hop != -1 and ep.max_hop < ep.min_hop:
                        raise ValidationError(
                            f"hop upper bound {ep.max_hop} must be "
                            f">= lower bound {ep.min_hop}")
                    if pctx.space:
                        for et in ep.types or ():
                            if not _has_edge(pctx, et):
                                raise ValidationError(
                                    f"edge `{et}' not found")
                for np_ in getattr(pp, "nodes", ()) or ():
                    if pctx.space:
                        for lb, _props in np_.labels or ():
                            if not _has_tag(pctx, lb):
                                raise ValidationError(
                                    f"tag `{lb}' not found")

    @_svalidator(A.InsertVerticesSentence)
    def v_insert_v(stmt, pctx):
        for row in stmt.rows:
            if len(row.values) != len(stmt.prop_names):
                raise ValidationError(
                    f"vertex row has {len(row.values)} values for "
                    f"{len(stmt.prop_names)} properties")
        seen_tags = set()
        seen_props = set()
        for tag, names in stmt.tags:
            if tag in seen_tags:
                raise ValidationError(f"duplicate tag `{tag}'")
            seen_tags.add(tag)
            for pn in names:
                if (tag, pn) in seen_props:
                    raise ValidationError(
                        f"duplicate property `{pn}' on tag `{tag}'")
                seen_props.add((tag, pn))
        if not pctx.space:
            return
        for tag, names in stmt.tags:
            if not _has_tag(pctx, tag):
                raise ValidationError(f"tag `{tag}' not found")
            sv = pctx.catalog.get_tag(pctx.space, tag).latest
            have = {p.name for p in sv.props}
            for pn in names:
                if pn not in have:
                    raise ValidationError(
                        f"tag `{tag}' has no property `{pn}'")

    @_svalidator(A.InsertEdgesSentence)
    def v_insert_e(stmt, pctx):
        for row in stmt.rows:
            if len(row.values) != len(stmt.prop_names):
                raise ValidationError(
                    f"edge row has {len(row.values)} values for "
                    f"{len(stmt.prop_names)} properties")
        if not pctx.space:
            return
        if not _has_edge(pctx, stmt.etype):
            raise ValidationError(f"edge `{stmt.etype}' not found")
        sv = pctx.catalog.get_edge(pctx.space, stmt.etype).latest
        have = {p.name for p in sv.props}
        for pn in stmt.prop_names:
            if pn not in have:
                raise ValidationError(
                    f"edge `{stmt.etype}' has no property `{pn}'")

    @_svalidator(A.UpdateSentence)
    def v_update(stmt, pctx):
        if not pctx.space:
            return
        get = _has_edge if stmt.is_edge else _has_tag
        if not get(pctx, stmt.schema_name):
            kind = "edge" if stmt.is_edge else "tag"
            raise ValidationError(
                f"{kind} `{stmt.schema_name}' not found")
        getter = (pctx.catalog.get_edge if stmt.is_edge
                  else pctx.catalog.get_tag)
        sv = getter(pctx.space, stmt.schema_name).latest
        have = {p.name for p in sv.props}
        for pn, _e in stmt.sets:
            if pn not in have:
                raise ValidationError(
                    f"`{stmt.schema_name}' has no property `{pn}'")

    @_svalidator(A.CreateSchemaSentence)
    def v_create_schema(stmt, pctx):
        seen = set()
        for p in stmt.props:
            if p.name in seen:
                raise ValidationError(
                    f"duplicate property `{p.name}'")
            seen.add(p.name)
        if stmt.ttl_col:
            pd = next((p for p in stmt.props if p.name == stmt.ttl_col),
                      None)
            if pd is None:
                raise ValidationError(
                    f"TTL column `{stmt.ttl_col}' does not exist")
            if pd.type_name.upper() not in ("INT", "INT64", "TIMESTAMP"):
                raise ValidationError(
                    f"TTL column `{stmt.ttl_col}' must be "
                    f"int/timestamp typed")

    @_svalidator(A.CreateIndexSentence)
    def v_create_index(stmt, pctx):
        if len(set(stmt.fields)) != len(stmt.fields):
            raise ValidationError("duplicate index field")
        if not pctx.space:
            return
        get = _has_edge if stmt.is_edge else _has_tag
        if not get(pctx, stmt.schema_name):
            kind = "edge" if stmt.is_edge else "tag"
            raise ValidationError(
                f"{kind} `{stmt.schema_name}' not found")
        getter = (pctx.catalog.get_edge if stmt.is_edge
                  else pctx.catalog.get_tag)
        sv = getter(pctx.space, stmt.schema_name).latest
        have = {p.name for p in sv.props}
        for f in stmt.fields:
            if f not in have:
                raise ValidationError(
                    f"`{stmt.schema_name}' has no property `{f}'")

    @_svalidator(A.LimitSentence)
    def v_limit(stmt, pctx):
        if stmt.count is not None and stmt.count < 0:
            raise ValidationError("LIMIT count is negative")
        if getattr(stmt, "offset", None) is not None and stmt.offset < 0:
            raise ValidationError("LIMIT offset is negative")

    @_svalidator(A.DeleteTagsSentence)
    def v_delete_tags(stmt, pctx):
        if not pctx.space:
            return
        for t in stmt.tags:
            if not _has_tag(pctx, t):
                raise ValidationError(f"tag `{t}' not found")

    _GRANTABLE = ("ADMIN", "DBA", "USER", "GUEST")

    def v_role(stmt, pctx):
        r = (stmt.role or "").upper()
        if r == "GOD":
            raise ValidationError(
                "GOD role can not be granted or revoked")
        if r not in _GRANTABLE:
            raise ValidationError(
                f"role `{stmt.role}' does not exist "
                f"(one of {', '.join(_GRANTABLE)})")

    _SENTENCE_VALIDATORS[A.GrantRoleSentence] = v_role
    _SENTENCE_VALIDATORS[A.RevokeRoleSentence] = v_role

    @_svalidator(A.AlterSchemaSentence)
    def v_alter_schema(stmt, pctx):
        """ALTER TAG/EDGE op conformance: DROP/CHANGE name an existing
        property, ADD a new one, TTL column int/timestamp-typed and
        present after the alter (reference: AlterSchema validators)."""
        if not pctx.space:
            return
        getter = (pctx.catalog.get_edge if stmt.is_edge
                  else pctx.catalog.get_tag)
        try:
            sv = getter(pctx.space, stmt.name).latest
        except SchemaError:
            kind = "edge" if stmt.is_edge else "tag"
            raise ValidationError(f"{kind} `{stmt.name}' not found")
        have = {p.name for p in sv.props}
        for n in stmt.drops:
            if n not in have:
                raise ValidationError(
                    f"`{stmt.name}' has no property `{n}' to drop")
            if sv.ttl_col and n == sv.ttl_col and not stmt.ttl_col:
                raise ValidationError(
                    f"`{n}' is the TTL column of `{stmt.name}' — "
                    f"reset TTL_COL before dropping it")
        for p in stmt.changes:
            if p.name not in have:
                raise ValidationError(
                    f"`{stmt.name}' has no property `{p.name}' to change")
        dropped = set(stmt.drops)
        for p in stmt.adds:
            if p.name in have and p.name not in dropped:
                raise ValidationError(
                    f"property `{p.name}' already exists on "
                    f"`{stmt.name}'")
        if stmt.ttl_col:
            # catalog PropDefs carry a PropType enum; AST prop defs a
            # type_name string — normalize both to the spelled type
            after = {p.name: p.ptype.value for p in sv.props
                     if p.name not in dropped}
            after.update({p.name: p.type_name
                          for p in list(stmt.adds) + list(stmt.changes)})
            tn = after.get(stmt.ttl_col)
            if tn is None:
                raise ValidationError(
                    f"TTL column `{stmt.ttl_col}' does not exist")
            if tn.upper() not in ("INT", "INT64", "TIMESTAMP"):
                raise ValidationError(
                    f"TTL column `{stmt.ttl_col}' must be "
                    f"int/timestamp typed")

    @_svalidator(A.DropSchemaSentence)
    def v_drop_schema(stmt, pctx):
        """Reference semantics: a schema with a live index can not be
        dropped — the index must go first."""
        if not pctx.space:
            return
        get = _has_edge if stmt.is_edge else _has_tag
        if not get(pctx, stmt.name):
            return               # IF EXISTS handling stays downstream
        related = list(pctx.catalog.indexes_for(pctx.space, stmt.name,
                                                stmt.is_edge))
        related += list(pctx.catalog.fulltext_indexes_for(
            pctx.space, stmt.name, stmt.is_edge))
        if related:
            kind = "edge" if stmt.is_edge else "tag"
            raise ValidationError(
                f"{kind} `{stmt.name}' has index "
                f"`{related[0].name}' — drop the index first")


_register_sentence_validators()


# ---------------------------------------------------------------------------
# sentence-level validation
# ---------------------------------------------------------------------------


def _exprs_of(stmt) -> list:
    """Expressions a sentence carries, by sentence shape (yield/where)."""
    from . import ast as A
    out = []
    where = getattr(stmt, "where", None)
    if where is not None:
        cond = getattr(where, "filter", where)
        if isinstance(cond, E.Expr):
            out.append(("where", cond))
    yld = getattr(stmt, "yield_", None)
    if yld is not None:
        for c in getattr(yld, "columns", []) or []:
            out.append(("yield", c.expr))
    return out


def validate(stmt, pctx) -> None:
    """Type-deduce every expression the sentence carries; raise
    ValidationError on provable type errors.  Composition sentences
    recurse; statements the deducer has no model for pass through."""
    from . import ast as A
    if isinstance(stmt, A.SeqSentence):
        for sub in stmt.stmts:
            validate(sub, pctx)
        return
    if isinstance(stmt, (A.PipedSentence, A.SetOpSentence)):
        validate(stmt.left, pctx)
        # the right side of a pipe reads $-.cols whose types come from
        # the left's output — deducible only to UNKNOWN; still validate
        # its literal/schema-typed subtrees
        validate(stmt.right, pctx)
        return
    if isinstance(stmt, A.ExplainSentence):
        validate(stmt.stmt, pctx)
        return
    if isinstance(stmt, A.AssignSentence):
        validate(stmt.stmt, pctx)
        return

    sv = _SENTENCE_VALIDATORS.get(type(stmt))
    if sv is not None:
        try:
            sv(stmt, pctx)
        except ValidationError:
            raise
        except Exception:  # noqa: BLE001 — structural checks never block
            pass

    edge_types = ()
    if isinstance(stmt, A.GoSentence) and stmt.over is not None:
        edge_types = tuple(stmt.over.edges or ())
    scope = Scope(pctx, edge_types=edge_types)
    for (_where, ex) in _exprs_of(stmt):
        if not isinstance(stmt, A.MatchSentence) and any(
                x.kind == "pattern_pred" for x in E.walk(ex)):
            raise ValidationError(
                "pattern predicate is only supported in a MATCH "
                "WHERE clause")
        try:
            deduce(ex, scope)
        except ValidationError:
            raise
        except Exception:  # noqa: BLE001 — deduction must never block
            return
