"""Sentence AST — the parser's output vocabulary.

A copy of `nebula_tpu/query/ast.py`: the analog of NebulaGraph's ~90
``Sentence`` classes (src/parser/*.h), trimmed to the supported nGQL
subset and expressed as plain dataclasses.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..core.expr import Expr


class Sentence:
    pass


# ---- composition ----------------------------------------------------------


@dataclass
class SeqSentence(Sentence):
    """stmt; stmt; ..."""
    stmts: List[Sentence]


@dataclass
class PipedSentence(Sentence):
    left: Sentence
    right: Sentence


@dataclass
class AssignSentence(Sentence):
    var: str
    stmt: Sentence


@dataclass
class SetOpSentence(Sentence):
    op: str                      # UNION | UNION ALL | INTERSECT | MINUS
    left: Sentence
    right: Sentence


@dataclass
class ExplainSentence(Sentence):
    stmt: Sentence
    profile: bool = False
    fmt: str = "row"


# ---- clauses --------------------------------------------------------------


@dataclass
class YieldColumn:
    expr: Expr
    alias: Optional[str] = None


@dataclass
class YieldClause:
    columns: List[YieldColumn]
    distinct: bool = False


@dataclass
class FromClause:
    vids: Optional[List[Expr]] = None   # literal/expr vid list
    ref: Optional[Expr] = None          # $-.col or $var.col


@dataclass
class OverClause:
    edges: List[str] = field(default_factory=list)  # empty = OVER *
    direction: str = "out"               # out | in (REVERSELY) | both (BIDIRECT)

    @property
    def is_all(self) -> bool:
        return not self.edges


@dataclass
class StepClause:
    m: int = 1                           # lower bound (GO m TO n STEPS)
    n: int = 1


@dataclass
class WhereClause:
    filter: Expr


@dataclass
class TruncateClause:                    # LIMIT/SAMPLE pushdown in GO
    counts: List[int] = field(default_factory=list)
    is_sample: bool = False


@dataclass
class OrderFactor:
    expr: Expr
    ascending: bool = True


# ---- admin / DDL ----------------------------------------------------------


@dataclass
class UseSentence(Sentence):
    space: str


@dataclass
class CreateSpaceSentence(Sentence):
    name: str
    if_not_exists: bool = False
    partition_num: int = 8
    replica_factor: int = 1
    vid_type: str = "FIXED_STRING(32)"
    comment: str = ""


@dataclass
class DropSpaceSentence(Sentence):
    name: str
    if_exists: bool = False


@dataclass
class PropDefAst:
    name: str
    type_name: str
    fixed_len: int = 0
    nullable: bool = True
    default: Optional[Expr] = None
    comment: str = ""


@dataclass
class CreateSchemaSentence(Sentence):
    is_edge: bool
    name: str
    props: List[PropDefAst]
    if_not_exists: bool = False
    ttl_duration: int = 0
    ttl_col: str = ""
    comment: str = ""


@dataclass
class AlterSchemaSentence(Sentence):
    is_edge: bool
    name: str
    adds: List[PropDefAst] = field(default_factory=list)
    drops: List[str] = field(default_factory=list)
    changes: List[PropDefAst] = field(default_factory=list)
    ttl_duration: Optional[int] = None
    ttl_col: Optional[str] = None


@dataclass
class DropSchemaSentence(Sentence):
    is_edge: bool
    name: str
    if_exists: bool = False


@dataclass
class DescribeSentence(Sentence):
    kind: str                            # space | tag | edge | index
    name: str


@dataclass
class ShowSentence(Sentence):
    kind: str                            # spaces|tags|edges|hosts|parts|stats|...
    extra: Any = None


@dataclass
class CreateIndexSentence(Sentence):
    is_edge: bool
    index_name: str
    schema_name: str
    fields: List[str]
    if_not_exists: bool = False
    # per-field string prefix length, 0 = full value (reference:
    # CREATE TAG INDEX i ON t(name(10)))
    field_lens: List[int] = field(default_factory=list)


@dataclass
class DropIndexSentence(Sentence):
    is_edge: bool
    index_name: str
    if_exists: bool = False


@dataclass
class RebuildIndexSentence(Sentence):
    is_edge: bool
    index_name: str


@dataclass
class CreateSpaceAsSentence(Sentence):
    name: str
    source: str
    if_not_exists: bool = False


@dataclass
class CreateFulltextIndexSentence(Sentence):
    is_edge: bool
    index_name: str
    schema_name: str
    field: str
    if_not_exists: bool = False


@dataclass
class DropFulltextIndexSentence(Sentence):
    index_name: str
    if_exists: bool = False


@dataclass
class RebuildFulltextIndexSentence(Sentence):
    index_name: Optional[str] = None     # None → all


@dataclass
class AddListenerSentence(Sentence):
    ltype: str                           # ELASTICSEARCH
    endpoints: List[str]


@dataclass
class RemoveListenerSentence(Sentence):
    ltype: str


@dataclass
class SubmitJobSentence(Sentence):
    job: str                             # balance data | balance leader | compact | stats | ingest


@dataclass
class ShowJobsSentence(Sentence):
    job_id: Optional[int] = None


@dataclass
class CreateSnapshotSentence(Sentence):
    pass


@dataclass
class DropSnapshotSentence(Sentence):
    name: str


@dataclass
class CreateBackupSentence(Sentence):
    name: Optional[str] = None


@dataclass
class DropBackupSentence(Sentence):
    name: str = ""


@dataclass
class RestoreBackupSentence(Sentence):
    name: str = ""


@dataclass
class KillQuerySentence(Sentence):
    session_id: Optional[int] = None
    plan_id: Optional[int] = None


# ---- DML ------------------------------------------------------------------


@dataclass
class VertexRowAst:
    vid: Expr
    values: List[Expr]


@dataclass
class InsertVerticesSentence(Sentence):
    # tag groups: [(tag_name, [prop, ...]), ...] — the reference grammar
    # allows INSERT VERTEX t1(a, b), t2(c) VALUES v:(x, y, z) with the
    # value list spanning the groups in order
    tags: list
    rows: List[VertexRowAst]
    if_not_exists: bool = False

    @property
    def prop_names(self) -> List[str]:
        return [n for _, ns in self.tags for n in ns]


@dataclass
class EdgeRowAst:
    src: Expr
    dst: Expr
    rank: int
    values: List[Expr]


@dataclass
class InsertEdgesSentence(Sentence):
    etype: str
    prop_names: List[str]
    rows: List[EdgeRowAst]
    if_not_exists: bool = False


@dataclass
class DeleteVerticesSentence(Sentence):
    vids: FromClause
    with_edge: bool = False


@dataclass
class EdgeKeyAst:
    src: Expr
    dst: Expr
    rank: int = 0


@dataclass
class DeleteEdgesSentence(Sentence):
    etype: str
    keys: List[EdgeKeyAst]
    ref: Optional[Tuple[Expr, Expr, Optional[Expr]]] = None  # src,dst,rank pipe refs


@dataclass
class DeleteTagsSentence(Sentence):
    tags: List[str]                     # empty = all (*)
    vids: FromClause


@dataclass
class AddHostsSentence(Sentence):
    hosts: list
    zone: str


@dataclass
class DropHostsSentence(Sentence):
    hosts: list


@dataclass
class DropZoneSentence(Sentence):
    zone: str


@dataclass
class MergeZoneSentence(Sentence):
    zones: List[str]
    into: str


@dataclass
class RenameZoneSentence(Sentence):
    old: str
    new: str


@dataclass
class DivideZoneSentence(Sentence):
    zone: str
    parts: list            # [(new_zone_name, [host, ...]), ...]


@dataclass
class DescZoneSentence(Sentence):
    zone: str


@dataclass
class ClearSpaceSentence(Sentence):
    name: str
    if_exists: bool = False


@dataclass
class StopJobSentence(Sentence):
    job_id: int


@dataclass
class RecoverJobSentence(Sentence):
    job_id: Optional[int] = None        # None = all failed jobs


@dataclass
class KillSessionSentence(Sentence):
    session_id: int


@dataclass
class GetConfigsSentence(Sentence):
    name: Optional[str] = None          # None = all (== SHOW CONFIGS)


@dataclass
class SignInTextServiceSentence(Sentence):
    endpoints: List[str]
    user: Optional[str] = None
    password: Optional[str] = None


@dataclass
class SignOutTextServiceSentence(Sentence):
    pass


@dataclass
class DescribeUserSentence(Sentence):
    name: str


@dataclass
class AlterSpaceSentence(Sentence):
    name: str
    op: str                             # add_zone
    zone: str


@dataclass
class DownloadSentence(Sentence):
    """DOWNLOAD HDFS "url" — the legacy bulk-load pipeline's fetch leg
    (always errors here: no HDFS offline; the surface exists for grammar
    parity)."""
    url: str


@dataclass
class IngestSentence(Sentence):
    """INGEST — the legacy bulk-load pipeline's apply leg (canonicalized
    to the ingest job)."""
    pass


@dataclass
class CreateUserSentence(Sentence):
    name: str
    password: str
    if_not_exists: bool = False


@dataclass
class DropUserSentence(Sentence):
    name: str
    if_exists: bool = False


@dataclass
class AlterUserSentence(Sentence):
    name: str
    password: str


@dataclass
class ChangePasswordSentence(Sentence):
    name: str
    old: str
    new: str


@dataclass
class GrantRoleSentence(Sentence):
    role: str
    space: str
    user: str


@dataclass
class RevokeRoleSentence(Sentence):
    role: str
    space: str
    user: str


@dataclass
class UpdateConfigsSentence(Sentence):
    # [(name, value_expr), ...] — UPDATE CONFIGS a = 1, b = 2 applies
    # atomically through Config.set_dynamic_many (all-or-nothing)
    updates: list


@dataclass
class UpdateSentence(Sentence):
    is_edge: bool
    schema_name: str
    vid: Optional[Expr] = None           # vertex target
    edge_key: Optional[EdgeKeyAst] = None
    sets: List[Tuple[str, Expr]] = field(default_factory=list)
    when: Optional[Expr] = None
    yield_: Optional[YieldClause] = None
    insertable: bool = False             # UPSERT


# ---- queries --------------------------------------------------------------


@dataclass
class GoSentence(Sentence):
    steps: StepClause
    from_: FromClause
    over: OverClause
    where: Optional[WhereClause] = None
    yield_: Optional[YieldClause] = None
    truncate: Optional[TruncateClause] = None


@dataclass
class FetchVerticesSentence(Sentence):
    tags: List[str]                      # empty = * (all tags)
    vids: FromClause
    yield_: Optional[YieldClause] = None


@dataclass
class FetchEdgesSentence(Sentence):
    etype: str
    keys: List[EdgeKeyAst]
    ref: Optional[Tuple[Expr, Expr, Optional[Expr]]] = None
    yield_: Optional[YieldClause] = None


@dataclass
class LookupSentence(Sentence):
    schema_name: str
    where: Optional[WhereClause] = None
    yield_: Optional[YieldClause] = None


@dataclass
class FindPathSentence(Sentence):
    kind: str                            # shortest | all | noloop
    from_: FromClause = None
    to: FromClause = None
    over: OverClause = None
    where: Optional[WhereClause] = None
    upto: int = 5
    with_prop: bool = False
    yield_: Optional[YieldClause] = None


@dataclass
class SubgraphSentence(Sentence):
    steps: int
    from_: FromClause
    in_edges: List[str] = field(default_factory=list)
    out_edges: List[str] = field(default_factory=list)
    both_edges: List[str] = field(default_factory=list)
    all_edges: bool = False
    where: Optional[WhereClause] = None
    with_prop: bool = False
    yield_: Optional[YieldClause] = None


@dataclass
class CallAlgoSentence(Sentence):
    """CALL algo.<func>(name=value, ...) [YIELD col [AS alias], ...]
    — the graph-analytics plane statement.  Parameter
    values are constant expressions (literals), evaluated at plan
    time."""
    module: str
    func: str
    params: Dict[str, Expr] = field(default_factory=dict)
    yield_: Optional[YieldClause] = None


@dataclass
class YieldSentence(Sentence):
    yield_: YieldClause
    where: Optional[WhereClause] = None


# pipe segments
@dataclass
class GroupBySentence(Sentence):
    keys: List[Expr]
    yield_: YieldClause = None


@dataclass
class OrderBySentence(Sentence):
    factors: List[OrderFactor]


@dataclass
class LimitSentence(Sentence):
    offset: int
    count: int


@dataclass
class SampleSentence(Sentence):
    count: int


# ---- MATCH ----------------------------------------------------------------


@dataclass
class NodePattern:
    alias: Optional[str] = None
    labels: List[Tuple[str, Optional[Dict[str, Expr]]]] = field(default_factory=list)
    props: Optional[Dict[str, Expr]] = None


@dataclass
class EdgePattern:
    alias: Optional[str] = None
    types: List[str] = field(default_factory=list)
    direction: str = "out"               # out | in | both
    min_hop: int = 1
    max_hop: int = 1                     # -1 = unbounded (*)
    props: Optional[Dict[str, Expr]] = None


@dataclass
class PathPattern:
    alias: Optional[str] = None          # p = (a)-[e]->(b)
    nodes: List[NodePattern] = field(default_factory=list)
    edges: List[EdgePattern] = field(default_factory=list)


def pattern_text(pat: "PathPattern") -> str:
    """Canonical source rendering of a path pattern — the to_text form of
    a pattern-predicate expression (EXPLAIN output, expr equality)."""
    from ..core.expr import to_text

    def props_text(props):
        return "{" + ", ".join(f"{k}: {to_text(v)}" for k, v in props.items()) + "}"

    def node_text(np: NodePattern) -> str:
        s = np.alias if np.alias and not np.alias.startswith("__anon_") else ""
        for lbl, lprops in np.labels:
            s += f":{lbl}"
            if lprops:
                s += props_text(lprops)
        if np.props:
            s += props_text(np.props)
        return f"({s})"

    out = [node_text(pat.nodes[0])]
    for ep, np in zip(pat.edges, pat.nodes[1:]):
        e = ep.alias if ep.alias and not ep.alias.startswith("__anon_") else ""
        if ep.types:
            e += ":" + "|".join(ep.types)
        if ep.min_hop != 1 or ep.max_hop != 1:
            e += "*"
            if ep.max_hop == -1:
                e += f"{ep.min_hop}.." if ep.min_hop != 1 else ""
            elif ep.min_hop == ep.max_hop:
                e += str(ep.min_hop)
            else:
                e += f"{ep.min_hop}..{ep.max_hop}"
        if ep.props:
            e += props_text(ep.props)
        body = f"[{e}]" if e else ""
        arrow = {"out": f"-{body}->", "in": f"<-{body}-",
                 "both": f"-{body}-"}[ep.direction]
        out.append(arrow)
        out.append(node_text(np))
    return "".join(out)


@dataclass
class MatchClauseAst:
    patterns: List[PathPattern]
    where: Optional[Expr] = None
    optional: bool = False


@dataclass
class UnwindClauseAst:
    expr: Expr
    alias: str = ""


@dataclass
class WithClauseAst:
    columns: List[YieldColumn] = None
    distinct: bool = False
    where: Optional[Expr] = None
    order_by: List[OrderFactor] = field(default_factory=list)
    skip: int = 0
    limit: int = -1


@dataclass
class ReturnClauseAst:
    columns: Optional[List[YieldColumn]] = None   # None = RETURN *
    distinct: bool = False
    order_by: List[OrderFactor] = field(default_factory=list)
    skip: int = 0
    limit: int = -1


@dataclass
class MatchSentence(Sentence):
    clauses: List[Any]                   # Match/Unwind/With clause asts in order
    return_: ReturnClauseAst = None
