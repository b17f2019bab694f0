"""The port's copy of `nebula_tpu/query/plan.py`, whole.

PlanNode layer — the optimizer/executor boundary.

This boundary is kept deliberately close to the reference's PlanNode
vocabulary (reference: src/graph/planner/plan/*.h) because it is the plugin seam the TPU backend hooks
into: `TpuTraverseRule` rewrites ExpandAll/Traverse(+Filter…) chains into
a fused `TpuTraverse` node, exactly as the north star prescribes.

One generic dataclass with a `kind` string + typed helper constructors —
60 subclasses would buy nothing in Python; golden-plan tests assert on
kind sequences, executors dispatch on kind.

Node kinds (grouped):
  control : Start, Loop, Argument, PassThrough
  explore : ExpandAll, Traverse, AppendVertices, GetVertices, GetEdges,
            ScanVertices, ScanEdges, IndexScan, TpuTraverse (tpu/)
  query   : Filter, Project, Aggregate, Dedup, Sort, TopN, Limit, Sample,
            Unwind, DataCollect, HashInnerJoin, HashLeftJoin, CrossJoin,
            Union, Intersect, Minus
  algo    : ShortestPath, AllPaths, Subgraph
  mutate  : InsertVertices, InsertEdges, Delete*, Update
  admin   : the DDL/SHOW/DESC/etc. one-shot nodes
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_ids = itertools.count()


@dataclass
class PlanNode:
    kind: str
    deps: List["PlanNode"] = field(default_factory=list)
    args: Dict[str, Any] = field(default_factory=dict)
    col_names: List[str] = field(default_factory=list)
    output_var: str = ""
    input_vars: List[str] = field(default_factory=list)
    id: int = field(default_factory=lambda: next(_ids))

    def __post_init__(self):
        if not self.output_var:
            self.output_var = f"__{self.kind}_{self.id}"
        if not self.input_vars and self.deps:
            self.input_vars = [d.output_var for d in self.deps]

    def dep(self, i: int = 0) -> "PlanNode":
        return self.deps[i]

    # -- description (EXPLAIN / golden-plan tests) --
    def describe(self, indent: int = 0) -> str:
        from ..core.expr import Expr, to_text
        pad = "  " * indent
        bits = []
        for k, v in self.args.items():
            if v is None or v == [] or v == {}:
                continue
            if isinstance(v, Expr):
                bits.append(f"{k}={to_text(v)}")
            elif isinstance(v, list) and v and isinstance(v[0], Expr):
                bits.append(f"{k}=[{', '.join(to_text(x) for x in v)}]")
            else:
                r = repr(v)
                if len(r) > 160:
                    # compiled-program args (TpuMatchPipeline segment
                    # lists) would swamp EXPLAIN — elide the body
                    r = r[:150] + f"…+{len(r) - 150}ch"
                bits.append(f"{k}={r}")
        line = f"{pad}{self.kind}#{self.id}"
        if bits:
            line += " {" + ", ".join(bits) + "}"
        if self.col_names:
            line += f" -> {self.col_names}"
        out = [line]
        for d in self.deps:
            out.append(d.describe(indent + 1))
        return "\n".join(out)

    def kind_tree(self) -> List[str]:
        """Flattened kinds, depth-first — golden-plan assertion target."""
        out = [self.kind]
        for d in self.deps:
            out.extend(d.kind_tree())
        return out


@dataclass
class ExecutionPlan:
    root: PlanNode
    space: Optional[str] = None

    def describe(self, fmt: str = "row") -> str:
        if fmt == "dot":
            return self.describe_dot()
        return self.root.describe()

    def describe_dot(self) -> str:
        """Graphviz rendering of the plan DAG (reference: EXPLAIN
        FORMAT=\"dot\")."""
        def esc(t: str) -> str:
            return t.replace("\\", "\\\\").replace('"', '\\"')

        lines = ["digraph exec_plan {", "  rankdir=BT;"]
        for n in walk_plan(self.root):
            label = n.kind + (f"\\n{esc(str(n.col_names))}"
                              if n.col_names else "")
            lines.append(f'  n{n.id} [label="{label}#{n.id}", '
                         f"shape=box];")
        for n in walk_plan(self.root):
            for d in n.deps:
                lines.append(f"  n{d.id} -> n{n.id};")
        lines.append("}")
        return "\n".join(lines)


# -- walk/transform helpers used by the optimizer ---------------------------


def walk_plan(node: PlanNode, seen=None):
    if seen is None:
        seen = set()
    if node.id in seen:
        return
    seen.add(node.id)
    yield node
    for d in node.deps:
        yield from walk_plan(d, seen)


def transform_plan(node: PlanNode, fn, memo: Optional[Dict[int, PlanNode]] = None) -> PlanNode:
    """Bottom-up rewrite; fn(node) returns a replacement or None to keep.
    Shared sub-DAGs are rewritten once (memo keyed by node id)."""
    if memo is None:
        memo = {}
    if node.id in memo:
        return memo[node.id]
    new_deps = [transform_plan(d, fn, memo) for d in node.deps]
    if new_deps != node.deps:
        node.deps = new_deps
        node.input_vars = [d.output_var for d in new_deps]
    r = fn(node)
    out = r if r is not None else node
    memo[node.id] = out
    return out
