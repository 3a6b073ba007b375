"""Logical plan nodes (counterpart of `spark_tpu/plan/logical.py`, the nodes
the port's DataFrame API builds): LocalRelation, Project, Filter,
Aggregate and Repartition."""

from __future__ import annotations

from typing import Any, Sequence

from ..errors import AnalysisException
from ..expr.expressions import Alias, AttributeReference, Expression
from .tree import TreeNode

__all__ = [
    "LogicalPlan", "LeafNode", "UnaryNode", "LocalRelation", "Project",
    "Filter", "Aggregate", "Repartition",
]


class LogicalPlan(TreeNode):
    @property
    def output(self) -> list[AttributeReference]:
        raise NotImplementedError(type(self).__name__)

    @property
    def resolved(self) -> bool:
        return self.expressions_resolved and all(c.resolved for c in self.children)

    @property
    def expressions_resolved(self) -> bool:
        return all(e.resolved for e in self.expressions())

    def expressions(self) -> list[Expression]:
        """All expressions directly held by this node."""
        out = []
        for k, v in self.__dict__.items():
            if k in self.child_fields:
                continue
            if isinstance(v, Expression):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                out.extend(x for x in v if isinstance(x, Expression))
        return out

    def map_expressions(self, f) -> "LogicalPlan":
        changed = False
        overrides: dict[str, Any] = {}
        for k, v in self.__dict__.items():
            if k in self.child_fields or k.startswith("_"):
                continue
            if isinstance(v, Expression):
                nv = f(v)
                if nv is not v:
                    changed = True
                overrides[k] = nv
            elif isinstance(v, (list, tuple)) and any(isinstance(x, Expression) for x in v):
                nl = [f(x) if isinstance(x, Expression) else x for x in v]
                if any(a is not b for a, b in zip(nl, v)):
                    changed = True
                overrides[k] = type(v)(nl) if isinstance(v, tuple) else nl
        return self.copy(**overrides) if changed else self

    def transform_expressions(self, rule) -> "LogicalPlan":
        return self.map_expressions(lambda e: e.transform_up(rule))

    def input_attrs(self) -> list[AttributeReference]:
        out = []
        for c in self.children:
            out.extend(c.output)
        return out


class LeafNode(LogicalPlan):
    child_fields = ()


class UnaryNode(LogicalPlan):
    child_fields = ("child",)

    @property
    def output(self) -> list[AttributeReference]:
        return self.child.output


class LocalRelation(LeafNode):
    """In-memory rows (a pyarrow.Table)."""

    def __init__(self, attrs: list[AttributeReference], table):
        self.attrs = attrs
        self.table = table

    @property
    def output(self):
        return self.attrs

    def _data_args(self):
        return (("ids", tuple(a.expr_id for a in self.attrs)),)


class Project(UnaryNode):
    def __init__(self, project_list: Sequence[Expression], child: LogicalPlan):
        self.project_list = list(project_list)
        self.child = child

    @property
    def output(self):
        out = []
        for e in self.project_list:
            if isinstance(e, Alias):
                out.append(e.to_attribute())
            elif isinstance(e, AttributeReference):
                out.append(e)
            else:
                raise AnalysisException(
                    f"project expression needs alias: {e.simple_string()}")
        return out


class Filter(UnaryNode):
    def __init__(self, condition: Expression, child: LogicalPlan):
        self.condition = condition
        self.child = child


class Aggregate(UnaryNode):
    """grouping_exprs + aggregate_exprs (the output list mixing grouping
    attrs and Alias(AggregateFunction))."""

    def __init__(self, grouping_exprs: Sequence[Expression],
                 aggregate_exprs: Sequence[Expression], child: LogicalPlan):
        self.grouping_exprs = list(grouping_exprs)
        self.aggregate_exprs = list(aggregate_exprs)
        self.child = child

    @property
    def output(self):
        out = []
        for e in self.aggregate_exprs:
            if isinstance(e, Alias):
                out.append(e.to_attribute())
            elif isinstance(e, AttributeReference):
                out.append(e)
            else:
                raise AnalysisException(
                    f"aggregate expression needs alias: {e.simple_string()}")
        return out


class Repartition(UnaryNode):
    def __init__(self, num_partitions: int | None, shuffle: bool,
                 partition_exprs: Sequence[Expression], child: LogicalPlan):
        self.num_partitions = num_partitions
        self.shuffle = shuffle
        self.partition_exprs = list(partition_exprs)
        self.child = child
