"""Logical plan nodes (counterpart of `spark_tpu/plan/logical.py`, the nodes
the port's DataFrame API and SQL parser build): UnresolvedRelation,
LogicalRelation (a data source), LocalRelation, OneRowRelation,
RangeRelation, SubqueryAlias, WithCTE, Project, Filter, Aggregate,
Distinct, Sort, Limit, Offset, Repartition, Window, GroupingSets, Join,
UsingJoin and Union, with the reference's crude row-count estimates (`stats_rows`)
that decide broadcast joins."""

from __future__ import annotations

from typing import Any, Sequence

from ..errors import AnalysisException
from ..expr.expressions import (
    Alias, AttributeReference, Expression, SortOrder,
)
from ..types import int64
from .tree import TreeNode

__all__ = [
    "LogicalPlan", "LeafNode", "UnaryNode", "BinaryNode", "LocalRelation",
    "LogicalRelation", "OneRowRelation", "RangeRelation",
    "UnresolvedRelation", "SubqueryAlias", "WithCTE", "Project", "Filter",
    "Aggregate", "Distinct", "Sort", "Limit", "Offset",
    "Repartition", "Window", "GroupingSets", "Join", "UsingJoin", "Union",
    "Generate", "normalize_join_type",
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

    def stats_rows(self) -> int | None:
        """Crude row-count estimate (the reference's, kept as is: it
        decides broadcast against shuffled joins)."""
        ests = [c.stats_rows() for c in self.children]
        if any(e is None for e in ests):
            return None
        return sum(ests) if ests else None


class LeafNode(LogicalPlan):
    child_fields = ()


class UnaryNode(LogicalPlan):
    child_fields = ("child",)

    @property
    def output(self) -> list[AttributeReference]:
        return self.child.output


class UnresolvedRelation(LeafNode):
    """A table name the analyzer looks up in the session catalog."""

    def __init__(self, name_parts: Sequence[str]):
        self.name_parts = tuple(name_parts)

    @property
    def name(self) -> str:
        return ".".join(self.name_parts)

    @property
    def resolved(self) -> bool:
        return False

    @property
    def output(self):
        raise AnalysisException(f"unresolved relation {self.name}")


class LogicalRelation(LeafNode):
    """A resolved data source (`io/sources.py`): its schema, splits and
    estimated rows."""

    def __init__(self, source, attrs: list[AttributeReference],
                 name: str = ""):
        self.source = source
        self.attrs = attrs
        self.name = name

    @property
    def output(self):
        return self.attrs

    def _data_args(self):
        return (("name", self.name),
                ("ids", tuple(a.expr_id for a in self.attrs)))

    def stats_rows(self):
        return getattr(self.source, "estimated_rows", None)

    def simple_string(self):
        return f"Relation[{self.name}]({', '.join(a.name for a in self.attrs)})"


class OneRowRelation(LeafNode):
    """SELECT without FROM: one row of no columns."""

    @property
    def output(self):
        return []

    def stats_rows(self):
        return 1


class RangeRelation(LeafNode):
    """spark.range(): int64 `id` from start to end (exclusive) by step."""

    def __init__(self, start: int, end: int, step: int, num_partitions: int,
                 attr: AttributeReference | None = None):
        self.start = start
        self.end = end
        self.step = step
        self.num_partitions = num_partitions
        self.attr = attr or AttributeReference("id", int64, nullable=False)

    @property
    def output(self):
        return [self.attr]

    def stats_rows(self):
        return max(0, (self.end - self.start + self.step - 1) // self.step)


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

    def stats_rows(self):
        return self.table.num_rows


class SubqueryAlias(UnaryNode):
    """A relation alias: its output attributes carry the alias as their
    qualifier, so `alias.column` resolves."""

    def __init__(self, alias: str, child: LogicalPlan):
        self.alias = alias
        self.child = child

    @property
    def output(self):
        return [AttributeReference(a.name, a.dtype, a.nullable, a.expr_id,
                                   qualifier=(self.alias,))
                for a in self.child.output]

    def stats_rows(self):
        return self.child.stats_rows()


class WithCTE(UnaryNode):
    """The top of a query whose CTEs the parser chose to materialise
    rather than inline: `materializations` is [(unique name, plan)] in
    definition order, and `child` reads each by its unique name. The
    session runs each plan once and splices the result in as an in-memory
    relation (the reference's WithCTE)."""

    def __init__(self, materializations, child: LogicalPlan):
        self.materializations = list(materializations)
        self.child = child

    @property
    def output(self):
        return self.child.output


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

    def stats_rows(self):
        return self.child.stats_rows()


class Filter(UnaryNode):
    def __init__(self, condition: Expression, child: LogicalPlan):
        self.condition = condition
        self.child = child

    def stats_rows(self):
        r = self.child.stats_rows()
        return None if r is None else max(1, r // 4)


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

    def stats_rows(self):
        r = self.child.stats_rows()
        if not self.grouping_exprs:
            return 1
        return None if r is None else max(1, r // 10)


class Sort(UnaryNode):
    def __init__(self, orders: Sequence[SortOrder], is_global: bool,
                 child: LogicalPlan):
        self.orders = list(orders)
        self.is_global = is_global
        self.child = child

    def stats_rows(self):
        return self.child.stats_rows()


class Limit(UnaryNode):
    def __init__(self, n: int, child: LogicalPlan):
        self.n = n
        self.child = child

    def stats_rows(self):
        r = self.child.stats_rows()
        return self.n if r is None else min(self.n, r)


class Offset(UnaryNode):
    def __init__(self, n: int, child: LogicalPlan):
        self.n = n
        self.child = child


class Distinct(UnaryNode):
    """SELECT DISTINCT and UNION's duplicate removal (the optimizer's
    ReplaceDistinct turns it into an Aggregate over every column)."""

    def __init__(self, child: LogicalPlan):
        self.child = child


class Repartition(UnaryNode):
    def __init__(self, num_partitions: int | None, shuffle: bool,
                 partition_exprs: Sequence[Expression], child: LogicalPlan):
        self.num_partitions = num_partitions
        self.shuffle = shuffle
        self.partition_exprs = list(partition_exprs)
        self.child = child


class Window(UnaryNode):
    """Window operator: window_exprs are Alias(WindowExpression) appended
    to the child's output; one node per (partition, order) spec."""

    def __init__(self, window_exprs: Sequence[Expression],
                 partition_spec: Sequence[Expression],
                 order_spec: Sequence[SortOrder], child: LogicalPlan):
        self.window_exprs = list(window_exprs)
        self.partition_spec = list(partition_spec)
        self.order_spec = list(order_spec)
        self.child = child

    @property
    def output(self):
        return self.child.output + [e.to_attribute() for e in self.window_exprs]


class GroupingSets(UnaryNode):
    """GROUP BY ROLLUP/CUBE/GROUPING SETS, rewritten after resolution into
    a Union of Aggregates (ExpandGroupingSets). `sets` holds indices into
    grouping_exprs, so resolution sees one expression list."""

    def __init__(self, sets: Sequence[Sequence[int]],
                 grouping_exprs: Sequence[Expression],
                 aggregate_exprs: Sequence[Expression], child: LogicalPlan):
        self.sets = [list(s) for s in sets]
        self.grouping_exprs = list(grouping_exprs)
        self.aggregate_exprs = list(aggregate_exprs)
        self.child = child

    @property
    def output(self):
        return Aggregate(self.grouping_exprs, self.aggregate_exprs,
                         self.child).output


class BinaryNode(LogicalPlan):
    child_fields = ("left", "right")


def normalize_join_type(jt: str) -> str:
    s = jt.lower().replace("_", "").replace(" ", "")
    mapping = {
        "inner": "inner", "cross": "cross",
        "left": "left_outer", "leftouter": "left_outer",
        "right": "right_outer", "rightouter": "right_outer",
        "full": "full_outer", "fullouter": "full_outer", "outer": "full_outer",
        "semi": "left_semi", "leftsemi": "left_semi",
        "anti": "left_anti", "leftanti": "left_anti",
    }
    if s not in mapping:
        raise AnalysisException(f"unsupported join type {jt}")
    return mapping[s]


class UsingJoin(BinaryNode):
    """JOIN ... USING (c1, ...) before resolution: ResolveUsingJoin
    (plan/analyzer.py) rewrites it into an equi Join and a projection that
    emits each using column once."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 join_type: str, using_cols: list):
        self.left = left
        self.right = right
        self.join_type = normalize_join_type(join_type)
        self.using_cols = list(using_cols)

    @property
    def resolved(self):
        return False    # always rewritten by ResolveUsingJoin

    @property
    def output(self):
        raise AnalysisException(
            f"unresolved USING join on {self.using_cols}")


class Join(BinaryNode):
    def __init__(self, left: LogicalPlan, right: LogicalPlan, join_type: str,
                 condition: Expression | None):
        self.left = left
        self.right = right
        self.join_type = normalize_join_type(join_type)
        self.condition = condition

    @property
    def output(self):
        jt = self.join_type
        if jt in ("left_semi", "left_anti"):
            return self.left.output
        lo = self.left.output
        ro = self.right.output
        if jt in ("right_outer", "full_outer"):
            lo = [a.with_nullability(True) for a in lo]
        if jt in ("left_outer", "full_outer"):
            ro = [a.with_nullability(True) for a in ro]
        return lo + ro

    def stats_rows(self):
        l = self.left.stats_rows()
        r = self.right.stats_rows()
        if l is None or r is None:
            return None
        return max(l, r)


class PythonEval(UnaryNode):
    """Append host-evaluated Python UDF columns (the logical shadow of
    Spark's ArrowEvalPythonExec)."""

    def __init__(self, udf_aliases: Sequence[Expression], child: LogicalPlan):
        self.udf_aliases = list(udf_aliases)
        self.child = child

    @property
    def output(self):
        return self.child.output + [a.to_attribute() for a in self.udf_aliases]


class Generate(UnaryNode):
    """Row generator (the reference's Generate over Explode): appends the
    generator's element column, each input row repeated once per element
    of its array (none for an empty or NULL array)."""

    def __init__(self, generator: Expression, element_attr,
                 child: LogicalPlan):
        self.generator = generator  # an array attribute, or split(col, d)
        self.element_attr = element_attr
        self.child = child

    @property
    def output(self):
        return self.child.output + [self.element_attr]


class Intersect(BinaryNode):
    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 is_all: bool = False):
        self.left = left
        self.right = right
        self.is_all = is_all

    @property
    def output(self):
        return self.left.output


class Except(BinaryNode):
    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 is_all: bool = False):
        self.left = left
        self.right = right
        self.is_all = is_all

    @property
    def output(self):
        return self.left.output


class Union(LogicalPlan):
    """UNION ALL of positionally matched branches: the first branch names
    the output, and a column is nullable where any branch's is."""

    child_fields = ("children_plans",)

    def __init__(self, children_plans: Sequence[LogicalPlan]):
        self.children_plans = list(children_plans)

    @property
    def output(self):
        first = self.children_plans[0].output
        nullables = [any(c.output[i].nullable for c in self.children_plans)
                     for i in range(len(first))]
        return [a.with_nullability(n) for a, n in zip(first, nullables)]
