"""Logical optimizer (counterpart of `spark_tpu/plan/optimizer.py`): the
rule framework (plan/tree.py's RuleExecutor), the reference's batch layout,
and the rules that change the plans the port's DataFrame API and SQL
slices build: subquery-alias elimination, grouping sets as a union of
aggregates, DISTINCT as an aggregate, the
subquery rewrites into joins (plan/subquery.py, after the structural rules
ran inside each subquery's plan), filter combination and pushdown (through
projects, aggregates and unions and into join sides), filter-into-join
merging, greedy join reordering of inner-join chains (comma-list FROMs),
constant folding, boolean and cast simplification, filter pruning,
empty-relation propagation, union flattening, IsNotNull inference on
inner-join keys, limit combination, project collapsing and column pruning
(through Window nodes too), INTERSECT/EXCEPT as a semi/anti join plus
DISTINCT, count(DISTINCT) as two aggregates, and the Python UDF batch:
host-only expressions (concat over string columns, casts to string,
date_format) become host UDFs that PythonEval evaluates over Arrow."""

from __future__ import annotations

import datetime
import math
from typing import Sequence

from ..errors import NotPortedError
from ..expr.expressions import (
    Add, AggregateFunction, Alias, And, AttributeReference, Cast, Divide,
    EqualTo, Expression, GreaterThan, GreaterThanOrEqual, Grouping,
    GroupingID, IsNotNull, LessThan, LessThanOrEqual, Literal, Multiply, Not,
    NotEqualTo, Or, Remainder, SortOrder, Subtract, UnaryMinus,
)
from ..types import NullType
from .logical import (
    Aggregate, Distinct, Filter, GroupingSets, Join, Limit, LocalRelation,
    LogicalPlan, LogicalRelation, Offset, Project, Repartition, Sort,
    SubqueryAlias, Union, Window,
)
from .tree import Batch, FixedPoint, Once, Rule, RuleExecutor

__all__ = ["Optimizer", "split_conjuncts", "join_conjuncts",
           "substitute_attrs"]


def split_conjuncts(e: Expression) -> list[Expression]:
    if isinstance(e, And):
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def join_conjuncts(es: Sequence[Expression]) -> Expression | None:
    out = None
    for e in es:
        out = e if out is None else And(out, e)
    return out


def substitute_attrs(e: Expression, mapping: dict[int, Expression]) -> Expression:
    def rule(x):
        if isinstance(x, AttributeReference) and x.expr_id in mapping:
            return mapping[x.expr_id]
        return x

    return e.transform_up(rule)


def alias_map(project_list: Sequence[Expression]) -> dict[int, Expression]:
    return {e.expr_id: e.child for e in project_list if isinstance(e, Alias)}


# ---------------------------------------------------------------------------
# Constant folding
# ---------------------------------------------------------------------------

def const_value(e: Expression):
    """Evaluate a literal-only expression on the host. Returns (ok, value)."""
    if isinstance(e, Literal):
        return True, e.value
    if isinstance(e, Cast):
        ok, v = const_value(e.child)
        if not ok:
            return False, None
        try:
            return True, _py_cast(v, e.to, e.explicit)
        except Exception:
            return False, None
    if isinstance(e, UnaryMinus):
        ok, v = const_value(e.child)
        return (True, -v) if ok and v is not None else (ok, None)
    if isinstance(e, Not):
        ok, v = const_value(e.child)
        return (True, (not v) if v is not None else None) if ok \
            else (False, None)
    binops = {
        Add: lambda a, b: a + b, Subtract: lambda a, b: a - b,
        Multiply: lambda a, b: a * b,
        Divide: lambda a, b: a / b if b else None,
        # as the reference folds it: in doubles, so a % b of two integers
        # folds to a whole double the literal's integral type reads back
        Remainder: lambda a, b: math.fmod(a, b) if b else None,
        EqualTo: lambda a, b: a == b, NotEqualTo: lambda a, b: a != b,
        LessThan: lambda a, b: a < b, LessThanOrEqual: lambda a, b: a <= b,
        GreaterThan: lambda a, b: a > b,
        GreaterThanOrEqual: lambda a, b: a >= b,
    }
    for cls, fn in binops.items():
        if type(e) is cls:
            ok1, a = const_value(e.left)
            ok2, b = const_value(e.right)
            if not (ok1 and ok2):
                return False, None
            if a is None or b is None:
                return True, None
            try:
                return True, fn(a, b)
            except Exception:
                return False, None
    return False, None


def _py_cast(v, to, explicit: bool = False):
    from ..types import (
        BooleanType, DateType, DecimalType, FractionalType, IntegralType,
        StringType, TimestampType,
    )

    if v is None:
        return None
    if isinstance(to, IntegralType):
        return int(v)
    if isinstance(to, DecimalType):
        # fold to an exact Decimal at the target scale
        import decimal as _d

        dv = v if isinstance(v, _d.Decimal) else _d.Decimal(str(v))
        q = dv.quantize(_d.Decimal(1).scaleb(-to.scale),
                        rounding=_d.ROUND_HALF_UP)
        if (explicit or isinstance(v, (float, _d.Decimal))) and \
                abs(q.scaleb(to.scale)) >= 10 ** to.precision:
            return None  # past the precision: NULL, as cast_val gives
        return q
    if isinstance(to, FractionalType):
        return float(v)
    if isinstance(to, BooleanType):
        return bool(v)
    if isinstance(to, StringType):
        return str(v)
    if isinstance(to, DateType):
        if isinstance(v, str):
            return datetime.date.fromisoformat(v.strip()[:10])
        return v
    if isinstance(to, TimestampType):
        if isinstance(v, str):
            return datetime.datetime.fromisoformat(v.strip())
        return v
    raise ValueError


class ConstantFolding(Rule):
    def apply(self, plan):
        def fold(e: Expression) -> Expression:
            if isinstance(e, Literal) or not e.resolved:
                return e
            if isinstance(e, (AggregateFunction, Alias, AttributeReference,
                              SortOrder)):
                return e
            if any(isinstance(c, AttributeReference) for c in e.iter_nodes()):
                return e
            ok, v = const_value(e)
            if ok:
                try:
                    dt = e.dtype
                    if isinstance(dt, NullType) and v is not None:
                        return Literal(v)
                    return Literal(v, dt) if v is not None \
                        else Literal(None, dt)
                except Exception:
                    return e
            return e

        def rule(node):
            if node.expressions_resolved:
                return node.transform_expressions(fold)
            return node

        return plan.transform_up(rule)


class BooleanSimplification(Rule):
    def apply(self, plan):
        t = lambda e: isinstance(e, Literal) and e.value is True  # noqa: E731
        f = lambda e: isinstance(e, Literal) and e.value is False  # noqa: E731

        def split_disjuncts(e: Expression) -> list[Expression]:
            if isinstance(e, Or):
                return split_disjuncts(e.left) + split_disjuncts(e.right)
            return [e]

        def simp(e: Expression) -> Expression:
            if isinstance(e, And):
                if t(e.left):
                    return e.right
                if t(e.right):
                    return e.left
                if f(e.left) or f(e.right):
                    return Literal(False)
            if isinstance(e, Or):
                if f(e.left):
                    return e.right
                if f(e.right):
                    return e.left
                if t(e.left) or t(e.right):
                    return Literal(True)
                # common-factor extraction: (a && b) || (a && c) =>
                # a && (b || c)
                branches = [split_conjuncts(b) for b in split_disjuncts(e)]
                if len(branches) > 1:
                    common = [c for c in branches[0]
                              if all(any(c.semantic_equals(x) for x in b)
                                     for b in branches[1:])]
                    if common:
                        residuals = []
                        for b in branches:
                            rest = [x for x in b
                                    if not any(x.semantic_equals(c)
                                               for c in common)]
                            residuals.append(join_conjuncts(rest) or
                                             Literal(True))
                        out = join_conjuncts(common)
                        if not any(t(r) for r in residuals):
                            disj = residuals[0]
                            for r in residuals[1:]:
                                disj = Or(disj, r)
                            out = And(out, disj)
                        return out
            if isinstance(e, Not):
                if t(e.child):
                    return Literal(False)
                if f(e.child):
                    return Literal(True)
                if isinstance(e.child, Not):
                    return e.child.child
            return e

        def rule(node):
            if node.expressions_resolved:
                return node.transform_expressions(simp)
            return node

        return plan.transform_up(rule)


class SimplifyCasts(Rule):
    def apply(self, plan):
        def simp(e):
            if isinstance(e, Cast) and e.child.resolved and \
                    e.child.dtype == e.to:
                return e.child
            return e

        def rule(node):
            if node.expressions_resolved:
                return node.transform_expressions(simp)
            return node

        return plan.transform_up(rule)


class CombineFilters(Rule):
    def apply(self, plan):
        def rule(node):
            if isinstance(node, Filter) and isinstance(node.child, Filter):
                return Filter(And(node.child.condition, node.condition),
                              node.child.child)
            return node

        return plan.transform_up(rule)


class PushDownPredicates(Rule):
    """Push filters through Project and Aggregate (grouping-only
    conjuncts) and into Join sides."""

    def apply(self, plan):
        def rule(node):
            if not isinstance(node, Filter):
                return node
            child = node.child
            if isinstance(child, Project):
                if any(isinstance(e, AggregateFunction)
                       for pe in child.project_list
                       for e in pe.iter_nodes()):
                    return node
                new_cond = substitute_attrs(node.condition,
                                            alias_map(child.project_list))
                return Project(child.project_list,
                               Filter(new_cond, child.child))
            if isinstance(child, Union):
                return Union([
                    Filter(_remap_union_cond(node.condition, child, i), c)
                    for i, c in enumerate(child.children_plans)])
            if isinstance(child, Join):
                return self._push_into_join(node, child)
            if isinstance(child, Aggregate):
                return self._push_through_aggregate(node, child)
            return node

        return plan.transform_up(rule)

    @staticmethod
    def _push_through_aggregate(node: Filter, child: Aggregate):
        out_to_group: dict[int, Expression] = {}
        for e in child.aggregate_exprs:
            if isinstance(e, Alias):
                out_to_group[e.expr_id] = e.child
            elif isinstance(e, AttributeReference):
                out_to_group[e.expr_id] = e
        child_ids = {a.expr_id for a in child.child.output}
        pushable, kept = [], []
        for c in split_conjuncts(node.condition):
            mapped = substitute_attrs(c, out_to_group)
            if any(isinstance(x, AggregateFunction)
                   for x in mapped.iter_nodes()):
                kept.append(c)
            elif mapped.references() <= child_ids and \
                    _only_grouping_refs(mapped, child):
                pushable.append(mapped)
            else:
                kept.append(c)
        if not pushable:
            return node
        new_agg = child.copy(child=Filter(join_conjuncts(pushable),
                                          child.child))
        return Filter(join_conjuncts(kept), new_agg) if kept else new_agg

    @staticmethod
    def _push_into_join(filt: Filter, join: Join):
        left_ids = {a.expr_id for a in join.left.output}
        right_ids = {a.expr_id for a in join.right.output}
        left_push, right_push, kept = [], [], []
        jt = join.join_type
        for c in split_conjuncts(filt.condition):
            refs = c.references()
            if refs and refs <= left_ids and jt in (
                    "inner", "left_outer", "left_semi", "left_anti", "cross"):
                left_push.append(c)
            elif refs and refs <= right_ids and jt in (
                    "inner", "right_outer", "cross"):
                right_push.append(c)
            else:
                kept.append(c)
        if not left_push and not right_push:
            return filt
        new_left = Filter(join_conjuncts(left_push), join.left) \
            if left_push else join.left
        new_right = Filter(join_conjuncts(right_push), join.right) \
            if right_push else join.right
        new_join = join.copy(left=new_left, right=new_right)
        if kept:
            return Filter(join_conjuncts(kept), new_join)
        return new_join


def _only_grouping_refs(e: Expression, agg: Aggregate) -> bool:
    group_ids = {g.expr_id for g in agg.grouping_exprs
                 if isinstance(g, AttributeReference)}

    def ok(x):
        if isinstance(x, AttributeReference):
            return x.expr_id in group_ids or any(
                g.semantic_equals(x) for g in agg.grouping_exprs)
        return all(ok(c) for c in x.children)

    return ok(e)


def _remap_union_cond(cond: Expression, union: Union, i: int) -> Expression:
    m = {a.expr_id: b
         for a, b in zip(union.output, union.children_plans[i].output)}
    return substitute_attrs(cond, m)


class RewriteHostOnlyExpressions(Rule):
    """Expressions with no device form become vectorized host UDFs (Spark's
    analog: expressions lacking codegen fall back to interpreted eval; here
    the fallback is the Arrow-UDF path):
      * concat/concat_ws over 2+ string COLUMNS (dictionary products are
        unbounded);
      * cast(non-string AS string) (value universe unknown host-side);
      * date_format and format_number."""

    def apply(self, plan):
        import numpy as np

        from ..expr.expressions import (
            Cast, Concat, ConcatWs, DateFormat, FormatNumber, Literal,
        )
        from ..expr.pyudf import PythonUDF
        from ..types import DateType, StringType, TimestampType, string

        def to_str_fn(dt):
            import datetime

            if isinstance(dt, DateType):
                return lambda a: np.array(
                    [(datetime.date(1970, 1, 1)
                      + datetime.timedelta(days=int(v))).isoformat()
                     for v in a], dtype=object)
            if isinstance(dt, TimestampType):
                return lambda a: np.array(
                    [(datetime.datetime(1970, 1, 1)
                      + datetime.timedelta(microseconds=int(v))).isoformat(
                          sep=" ")
                     for v in a], dtype=object)
            return lambda a: np.array([_fmt_num(v) for v in a], dtype=object)

        def fix(e: Expression) -> Expression:
            if isinstance(e, DateFormat):
                import datetime

                strf = DateFormat.to_strftime(e.fmt)
                is_ts = isinstance(e.child.dtype, TimestampType)

                def fmt_fn(a, _strf=strf, _ts=is_ts):
                    out = []
                    for v in a:
                        if v is None:
                            out.append(None)
                        elif _ts:
                            out.append((datetime.datetime(1970, 1, 1)
                                        + datetime.timedelta(
                                            microseconds=int(v)))
                                       .strftime(_strf))
                        else:
                            out.append((datetime.date(1970, 1, 1)
                                        + datetime.timedelta(days=int(v)))
                                       .strftime(_strf))
                    return np.array(out, dtype=object)

                return PythonUDF(fmt_fn, [e.child], string,
                                 name="date_format", vectorized=True)
            if isinstance(e, FormatNumber):
                return PythonUDF(e.format_fn(), [e.child], string,
                                 name="format_number")
            if isinstance(e, (Concat, ConcatWs)):
                cols = [a for a in e.args if not isinstance(a, Literal)]
                if len(cols) >= 2:
                    sep = e.sep if isinstance(e, ConcatWs) else ""

                    def concat_fn(*arrays, _sep=sep):
                        out = []
                        for vals in zip(*arrays):
                            if any(v is None for v in vals):
                                out.append(None)
                            else:
                                out.append(_sep.join(str(v) for v in vals))
                        return np.array(out, dtype=object)

                    return PythonUDF(concat_fn, list(e.args), string,
                                     name="concat")
            if isinstance(e, Cast) and isinstance(e.to, StringType) and \
                    e.child.resolved and \
                    not isinstance(e.child.dtype, StringType):
                return PythonUDF(to_str_fn(e.child.dtype), [e.child],
                                 string, name="cast_str")
            return e

        def rule(node):
            if node.expressions_resolved:
                return node.transform_expressions(
                    lambda ex: ex.transform_up(fix))
            return node

        return plan.transform_up(rule)


def _fmt_num(v):
    if v is None:
        return None
    if isinstance(v, float):
        return repr(v)
    import numpy as _np

    if isinstance(v, _np.floating):
        return repr(float(v))
    if isinstance(v, (bool, _np.bool_)):
        return str(bool(v)).lower()
    return str(v)


class ExtractPythonUDFs(Rule):
    """Pull PythonUDFs out of projections/filters into PythonEval operators
    (Spark's ExtractPythonUDFs)."""

    def apply(self, plan):
        from ..expr.pyudf import PythonUDF
        from .logical import PythonEval

        def rule(node):
            if not isinstance(node, (Project, Filter)):
                return node
            if not any(isinstance(x, PythonUDF)
                       for e in node.expressions()
                       for x in e.iter_nodes()):
                return node
            collected: list[Alias] = []

            def extract(x: Expression) -> Expression:
                if isinstance(x, PythonUDF):
                    al = Alias(x, f"_pyudf{len(collected)}")
                    collected.append(al)
                    return al.to_attribute()
                return x

            new_node = node.map_expressions(
                lambda e: e.transform_up(extract))
            child = PythonEval(collected, node.child)
            new_node = new_node.copy(child=child)
            if isinstance(new_node, Filter):
                return Project(list(node.output), new_node)
            return new_node

        return plan.transform_up(rule)


class MergeFilterIntoJoin(Rule):
    """Filter over a cross/inner Join: its conjuncts over both sides become
    join condition (turns `a.join(b).filter(a.k == b.k)` into an equi
    join)."""

    def apply(self, plan):
        def rule(node):
            if isinstance(node, Filter) and isinstance(node.child, Join) and \
                    node.child.join_type in ("inner", "cross"):
                join = node.child
                lids = {a.expr_id for a in join.left.output}
                rids = {a.expr_id for a in join.right.output}
                both, keep = [], []
                for c in split_conjuncts(node.condition):
                    refs = c.references()
                    (both if refs & lids and refs & rids else keep).append(c)
                if not both:
                    return node
                cond = join.condition
                for c in both:
                    cond = c if cond is None else And(cond, c)
                new_join = Join(join.left, join.right, "inner", cond)
                if keep:
                    return Filter(join_conjuncts(keep), new_join)
                return new_join
            return node

        return plan.transform_up(rule)


class InferFiltersFromJoinKeys(Rule):
    """Add IsNotNull on the nullable keys of an inner equi join, so each
    side drops null keys before it is shuffled or broadcast."""

    def apply(self, plan):
        def rule(node):
            if isinstance(node, Join) and node.join_type == "inner" and \
                    node.condition is not None and node.resolved:
                left_ids = {a.expr_id for a in node.left.output}
                right_ids = {a.expr_id for a in node.right.output}
                lnew, rnew = [], []
                for c in split_conjuncts(node.condition):
                    if not isinstance(c, EqualTo):
                        continue
                    for side in (c.left, c.right):
                        if isinstance(side, AttributeReference) and \
                                side.nullable:
                            if side.expr_id in left_ids:
                                lnew.append(IsNotNull(side))
                            elif side.expr_id in right_ids:
                                rnew.append(IsNotNull(side))
                nl, nr = node.left, node.right
                if lnew and not _already_filtered(nl, lnew):
                    nl = Filter(join_conjuncts(lnew), nl)
                if rnew and not _already_filtered(nr, rnew):
                    nr = Filter(join_conjuncts(rnew), nr)
                if nl is not node.left or nr is not node.right:
                    return node.copy(left=nl, right=nr)
            return node

        return plan.transform_down(rule)


def _already_filtered(p: LogicalPlan, conds: list[Expression]) -> bool:
    existing: list[Expression] = []
    q = p
    while isinstance(q, Filter):
        existing.extend(split_conjuncts(q.condition))
        q = q.child
    return all(any(c.semantic_equals(e) for e in existing) for c in conds)


class ColumnPruning(Rule):
    """One top-down pass narrowing projects and aggregates to the columns
    required above them, with a Project over each join side that carries
    columns nobody above reads."""

    def apply(self, plan):
        required = {a.expr_id for a in plan.output}
        return _collapse_adjacent_projects(self._prune(plan, required))

    def _prune(self, node: LogicalPlan, required: set[int]) -> LogicalPlan:
        if isinstance(node, Project):
            new_list = [e for e in node.project_list
                        if _out_id(e) in required] or node.project_list[:1]
            child_req: set[int] = set()
            for e in new_list:
                child_req |= e.references()
            return Project(new_list, self._prune(node.child, child_req))
        if isinstance(node, Aggregate):
            new_aggs = [e for e in node.aggregate_exprs
                        if _out_id(e) in required] \
                or node.aggregate_exprs[:1]
            child_req = set()
            for e in list(node.grouping_exprs) + new_aggs:
                child_req |= e.references()
            return Aggregate(node.grouping_exprs, new_aggs,
                             self._prune(node.child, child_req))
        if isinstance(node, (Filter, Sort, Limit, Offset, Repartition,
                             Distinct, SubqueryAlias)):
            child_req = set(required)
            for e in node.expressions():
                child_req |= e.references()
            if isinstance(node, Distinct):
                child_req |= {a.expr_id for a in node.child.output}
            new_child = self._prune(node.child, child_req)
            if new_child is not node.child:
                return node.copy(child=new_child)
            return node
        if isinstance(node, Join):
            cond_refs = node.condition.references() \
                if node.condition is not None else set()
            lids = {a.expr_id for a in node.left.output}
            rids = {a.expr_id for a in node.right.output}
            nl = self._prune_side(node.left, (required | cond_refs) & lids)
            nr = self._prune_side(node.right, (required | cond_refs) & rids)
            if nl is not node.left or nr is not node.right:
                return node.copy(left=nl, right=nr)
            return node
        if isinstance(node, LogicalRelation):
            # the scan reads only these columns from its files
            keep = [a for a in node.attrs if a.expr_id in required] \
                or node.attrs[:1]
            if len(keep) != len(node.attrs):
                return node.copy(attrs=keep)
            return node
        if isinstance(node, Window):
            child_req = {a.expr_id for a in node.child.output}
            for e in node.expressions():
                child_req |= e.references()
            return node.copy(child=self._prune(node.child, child_req))
        # Union (positional), LocalRelation and other leaves: conservative
        return node.map_children(
            lambda c: self._prune(c, {a.expr_id for a in c.output}))

    def _prune_side(self, side: LogicalPlan, req: set[int]) -> LogicalPlan:
        if {a.expr_id for a in side.output} - req:
            keep = [a for a in side.output if a.expr_id in req] \
                or side.output[:1]
            return Project(keep, self._prune(side, set(req)))
        return self._prune(side, req)


def _out_id(e: Expression) -> int | None:
    if isinstance(e, (Alias, AttributeReference)):
        return e.expr_id
    return None


def _collapse_adjacent_projects(plan: LogicalPlan) -> LogicalPlan:
    def rule(node):
        if isinstance(node, Project) and isinstance(node.child, Project):
            m = alias_map(node.child.project_list)
            new_list = []
            for e in node.project_list:
                sub = substitute_attrs(
                    e.child if isinstance(e, Alias) else e, m)
                if isinstance(e, AttributeReference) and \
                        isinstance(sub, AttributeReference) and \
                        sub.expr_id == e.expr_id:
                    new_list.append(sub)
                else:  # keep the outer name and id
                    new_list.append(Alias(sub, e.name, e.expr_id))
            return Project(new_list, node.child.child)
        return node

    return plan.transform_up(rule)


class ReorderJoins(Rule):
    """Greedy left-deep reordering of inner-join chains by estimated row
    counts (the reference's: plan/stats.py `estimate`): seed with the
    cheapest connected pair, then repeatedly attach the cheapest relation
    connected to the rows already joined by an equality (by any predicate
    only when none is). A pair's or a step's cost is the product of the
    rows divided by the largest ndv of its connecting equi keys, which
    only ANALYZE TABLE gives; without it the cost is the product.
    Fires on Filter(Join) too: a comma-list FROM parses as a cross-join
    chain under one Filter holding every WHERE conjunct; multi-table
    conjuncts become join conditions, single-table ones stay in the
    Filter."""

    def apply(self, plan):
        from .stats import Statistics, estimate

        def rule(node):
            filter_conds: list[Expression] = []
            join = node
            if isinstance(node, Filter) and isinstance(node.child, Join):
                filter_conds = split_conjuncts(node.condition)
                join = node.child
            if not isinstance(join, Join) or \
                    join.join_type not in ("inner", "cross"):
                return node
            items: list[LogicalPlan] = []
            conds: list[Expression] = []

            def flatten(n):
                if isinstance(n, Join) and n.join_type in ("inner", "cross"):
                    flatten(n.left)
                    flatten(n.right)
                    if n.condition is not None:
                        conds.extend(split_conjuncts(n.condition))
                else:
                    items.append(n)

            flatten(join)
            if len(items) <= 2:
                return node
            single_table: list[Expression] = []
            if filter_conds:
                item_ids = [{a.expr_id for a in it.output} for it in items]
                for c in filter_conds:
                    refs = c.references()
                    touched = sum(1 for ids in item_ids if refs & ids)
                    (conds if touched >= 2 else single_table).append(c)
            if not conds:
                # a condition-less (pure cross) chain: nothing to gain
                return node

            ests = {}
            istats: dict[int, Statistics] = {}
            for it in items:
                st = estimate(it)
                istats[id(it)] = st
                ests[id(it)] = float("inf") if st.row_count is None \
                    else st.row_count
            remaining = list(items)

            def _key(x):  # deterministic tie-break: a stable fixpoint
                out0 = x.output[0].expr_id if x.output else 0
                return (ests[id(x)], out0)

            def _ndv_denom(cd, stats_of) -> int:
                denom = 1
                for side in (cd.left, cd.right):
                    if isinstance(side, AttributeReference):
                        for st in stats_of:
                            cs = st.get(side.name.lower())
                            if cs is not None and cs.distinct_count:
                                denom = max(denom, cs.distinct_count)
                return denom

            def _pair_cost(a, b) -> float:
                ra, rb = ests[id(a)], ests[id(b)]
                if ra == float("inf") or rb == float("inf"):
                    return float("inf")
                aids = {x.expr_id for x in a.output}
                bids = {x.expr_id for x in b.output}
                denom, connected = 1, False
                for cd in conds:
                    refs = cd.references()
                    if not (refs and refs <= (aids | bids)
                            and refs & aids and refs & bids):
                        continue
                    connected = True
                    if isinstance(cd, EqualTo):
                        denom = max(denom, _ndv_denom(
                            cd, (istats[id(a)].col_stats,
                                 istats[id(b)].col_stats)))
                return (ra * rb) / denom if connected else float("inf")

            best, best_cost = None, float("inf")
            for i, a in enumerate(items):
                for b in items[i + 1:]:
                    c = _pair_cost(a, b)
                    if c < best_cost:
                        best, best_cost = (a, b), c
            cur = min(best, key=_key) if best is not None \
                else min(remaining, key=_key)
            remaining.remove(cur)
            joined_ids = {a.expr_id for a in cur.output}
            unused = list(conds)
            result = cur
            cur_rows = ests[id(cur)]
            cur_colstats = dict(istats[id(cur)].col_stats)

            def _joined_rows(cand) -> float:
                """|result join cand|: the product over the largest ndv of
                the connecting equi keys (a candidate's own statistics
                first, then those joined so far)."""
                crows = ests[id(cand)]
                if cur_rows == float("inf") or crows == float("inf"):
                    return crows
                cstats = istats[id(cand)].col_stats
                cids = {a.expr_id for a in cand.output}
                denom = 1
                for cd in unused:
                    if not isinstance(cd, EqualTo):
                        continue
                    refs = cd.references()
                    if not (refs and refs <= (joined_ids | cids)
                            and refs & joined_ids and refs & cids):
                        continue
                    for side in (cd.left, cd.right):
                        if isinstance(side, AttributeReference):
                            cs = (cstats.get(side.name.lower())
                                  or cur_colstats.get(side.name.lower()))
                            if cs is not None and cs.distinct_count:
                                denom = max(denom, cs.distinct_count)
                return (cur_rows * crows) / max(denom, 1)

            while remaining:
                def connects(cand, equi_only: bool):
                    cids = {a.expr_id for a in cand.output}
                    for cd in unused:
                        if equi_only and not isinstance(cd, EqualTo):
                            continue
                        refs = cd.references()
                        if refs and refs <= (joined_ids | cids) \
                                and refs & joined_ids and refs & cids:
                            return True
                    return False

                cands = [r for r in remaining if connects(r, True)] or \
                    [r for r in remaining if connects(r, False)]
                pool = cands or remaining
                pick = min(pool, key=lambda x: (_joined_rows(x), _key(x)))
                remaining.remove(pick)
                cur_rows = _joined_rows(pick)
                cur_colstats.update(istats[id(pick)].col_stats)
                joined_ids |= {a.expr_id for a in pick.output}
                applicable = [cd for cd in unused
                              if cd.references() <= joined_ids]
                for cd in applicable:
                    unused.remove(cd)
                result = Join(result, pick, "inner",
                              join_conjuncts(applicable))
            leftover = unused + single_table
            if leftover:
                result = Filter(join_conjuncts(leftover), result)
            if [a.expr_id for a in result.output] != \
                    [a.expr_id for a in node.output]:
                result = Project(list(node.output), result)
            return result

        return plan.transform_up(rule)


class EliminateSubqueryAliases(Rule):
    """Once resolution is done, aliases are noise (the reference runs this
    first in the optimizer)."""

    def apply(self, plan):
        def rule(node):
            if isinstance(node, SubqueryAlias):
                return node.child
            return node

        return plan.transform_up(rule)


def _empty_table(attrs):
    import pyarrow as pa

    from ..types import to_arrow_type

    return pa.table(
        {a.name: pa.array([], type=to_arrow_type(a.dtype)) for a in attrs}
        if attrs else {"__dummy": pa.array([], pa.int32())})


class PruneFilters(Rule):
    def apply(self, plan):
        def rule(node):
            if isinstance(node, Filter) and isinstance(node.condition,
                                                       Literal):
                if node.condition.value is True:
                    return node.child
                return LocalRelation(list(node.output),
                                     _empty_table(node.output))
            return node

        return plan.transform_up(rule)


class PropagateEmptyRelation(Rule):
    """Empty local relations collapse the operators above them, and empty
    union branches drop out (reference: PropagateEmptyRelation)."""

    def apply(self, plan):
        def is_empty(p: LogicalPlan) -> bool:
            return isinstance(p, LocalRelation) and p.table.num_rows == 0

        def empty_of(node: LogicalPlan) -> LogicalPlan:
            return LocalRelation(list(node.output), _empty_table(node.output))

        def rule(node):
            if isinstance(node, (Filter, Sort, Limit, Offset, Repartition)) \
                    and is_empty(node.child):
                return empty_of(node)
            if isinstance(node, Project) and is_empty(node.child) and \
                    node.resolved:
                return empty_of(node)
            if isinstance(node, Join) and node.resolved:
                if node.join_type in ("inner", "cross", "left_semi") and \
                        (is_empty(node.left) or is_empty(node.right)):
                    return empty_of(node)
                if node.join_type in ("left_outer", "left_anti") and \
                        is_empty(node.left):
                    return empty_of(node)
            if isinstance(node, Union) and node.resolved:
                alive = [c for c in node.children_plans if not is_empty(c)]
                if not alive:
                    return empty_of(node)
                if len(alive) < len(node.children_plans):
                    if len(alive) == 1:
                        # keep the union's output ids, positionally
                        return Project(
                            [Alias(b, a.name, a.expr_id)
                             for a, b in zip(node.output, alive[0].output)],
                            alive[0])
                    return Union(alive)
            return node

        return plan.transform_up(rule)


class ReplaceDistinct(Rule):
    def apply(self, plan):
        def rule(node):
            if isinstance(node, Distinct):
                out = node.child.output
                return Aggregate(list(out), list(out), node.child)
            return node

        return plan.transform_up(rule)


class CombineUnions(Rule):
    """Flatten nested unions into one."""

    def apply(self, plan):
        def rule(node):
            if isinstance(node, Union) and any(
                    isinstance(c, Union) for c in node.children_plans):
                flat: list[LogicalPlan] = []
                for c in node.children_plans:
                    if isinstance(c, Union):
                        flat.extend(c.children_plans)
                    else:
                        flat.append(c)
                return Union(flat)
            return node

        return plan.transform_up(rule)


class CollapseProjects(Rule):
    def apply(self, plan):
        return _collapse_adjacent_projects(plan)


class RemoveNoopProject(Rule):
    def apply(self, plan):
        def rule(node):
            if isinstance(node, Project):
                child_out = node.child.output
                if len(node.project_list) == len(child_out) and all(
                        isinstance(e, AttributeReference) and
                        e.expr_id == a.expr_id and e.name == a.name
                        for e, a in zip(node.project_list, child_out)):
                    return node.child
            return node

        return plan.transform_up(rule)


class CombineLimits(Rule):
    def apply(self, plan):
        def rule(node):
            if isinstance(node, Limit) and isinstance(node.child, Limit):
                return Limit(min(node.n, node.child.n), node.child.child)
            return node

        return plan.transform_up(rule)


class OptimizeSubqueryPlans(Rule):
    """Apply structural rules inside subquery expression plans (a DISTINCT
    inside an IN subquery must become an aggregate before the subquery
    becomes a join)."""

    def __init__(self, rules):
        self.rules = rules

    def apply(self, plan):
        from .subquery import map_subquery_plans

        def optimize(p):
            p = self.apply(p)  # nested subqueries first
            for r in self.rules:
                p = r.apply(p)
            return p

        return plan.transform_up(lambda node: map_subquery_plans(node,
                                                                 optimize))


class RewriteModeAggregate(Rule):
    """mode(v) [GROUP BY g] -> per-value counts, a max-count self-join,
    and a min-value tie-break: three plain aggregates and one equi join
    (the reference's rewrite), so mode runs on the ordinary aggregate and
    join operators. Deterministic on ties (smallest value wins). A mode
    beside another aggregate, over an expression, or over two columns is
    refused, as the reference refuses it."""

    def apply(self, plan):
        from ..errors import UnsupportedOperationError
        from ..expr.expressions import Count, EqualNullSafe, Max, Min, Mode

        def rule(node):
            if not isinstance(node, Aggregate) or not node.resolved:
                return node
            modes = [x for e in node.aggregate_exprs
                     for x in e.iter_nodes() if isinstance(x, Mode)]
            if not modes:
                return node
            grouping = list(node.grouping_exprs)
            if not all(isinstance(g, AttributeReference)
                       for g in grouping):
                raise UnsupportedOperationError(
                    "mode() requires plain grouping columns")
            other_aggs = [x for e in node.aggregate_exprs
                          for x in e.iter_nodes()
                          if isinstance(x, AggregateFunction)
                          and not isinstance(x, Mode)]
            args = {m.child.expr_id for m in modes
                    if isinstance(m.child, AttributeReference)}
            if other_aggs or len(args) != 1 or \
                    not all(isinstance(m.child, AttributeReference)
                            for m in modes):
                raise UnsupportedOperationError(
                    "mode() needs a plain column argument and cannot "
                    "mix with other aggregates or a second mode column")
            v = modes[0].child

            # 1. count per (grouping, value); NULL values count 0, so
            #    they only win when the group is all-NULL: Mode ignores
            #    nulls, and an all-null group's mode is NULL
            c_alias = Alias(Count(v), "__mode_c")
            counts = Aggregate(grouping + [v],
                               grouping + [v, c_alias], node.child)
            c_attr = c_alias.to_attribute()

            # 2. max count per grouping, over an id-independent copy of
            #    the counts subtree (it appears on both join sides)
            from .subquery import _fresh_plan

            mapping: dict = {}
            counts2 = _fresh_plan(counts, mapping)
            g2 = [mapping.get(g.expr_id, g) for g in grouping]
            c2 = mapping.get(c_attr.expr_id, c_attr)
            mc_alias = Alias(Max(c2), "__mode_mc")
            maxc = Aggregate(list(g2), list(g2) + [mc_alias], counts2)
            mc_attr = mc_alias.to_attribute()

            cond: Expression = EqualTo(c_attr, mc_attr)
            for g, gg in zip(grouping, g2):
                # null-safe: a NULL grouping key is a real group and
                # must survive the self-join
                cond = And(cond, EqualNullSafe(g, gg))
            joined = Join(counts, maxc, "inner", cond)

            # 3. tie-break: smallest winning value, then PROJECT the
            #    original output expressions with every Mode node
            #    substituted: covers mode() under aliases, arithmetic,
            #    or scalar functions, with output ids preserved
            mv_alias = Alias(Min(v), "__mode_val")
            final = Aggregate(grouping,
                              grouping + [mv_alias], joined)
            mv_attr = mv_alias.to_attribute()

            def sub(x):
                return mv_attr if isinstance(x, Mode) else x

            out_exprs = [e.transform_up(sub)
                         for e in node.aggregate_exprs]
            return Project(out_exprs, final)

        return plan.transform_up(rule)


class RewriteDistinctAggregates(Rule):
    """count(DISTINCT x) [GROUP BY g] -> two-level aggregation: inner
    Aggregate(g, x) dedups, outer counts. Mixed with plain aggregates, the
    two kinds aggregate apart and join back on the grouping keys (a cross
    join of two one-row aggregates without them). DISTINCT over two
    different expressions is refused, as the reference refuses it."""

    def apply(self, plan):
        from ..expr.expressions import Count

        def rule(node):
            if not isinstance(node, Aggregate) or not node.resolved:
                return node
            distincts = []
            others = []
            for e in node.aggregate_exprs:
                for x in e.iter_nodes():
                    if isinstance(x, AggregateFunction):
                        if getattr(x, "distinct", False):
                            distincts.append(x)
                        else:
                            others.append(x)
            if not distincts:
                return node
            if others:
                return self._rewrite_mixed(node, distincts)
            first_child = distincts[0].child
            if any(not d.child.semantic_equals(first_child)
                   for d in distincts[1:]):
                from ..errors import UnsupportedOperationError

                raise UnsupportedOperationError(
                    "multiple DISTINCT aggregates on different expressions "
                    "are not supported yet")

            # inner: dedup (g..., x)
            inner_group: list[Expression] = []
            inner_outs: list[Expression] = []
            group_attr: list[tuple[Expression, AttributeReference]] = []
            for i, g in enumerate(node.grouping_exprs):
                if isinstance(g, AttributeReference):
                    inner_group.append(g)
                    inner_outs.append(g)
                    group_attr.append((g, g))
                else:
                    al = Alias(g, f"_g{i}")
                    inner_group.append(g)
                    inner_outs.append(al)
                    group_attr.append((g, al.to_attribute()))
            if isinstance(first_child, AttributeReference):
                x_attr = first_child
                inner_outs.append(first_child)
            else:
                xal = Alias(first_child, "_dx")
                x_attr = xal.to_attribute()
                inner_outs.append(xal)
            inner = Aggregate(inner_group + [first_child], inner_outs,
                              node.child)

            # outer: original outputs with fn(distinct x) -> fn(x)
            def fix(e: Expression) -> Expression:
                if isinstance(e, AggregateFunction) and \
                        getattr(e, "distinct", False):
                    if isinstance(e, Count):
                        return Count(x_attr, distinct=False)
                    out = e.copy(child=x_attr)
                    out.distinct = False
                    return out
                for g, a in group_attr:
                    if e.semantic_equals(g):
                        return a
                return e

            outer_group = [a for _, a in group_attr]
            outer_outs = []
            for e in node.aggregate_exprs:
                if isinstance(e, Alias):
                    outer_outs.append(
                        Alias(e.child.transform_up(fix), e.name, e.expr_id))
                else:
                    outer_outs.append(e.transform_up(fix))
            return Aggregate(outer_group, outer_outs, inner)

        return plan.transform_up(rule)

    def _rewrite_mixed(self, node: Aggregate, distincts):
        """Mixed DISTINCT + plain aggregates: split into two aggregates over
        the same child and join them back on the grouping keys (the
        reference uses a single Expand; the join formulation reuses existing
        operators). Null-safe key equality keeps null-keyed groups."""
        from ..expr.expressions import AggregateFunction as AF

        # grouping attrs for both sides (aliased when complex)
        def key_aliases(suffix: str):
            outs, attrs = [], []
            for i, g in enumerate(node.grouping_exprs):
                al = Alias(g, f"_k{suffix}{i}")
                outs.append(al)
                attrs.append(al.to_attribute())
            return outs, attrs

        nd_keys, nd_attrs = key_aliases("n")
        d_keys, d_attrs = key_aliases("d")

        nd_funcs, d_funcs = [], []
        for e in node.aggregate_exprs:
            for x in e.iter_nodes():
                if isinstance(x, AF):
                    bucket = d_funcs if getattr(x, "distinct", False) \
                        else nd_funcs
                    if not any(x.semantic_equals(f) for f in bucket):
                        bucket.append(x)

        nd_aliases = [Alias(f, f"_nd{i}") for i, f in enumerate(nd_funcs)]
        d_aliases = [Alias(f, f"_d{i}") for i, f in enumerate(d_funcs)]

        nd_agg = Aggregate(node.grouping_exprs, nd_keys + nd_aliases,
                           node.child)
        d_agg = Aggregate(node.grouping_exprs, d_keys + d_aliases,
                          node.child)
        # recursively rewrite the distinct side (now distinct-only)
        d_agg = self.apply(d_agg)

        if node.grouping_exprs:
            cond = None
            for l, r in zip(nd_attrs, d_attrs):
                for c in _null_safe_eq_conjuncts(l, r):
                    cond = c if cond is None else And(cond, c)
            joined = Join(nd_agg, d_agg, "inner", cond)
        else:
            joined = Join(nd_agg, d_agg, "cross", None)

        nd_map = {id(f): a.to_attribute() for f, a in zip(nd_funcs, nd_aliases)}
        d_map = list(zip(d_funcs, [a.to_attribute() for a in d_aliases]))
        g_map = list(zip(node.grouping_exprs, nd_attrs))

        def fix(x: Expression) -> Expression:
            if isinstance(x, AF):
                if getattr(x, "distinct", False):
                    for f, a in d_map:
                        if x.semantic_equals(f):
                            return a
                else:
                    for f, a in zip(nd_funcs,
                                    [al.to_attribute() for al in nd_aliases]):
                        if x.semantic_equals(f):
                            return a
            for g, a in g_map:
                if x.semantic_equals(g):
                    return a
            return x

        outs = []
        for e in node.aggregate_exprs:
            if isinstance(e, Alias):
                outs.append(Alias(e.child.transform_up(fix), e.name,
                                  e.expr_id))
            elif isinstance(e, AttributeReference):
                outs.append(Alias(fix(e), e.name, e.expr_id))
            else:
                outs.append(e.transform_up(fix))
        return Project(outs, joined)


class ReplaceSetOps(Rule):
    """INTERSECT -> semi join + distinct; EXCEPT -> anti join + distinct
    (Spark's ReplaceIntersectWithSemiJoin / ReplaceExceptWithAntiJoin).
    Null-safe equality per column."""

    def apply(self, plan):
        from .logical import Except, Intersect

        def rule(node):
            if isinstance(node, (Intersect, Except)) and node.resolved:
                # null-safe equality expressed as plain equi keys so the hash
                # join kernel applies: (isnull(l)=isnull(r)) AND
                # (coalesce(l,d)=coalesce(r,d))
                cond = None
                for l, r in zip(node.left.output, node.right.output):
                    for c in _null_safe_eq_conjuncts(l, r):
                        cond = c if cond is None else And(cond, c)
                jt = "left_semi" if isinstance(node, Intersect) else "left_anti"
                return Distinct(Join(node.left, node.right, jt, cond))
            return node

        return plan.transform_up(rule)


def _null_safe_eq_conjuncts(l: Expression, r: Expression) -> list[Expression]:
    from ..expr.expressions import Coalesce, IsNull
    from ..types import BooleanType, DateType, NumericType, StringType

    if not (l.nullable or r.nullable):
        return [EqualTo(l, r)]
    dt = l.dtype
    if isinstance(dt, StringType):
        d = Literal("")
    elif isinstance(dt, BooleanType):
        d = Literal(False)
    elif isinstance(dt, (NumericType, DateType)):
        d = Literal(0)
    else:
        d = Literal(0)
    from ..expr.expressions import cast_if

    d = cast_if(d, dt)
    return [EqualTo(IsNull(l), IsNull(r)),
            EqualTo(Coalesce([l, d]), Coalesce([r, d]))]


class ExpandGroupingSets(Rule):
    """GroupingSets -> Union of per-set Aggregates over the same child,
    with NULL fills for the grouping keys a set leaves out and grouping()
    / grouping_id() folded to literals per branch."""

    def apply(self, plan):
        def rule(node):
            if not isinstance(node, GroupingSets) or not node.resolved:
                return node
            branches = []
            for si, idxs in enumerate(node.sets):
                keys = [node.grouping_exprs[i] for i in idxs]
                out_exprs = [self._fill(e, keys, node.grouping_exprs, si)
                             for e in node.aggregate_exprs]
                branches.append(Aggregate(list(keys), out_exprs, node.child))
            return Union(branches) if len(branches) > 1 else branches[0]

        return plan.transform_up(rule)

    def _fill(self, e: Expression, keys, all_keys, set_index: int):
        def in_set(x):
            return any(x.semantic_equals(k)
                       or (isinstance(k, Alias) and x.semantic_equals(k.child))
                       for k in keys)

        def rule(x):
            # grouping()/grouping_id() fold per branch BEFORE the null fill
            # below can touch their key argument
            if isinstance(x, Grouping):
                return Literal(0 if in_set(x.child) else 1)
            if isinstance(x, GroupingID):
                gid = 0
                for a in x.args or list(all_keys):
                    gid = (gid << 1) | (0 if in_set(a) else 1)
                return Literal(gid)
            if any(x.semantic_equals(g) for g in all_keys) and not in_set(x):
                return Cast(Literal(None), x.dtype)
            return x

        if isinstance(e, Alias):
            return Alias(e.child.transform_down(rule), e.name,
                         e.expr_id if set_index == 0 else None)
        if isinstance(e, AttributeReference):
            if any(e.semantic_equals(g) for g in all_keys) and not in_set(e):
                return Alias(Cast(Literal(None), e.dtype), e.name,
                             e.expr_id if set_index == 0 else None)
            return e if set_index == 0 else Alias(e, e.name)
        return e


def _finish_analysis_rules():
    return [EliminateSubqueryAliases(), ReplaceSetOps(), ExpandGroupingSets(),
            ReplaceDistinct(), RewriteModeAggregate(),
            RewriteDistinctAggregates()]


class Optimizer(RuleExecutor):
    """The reference's batch layout, with the ported rules in their
    places."""

    def batches(self):
        from .subquery import (
            RewriteCorrelatedScalarSubquery, RewriteExistenceSubquery,
            RewritePredicateSubquery,
        )

        return [
            Batch("Finish analysis", Once(), [
                OptimizeSubqueryPlans(_finish_analysis_rules() +
                                      [BooleanSimplification()]),
                *_finish_analysis_rules(),
            ]),
            Batch("Subqueries", FixedPoint(10), [
                RewritePredicateSubquery(),
                RewriteExistenceSubquery(),
                RewriteCorrelatedScalarSubquery(),
            ]),
            Batch("Operator optimization", FixedPoint(100), [
                CombineFilters(),
                MergeFilterIntoJoin(),
                PushDownPredicates(),
                ReorderJoins(),
                ConstantFolding(),
                BooleanSimplification(),
                SimplifyCasts(),
                PruneFilters(),
                PropagateEmptyRelation(),
                CombineUnions(),
                CombineLimits(),
                CollapseProjects(),
                RemoveNoopProject(),
            ]),
            Batch("Join hygiene", Once(), [
                InferFiltersFromJoinKeys(),
                PushDownPredicates(),
                CombineFilters(),
            ]),
            Batch("Python UDFs", FixedPoint(10), [
                RewriteHostOnlyExpressions(),
                ExtractPythonUDFs(),
            ]),
            Batch("Column pruning", FixedPoint(20), [
                ColumnPruning(),
                RemoveNoopProject(),
            ]),
        ]
