"""Logical optimizer (counterpart of `spark_tpu/plan/optimizer.py`): the
rule framework (plan/tree.py's RuleExecutor), the reference's batch layout,
and the rules that change the plans the port's DataFrame API builds:
filter combination and pushdown (through projects, aggregates and into join
sides), filter-into-join merging, IsNotNull inference on inner-join keys,
limit combination, project collapsing and column pruning. The reference's
other rules (constant folding, subqueries, join reordering of three or more
tables, ...) are listed in ROADMAP.md."""

from __future__ import annotations

from typing import Sequence

from ..expr.expressions import (
    AggregateFunction, Alias, And, AttributeReference, EqualTo, Expression,
    IsNotNull,
)
from .logical import (
    Aggregate, Filter, Join, Limit, LogicalPlan, Offset, Project,
    Repartition, Sort,
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
        if isinstance(node, (Filter, Sort, Limit, Offset, Repartition)):
            child_req = set(required)
            for e in node.expressions():
                child_req |= e.references()
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
        # LocalRelation and other leaves: conservative
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


class Optimizer(RuleExecutor):
    """The reference's batch layout, with the ported rules in their
    places."""

    def batches(self):
        return [
            Batch("Operator optimization", FixedPoint(100), [
                CombineFilters(),
                MergeFilterIntoJoin(),
                PushDownPredicates(),
                CombineLimits(),
                CollapseProjects(),
                RemoveNoopProject(),
            ]),
            Batch("Join hygiene", Once(), [
                InferFiltersFromJoinKeys(),
                PushDownPredicates(),
                CombineFilters(),
            ]),
            Batch("Column pruning", FixedPoint(20), [
                ColumnPruning(),
                RemoveNoopProject(),
            ]),
        ]
