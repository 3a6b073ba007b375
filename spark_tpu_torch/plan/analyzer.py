"""Analyzer: resolves columns and names unnamed outputs (counterpart of
`spark_tpu/plan/analyzer.py`, the rules the DataFrame slice needs):
ResolveReferences (with star expansion), ResolveAliases and CheckAnalysis.
Numeric coercion happens where each expression evaluates (common_type
casts), as in the JAX package. The other rules are listed in ROADMAP.md."""

from __future__ import annotations

import difflib
from typing import Sequence

from ..errors import AnalysisException, NotPortedError, UnresolvedColumnError
from ..expr.expressions import (
    AggregateFunction, Alias, AttributeReference, Average, Cast, Count,
    Expression, Literal, Max, Min, Sum, UnresolvedAttribute, UnresolvedStar,
)
from .logical import Aggregate, Join, LogicalPlan, Project
from .tree import Batch, FixedPoint, Once, Rule, RuleExecutor


def _resolve_name(name_parts: tuple[str, ...],
                  attrs: Sequence[AttributeReference],
                  case_sensitive: bool) -> AttributeReference | None:
    def norm(s: str) -> str:
        return s if case_sensitive else s.lower()

    if len(name_parts) != 1:
        return None    # qualified names need relation aliases (not ported)
    matches = [a for a in attrs if norm(a.name) == norm(name_parts[0])]
    if len(matches) == 1:
        return matches[0]
    if len(matches) > 1:
        if len({m.expr_id for m in matches}) == 1:
            return matches[0]
        raise AnalysisException(
            f"Reference `{'.'.join(name_parts)}` is ambiguous",
            error_class="AMBIGUOUS_REFERENCE")
    return None


class ResolveReferences(Rule):
    def __init__(self, case_sensitive: bool = False):
        self.case_sensitive = case_sensitive

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        cs = self.case_sensitive

        def rule(node: LogicalPlan):
            if not all(c.resolved for c in node.children):
                return node
            try:
                inputs = node.input_attrs()
            except AnalysisException:
                return node  # child awaits ResolveAliases

            if isinstance(node, (Project, Aggregate)):
                lst = node.project_list if isinstance(node, Project) \
                    else node.aggregate_exprs
                if any(isinstance(e, UnresolvedStar) for e in lst):
                    expanded: list[Expression] = []
                    for e in lst:
                        if isinstance(e, UnresolvedStar):
                            expanded.extend(inputs)
                        else:
                            expanded.append(e)
                    if isinstance(node, Project):
                        return node.copy(project_list=expanded)
                    return node.copy(aggregate_exprs=expanded)

            def resolve_expr(e: Expression) -> Expression:
                if isinstance(e, UnresolvedAttribute):
                    a = _resolve_name(e.name_parts, inputs, cs)
                    return e if a is None else a
                return e

            return node.transform_expressions(resolve_expr)

        return plan.transform_up(rule)


class ResolveAliases(Rule):
    """Wrap top-level unnamed project/aggregate expressions in Aliases."""

    def apply(self, plan):
        def rule(node):
            if isinstance(node, Project):
                if node.expressions_resolved and any(
                        not isinstance(e, (Alias, AttributeReference, UnresolvedStar))
                        for e in node.project_list):
                    return node.copy(project_list=[_auto_alias(e)
                                                   for e in node.project_list])
            if isinstance(node, Aggregate):
                if node.expressions_resolved and any(
                        not isinstance(e, (Alias, AttributeReference, UnresolvedStar))
                        for e in node.aggregate_exprs):
                    return node.copy(aggregate_exprs=[_auto_alias(e)
                                                      for e in node.aggregate_exprs])
            return node

        return plan.transform_up(rule)


def _auto_alias(e: Expression) -> Expression:
    if isinstance(e, (Alias, AttributeReference, UnresolvedStar)):
        return e
    return Alias(e, _pretty_name(e))


def _pretty_name(e: Expression) -> str:
    if isinstance(e, Sum):
        return f"sum({_pretty_name(e.child)})"
    if isinstance(e, Count):
        return f"count({_pretty_name(e.child) if e.child else '1'})"
    if isinstance(e, Min):
        return f"min({_pretty_name(e.child)})"
    if isinstance(e, Max):
        return f"max({_pretty_name(e.child)})"
    if isinstance(e, Average):
        return f"avg({_pretty_name(e.child)})"
    if isinstance(e, (AttributeReference, UnresolvedAttribute)):
        return e.name
    if isinstance(e, Literal):
        return str(e.value)
    if isinstance(e, Cast):
        return _pretty_name(e.child)
    sym = getattr(e, "symbol", None)
    if sym is not None and hasattr(e, "left") and hasattr(e, "right"):
        return f"({_pretty_name(e.left)} {sym} {_pretty_name(e.right)})"
    kids = [c for c in e.children if c is not None]
    if kids:
        return (f"{e.sql_name()}"
                f"({', '.join(_pretty_name(c) for c in kids)})")
    return e.simple_string()


class CheckAnalysis(Rule):
    def apply(self, plan):
        def check(node):
            for e in node.expressions():
                for sub in e.iter_nodes():
                    if isinstance(sub, UnresolvedAttribute):
                        cands = [a.name for a in node.input_attrs()]
                        close = difflib.get_close_matches(sub.name, cands, 3)
                        raise UnresolvedColumnError(sub.name, close or cands[:5])
                    if isinstance(sub, UnresolvedStar):
                        raise AnalysisException("unexpected * in expression")
                    if isinstance(sub, Count) and sub.distinct:
                        raise NotPortedError("count(distinct)")
            if isinstance(node, Join) and {
                    a.expr_id for a in node.left.output} & {
                    a.expr_id for a in node.right.output}:
                raise NotPortedError(
                    "self-join (deduplicating the attributes of a relation "
                    "joined to itself)")
            if isinstance(node, Aggregate) and node.resolved:
                grouping_ids = {g.expr_id for g in node.grouping_exprs
                                if isinstance(g, AttributeReference)}
                for e in node.aggregate_exprs:
                    _check_agg_expr(e, grouping_ids, node)
            return None

        plan.foreach(check)
        return plan


def _check_agg_expr(e: Expression, grouping_ids: set[int], agg: Aggregate):
    def matches_grouping(x: Expression) -> bool:
        for g in agg.grouping_exprs:
            gc = g.child if isinstance(g, Alias) else g
            if x.semantic_equals(g) or x.semantic_equals(gc):
                return True
        return False

    def ok(x: Expression, inside_agg: bool) -> bool:
        if not inside_agg and matches_grouping(x):
            return True
        if isinstance(x, AggregateFunction):
            return all(ok(c, True) for c in x.children)
        if isinstance(x, AttributeReference) and not inside_agg:
            if x.expr_id not in grouping_ids:
                raise AnalysisException(
                    f"column {x.name} is neither grouped nor aggregated",
                    error_class="MISSING_AGGREGATION")
            return True
        return all(ok(c, inside_agg) for c in x.children)

    ok(e.child if isinstance(e, Alias) else e, False)


class Analyzer(RuleExecutor):
    def __init__(self, case_sensitive: bool = False):
        super().__init__()
        self.case_sensitive = case_sensitive

    def batches(self):
        cs = self.case_sensitive
        return [
            Batch("Resolution", FixedPoint(50), [
                ResolveReferences(cs),
                ResolveAliases(),
            ]),
            Batch("Check", Once(), [CheckAnalysis()]),
        ]
