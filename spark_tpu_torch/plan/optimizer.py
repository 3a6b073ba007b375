"""Logical optimizer (counterpart of `spark_tpu/plan/optimizer.py`): the
rule framework (plan/tree.py's RuleExecutor) and the rules that change the
plans the port's DataFrame API builds. Of the reference's rules only
CombineFilters fires on them; the rest are listed in ROADMAP.md."""

from __future__ import annotations

from ..expr.expressions import And, AttributeReference, Expression
from .logical import Filter
from .tree import Batch, FixedPoint, Rule, RuleExecutor

__all__ = ["Optimizer", "split_conjuncts", "substitute_attrs"]


def split_conjuncts(e: Expression) -> list[Expression]:
    if isinstance(e, And):
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def substitute_attrs(e: Expression, mapping: dict[int, Expression]) -> Expression:
    def rule(x):
        if isinstance(x, AttributeReference) and x.expr_id in mapping:
            return mapping[x.expr_id]
        return x

    return e.transform_up(rule)


class CombineFilters(Rule):
    def apply(self, plan):
        def rule(node):
            if isinstance(node, Filter) and isinstance(node.child, Filter):
                return Filter(And(node.child.condition, node.condition),
                              node.child.child)
            return node

        return plan.transform_up(rule)


class Optimizer(RuleExecutor):
    def batches(self):
        return [Batch("Operator optimization", FixedPoint(100),
                      [CombineFilters()])]
