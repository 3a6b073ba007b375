"""Row-count estimates for join reordering (counterpart of
`spark_tpu/plan/stats.py`, its estimator without catalog statistics).

The port has no ANALYZE TABLE, so no column statistics exist, and every
rule below is the reference's fallback where they are missing:
  Filter    - 0.25 per conjunct (an OR of two a + b - ab, a NOT 1 - s);
              conjuncts multiply.
  Join      - |L| * |R| (semi/anti |L| / 2; an outer join at least its
              preserved side).
  Aggregate - min(product over the keys of sqrt(|child|) + 1,
              0.9 |child|); 1 without keys.
  Limit     - min(n, |child|). Other unary nodes pass through.
"""

from __future__ import annotations

import math

from ..expr.expressions import And, Expression, Not, Or
from . import logical as L

_FALLBACK_SELECTIVITY = 0.25


def _selectivity(c: Expression) -> float:
    if isinstance(c, Not):
        return 1.0 - _selectivity(c.child)
    if isinstance(c, Or):
        a, b = _selectivity(c.left), _selectivity(c.right)
        return min(1.0, a + b - a * b)
    if isinstance(c, And):
        return _selectivity(c.left) * _selectivity(c.right)
    return _FALLBACK_SELECTIVITY


def estimate_rows(plan: L.LogicalPlan) -> int | None:
    """Bottom-up row count of a logical plan (BasicStatsPlanVisitor), None
    where a leaf has no count."""
    from .optimizer import split_conjuncts

    def go(node) -> int | None:
        if isinstance(node, L.LocalRelation):
            return node.table.num_rows
        if isinstance(node, L.LogicalRelation):
            # the port keeps no ANALYZE TABLE statistics: the source's
            # estimate (a Parquet footer's row count; None for CSV, JSON)
            return getattr(node.source, "estimated_rows", None)
        if isinstance(node, L.Filter):
            rows = go(node.child)
            if rows is None:
                return None
            sel = 1.0
            for c in split_conjuncts(node.condition):
                sel *= _selectivity(c)
            return max(1, int(rows * sel))
        if isinstance(node, L.Join):
            lt, rt = go(node.left), go(node.right)
            if lt is None or rt is None:
                return None
            if node.join_type in ("left_semi", "left_anti"):
                return max(1, lt // 2)
            est = max(1, lt * rt)
            if node.join_type in ("left_outer", "full_outer"):
                est = max(est, lt)
            if node.join_type in ("right_outer", "full_outer"):
                est = max(est, rt)
            return est
        if isinstance(node, L.Aggregate):
            rows = go(node.child)
            if rows is None:
                return None
            if not node.grouping_exprs:
                return 1
            ndv = int(math.sqrt(rows) + 1) ** len(node.grouping_exprs)
            return max(1, min(ndv, int(rows * 0.9)))
        if isinstance(node, L.Limit):
            rows = go(node.child)
            return rows if rows is None else min(rows, node.n)
        kids = node.children
        if len(kids) == 1:
            return go(kids[0])
        return node.stats_rows()

    return go(plan)
