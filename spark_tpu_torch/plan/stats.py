"""Statistics: table and column statistics and plan-level estimates
(counterpart of `spark_tpu/plan/stats.py`, copied).

ANALYZE TABLE computes `Statistics` in one columnar pass over the table's
Arrow result (`compute_table_stats`) and attaches them to the view's
relation leaf (`_cbo_stats`). `estimate` is a pure function over a logical
plan that ReorderJoins' greedy cost model reads (plan/optimizer.py).
Without ANALYZE no column statistics exist, and each rule falls back:

  Filter    - per conjunct: equality 1/ndv, a range by min/max
              interpolation, null checks from null_count; 0.25 where a
              column has no statistics. Conjuncts multiply.
  Join      - |L| * |R| / max(ndv(lk), ndv(rk)) over the equi keys
              (semi/anti |L| / 2; an outer join at least its preserved
              side).
  Aggregate - min(product of the keys' ndv, 0.9 |child|), an unknown
              ndv sqrt(|child|) + 1; 1 without keys.
  Distinct  - 0.9 |child|. Union - the sum. Limit - min(n, |child|).
  Other unary nodes pass through.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from ..expr.expressions import (
    And, AttributeReference, EqualTo, Expression, GreaterThan,
    GreaterThanOrEqual, In, IsNotNull, IsNull, LessThan, LessThanOrEqual,
    Literal, Not, Or,
)
from . import logical as L


@dataclass
class ColumnStat:
    """Per-column statistics (CatalogColumnStat role)."""

    distinct_count: Optional[int] = None
    min: object = None
    max: object = None
    null_count: Optional[int] = None

    @staticmethod
    def from_arrow(col) -> "ColumnStat":
        import pyarrow.compute as pc

        try:
            ndv = pc.count_distinct(col).as_py()
        except Exception:
            ndv = None
        nulls = col.null_count
        mn = mx = None
        try:
            mm = pc.min_max(col)
            mn, mx = mm["min"].as_py(), mm["max"].as_py()
        except Exception:
            pass
        return ColumnStat(ndv, mn, mx, nulls)


@dataclass
class Statistics:
    """Plan-level statistics (logical.Statistics role)."""

    row_count: Optional[int] = None
    col_stats: dict = None  # attr name (lower) → ColumnStat

    def __post_init__(self):
        if self.col_stats is None:
            self.col_stats = {}


def compute_table_stats(table, columns=None) -> Statistics:
    """One columnar pass over an Arrow table (ANALYZE TABLE role)."""
    cols = {}
    for name in (columns or table.column_names):
        if name in table.column_names:
            cols[name.lower()] = ColumnStat.from_arrow(table.column(name))
    return Statistics(table.num_rows, cols)


# ---------------------------------------------------------------------------
# Estimation
# ---------------------------------------------------------------------------

_FALLBACK_SELECTIVITY = 0.25


def _attr_of(e: Expression):
    return e if isinstance(e, AttributeReference) else None


def _num(v):
    import datetime

    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.toordinal() if isinstance(v, datetime.date) and \
            not isinstance(v, datetime.datetime) else v.timestamp()
    return None


def _range_selectivity(cs: ColumnStat, op: str, value) -> float:
    lo, hi, v = _num(cs.min), _num(cs.max), _num(value)
    if lo is None or hi is None or v is None or hi <= lo:
        return _FALLBACK_SELECTIVITY
    frac = (v - lo) / (hi - lo)
    frac = min(1.0, max(0.0, frac))
    if op in ("<", "<="):
        return frac
    return 1.0 - frac


def _conjunct_selectivity(c: Expression, stats: Statistics) -> float:
    def col_stat(e):
        a = _attr_of(e)
        return stats.col_stats.get(a.name.lower()) if a is not None else None

    if isinstance(c, EqualTo):
        for side, other in ((c.left, c.right), (c.right, c.left)):
            cs = col_stat(side)
            if cs is not None and isinstance(other, Literal) and \
                    cs.distinct_count:
                return 1.0 / cs.distinct_count
    if isinstance(c, (LessThan, LessThanOrEqual)):
        cs = col_stat(c.left)
        if cs is not None and isinstance(c.right, Literal):
            return _range_selectivity(cs, "<", c.right.value)
    if isinstance(c, (GreaterThan, GreaterThanOrEqual)):
        cs = col_stat(c.left)
        if cs is not None and isinstance(c.right, Literal):
            return _range_selectivity(cs, ">", c.right.value)
    if isinstance(c, In):
        cs = col_stat(c.child)
        if cs is not None and cs.distinct_count and c.items:
            return min(1.0, len(c.items) / cs.distinct_count)
    if isinstance(c, IsNull):
        cs = col_stat(c.child)
        if cs is not None and cs.null_count is not None and stats.row_count:
            return cs.null_count / max(stats.row_count, 1)
    if isinstance(c, IsNotNull):
        cs = col_stat(c.child)
        if cs is not None and cs.null_count is not None and stats.row_count:
            return 1.0 - cs.null_count / max(stats.row_count, 1)
    if isinstance(c, Not):
        return 1.0 - _conjunct_selectivity(c.child, stats)
    if isinstance(c, Or):
        a = _conjunct_selectivity(c.left, stats)
        b = _conjunct_selectivity(c.right, stats)
        return min(1.0, a + b - a * b)
    if isinstance(c, And):
        return _conjunct_selectivity(c.left, stats) * \
            _conjunct_selectivity(c.right, stats)
    return _FALLBACK_SELECTIVITY


def estimate(plan: L.LogicalPlan, catalog_stats=None) -> Statistics:
    """Bottom-up statistics for a logical plan (BasicStatsPlanVisitor).
    `catalog_stats`: name(lower) → Statistics from ANALYZE TABLE."""
    catalog_stats = catalog_stats or {}

    def go(node) -> Statistics:
        attached = getattr(node, "_cbo_stats", None)  # ANALYZE TABLE
        if attached is not None:
            return attached
        if isinstance(node, L.LocalRelation):
            return Statistics(node.table.num_rows if node.table is not None
                              else None)
        if isinstance(node, L.LogicalRelation):
            named = catalog_stats.get(node.name.lower())
            if named is not None:
                return named
            return Statistics(getattr(node.source, "estimated_rows", None))
        if isinstance(node, L.Filter):
            child = go(node.child)
            if child.row_count is None:
                return child
            from .optimizer import split_conjuncts

            sel = 1.0
            for c in split_conjuncts(node.condition):
                sel *= _conjunct_selectivity(c, child)
            return Statistics(max(1, int(child.row_count * sel)),
                              child.col_stats)
        if isinstance(node, L.Join):
            lt, rt = go(node.left), go(node.right)
            if lt.row_count is None or rt.row_count is None:
                return Statistics(None)
            merged = {**lt.col_stats, **rt.col_stats}
            if node.join_type in ("left_semi", "left_anti"):
                return Statistics(max(1, lt.row_count // 2), lt.col_stats)
            if node.condition is None:
                return Statistics(lt.row_count * rt.row_count, merged)
            from .optimizer import split_conjuncts

            denom = 1
            for c in split_conjuncts(node.condition):
                if isinstance(c, EqualTo):
                    la, ra = _attr_of(c.left), _attr_of(c.right)
                    nl = lt.col_stats.get(la.name.lower()) if la else None
                    nr = rt.col_stats.get(ra.name.lower()) if ra else None
                    nds = [s.distinct_count for s in (nl, nr)
                           if s is not None and s.distinct_count]
                    if nds:
                        denom = max(denom, max(nds))
            est = max(1, (lt.row_count * rt.row_count) // max(denom, 1))
            if node.join_type in ("left_outer", "full_outer"):
                est = max(est, lt.row_count)
            if node.join_type in ("right_outer", "full_outer"):
                est = max(est, rt.row_count)
            return Statistics(est, merged)
        if isinstance(node, (L.Aggregate, L.Distinct)):
            child = go(node.child)
            if child.row_count is None:
                return child
            groups = getattr(node, "grouping_exprs", None)
            if groups is None:  # Distinct
                return Statistics(max(1, int(child.row_count * 0.9)),
                                  child.col_stats)
            if not groups:
                return Statistics(1, child.col_stats)
            ndv = 1
            for g in groups:
                a = _attr_of(g)
                cs = child.col_stats.get(a.name.lower()) if a else None
                ndv *= cs.distinct_count if cs and cs.distinct_count \
                    else int(math.sqrt(child.row_count) + 1)
            return Statistics(
                max(1, min(ndv, int(child.row_count * 0.9))),
                child.col_stats)
        if isinstance(node, L.Limit):
            child = go(node.child)
            n = getattr(node, "limit", None) or getattr(node, "n", None)
            if child.row_count is not None and isinstance(n, int):
                return Statistics(min(child.row_count, n), child.col_stats)
            return child
        if isinstance(node, L.Union):
            subs = [go(c) for c in node.children]
            if any(s.row_count is None for s in subs):
                return Statistics(None)
            return Statistics(sum(s.row_count for s in subs))
        # pass-through unary default
        kids = node.children
        if len(kids) == 1:
            return go(kids[0])
        if not kids:
            return Statistics(node.stats_rows())
        return Statistics(node.stats_rows())

    return go(plan)
