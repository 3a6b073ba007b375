"""Column functions (counterpart of `spark_tpu/api/functions.py`, the port's
subset): col, lit (string and decimal literals too), the sort orders asc and
desc, substring, when, coalesce, round, abs, the aggregates sum, count,
min, max, avg, grouping and grouping_id (with rollup and cube), and the
window functions row_number, rank, dense_rank, percent_rank, cume_dist,
ntile, lag and lead (with `Column.over`)."""

from __future__ import annotations

from typing import Any

from ..expr import expressions as E
from ..expr import window as W
from .column import Column, _expr


def col(name: str) -> Column:
    if name == "*":
        return Column(E.UnresolvedStar())
    return Column(E.UnresolvedAttribute(name.split(".")))


def lit(v: Any) -> Column:
    if isinstance(v, Column):
        return v
    return Column(E.Literal(v))


def _c(v) -> E.Expression:
    if isinstance(v, str):
        return E.UnresolvedAttribute(v.split("."))
    return _expr(v)


def sum(c) -> Column:  # noqa: A001
    return Column(E.Sum(_c(c)))


def count(c) -> Column:
    e = _c(c)
    if isinstance(e, E.UnresolvedAttribute) and e.name == "*":
        e = None
    if isinstance(e, E.UnresolvedStar):
        e = None
    return Column(E.Count(e))


def avg(c) -> Column:
    return Column(E.Average(_c(c)))


def min(c) -> Column:  # noqa: A001
    return Column(E.Min(_c(c)))


def max(c) -> Column:  # noqa: A001
    return Column(E.Max(_c(c)))


def substring(c, pos: int, length: int) -> Column:
    return Column(E.Substring(_c(c), E.Literal(pos), E.Literal(length)))


def asc(c) -> Column:
    return Column(E.SortOrder(_c(c), True))


def desc(c) -> Column:
    return Column(E.SortOrder(_c(c), False))


def when(cond: Column, value) -> Column:
    return Column(E.CaseWhen([(cond.expr, _expr(value))], None))


def coalesce(*cols) -> Column:
    return Column(E.Coalesce([_c(c) for c in cols]))


def round(c, scale: int = 0) -> Column:  # noqa: A001
    return Column(E.Round(_c(c), E.Literal(scale)))


def abs(c) -> Column:  # noqa: A001
    return Column(E.Abs(_c(c)))


def grouping(c) -> Column:
    return Column(E.Grouping(_c(c)))


def grouping_id(*cols) -> Column:
    return Column(E.GroupingID([_c(c) for c in cols]))


# --- window functions -------------------------------------------------------

def row_number() -> Column:
    return Column(W.RowNumber())


def rank() -> Column:
    return Column(W.Rank())


def dense_rank() -> Column:
    return Column(W.DenseRank())


def percent_rank() -> Column:
    return Column(W.PercentRank())


def cume_dist() -> Column:
    return Column(W.CumeDist())


def ntile(n: int) -> Column:
    return Column(W.NTile(E.Literal(n)))


def lag(c, offset: int = 1, default=None) -> Column:
    return Column(W.Lag(_c(c), offset,
                        None if default is None else E.Literal(default)))


def lead(c, offset: int = 1, default=None) -> Column:
    return Column(W.Lead(_c(c), offset,
                         None if default is None else E.Literal(default)))
