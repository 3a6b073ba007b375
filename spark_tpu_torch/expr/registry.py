"""Function registry: SQL function names -> expression builders
(counterpart of `spark_tpu/expr/registry.py`, the functions of the port's
slice). A name the reference knows and the port does not raises
`NotPortedError` naming it."""

from __future__ import annotations

from typing import Sequence

from ..errors import AnalysisException, NotPortedError
from . import expressions as E
from . import window as W

_BUILDERS = {
    "sum": lambda c: E.Sum(c),
    "min": lambda c: E.Min(c),
    "max": lambda c: E.Max(c),
    "avg": lambda c: E.Average(c),
    "mean": lambda c: E.Average(c),
    "stddev": lambda c: E.StddevSamp(c),
    "stddev_samp": lambda c: E.StddevSamp(c),
    "stddev_pop": lambda c: E.StddevPop(c),
    "variance": lambda c: E.VarianceSamp(c),
    "var_samp": lambda c: E.VarianceSamp(c),
    "var_pop": lambda c: E.VariancePop(c),
    "substring": lambda c, p, l=None: E.Substring(c, p, l),
    "substr": lambda c, p, l=None: E.Substring(c, p, l),
    "round": lambda c, s=None: E.Round(c, s),
    "if": lambda p, a, b: E.If(p, a, b),
    "coalesce": lambda *a: E.Coalesce(list(a)),
    "upper": lambda c: E.Upper(c),
    "ucase": lambda c: E.Upper(c),
    "concat": lambda *a: E.Concat(list(a)),
    "abs": lambda c: E.Abs(c),
    "grouping": lambda c: E.Grouping(c),
    "grouping_id": lambda *a: E.GroupingID(list(a)),
    "date_add": lambda d, n: E.DateAdd(d, n),
    "date_sub": lambda d, n: E.DateSub(d, n),
    "datediff": lambda a, b: E.DateDiff(a, b),
    "date_format": lambda c, f: E.DateFormat(c, f),
    "row_number": lambda: W.RowNumber(),
    "rank": lambda: W.Rank(),
    "dense_rank": lambda: W.DenseRank(),
    "percent_rank": lambda: W.PercentRank(),
    "cume_dist": lambda: W.CumeDist(),
    "ntile": lambda n: W.NTile(n),
    "lag": lambda c, off=None, d=None: W.Lag(
        c, off if off is not None else E.Literal(1), d),
    "lead": lambda c, off=None, d=None: W.Lead(
        c, off if off is not None else E.Literal(1), d),
    "first_value": lambda c: W.FirstValue(c),
    "last_value": lambda c: W.LastValue(c),
    "nth_value": lambda c, n: W.NthValue(c, n),
}


def build_function(name: str, args: Sequence[E.Expression],
                   distinct: bool = False) -> E.Expression:
    n = name.lower()
    if n == "count":
        if len(args) == 0 or isinstance(args[0], E.UnresolvedStar):
            return E.Count(None, distinct=False)
        return E.Count(args[0], distinct=distinct)
    b = _BUILDERS.get(n)
    if b is None:
        raise NotPortedError(f"function {name}")
    if distinct:
        raise NotPortedError(f"{name}(DISTINCT ...)")
    try:
        return b(*args)
    except TypeError as e:
        raise AnalysisException(
            f"wrong number of arguments for {name}: {len(args)}") from e
