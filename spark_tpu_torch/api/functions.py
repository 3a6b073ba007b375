"""Column functions (counterpart of `spark_tpu/api/functions.py`, the port's
subset): col, column, expr (a SQL expression string), lit (string and
decimal literals too), the sort orders asc and desc, when, coalesce,
round, abs, the aggregates sum, count, countDistinct,
approx_count_distinct, min, max, avg, stddev, stddev_samp, stddev_pop,
variance, var_samp, var_pop, grouping and grouping_id (with rollup
and cube), the window functions row_number, rank, dense_rank,
percent_rank, cume_dist, ntile, lag and lead (with `Column.over`), and the
scalar functions of the reference's wrappers: isnull, isnan, greatest,
least, nanvl, sqrt, exp, log, log10, floor, ceil, pow, negative, upper,
lower, trim, ltrim, rtrim, length, substring, concat, regexp_extract,
lpad, rpad, regexp_replace, year, month, dayofmonth, quarter, dayofweek,
dayofyear, weekofyear, date_add, date_sub, datediff, trunc, make_date,
to_date, hour, minute, second, unix_timestamp, from_unixtime,
to_timestamp and make_timestamp, and the collections: split, explode,
size/cardinality, element_at, the array_*, arrays_* and map_* functions,
flatten, slice, sort_array, sequence, str_to_map, regexp_extract_all, and
the constructors array, create_map (SQL map), struct and named_struct."""

from __future__ import annotations

from typing import Any

from ..expr import expressions as E
from ..expr import window as W
from ..types import date
from .column import Column, _expr


def col(name: str) -> Column:
    if name == "*":
        return Column(E.UnresolvedStar())
    return Column(E.UnresolvedAttribute(name.split(".")))


column = col


def expr(sql_text: str) -> Column:
    from ..sql.parser import parse_expression

    return Column(parse_expression(sql_text))


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


def countDistinct(c) -> Column:
    return Column(E.Count(_c(c), distinct=True))


count_distinct = countDistinct


def approx_count_distinct(c, rsd=None) -> Column:
    return Column(E.Count(_c(c), distinct=True))


def avg(c) -> Column:
    return Column(E.Average(_c(c)))


mean = avg


def stddev(c) -> Column:
    return Column(E.StddevSamp(_c(c)))


stddev_samp = stddev


def stddev_pop(c) -> Column:
    return Column(E.StddevPop(_c(c)))


def variance(c) -> Column:
    return Column(E.VarianceSamp(_c(c)))


var_samp = variance


def var_pop(c) -> Column:
    return Column(E.VariancePop(_c(c)))


def min(c) -> Column:  # noqa: A001
    return Column(E.Min(_c(c)))


def max(c) -> Column:  # noqa: A001
    return Column(E.Max(_c(c)))


def first(c, ignorenulls: bool = True) -> Column:
    return Column(E.First(_c(c), ignorenulls))


def any_value(c) -> Column:
    return Column(E.AnyValue(_c(c)))


def median(c) -> Column:
    return Column(E.Median(_c(c)))


def percentile_approx(c, q, accuracy=None) -> Column:
    return Column(E.Percentile(_c(c), float(q)))


def corr(a, b) -> Column:
    from ..expr import agg_compound as AC

    return Column(AC.corr(_c(a), _c(b)))


def covar_samp(a, b) -> Column:
    from ..expr import agg_compound as AC

    return Column(AC.covar_samp(_c(a), _c(b)))


def covar_pop(a, b) -> Column:
    from ..expr import agg_compound as AC

    return Column(AC.covar_pop(_c(a), _c(b)))


def skewness(c) -> Column:
    from ..expr import agg_compound as AC

    return Column(AC.skewness(_c(c)))


def kurtosis(c) -> Column:
    from ..expr import agg_compound as AC

    return Column(AC.kurtosis(_c(c)))


def sum_distinct(c) -> Column:
    e = E.Sum(_c(c))
    e.distinct = True
    return Column(e)


def collect_list(c) -> Column:
    return Column(E.CollectList(_c(c)))


def collect_set(c) -> Column:
    return Column(E.CollectSet(_c(c)))


def array_agg(c) -> Column:
    return Column(E.CollectList(_c(c)))


# --- conditionals and math ---------------------------------------------------

def isnull(c) -> Column:
    return Column(E.IsNull(_c(c)))


def isnan(c) -> Column:
    return Column(E.IsNaN(_c(c)))


def greatest(*cols) -> Column:
    return Column(E.Greatest([_c(c) for c in cols]))


def least(*cols) -> Column:
    return Column(E.Least([_c(c) for c in cols]))


def nanvl(a, b) -> Column:
    # as the reference's wrapper: if(isnan(a), b, a), whose type is the
    # common type of a and b (SQL's nanvl gives a double)
    return Column(E.If(E.IsNaN(_c(a)), _c(b), _c(a)))


def sqrt(c) -> Column:
    return Column(E.Sqrt(_c(c)))


def exp(c) -> Column:
    return Column(E.Exp(_c(c)))


def log(c) -> Column:
    return Column(E.Log(_c(c)))


def log10(c) -> Column:
    return Column(E.Log10(_c(c)))


def floor(c) -> Column:
    return Column(E.Floor(_c(c)))


def ceil(c) -> Column:
    return Column(E.Ceil(_c(c)))


def pow(a, b) -> Column:  # noqa: A001
    return Column(E.Pow(_c(a), _c(b)))


def negative(c) -> Column:
    return Column(E.UnaryMinus(_c(c)))


# --- strings -----------------------------------------------------------------

def upper(c) -> Column:
    return Column(E.Upper(_c(c)))


def lower(c) -> Column:
    return Column(E.Lower(_c(c)))


def trim(c) -> Column:
    return Column(E.Trim(_c(c)))


def ltrim(c) -> Column:
    return Column(E.LTrim(_c(c)))


def rtrim(c) -> Column:
    return Column(E.RTrim(_c(c)))


def length(c) -> Column:
    return Column(E.Length(_c(c)))


def substring(c, pos: int, length: int) -> Column:
    return Column(E.Substring(_c(c), E.Literal(pos), E.Literal(length)))


def concat(*cols) -> Column:
    return Column(E.Concat([_c(c) for c in cols]))


def regexp_extract(c, pattern: str, idx: int = 1) -> Column:
    return Column(E.RegexpExtract(_c(c), E.Literal(pattern), E.Literal(idx)))


def lpad(c, length: int, pad: str = " ") -> Column:
    return Column(E.Lpad(_c(c), E.Literal(length), E.Literal(pad)))


def rpad(c, length: int, pad: str = " ") -> Column:
    return Column(E.Rpad(_c(c), E.Literal(length), E.Literal(pad)))


def regexp_replace(c, pattern: str, replacement: str) -> Column:
    # the replacement goes to re.sub as it is (SQL's names groups $1)
    return Column(E.RegexpReplace(_c(c), E.Literal(pattern),
                                  E.Literal(replacement), java_refs=False))


# --- dates -------------------------------------------------------------------

def year(c) -> Column:
    return Column(E.Year(_c(c)))


def month(c) -> Column:
    return Column(E.Month(_c(c)))


def dayofmonth(c) -> Column:
    return Column(E.DayOfMonth(_c(c)))


def quarter(c) -> Column:
    return Column(E.Quarter(_c(c)))


def dayofweek(c) -> Column:
    return Column(E.DayOfWeek(_c(c)))


def dayofyear(c) -> Column:
    return Column(E.DayOfYear(_c(c)))


def weekofyear(c) -> Column:
    return Column(E.WeekOfYear(_c(c)))


def date_add(c, days) -> Column:
    return Column(E.DateAdd(_c(c), _c(days)))


def date_sub(c, days) -> Column:
    return Column(E.DateSub(_c(c), _c(days)))


def datediff(end, start) -> Column:
    return Column(E.DateDiff(_c(end), _c(start)))


def trunc(c, fmt: str) -> Column:
    return Column(E.TruncDate(_c(c), fmt))


def make_date(y, m, d) -> Column:
    return Column(E.MakeDate(_c(y), _c(m), _c(d)))


def to_date(c, fmt: str | None = None) -> Column:
    return Column(E.Cast(_c(c), date))


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


# --- timestamps and intervals ------------------------------------------------

def hour(c) -> Column:
    return Column(E.Hour(_c(c)))


def minute(c) -> Column:
    return Column(E.Minute(_c(c)))


def second(c) -> Column:
    return Column(E.Second(_c(c)))


def _call(name: str, *args) -> Column:
    """A registry function over resolved-later arguments (the builder
    dispatches on their types at analysis)."""
    return Column(E.UnresolvedFunction(name, list(args), False))


def unix_timestamp(c) -> Column:
    return _call("unix_timestamp", _c(c))


def from_unixtime(c) -> Column:
    return _call("from_unixtime", _c(c))


def to_timestamp(c) -> Column:
    return _call("to_timestamp", _c(c))


def make_timestamp(y, mo, d, h, mi, s) -> Column:
    return _call("make_timestamp", *[_c(x) for x in (y, mo, d, h, mi, s)])


# --- collections -------------------------------------------------------------

def split(c, pattern: str) -> Column:
    return Column(E.Split(_c(c), E.Literal(pattern)))


def explode(c) -> Column:
    return Column(E.Explode(_c(c)))


def size(c) -> Column:
    return Column(E.Size(_c(c)))


cardinality = size


def array_contains(c, value) -> Column:
    return Column(E.ArrayContains(_c(c), E.Literal(value)))


def array_min(c) -> Column:
    return Column(E.ArrayMin(_c(c)))


def array_max(c) -> Column:
    return Column(E.ArrayMax(_c(c)))


def sort_array(c, asc: bool = True) -> Column:
    return Column(E.SortArray(_c(c), E.Literal(asc)))


def array_sort(c) -> Column:
    return Column(E.ArraySortNullsLast(_c(c)))


def array_distinct(c) -> Column:
    return Column(E.ArrayDistinct(_c(c)))


def element_at(c, idx) -> Column:
    # dispatches on the resolved type (a map key or an array index)
    return _call("element_at", _c(c), E.Literal(idx))


def flatten(c) -> Column:
    return Column(E.Flatten(_c(c)))


def slice(c, start: int, length: int) -> Column:  # noqa: A001
    return Column(E.Slice(_c(c), E.Literal(start), E.Literal(length)))


def array_remove(c, value) -> Column:
    return Column(E.ArrayRemove(_c(c), E.Literal(value)))


def array_join(c, sep: str, null_replacement: str | None = None) -> Column:
    return Column(E.ArrayJoin(_c(c), E.Literal(sep),
                              None if null_replacement is None
                              else E.Literal(null_replacement)))


def array_position(c, value) -> Column:
    return Column(E.ArrayPosition(_c(c), E.Literal(value)))


def map_keys(c) -> Column:
    return Column(E.MapKeys(_c(c)))


def map_values(c) -> Column:
    return Column(E.MapValues(_c(c)))


def map_contains_key(c, key) -> Column:
    return Column(E.MapContainsKey(_c(c), E.Literal(key)))


def regexp_extract_all(c, pattern: str, idx: int | None = None) -> Column:
    return Column(E.RegexpExtractAll(_c(c), E.Literal(pattern),
                                     None if idx is None else E.Literal(idx)))


def array(*cols) -> Column:
    return _call("array", *[_c(c) for c in cols])


def create_map(*cols) -> Column:
    return _call("map", *[_c(c) for c in cols])


def struct(*cols) -> Column:
    return _call("struct", *[_c(c) for c in cols])


def named_struct(*args) -> Column:
    """named_struct('n1', c1, 'n2', c2, ...): names are literals."""
    return _call("named_struct", *[E.Literal(a) if i % 2 == 0 else _c(a)
                                   for i, a in enumerate(args)])


def sequence(start, stop, step=None) -> Column:
    return _call("sequence", *[_c(x) for x in (start, stop, step)
                               if x is not None])


def array_repeat(c, n: int) -> Column:
    return _call("array_repeat", _c(c), E.Literal(n))


def array_union(a, b) -> Column:
    return _call("array_union", _c(a), _c(b))


def array_intersect(a, b) -> Column:
    return _call("array_intersect", _c(a), _c(b))


def array_except(a, b) -> Column:
    return _call("array_except", _c(a), _c(b))


def arrays_overlap(a, b) -> Column:
    return _call("arrays_overlap", _c(a), _c(b))


def array_append(c, value) -> Column:
    return _call("array_append", _c(c), _expr(value))


def array_prepend(c, value) -> Column:
    return _call("array_prepend", _c(c), _expr(value))


def array_insert(c, pos: int, value) -> Column:
    return _call("array_insert", _c(c), E.Literal(pos), _expr(value))


def array_compact(c) -> Column:
    return _call("array_compact", _c(c))


def arrays_zip(*cols) -> Column:
    return _call("arrays_zip", *[_c(c) for c in cols])


def map_from_arrays(k, v) -> Column:
    return _call("map_from_arrays", _c(k), _c(v))


def map_from_entries(c) -> Column:
    return _call("map_from_entries", _c(c))


def str_to_map(c, pair_delim: str = ",", key_value_delim: str = ":") -> Column:
    return _call("str_to_map", _c(c), E.Literal(pair_delim),
                 E.Literal(key_value_delim))
