"""Function registry: SQL function names -> expression builders
(counterpart of `spark_tpu/expr/registry.py`: every name of the
reference's registry, with its argument defaults). The collection
constructors and set functions are host UDFs row by row, and the
higher-order functions lower to host UDFs over their collection and
captured columns (`expr/higher_order.py`), as the reference builds them.
DISTINCT is accepted on count, sum and avg."""

from __future__ import annotations

import calendar
import datetime
import fnmatch
import hashlib
import math
from typing import Callable, Sequence

from ..errors import AnalysisException, ExecutionError, NotPortedError
from ..types import (
    ArrayType, MapType, StructField, StructType, boolean, common_type, date,
    int32, int64, string, timestamp,
)
from . import expressions as E
from . import window as W
from .pyudf import PythonUDF

Builder = Callable[..., E.Expression]


def _lit_str(e: E.Expression) -> str:
    if isinstance(e, E.Literal) and isinstance(e.value, str):
        return e.value
    raise AnalysisException("expected a string literal argument")


def _conv_base(s: str, from_base: int, to_base: int) -> str | None:
    """conv('ff', 16, 10) -> '255'."""
    try:
        v = int(s.strip(), from_base)
    except ValueError:
        return None
    if to_base == 10:
        return str(v)
    digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    neg = v < 0
    v = abs(v)
    out = ""
    while True:
        out = digits[v % to_base] + out
        v //= to_base
        if v == 0:
            break
    return ("-" + out) if neg else out


def _stable_hash(xs, bits: int) -> int:
    """A deterministic hash of the arguments' Python values, sha256 based:
    the reference's `hash` and `xxhash64`, which depart from Spark's
    Murmur3 and xxHash64 on purpose (the same shape and stability, other
    values); the port follows the reference."""
    h = hashlib.sha256(repr(tuple(xs)).encode()).digest()
    return int.from_bytes(h[: bits // 8], "little", signed=True)


def _width_bucket(v, lo, hi, n):
    n = int(n)
    if n <= 0 or lo == hi:
        return None
    if lo < hi:
        if v < lo:
            return 0
        if v >= hi:
            return n + 1
        return int((v - lo) / (hi - lo) * n) + 1
    if v > lo:
        return 0
    if v <= hi:
        return n + 1
    return int((lo - v) / (lo - hi) * n) + 1


def _strict(fn):
    """`fn` giving NULL where any argument is NULL."""
    def g(*a):
        if any(x is None for x in a):
            return None
        return fn(*a)
    return g


def _chr(i):
    return "" if i < 0 else chr(int(i) % 256)


def _elt(n, *ss):
    et = ss[0].dtype if ss else string
    for x in ss[1:]:
        et = common_type(et, x.dtype) or et
    return PythonUDF(lambda i, *xs: None if i is None or not (
        1 <= int(i) <= len(xs)) else xs[int(i) - 1],
        [n, *ss], et, name="elt", vectorized=False)


def _date_part(field, src):
    f = _lit_str(field).lower().rstrip("s")
    m = {"year": E.Year, "yr": E.Year, "month": E.Month,
         "mon": E.Month, "day": E.DayOfMonth, "d": E.DayOfMonth,
         "dayofweek": E.DayOfWeek, "dow": E.DayOfWeek,
         "doy": E.DayOfYear, "quarter": E.Quarter, "qtr": E.Quarter,
         "week": E.WeekOfYear, "hour": E.Hour, "hr": E.Hour,
         "minute": E.Minute, "min": E.Minute, "second": E.Second,
         "sec": E.Second}
    if f not in m:
        raise AnalysisException(f"date_part: unknown field {field}")
    return m[f](src)


def _seq(x, y, s=None):
    """sequence(start, stop[, step]), both ends included."""
    if s is None:
        s = 1 if y >= x else -1
    s = int(s)
    if s == 0 or (s > 0) != (y >= x) and x != y:
        raise ExecutionError(
            f"sequence: illegal step {s} for bounds {x}..{y}")
    return list(range(int(x), int(y) + (1 if s > 0 else -1), s))


def _make_timestamp(y, mo, d, h, mi, sec) -> int:
    """make_timestamp(...) as epoch microseconds (the seconds' fraction
    rounded to a microsecond, as the reference rounds it)."""
    dt = datetime.datetime(int(y), int(mo), int(d), int(h), int(mi),
                           int(float(sec)))
    return calendar.timegm(dt.timetuple()) * 1_000_000 \
        + int(round((float(sec) % 1) * 1e6))


def _intersect(x, y):
    right = set(v for v in y if v is not None)
    y_null = any(v is None for v in y)
    return [v for v in dict.fromkeys(x)
            if v in right or (v is None and y_null)]


def _except(x, y):
    right = set(v for v in y if v is not None)
    y_null = any(v is None for v in y)
    return [v for v in dict.fromkeys(x)
            if v not in right and not (v is None and y_null)]


def _overlap(x, y):
    if set(v for v in x if v is not None) & \
            set(v for v in y if v is not None):
        return True
    return None if (None in list(x) or None in list(y)) and x and y \
        else False


def _insert(x, i, e):
    i = int(i)
    if i > 0:
        return list(x[:i - 1]) + [e] + list(x[i - 1:])
    return list(x[:len(x) + i + 1]) + [e] + list(x[len(x) + i + 1:])


def _zip(*xs):
    if not xs:
        return []
    return [{str(i): (x[j] if j < len(x) else None)
             for i, x in enumerate(xs)}
            for j in range(max(len(x) for x in xs))]


def _from_entries(es):
    def kv(e):
        return (e[list(e)[0]], e[list(e)[1]]) if isinstance(e, dict) \
            else (e[0], e[1])

    return dict(kv(e) for e in es)


def _str_to_map(x, p=",", kv=":"):
    if not x:
        return {}
    return {(part.split(kv, 1) + [None])[0]: (part.split(kv, 1) + [None])[1]
            for part in x.split(p)}


def _elem(e, default=int64):
    dt = e.dtype
    return dt.element_type if isinstance(dt, ArrayType) else default


def _array_sort(c, f=None):
    if f is not None:
        from . import higher_order as H

        return H.lower_hof(H.ArraySortLambda([c], f))
    return E.ArraySortNullsLast(c)


def _host(fn, name: str, rtype, strict: bool = True):
    """A builder of a host UDF row by row (the port's PythonEvalExec), as
    the reference builds these names."""
    return lambda *a: PythonUDF(_strict(fn) if strict else fn, list(a),
                                rtype, name=name, vectorized=False)


def _agg_compound(name: str):
    def build(*args):
        from . import agg_compound as AC

        return getattr(AC, name)(*args)
    return build


def _hof(name: str):
    def build(*args):
        from . import higher_order as H

        return getattr(H, f"build_{name}")(*args)
    return build


_REGISTRY: dict[str, Builder] = {
    # aggregates
    "sum": lambda c: E.Sum(c),
    "min": lambda c: E.Min(c),
    "max": lambda c: E.Max(c),
    "avg": lambda c: E.Average(c),
    "mean": lambda c: E.Average(c),
    "first": lambda c, *a: E.First(c),
    "any_value": lambda c, *a: E.AnyValue(c),
    "collect_set": lambda c: E.CollectSet(c),
    "collect_list": lambda c: E.CollectList(c),
    "array_agg": lambda c: E.CollectList(c),
    "median": lambda c: E.Median(c),
    "percentile": lambda c, q: E.Percentile(c, float(q.value)),
    "percentile_approx": lambda c, q, *a: E.Percentile(c, float(q.value)),
    "corr": _agg_compound("corr"),
    "covar_samp": _agg_compound("covar_samp"),
    "covar_pop": _agg_compound("covar_pop"),
    "skewness": _agg_compound("skewness"),
    "kurtosis": _agg_compound("kurtosis"),
    "bit_and": lambda c: E.BitAndAgg(c),
    "bit_or": lambda c: E.BitOrAgg(c),
    "bit_xor": lambda c: E.BitXorAgg(c),
    "mode": lambda c: E.Mode(c),
    # higher-order functions (expr/higher_order.py)
    "transform": _hof("transform"),
    "filter": _hof("filter"),
    "exists": _hof("exists"),
    "forall": _hof("forall"),
    "any_match": _hof("exists"),
    "all_match": _hof("forall"),
    "aggregate": _hof("aggregate"),
    "reduce": _hof("aggregate"),
    "zip_with": _hof("zip_with"),
    "transform_keys": _hof("transform_keys"),
    "transform_values": _hof("transform_values"),
    "map_filter": _hof("map_filter"),
    "map_zip_with": _hof("map_zip_with"),
    "stddev": lambda c: E.StddevSamp(c),
    "stddev_samp": lambda c: E.StddevSamp(c),
    "stddev_pop": lambda c: E.StddevPop(c),
    "variance": lambda c: E.VarianceSamp(c),
    "var_samp": lambda c: E.VarianceSamp(c),
    "var_pop": lambda c: E.VariancePop(c),
    "approx_count_distinct": lambda c, *a: E.Count(c, distinct=True),
    "bool_and": lambda c: E.Cast(E.Min(E.Cast(c, int32)), boolean),
    "every": lambda c: E.Cast(E.Min(E.Cast(c, int32)), boolean),
    "bool_or": lambda c: E.Cast(E.Max(E.Cast(c, int32)), boolean),
    "any": lambda c: E.Cast(E.Max(E.Cast(c, int32)), boolean),
    "some": lambda c: E.Cast(E.Max(E.Cast(c, int32)), boolean),
    "count_if": lambda c: E.Coalesce(
        [E.Sum(E.If(c, E.Literal(1), E.Literal(0))), E.Literal(0)]),
    # math
    "abs": lambda c: E.Abs(c),
    "sqrt": lambda c: E.Sqrt(c),
    "exp": lambda c: E.Exp(c),
    "ln": lambda c: E.Log(c),
    # log(x) = ln(x); log(base, x) = ln(x) / ln(base)
    "log": lambda a, b=None: E.Log(a) if b is None
    else E.Divide(E.Log(b), E.Log(a)),
    "pmod": lambda a, b: E.Remainder(E.Add(E.Remainder(a, b), b), b),
    "log10": lambda c: E.Log10(c),
    "floor": lambda c: E.Floor(c),
    "ceil": lambda c: E.Ceil(c),
    "ceiling": lambda c: E.Ceil(c),
    "round": lambda c, s=None: E.Round(c, s),
    "bround": lambda c, s=None: E.BRound(c, s),
    "power": lambda a, b: E.Pow(a, b),
    "pow": lambda a, b: E.Pow(a, b),
    "mod": lambda a, b: E.Remainder(a, b),
    "negative": lambda c: E.UnaryMinus(c),
    "sin": lambda c: E.Sin(c),
    "cos": lambda c: E.Cos(c),
    "tan": lambda c: E.Tan(c),
    "asin": lambda c: E.Asin(c),
    "acos": lambda c: E.Acos(c),
    "atan": lambda c: E.Atan(c),
    "atan2": lambda a, b: E.Atan2(a, b),
    "sinh": lambda c: E.Sinh(c),
    "cosh": lambda c: E.Cosh(c),
    "tanh": lambda c: E.Tanh(c),
    "log2": lambda c: E.Log2(c),
    "log1p": lambda c: E.Log1p(c),
    "expm1": lambda c: E.Expm1(c),
    "degrees": lambda c: E.Degrees(c),
    "radians": lambda c: E.Radians(c),
    "cbrt": lambda c: E.Cbrt(c),
    "sign": lambda c: E.Signum(c),
    "signum": lambda c: E.Signum(c),
    "pi": lambda: E.Literal(3.141592653589793),
    "e": lambda: E.Literal(2.718281828459045),
    "hypot": lambda a, b: E.Sqrt(E.Add(E.Multiply(a, a),
                                       E.Multiply(b, b))),
    "nanvl": lambda a, b: E.NanVl(a, b),
    "shiftleft": lambda a, b: E.ShiftLeft(a, b),
    "shiftright": lambda a, b: E.ShiftRight(a, b),
    "bit_and_op": lambda a, b: E.BitwiseAnd(a, b),
    "bit_or_op": lambda a, b: E.BitwiseOr(a, b),
    "bit_xor_op": lambda a, b: E.BitwiseXor(a, b),
    "bit_not": lambda c: E.BitwiseNot(c),
    "try_add": lambda a, b: E.TryAdd(a, b),
    "try_subtract": lambda a, b: E.TrySubtract(a, b),
    "try_multiply": lambda a, b: E.TryMultiply(a, b),
    "try_divide": lambda a, b: E.If(
        E.EqualTo(b, E.Literal(0)), E.Literal(None), E.Divide(a, b)),
    # conditionals and null functions
    "if": lambda p, a, b: E.If(p, a, b),
    "coalesce": lambda *a: E.Coalesce(list(a)),
    "nullif": lambda a, b: E.NullIf(a, b),
    "nvl": lambda a, b: E.Coalesce([a, b]),
    "ifnull": lambda a, b: E.Coalesce([a, b]),
    "nvl2": lambda a, b, c: E.If(E.IsNotNull(a), b, c),
    "greatest": lambda *a: E.Greatest(list(a)),
    "least": lambda *a: E.Least(list(a)),
    "isnull": lambda c: E.IsNull(c),
    "isnotnull": lambda c: E.IsNotNull(c),
    "isnan": lambda c: E.IsNaN(c),
    "grouping": lambda c: E.Grouping(c),
    "grouping_id": lambda *a: E.GroupingID(list(a)),
    "typeof": lambda a: E.Literal(a.dtype.simple_string()),
    # strings
    "upper": lambda c: E.Upper(c),
    "ucase": lambda c: E.Upper(c),
    "lower": lambda c: E.Lower(c),
    "lcase": lambda c: E.Lower(c),
    "trim": lambda c: E.Trim(c),
    "ltrim": lambda c: E.LTrim(c),
    "rtrim": lambda c: E.RTrim(c),
    "length": lambda c: E.Length(c),
    "char_length": lambda c: E.Length(c),
    "substring": lambda c, p, l=None: E.Substring(c, p, l),
    "substr": lambda c, p, l=None: E.Substring(c, p, l),
    "concat": lambda *a: E.Concat(list(a)),
    "concat_ws": lambda sep, *a: E.ConcatWs(sep, list(a)),
    "replace": lambda c, s, rep: E.StringReplace(c, s, rep),
    "lpad": lambda c, l, p=None: E.Lpad(
        c, l, p if p is not None else E.Literal(" ")),
    "rpad": lambda c, l, p=None: E.Rpad(
        c, l, p if p is not None else E.Literal(" ")),
    "startswith": lambda c, p: E.StartsWith(c, _lit_str(p)),
    "endswith": lambda c, p: E.EndsWith(c, _lit_str(p)),
    "contains": lambda c, p: E.Contains(c, _lit_str(p)),
    "like": lambda c, p: E.Like(c, _lit_str(p)),
    "rlike": lambda c, p: E.RLike(c, _lit_str(p)),
    "regexp": lambda c, p: E.RLike(c, _lit_str(p)),
    "regexp_like": lambda c, p: E.RLike(c, _lit_str(p)),
    "regexp_extract": lambda c, p, i=None: E.RegexpExtract(c, p, i),
    "regexp_replace": lambda c, p, rp: E.RegexpReplace(c, p, rp),
    "regexp_substr": lambda c, p: E.RegexpSubstr(c, p),
    "regexp_instr": lambda c, p: E.RegexpInstr(c, p),
    "regexp_count": lambda c, p: E.RegexpCount(c, p),
    "initcap": lambda c: E.Initcap(c),
    "reverse": lambda c: E.Reverse(c),
    "repeat": lambda c, n: E.Repeat(c, n),
    "substring_index": lambda c, d, n: E.SubstringIndex(c, d, n),
    "left": lambda c, n: E.Left(c, n),
    "right": lambda c, n: E.Right(c, n),
    "overlay": lambda c, rp, p, l=None: E.Overlay(c, rp, p, l),
    "translate": lambda c, m, rep: E.Translate(c, m, rep),
    "soundex": lambda c: E.Soundex(c),
    "md5": lambda c: E.Md5(c),
    "sha1": lambda c: E.Sha1(c),
    "sha": lambda c: E.Sha1(c),
    "sha2": lambda c, b: E.Sha2(c, b),
    "base64": lambda c: E.Base64(c),
    "unbase64": lambda c: E.Unbase64(c),
    "crc32": lambda c: E.Crc32(c),
    "levenshtein": lambda c, o: E.Levenshtein(c, o),
    "ascii": lambda c: E.Ascii(c),
    "instr": lambda c, s: E.Instr(c, s),
    "locate": lambda s, c, pos=None: E.Instr(c, s),
    "position": lambda s, c: E.Instr(c, s),
    "format_number": lambda c, d: E.FormatNumber(c, d),
    "get_json_object": lambda c, p: E.GetJsonObject(c, p),
    "to_number": lambda c, f: E.ToNumber(c, f, strict=True),
    "try_to_number": lambda c, f: E.ToNumber(c, f, strict=False),
    "date_format": lambda c, f: E.DateFormat(c, f),
    # host UDFs, row by row
    "char": _host(_chr, "char", string),
    "chr": _host(_chr, "chr", string),
    "elt": _elt,
    "find_in_set": _host(lambda x, l: 0 if "," in x else (
        (l.split(",").index(x) + 1) if x in l.split(",") else 0),
        "find_in_set", int32),
    "format_string": _host(lambda fmt, *xs: fmt % xs, "format_string",
                           string),
    "printf": _host(lambda fmt, *xs: fmt % xs, "printf", string),
    "bin": _host(lambda i: bin(int(i))[2:] if i >= 0
                 else bin(int(i) & ((1 << 64) - 1))[2:], "bin", string),
    "hex": _host(lambda v: format(int(v) & ((1 << 64) - 1), "X")
                 if not isinstance(v, str) else v.encode().hex().upper(),
                 "hex", string),
    "unhex": _host(lambda s: bytes.fromhex(s).decode(errors="replace"),
                   "unhex", string),
    "conv": _host(lambda s, f, t: _conv_base(str(s), int(f), int(t)),
                  "conv", string),
    "bit_count": _host(lambda i: bin(int(i) & ((1 << 64) - 1)).count("1"),
                       "bit_count", int32),
    "factorial": _host(lambda i: None if i < 0 or i > 20
                       else math.factorial(int(i)), "factorial", int64),
    "width_bucket": _host(_width_bucket, "width_bucket", int64),
    "hash": _host(lambda *xs: _stable_hash(xs, bits=32), "hash", int32,
                  strict=False),
    "xxhash64": _host(lambda *xs: _stable_hash(xs, bits=64), "xxhash64",
                      int64, strict=False),
    # dates
    "year": lambda c: E.Year(c),
    "month": lambda c: E.Month(c),
    "day": lambda c: E.DayOfMonth(c),
    "dayofmonth": lambda c: E.DayOfMonth(c),
    "quarter": lambda c: E.Quarter(c),
    "dayofweek": lambda c: E.DayOfWeek(c),
    "dayofyear": lambda c: E.DayOfYear(c),
    "weekofyear": lambda c: E.WeekOfYear(c),
    "date_part": _date_part,
    "datepart": _date_part,
    "date_add": lambda d, n: E.DateAdd(d, n),
    "date_sub": lambda d, n: E.DateSub(d, n),
    "datediff": lambda a, b: E.DateDiff(a, b),
    "trunc": lambda c, f: E.TruncDate(c, _lit_str(f)),
    "date_trunc": lambda f, c: E.TruncDate(c, _lit_str(f), allow_day=True),
    "make_date": lambda y, m, d: E.MakeDate(y, m, d),
    "add_months": lambda d, n: E.AddMonths(d, n),
    "months_between": lambda a, b, *x: E.MonthsBetween(a, b),
    "last_day": lambda c: E.LastDay(c),
    "to_date": lambda c, fmt=None: E.Cast(c, date),
    "unix_date": lambda d: E.DateDiff(d, E.Literal(datetime.date(1970, 1, 1))),
    # timestamps and intervals
    "hour": lambda c: E.Hour(c),
    "minute": lambda c: E.Minute(c),
    "second": lambda c: E.Second(c),
    "unix_timestamp": lambda c: E.UnixTimestamp(c),
    "from_unixtime": lambda c, fmt=None: E.FromUnixtime(c),
    "to_timestamp": lambda c, fmt=None: E.Cast(c, timestamp),
    "make_timestamp": lambda y, mo, d, h, mi, s: E.host_udf(
        _strict(_make_timestamp), [y, mo, d, h, mi, s], timestamp,
        "make_timestamp"),
    "make_interval": lambda y=None, mo=None, w=None, d=None, h=None,
    mi=None, s=None: E.build_make_interval(y, mo, w, d, h, mi, s),
    "make_dt_interval": lambda d=None, h=None, mi=None, s=None:
    E.build_make_interval(None, None, None, d, h, mi, s),
    "make_ym_interval": lambda y=None, mo=None:
    E.build_make_interval(y, mo, None, None, None, None, None),
    # collections: dictionary luts and transforms
    "split": lambda c, d: E.Split(c, d),
    "explode": lambda c: E.Explode(c),
    "size": lambda c: E.Size(c),
    "cardinality": lambda c: E.Size(c),
    "array_contains": lambda c, v: E.ArrayContains(c, v),
    "array_min": lambda c: E.ArrayMin(c),
    "array_max": lambda c: E.ArrayMax(c),
    "sort_array": lambda c, asc=None: E.SortArray(c, asc),
    "array_sort": _array_sort,
    "array_distinct": lambda c: E.ArrayDistinct(c),
    "element_at": lambda c, i: E.build_element_at(c, i),
    "flatten": lambda c: E.Flatten(c),
    "slice": lambda c, s, ln: E.Slice(c, s, ln),
    "array_remove": lambda c, v: E.ArrayRemove(c, v),
    "array_join": lambda c, sep, nr=None: E.ArrayJoin(c, sep, nr),
    "array_position": lambda c, v: E.ArrayPosition(c, v),
    "map_keys": lambda c: E.MapKeys(c),
    "map_values": lambda c: E.MapValues(c),
    "map_contains_key": lambda c, k: E.MapContainsKey(c, k),
    "regexp_extract_all": lambda c, p, g=None: E.RegexpExtractAll(c, p, g),
    # collections: constructors and set functions, host UDFs row by row
    "array": lambda *a: E.build_array_ctor(list(a)),
    "map": lambda *a: E.build_map_ctor(list(a)),
    "struct": lambda *a: E.build_struct_ctor(list(a)),
    "named_struct": lambda *a: E.build_named_struct(list(a)),
    "sequence": lambda a, b, step=None: E.host_udf(
        _strict(_seq), [a, b] + ([step] if step is not None else []),
        ArrayType(int64), "sequence"),
    "array_repeat": lambda v, n: E.host_udf(
        lambda x, k: [] if k is None else [x] * int(k), [v, n],
        ArrayType(v.dtype), "array_repeat"),
    "array_union": lambda a, b: E.host_udf(
        _strict(lambda x, y: list(dict.fromkeys(list(x) + list(y)))),
        [a, b], a.dtype, "array_union"),
    "array_intersect": lambda a, b: E.host_udf(_strict(_intersect), [a, b],
                                         a.dtype, "array_intersect"),
    "array_except": lambda a, b: E.host_udf(_strict(_except), [a, b], a.dtype,
                                      "array_except"),
    "arrays_overlap": lambda a, b: E.host_udf(_strict(_overlap), [a, b],
                                        boolean, "arrays_overlap"),
    "array_append": lambda a, v: E.host_udf(
        lambda x, e: None if x is None else list(x) + [e], [a, v],
        a.dtype, "array_append"),
    "array_prepend": lambda a, v: E.host_udf(
        lambda x, e: None if x is None else [e] + list(x), [a, v],
        a.dtype, "array_prepend"),
    "array_insert": lambda a, p, v: E.host_udf(_strict(_insert), [a, p, v],
                                         a.dtype, "array_insert"),
    "array_compact": lambda a: E.host_udf(
        lambda x: None if x is None else [v for v in x if v is not None],
        [a], a.dtype, "array_compact"),
    "arrays_zip": lambda *args: E.host_udf(
        _strict(_zip), args,
        ArrayType(StructType(tuple(StructField(str(i), _elem(a), True)
                                   for i, a in enumerate(args)))),
        "arrays_zip"),
    "map_from_arrays": lambda k, v: E.host_udf(
        _strict(lambda ks, vs: dict(zip(ks, vs))), [k, v],
        MapType(_elem(k, string), _elem(v)), "map_from_arrays"),
    "map_from_entries": lambda a: E.host_udf(_strict(_from_entries), [a],
                                       MapType(string, int64),
                                       "map_from_entries"),
    "str_to_map": lambda s, pd=None, kvd=None: E.host_udf(
        _strict(_str_to_map), [s] + [x for x in (pd, kvd) if x is not None],
        MapType(string, string), "str_to_map"),
    # window and ranking
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


def lookup(name: str) -> Builder | None:
    return _REGISTRY.get(name.lower())


def registered_names() -> list[str]:
    """Every SQL function name the port builds (with `count`, which
    build_function special-cases)."""
    return list(_REGISTRY) + ["count"]


def filter_names(pattern: str | None) -> list[str]:
    """Sorted function names matching a SHOW FUNCTIONS pattern:
    case-insensitive, `*` wildcard, `|` alternation."""
    names = sorted(registered_names())
    if not pattern:
        return names
    alts = [p.strip().lower() for p in pattern.split("|") if p.strip()]
    return [n for n in names
            if any(fnmatch.fnmatch(n.lower(), a) for a in alts)]


def function_exists(name: str) -> bool:
    return name.lower() in {n.lower() for n in registered_names()}


def build_function(name: str, args: Sequence[E.Expression],
                   distinct: bool = False) -> E.Expression:
    n = name.lower()
    if n == "count":
        if len(args) == 0 or isinstance(args[0], E.UnresolvedStar):
            return E.Count(None, distinct=False)
        return E.Count(args[0], distinct=distinct)
    b = lookup(n)
    if b is None:
        raise NotPortedError(f"function {name}")
    try:
        out = b(*args)
    except TypeError as e:
        raise AnalysisException(
            f"wrong number of arguments for {name}: {len(args)}") from e
    if distinct:
        if isinstance(out, (E.Sum, E.Average)):
            out.distinct = True  # consumed by RewriteDistinctAggregates
        else:
            raise AnalysisException(f"DISTINCT is not supported for {name}")
    return out
