"""Expression tree (counterpart of `spark_tpu/expr/expressions.py`, its
scalar expressions over the port's types).

Each expression keeps the JAX package's class name, type rules, null
semantics and `simple_string`, with one `eval(ctx)` written on torch
tensors:
  * leaves, aliases and casts between the ported types (decimals rescale
    half-up; float -> decimal rounds half to even; float -> integral
    saturates as the reference's compiler converts); a string casts to a
    number, a boolean or a date by parsing its dictionary once on the host
    into a data lut and an ok lut (try_cast is the same cast);
  * `+ - * /` (plain ops wrap on integral overflow, the try_ variants give
    NULL, x/0 gives NULL, decimal + - * stay exact scaled int64), `%`
    (the dividend's sign; x % 0 is NULL), the bitwise operators and
    shifts (an amount outside [0, bits) gives 0 or the sign fill), pow;
  * the math functions with the reference's domain checks (NULL, not
    NaN), atan2, sign, floor/ceil, round (half up) and bround (half to
    even), nanvl, isnan;
  * the comparisons (strings by value hash for = <> <=>, by merged
    dictionary rank for the orderings), <=>, Kleene and/or/not,
    is [not] null, IN over a list, CASE WHEN / if / coalesce / nullif,
    greatest/least (NULLs skipped);
  * dates: date +/- days or an INTERVAL, date_add/date_sub/datediff, the
    calendar fields (year ... ISO week), trunc/date_trunc, make_date,
    add_months, last_day, months_between;
  * timestamps (int64 microseconds, no time zone): casts to and from dates,
    numbers and strings, + / - an INTERVAL of days and microseconds,
    hour/minute/second (floor operations, right before 1970),
    unix_timestamp, from_unixtime (a TIMESTAMP, as the reference gives),
    make_interval's literal folding;
  * collections: arrays, maps and structs are dictionary-encoded columns,
    so each function is a lut over the dictionary's entries (size,
    array_contains, element_at, a struct field, a map lookup, ...) or a
    transform of it into another dictionary (split, map_keys, sort_array,
    slice, ...); the constructors (array, map, struct, named_struct) are
    host UDFs row by row; explode() is a marker the analyzer moves into a
    Generate node;
  * strings as dictionary luts built on the host, once per dictionary:
    transforms (substr, upper/lower, trim, pad, replace, translate,
    regexp_replace/extract, the hashes and encodings, ...), deduplicated
    and recoded where two values map to one; predicates (LIKE, RLIKE,
    startswith/endswith/contains); integer luts (length, instr, ascii,
    levenshtein, the regexp counts); per-entry value and validity luts
    (get_json_object, crc32, regexp_substr, to_number);
  * grouping()/grouping_id() (folded per grouping set) and the aggregate
    functions sum, count, min, max, avg and the central moments.
A double scaled by literal factors is computed as the reference's
compiler computes it: a division by a literal as a product with its
reciprocal, a chain of constant factors folded into one, and a product
feeding a sum rounded once, as its fused multiply-add (`_fma`). A cast to
a narrower decimal gives NULL where the value has more digits than the
target precision, as Spark's non-ANSI cast does.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import json
import math
import re
import zlib
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..columnar.batch import (
    EMPTY_DICT, StringDict, _order_key, _take_codes, canon_value,
    empty_entry, merge_string_dicts,
)
from ..errors import (
    AnalysisException, ExecutionError, NotPortedError, TypeCheckError,
    UnsupportedOperationError,
)
from ..plan.tree import TreeNode, next_id
from ..types import (
    ArrayType, BooleanType, DataType, DateType, DecimalType, FractionalType,
    IntegralType, MapType, NullType, NumericType, StringType, StructField,
    StructType, TimestampType, boolean, common_type, date, dict_encoded,
    float64, infer_type, int32, int64, null_type, string, timestamp,
)
from .eval import EvalCtx, Val

__all__ = [
    "Expression", "Literal", "AttributeReference", "UnresolvedAttribute",
    "UnresolvedStar", "UnresolvedFunction", "Alias", "SortOrder", "Cast",
    "cast_if", "Substring", "In", "If", "CaseWhen", "Coalesce", "Round",
    "BRound", "Add", "Subtract", "Multiply", "Divide", "Remainder", "TryAdd",
    "TrySubtract", "TryMultiply", "BitwiseAnd", "BitwiseOr", "BitwiseXor",
    "BitwiseNot", "ShiftLeft", "ShiftRight", "Pow", "EqualTo", "NotEqualTo",
    "EqualNullSafe", "LessThan", "LessThanOrEqual", "GreaterThan",
    "GreaterThanOrEqual", "And", "Or", "Not", "IsNull", "IsNotNull",
    "IsNaN", "NullIf", "Greatest", "Least", "NanVl", "Abs", "UnaryMinus",
    "Sqrt", "Exp", "Log", "Log10", "Log2", "Log1p", "Expm1", "Sin", "Cos",
    "Tan", "Asin", "Acos", "Atan", "Atan2", "Sinh", "Cosh", "Tanh", "Cbrt",
    "Degrees", "Radians", "Signum", "Floor", "Ceil", "Upper", "Lower",
    "Trim", "LTrim", "RTrim", "StringReplace", "Lpad", "Rpad", "Initcap",
    "Reverse", "Repeat", "SubstringIndex", "RegexpExtract", "RegexpReplace",
    "Left", "Right", "Overlay", "Soundex", "Md5", "Sha1", "Sha2", "Base64",
    "Unbase64", "Translate", "FormatNumber", "ConcatWs", "Concat", "Like",
    "RLike", "StartsWith", "EndsWith", "Contains", "Length", "RegexpInstr",
    "RegexpCount", "Levenshtein", "Ascii", "Instr", "GetJsonObject",
    "Crc32", "RegexpSubstr", "ToNumber", "AggregateFunction", "Sum", "Count",
    "Min", "Max", "Average", "IntervalLiteral", "DateAdd", "DateSub",
    "DateDiff", "Year", "Month", "DayOfMonth", "Quarter", "DayOfWeek",
    "DayOfYear", "WeekOfYear", "TruncDate", "MakeDate", "AddMonths",
    "LastDay", "MonthsBetween", "Grouping", "GroupingID", "DateFormat",
    "StddevSamp", "StddevPop", "VarianceSamp", "VariancePop", "First",
    "AnyValue", "Mode", "BitAndAgg", "BitOrAgg", "BitXorAgg", "Percentile",
    "Median", "CollectSet", "CollectList", "Hour", "Minute", "Second", "UnixTimestamp", "FromUnixtime",
    "build_make_interval", "Split", "Explode", "Size", "ArrayContains",
    "ArrayMin", "ArrayMax", "ElementAt", "ElementAtString", "GetStructField",
    "GetMapValue", "MapContainsKey", "Flatten", "ArrayJoin", "ArrayPosition",
    "RegexpExtractAll", "MapKeys", "MapValues", "SortArray",
    "ArraySortNullsLast", "ArrayDistinct", "Slice", "ArrayRemove",
    "build_element_at", "build_struct_ctor", "build_named_struct",
    "build_array_ctor", "build_map_ctor",
]


# ---------------------------------------------------------------------------
# Base
# ---------------------------------------------------------------------------

class Expression(TreeNode):
    @property
    def dtype(self) -> DataType:
        raise NotImplementedError(type(self).__name__)

    @property
    def nullable(self) -> bool:
        return True

    @property
    def resolved(self) -> bool:
        return all(c.resolved for c in self.children)

    def references(self) -> set[int]:
        out: set[int] = set()
        for n in self.iter_nodes():
            if isinstance(n, AttributeReference):
                out.add(n.expr_id)
        return out

    def eval(self, ctx: EvalCtx) -> Val:
        raise NotPortedError(f"expression {type(self).__name__}")

    def sql_name(self) -> str:
        return type(self).__name__.lower()


# ---------------------------------------------------------------------------
# Leaves & named expressions
# ---------------------------------------------------------------------------

class Literal(Expression):
    child_fields = ()

    def __init__(self, value: Any, dtype: DataType | None = None):
        self.value = value
        self._dtype = dtype if dtype is not None else infer_type(value)
        if isinstance(value, datetime.datetime):
            self.value = _micros(value)
        elif isinstance(value, datetime.date):
            self.value = (value - datetime.date(1970, 1, 1)).days
        else:
            import decimal as _d

            if isinstance(value, _d.Decimal):
                if not isinstance(self._dtype, DecimalType):
                    raise TypeCheckError(
                        f"decimal literal of type {self._dtype}")
                self.value = int(value.scaleb(self._dtype.scale)
                                 .to_integral_value())

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self.value is None

    @property
    def resolved(self) -> bool:
        return True

    def _data_args(self) -> tuple:
        return (("value", self.value), ("dtype", str(self._dtype)))

    def eval(self, ctx: EvalCtx) -> Val:
        dt = self._dtype.device_dtype
        if dict_encoded(self._dtype):
            # a string, binary or nested literal: a one-entry dictionary,
            # every row code 0
            sd = StringDict([empty_entry(self._dtype) if self.value is None
                             else self.value])
            return Val(self._dtype, ctx.scalar(0, dt),
                       None if self.value is not None
                       else ctx.scalar(False, torch.bool), sd)
        if self.value is None:
            return Val(self._dtype, ctx.scalar(0, dt),
                       ctx.scalar(False, torch.bool))
        return Val(self._dtype, ctx.scalar(self.value, dt), None)

    def simple_string(self) -> str:
        return f"lit({self.value!r})"


class AttributeReference(Expression):
    """A resolved column (expr_id disambiguates same-named columns)."""

    child_fields = ()

    def __init__(self, name: str, dtype: DataType, nullable: bool = True,
                 expr_id: int | None = None, qualifier: tuple[str, ...] = ()):
        self.name = name
        self._dtype = dtype
        self._nullable = nullable
        self.expr_id = next_id() if expr_id is None else expr_id
        self.qualifier = tuple(qualifier)

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    @property
    def resolved(self) -> bool:
        return True

    def eval(self, ctx: EvalCtx) -> Val:
        return ctx.attribute(self.expr_id)

    def _data_args(self) -> tuple:
        return (("expr_id", self.expr_id),)

    def with_nullability(self, nullable: bool) -> "AttributeReference":
        return AttributeReference(self.name, self._dtype, nullable,
                                  self.expr_id, self.qualifier)

    def new_instance(self) -> "AttributeReference":
        return AttributeReference(self.name, self._dtype, self._nullable,
                                  None, self.qualifier)

    def simple_string(self) -> str:
        return f"{self.name}#{self.expr_id}"


class UnresolvedAttribute(Expression):
    child_fields = ()

    def __init__(self, name_parts: Sequence[str]):
        self.name_parts = tuple(name_parts)

    @property
    def name(self) -> str:
        return ".".join(self.name_parts)

    @property
    def resolved(self) -> bool:
        return False

    def simple_string(self) -> str:
        return f"'{self.name}"


class UnresolvedStar(Expression):
    child_fields = ()

    def __init__(self, target: Optional[str] = None):
        self.target = target

    @property
    def resolved(self) -> bool:
        return False


class UnresolvedFunction(Expression):
    child_fields = ("args",)

    def __init__(self, name: str, args: Sequence[Expression],
                 distinct: bool = False):
        self.fname = name
        self.args = list(args)
        self.distinct = distinct

    @property
    def resolved(self) -> bool:
        return False


class Alias(Expression):
    child_fields = ("child",)

    def __init__(self, child: Expression, name: str, expr_id: int | None = None):
        self.child = child
        self.name = name
        self.expr_id = next_id() if expr_id is None else expr_id

    @property
    def dtype(self) -> DataType:
        return self.child.dtype

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def to_attribute(self) -> AttributeReference:
        dt = self.child.dtype if self.child.resolved else null_type
        return AttributeReference(self.name, dt, self.child.nullable,
                                  self.expr_id)

    def eval(self, ctx: EvalCtx) -> Val:
        return ctx.eval(self.child)

    def _data_args(self) -> tuple:
        return (("name", self.name), ("expr_id", self.expr_id))

    def simple_string(self) -> str:
        return f"{self.child.simple_string()} AS {self.name}#{self.expr_id}"


class SortOrder(Expression):
    """Sort direction wrapper: `nulls_first` None means Spark's default
    (nulls first when ascending, last when descending)."""

    child_fields = ("child",)

    def __init__(self, child: Expression, ascending: bool = True,
                 nulls_first: bool | None = None):
        self.child = child
        self.ascending = ascending
        self.nulls_first = nulls_first

    @property
    def dtype(self) -> DataType:
        return self.child.dtype

    @property
    def nulls_first_effective(self) -> bool:
        return self.ascending if self.nulls_first is None else \
            self.nulls_first

    def eval(self, ctx: EvalCtx) -> Val:
        return ctx.eval(self.child)


# ---------------------------------------------------------------------------
# Cast
# ---------------------------------------------------------------------------

class Cast(Expression):
    child_fields = ("child",)

    def __init__(self, child: Expression, to: DataType,
                 explicit: bool = False):
        self.child = child
        self.to = to
        # written by the user (CAST, Column.cast), not put in by type
        # coercion: only then does an integer past the target precision
        # read as NULL (a comparison casts its integer side to the other
        # side's decimal type, where a range check would drop rows)
        self.explicit = explicit

    @property
    def dtype(self) -> DataType:
        return self.to

    @property
    def nullable(self) -> bool:
        frm = self.child.dtype if self.child.resolved else null_type
        if isinstance(frm, StringType) and not isinstance(self.to, StringType):
            return True  # a value that does not parse is NULL
        return self.child.nullable

    def eval(self, ctx: EvalCtx) -> Val:
        return cast_val(ctx, ctx.eval(self.child), self.to, self.explicit)

    def simple_string(self) -> str:
        return f"cast({self.child.simple_string()} as {self.to.simple_string()})"


def cast_val(ctx: EvalCtx, c: Val, to: DataType,
             explicit: bool = False) -> Val:
    frm = c.dtype
    if type(frm) is type(to) and frm == to:
        return c
    dd = to.device_dtype
    if isinstance(frm, NullType):
        return Val(to, ctx.scalar(0, dd), ctx.scalar(False, torch.bool),
                   StringDict([empty_entry(to)]) if dict_encoded(to)
                   else None)
    if isinstance(frm, StringType) and not isinstance(to, StringType):
        return _string_parse(ctx, c, to)
    if isinstance(to, StringType):
        raise NotPortedError(f"cast({frm.simple_string()} as "
                             f"{to.simple_string()})")
    data = c.data
    if isinstance(frm, DecimalType) and isinstance(to, DecimalType):
        delta = to.scale - frm.scale
        if delta >= 0:
            out = data * (10 ** delta)
        else:
            # half-up (away from zero) on the integers, as the reference
            f = 10 ** (-delta)
            half = f // 2
            out = torch.where(data >= 0, (data + half) // f,
                              -((-data + half) // f))
        if delta < 0 or to.precision - to.scale < frm.precision - frm.scale:
            return Val(to, out, _fits_precision(out, to, c.validity))
        return Val(to, out, c.validity)
    if isinstance(frm, DecimalType):
        # a product with the reciprocal of 10^scale: the reference's
        # compiler turns its division by that constant into this product,
        # and a product rounds the same on every device (a quotient by a
        # host scalar does not: CUDA takes the reciprocal's product)
        scaled = data.to(torch.float64) * (1.0 / 10.0 ** frm.scale)
        return cast_val(ctx, Val(float64, scaled, c.validity), to)
    if isinstance(to, DecimalType):
        if data.dtype.is_floating_point:
            # torch.round rounds half to even, as the reference's rint;
            # NaN, infinities and values past the precision read as NULL
            d = torch.round(data.to(torch.float64) * (10.0 ** to.scale))
            ok = d.abs() < float(10 ** to.precision)
            out = torch.where(ok, d, torch.zeros_like(d)).to(torch.int64)
            return Val(to, out, ok if c.validity is None
                       else ok & c.validity)
        # in an explicit cast, an integer with more digits than the
        # target's integral part reads as NULL (checked before the
        # scaling, which could wrap)
        whole = data.to(torch.int64)
        ok = c.validity
        if explicit and to.precision - to.scale < 19:
            ok = whole.abs() < 10 ** (to.precision - to.scale)
            ok = ok if c.validity is None else ok & c.validity
        return Val(to, whole * (10 ** to.scale), ok)
    if isinstance(frm, DateType) and isinstance(to, TimestampType):
        return Val(to, data.to(torch.int64) * _US_PER_DAY, c.validity)
    if isinstance(frm, TimestampType) and isinstance(to, DateType):
        # floor: an instant before 1970 belongs to the day that holds it
        return Val(to, _floordiv(data, _US_PER_DAY).to(torch.int32),
                   c.validity)
    if isinstance(frm, (DateType, TimestampType)) and \
            isinstance(to, NumericType):
        return Val(to, data.to(dd), c.validity)
    if isinstance(to, BooleanType):
        return Val(to, data != 0, c.validity)
    if isinstance(frm, FractionalType) and isinstance(to, IntegralType):
        # float -> int truncates toward zero; NaN/inf read as 0
        t = torch.nan_to_num(torch.trunc(data), nan=0.0, posinf=0.0,
                             neginf=0.0)
        return Val(to, _float_to_int(t, dd), c.validity)
    return Val(to, data.to(dd), c.validity)


_TRUE_STRINGS = {"t", "true", "y", "yes", "1"}
_FALSE_STRINGS = {"f", "false", "n", "no", "0"}


def _parse_str(s: str, to: DataType):
    """One dictionary value parsed as `to` (the reference's `_parse_str`):
    None where it does not parse."""
    s = s.strip()
    try:
        if isinstance(to, BooleanType):
            ls = s.lower()
            if ls in _TRUE_STRINGS:
                return True
            if ls in _FALSE_STRINGS:
                return False
            return None
        if isinstance(to, IntegralType):
            return int(float(s)) if ("." in s or "e" in s.lower()) else int(s)
        if isinstance(to, DecimalType):
            import decimal as _d

            return int(_d.Decimal(s).scaleb(to.scale).to_integral_value(
                rounding=_d.ROUND_HALF_UP))
        if isinstance(to, FractionalType):
            return float(s)
        if isinstance(to, DateType):
            return (datetime.date.fromisoformat(s[:10])
                    - datetime.date(1970, 1, 1)).days
        if isinstance(to, TimestampType):
            return _parse_ts(s)
    except (ValueError, ArithmeticError):
        return None
    raise NotPortedError(f"cast(string as {to.simple_string()})")


def _value_luts(ctx: EvalCtx, c: Val, key: str, to: DataType, fn,
                nullable: bool = True) -> Val:
    """`fn` of each dictionary value of the string Val `c`, computed once
    on the host into a data lut of `to` and, where `nullable`, an ok lut
    (`fn` gives None for NULL), which the codes gather on the device. Each
    lut is asked for in every pass (C7); the dictionary keeps its device
    copies under `key`. `c` may be any dictionary-encoded value (a nested
    entry goes to `fn` as its list or dict)."""
    sd = c.sdict or StringDict([empty_entry(c.dtype)])
    np_dt = torch.empty(0, dtype=to.device_dtype).numpy().dtype
    memo: list = []

    def luts():
        if not memo:
            vals = sd.values or [empty_entry(c.dtype)]
            out = np.zeros(len(vals), dtype=np_dt)
            ok = np.zeros(len(vals), dtype=bool)
            for i, v in enumerate(vals):
                p = fn(v)
                if p is not None:
                    out[i] = p
                    ok[i] = True
            memo.append((out, ok))
        return memo[0]

    def lut(i, name):
        return _take_codes(ctx.aux(lambda: luts()[i], lambda: sd._on(
            name, ctx.device, lambda: luts()[i])), c.data)

    if not nullable:
        return Val(to, lut(0, key), c.validity)
    ok = lut(1, key + ":ok")
    return Val(to, lut(0, key), ok if c.validity is None
               else ok & c.validity)


def _string_parse(ctx: EvalCtx, c: Val, to: DataType) -> Val:
    """cast(string as numeric, boolean or date), and try_cast: each
    dictionary value parsed once on the host (`_parse_str`); a value that
    does not parse is NULL. A value past the target type's range raises,
    as numpy's assignment raises in the reference."""
    return _value_luts(ctx, c, f"parse:{to.simple_string()}", to,
                       lambda v: _parse_str(v, to))


def _float_to_int(x: torch.Tensor, dd: torch.dtype) -> torch.Tensor:
    """Whole floats converted to the integral dtype `dd` as the reference's
    compiler converts them: NaN reads as 0 and a value past the type's
    range saturates at its end (torch's own conversion of such a value is
    undefined: on x86 it gives the minimum)."""
    info = torch.iinfo(dd)
    hi = x >= float(info.max) + 1.0  # 2^(bits-1), a power of two
    lo = x < float(info.min)
    safe = torch.where(hi | lo | torch.isnan(x), torch.zeros_like(x), x)
    return torch.where(hi, info.max, torch.where(lo, info.min, safe.to(dd)))


def _fits_precision(data: torch.Tensor, to: DecimalType, validity):
    """Validity of a rescaled decimal: a value with more digits than the
    target precision reads as NULL, as Spark's non-ANSI cast gives (the
    reference emits the overflowed value; ROADMAP.md section C)."""
    ok = data.abs() < 10 ** to.precision
    return ok if validity is None else ok & validity


def cast_if(e: Expression, to: DataType) -> Expression:
    if e.resolved and e.dtype == to:
        return e
    c = getattr(e, "_cast_cache", None)
    if c is not None and c.to == to:
        return c
    c = Cast(e, to)
    e._cast_cache = c
    return c


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

class BinaryExpression(Expression):
    child_fields = ("left", "right")
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.left = left
        self.right = right

    def simple_string(self) -> str:
        return (f"({self.left.simple_string()} {self.symbol} "
                f"{self.right.simple_string()})")


class BinaryArithmetic(BinaryExpression):
    @property
    def dtype(self) -> DataType:
        lt, rt = self.left.dtype, self.right.dtype
        ct = common_type(lt, rt)
        if ct is None or not isinstance(ct, NumericType):
            if isinstance(lt, DateType) or isinstance(rt, DateType):
                return self._date_result(lt, rt)
            raise TypeCheckError(
                f"{type(self).__name__} needs numeric operands, got "
                f"{lt.simple_string()}, {rt.simple_string()}")
        return self._result_type(ct)

    def _date_result(self, lt, rt) -> DataType:
        raise TypeCheckError(f"cannot apply {self.symbol} to dates")

    def _result_type(self, ct: DataType) -> DataType:
        return ct

    def eval(self, ctx: EvalCtx) -> Val:
        l = ctx.eval(self.left)
        r = ctx.eval(self.right)
        v = ctx.and_valid(l, r)
        out = self.dtype
        ld, rd = self._align(ctx, l, r, out)
        data, extra_null = self._op(ld, rd)
        if extra_null is not None:
            v = extra_null if v is None else (v & extra_null)
        return Val(out, data, v)

    def _align(self, ctx, l: Val, r: Val, out: DataType):
        if isinstance(out, DecimalType):
            lc = l if isinstance(l.dtype, DecimalType) \
                else cast_val(ctx, l, out)
            rc = r if isinstance(r.dtype, DecimalType) \
                else cast_val(ctx, r, out)
            return lc.data, rc.data
        dd = out.device_dtype
        return l.data.to(dd), r.data.to(dd)

    def _op(self, l, r):
        raise NotImplementedError


def _decimal_sum_type(ct: DataType) -> DataType:
    if isinstance(ct, DecimalType):
        return DecimalType(min(ct.precision + 1, DecimalType.MAX_PRECISION),
                           ct.scale)
    return ct


class Add(BinaryArithmetic):
    """`+`; a date plus an integer count of days, or plus an INTERVAL."""

    symbol = "+"

    @property
    def dtype(self):
        if isinstance(self.right, IntervalLiteral):
            return self.left.dtype
        if isinstance(self.left, IntervalLiteral):
            return self.right.dtype
        return super().dtype

    def _date_result(self, lt, rt):
        if isinstance(lt, DateType) and isinstance(rt, IntegralType):
            return date
        if isinstance(rt, DateType) and isinstance(lt, IntegralType):
            return date
        raise TypeCheckError("date + non-int")

    def _result_type(self, ct):
        return _decimal_sum_type(ct)

    def eval(self, ctx):
        for iv, other in ((self.right, self.left), (self.left, self.right)):
            if isinstance(iv, IntervalLiteral):
                return _apply_interval(ctx.eval(other), iv)
        lt, rt = self.left.dtype, self.right.dtype
        if isinstance(lt, DateType) or isinstance(rt, DateType):
            l, r = ctx.eval(self.left), ctx.eval(self.right)
            v = ctx.and_valid(l, r)
            if isinstance(lt, DateType):
                return Val(date, l.data + r.data.to(torch.int32), v)
            return Val(date, r.data + l.data.to(torch.int32), v)
        return _contracted_sum(ctx, self, 1.0) or super().eval(ctx)

    def _op(self, l, r):
        return l + r, None


class Subtract(BinaryArithmetic):
    """`-`; a date minus days or an INTERVAL, and date - date in days."""

    symbol = "-"

    @property
    def dtype(self):
        if isinstance(self.right, IntervalLiteral):
            return self.left.dtype
        return super().dtype

    def _date_result(self, lt, rt):
        if isinstance(lt, DateType) and isinstance(rt, DateType):
            return int32
        if isinstance(lt, DateType) and isinstance(rt, IntegralType):
            return date
        raise TypeCheckError("unsupported date subtraction")

    def _result_type(self, ct):
        return _decimal_sum_type(ct)

    def eval(self, ctx):
        if isinstance(self.right, IntervalLiteral):
            return _apply_interval(ctx.eval(self.left), self.right.negated())
        if isinstance(self.left.dtype, DateType):
            l, r = ctx.eval(self.left), ctx.eval(self.right)
            out = self._date_result(l.dtype, r.dtype)
            return Val(out, (l.data - r.data).to(torch.int32),
                       ctx.and_valid(l, r))
        return _contracted_sum(ctx, self, -1.0) or super().eval(ctx)

    def _op(self, l, r):
        return l - r, None


class Multiply(BinaryArithmetic):
    symbol = "*"

    @staticmethod
    def _decimal_types(lt, rt):
        def as_dec(t):
            if isinstance(t, DecimalType):
                return t
            if isinstance(t, IntegralType):
                p = {1: 3, 2: 5, 4: 10, 8: 19}[t.device_dtype.itemsize]
                return DecimalType(p, 0)
            return None

        ld, rd = as_dec(lt), as_dec(rt)
        if ld is not None and rd is not None and (
                isinstance(lt, DecimalType) or isinstance(rt, DecimalType)):
            return ld, rd
        return None

    def _result_type(self, ct):
        if isinstance(ct, DecimalType):
            dd = self._decimal_types(self.left.dtype, self.right.dtype)
            if dd is not None:
                p = dd[0].precision + dd[1].precision
                s = dd[0].scale + dd[1].scale
                if p <= DecimalType.MAX_PRECISION:
                    return DecimalType(p, s)  # exact scaled-int64 product
            # past int64's digits the reference computes in float64
            return float64
        return ct

    def _align(self, ctx, l, r, out):
        if isinstance(out, DecimalType):
            # exact: the raw scaled int64 product, the scales add
            return l.data.to(torch.int64), r.data.to(torch.int64)
        if isinstance(out, FractionalType) and (
                isinstance(l.dtype, DecimalType)
                or isinstance(r.dtype, DecimalType)):
            return (cast_val(ctx, l, float64).data,
                    cast_val(ctx, r, float64).data)
        return super()._align(ctx, l, r, out)

    def eval(self, ctx):
        return _eval_scaled(ctx, self) or super().eval(ctx)

    def _op(self, l, r):
        return l * r, None


# Doubles scaled by constants round as the reference's compiled programs
# do. XLA's algebraic simplifier rewrites a division by a constant into a
# product with its reciprocal (the decimal -> double cast divides by
# 10^scale) and `(A * C1) * C2` into `A * (C1 * C2)`; the product of the
# two constants is a new instruction, which is a constant again only once
# the constant-folding pass has run. The passes alternate until nothing
# changes. The port replays them on the chain of constant factors and
# applies the resulting factor with one multiplication, which rounds the
# same on the CPU and the card.

def _constant_factor(e: Expression) -> float | None:
    if isinstance(e, Literal) and e.value is not None and \
            isinstance(e.dtype, (IntegralType, FractionalType)) and \
            not isinstance(e.dtype, DecimalType):
        return float(e.value)
    return None


def _scale_chain(e: Expression):
    """The chain of products and quotients by constants that computes `e`
    read as a double, as links ("div", child, constant) and ("mul", child,
    constant) down to ("raw", decimal expression), a decimal's unscaled
    integers, or ("leaf", expression). A constant is ("const", value) or
    ("mulc", constant, constant), a product not folded yet."""
    if isinstance(e, Divide):
        c = _constant_factor(e.right)
        if c:  # a zero divisor keeps the NULL path
            return ("div", _scale_chain(e.left), ("const", c))
    elif isinstance(e, Multiply) and e.dtype == float64:
        for lit, other in ((e.right, e.left), (e.left, e.right)):
            c = _constant_factor(lit)
            if c is not None and _constant_factor(other) is None:
                return ("mul", _scale_chain(other), ("const", c))
    elif isinstance(e, Cast) and e.to == float64 and \
            isinstance(e.child.dtype, DecimalType):
        return _scale_chain(e.child)
    elif isinstance(e.dtype, DecimalType):
        # read as a double: its unscaled integers over 10^scale
        return ("div", ("raw", e), ("const", 10.0 ** e.dtype.scale))
    return ("leaf", e)


def _simplify_pass(node):
    """One post-order pass of the two rewrites; a rewritten node is not
    revisited in the same pass."""
    kind = node[0]
    if kind in ("leaf", "raw"):
        return node
    child, k = _simplify_pass(node[1]), node[2]
    if kind == "div":
        return ("mul", child, ("const", 1.0 / k[1]))
    if k[0] == "const" and child[0] == "mul" and child[2][0] == "const":
        return ("mul", child[1], ("mulc", child[2], k))
    return ("mul", child, k)


def _fold_constants(node):
    kind = node[0]
    if kind == "mulc":
        return ("const", _fold_constants(node[1])[1] *
                _fold_constants(node[2])[1])
    if kind in ("mul", "div"):
        return (kind, _fold_constants(node[1]), _fold_constants(node[2]))
    return node


def _eval_scaled(ctx: EvalCtx, e: Expression) -> Val | None:
    """`e` as base * factor when it is a double scaled by constants, else
    None (the operator's own evaluation)."""
    ops = _scaled_operands(ctx, e)
    if ops is None:
        return None
    data, f, v = ops
    return Val(float64, data * f, v)


def _scaled_operands(ctx: EvalCtx, e: Expression):
    """(x, f, validity) with `e` = x * f, f its chain's last constant
    factor, where `e` is a double scaled by constants; else None."""
    if e.dtype != float64:
        return None
    node = _scale_chain(e)
    if node[0] not in ("mul", "div"):
        return None
    while True:
        nxt = _fold_constants(_simplify_pass(node))
        if nxt == node:
            break
        node = nxt
    factors = []
    while node[0] == "mul":
        factors.append(node[2][1])
        node = node[1]
    kind, base = node
    v = ctx.eval(base)
    if kind == "raw":
        data = v.data.to(torch.float64)
    else:
        data = cast_val(ctx, v, float64).data
    for f in reversed(factors[1:]):
        data = data * f
    return data, factors[0], v.validity


def _product_operands(ctx: EvalCtx, e: Expression):
    """(a, b, validity) where `e` is a double product a * b, which the
    reference's compiler contracts with a sum that reads it into one fused
    multiply-add; else None."""
    if not isinstance(e, Multiply) or e.dtype != float64:
        return None
    ops = _scaled_operands(ctx, e)
    if ops is None:
        l, r = ctx.eval(e.left), ctx.eval(e.right)
        ops = (*e._align(ctx, l, r, float64), ctx.and_valid(l, r))
    a, b, v = ops
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return None
    # a literal factor (the moments' 3.0 * ...) broadcasts as a tensor
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    elif not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a, b, v


def _contracted_sum(ctx: EvalCtx, e: Expression, sign: float):
    """left + sign * right of doubles where one side is a product, rounded
    once as the reference's compiler rounds it (the left product first,
    as LLVM contracts it); else None."""
    if e.dtype != float64:
        return None
    for side, other, neg_prod in ((e.left, e.right, False),
                                  (e.right, e.left, sign < 0)):
        ops = _product_operands(ctx, side)
        if ops is None:
            continue
        a, b, v = ops
        o = ctx.eval(other)
        od = cast_val(ctx, o, float64).data
        if side is e.left and sign < 0:
            od = -od
        if neg_prod:
            a = -a
        v = v if o.validity is None else (o.validity if v is None
                                          else v & o.validity)
        return Val(float64, _fma(a, b, od), v)
    return None


def _signed_int(t: torch.Tensor) -> bool:
    return not t.dtype.is_floating_point and t.dtype != torch.bool


class TryAdd(Add):
    """try_add: NULL on integral overflow instead of wrapping."""

    def _op(self, l, r):
        data, _ = super()._op(l, r)
        if not _signed_int(data):
            return data, None
        # signed add overflows iff operands share a sign the result lost
        ok = ~(((l >= 0) == (r >= 0)) & ((data >= 0) != (l >= 0)))
        return data, ok


class TrySubtract(Subtract):
    """try_subtract: NULL on integral overflow instead of wrapping."""

    def _op(self, l, r):
        data, _ = super()._op(l, r)
        if not _signed_int(data):
            return data, None
        ok = ~(((l >= 0) != (r >= 0)) & ((data >= 0) != (l >= 0)))
        return data, ok


class TryMultiply(Multiply):
    """try_multiply: NULL on integral overflow instead of wrapping."""

    def _op(self, l, r):
        data, _ = super()._op(l, r)
        if not _signed_int(data):
            return data, None
        info = torch.iinfo(data.dtype)
        if info.bits < 64:
            wide = l.to(torch.int64) * r.to(torch.int64)
            return data, (wide >= info.min) & (wide <= info.max)
        # int64: the wrapped product res = l*r - k*2^64 satisfies
        # floor(res/l) == r only for k == 0; (-1, INT64_MIN) is special
        nz = torch.where(l == 0, torch.ones_like(l), l)
        ok = (l == 0) | (torch.floor_divide(data, nz) == r)
        ok = ok & ~((l == -1) & (r == info.min))
        return data, ok


class Divide(BinaryArithmetic):
    symbol = "/"

    def _result_type(self, ct):
        return float64

    def eval(self, ctx):
        return _eval_scaled(ctx, self) or super().eval(ctx)

    def _align(self, ctx, l, r, out):
        return (cast_val(ctx, l, float64).data, cast_val(ctx, r, float64).data)

    def _op(self, l, r):
        zero = r == 0
        safe = torch.where(zero, torch.ones_like(r), r)
        return l / safe, ~zero  # x/0 => NULL (non-ANSI Spark semantics)


def _two_product(a, b):
    """(p, e) with p = fl(a * b) and a * b = p + e exactly (Dekker's
    product: each factor split into halves of 26 bits, a factor past 2^900
    scaled by 2^-200 first, which is exact, so that the split cannot
    overflow)."""
    big = 2.0 ** 900
    sa = torch.ones_like(a).masked_fill(a.abs() > big, 2.0 ** -200)
    sb = torch.ones_like(b).masked_fill(b.abs() > big, 2.0 ** -200)
    a2, b2 = a * sa, b * sb
    p2 = a2 * b2

    def split(x):
        t = x * 134217729.0  # 2^27 + 1
        hi = t - (t - x)
        return hi, x - hi

    ah, al = split(a2)
    bh, bl = split(b2)
    e2 = ((ah * bh - p2) + ah * bl + al * bh) + al * bl
    scale = 1.0 / (sa * sb)
    return a * b, e2 * scale


def _fma(a, b, c):
    """a * b + c rounded once, as a fused multiply-add: the reference's
    compiler contracts a product feeding a sum inside one fused loop, and
    torch runs each op as its own kernel, so the port forms the exact
    product (`_two_product`) and sum (Knuth's TwoSum) and rounds their
    total once. Non-finite intermediates fall back to a * b + c."""
    p, e = _two_product(a, b)
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    out = s + (t + e)
    return torch.where(torch.isfinite(s) & torch.isfinite(e), out, s)


class Remainder(BinaryArithmetic):
    """`%` and mod: the sign of the dividend (Java's), not the divisor's
    (torch.remainder's); a zero divisor gives NULL. Integers by the
    reference's formula l - sign(l) * (|l| // |r|) * |r|, which wraps as
    it wraps where |x| of the int64 minimum is the minimum; doubles as
    l - trunc(l / r) * r, with a literal divisor's quotient taken as a
    product with its reciprocal, as the reference's compiler rewrites a
    division by a constant, and the product and difference rounded once,
    as its fused multiply-add rounds them (`_fma`)."""

    symbol = "%"

    def _op(self, l, r):
        zero = r == 0
        safe = torch.where(zero, torch.ones_like(r), r)
        if l.dtype.is_floating_point:
            q = l * (1.0 / safe) if safe.dim() == 0 else l / safe
            return _fma(-torch.trunc(q), safe, l), ~zero
        a = torch.abs(safe)
        return l - torch.sign(l) * _floordiv(torch.abs(l), a) * a, ~zero


class BitwiseAnd(BinaryArithmetic):
    symbol = "&"

    def _op(self, l, r):
        return l & r, None


class BitwiseOr(BinaryArithmetic):
    symbol = "|"

    def _op(self, l, r):
        return l | r, None


class BitwiseXor(BinaryArithmetic):
    symbol = "^"

    def _op(self, l, r):
        return l ^ r, None


def _shift_out_of_range(l, r):
    bits = torch.iinfo(l.dtype).bits
    oob = (r < 0) | (r >= bits)
    return oob, torch.where(oob, torch.zeros_like(r), r)


class ShiftLeft(BinaryArithmetic):
    """`<<`: an amount outside [0, bits) gives 0, as the reference's
    shift_left gives on every device; C++ leaves it undefined, so the
    port shifts by an amount kept in range and picks the result."""

    symbol = "<<"

    def _op(self, l, r):
        oob, amt = _shift_out_of_range(l, r)
        return torch.where(oob, torch.zeros_like(l), l << amt), None


class ShiftRight(BinaryArithmetic):
    """`>>`: arithmetic; an amount outside [0, bits) fills with the sign
    bit (0 or -1), as the reference's shift_right_arithmetic."""

    symbol = ">>"

    def _op(self, l, r):
        oob, amt = _shift_out_of_range(l, r)
        fill = torch.where(l < 0, -1, 0).to(l.dtype)
        return torch.where(oob, fill, l >> amt), None


class Pow(BinaryArithmetic):
    symbol = "^"

    def _result_type(self, ct):
        return float64

    def _align(self, ctx, l, r, out):
        return (cast_val(ctx, l, float64).data, cast_val(ctx, r, float64).data)

    def _op(self, l, r):
        return torch.pow(l, r), None


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------

def _string_eq_domain(ctx: EvalCtx, v: Val) -> torch.Tensor:
    """A string value's codes mapped to 64-bit value hashes: equal strings
    hash equal whatever dictionary holds them."""
    sd = v.sdict or EMPTY_DICT
    return _take_codes(ctx.aux(lambda: sd.hashes if len(sd.values)
                               else np.zeros(1, np.int64),
                               lambda: sd.device_hashes(ctx.device)),
                       v.data)


def _string_rank_domain(ctx: EvalCtx, l: Val, r: Val):
    """Two string values mapped into one ordering domain: ranks in the
    sorted union of both dictionaries (ranks of two dictionaries do not
    compare). Nested entries order by `_order_key` (lists element by
    element, structs field by field)."""
    a = l.sdict or StringDict([empty_entry(l.dtype)])
    b = r.sdict or StringDict([empty_entry(r.dtype)])
    key = _order_key if (a.nested or b.nested) else (lambda v: v)
    ka = [key(v) for v in a.values]
    kb = [key(v) for v in b.values]
    allv = sorted(set(ka) | set(kb))
    pos = {v: i for i, v in enumerate(allv)}
    la = np.array([pos[v] for v in ka] or [0], dtype=np.int64)
    lb = np.array([pos[v] for v in kb] or [0], dtype=np.int64)
    return (_take_codes(ctx.aux(lambda: la), l.data),
            _take_codes(ctx.aux(lambda: lb), r.data))


class BinaryComparison(BinaryExpression):
    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        l = ctx.eval(self.left)
        r = ctx.eval(self.right)
        if dict_encoded(l.dtype) and dict_encoded(r.dtype):
            # strings, and nested values by canonical form (the reference
            # compares a nested column's codes)
            if type(self) in (EqualTo, NotEqualTo):
                ld = _string_eq_domain(ctx, l)
                rd = _string_eq_domain(ctx, r)
            else:
                ld, rd = _string_rank_domain(ctx, l, r)
            return Val(boolean, self._cmp(ld, rd), ctx.and_valid(l, r))
        ct = common_type(l.dtype, r.dtype) or l.dtype
        lc = cast_val(ctx, l, ct)
        rc = cast_val(ctx, r, ct)
        return Val(boolean, self._cmp(lc.data, rc.data),
                   ctx.and_valid(lc, rc))

    def _cmp(self, l, r):
        raise NotImplementedError


class EqualTo(BinaryComparison):
    symbol = "="

    def _cmp(self, l, r):
        return l == r


class NotEqualTo(BinaryComparison):
    symbol = "!="

    def _cmp(self, l, r):
        return l != r


class EqualNullSafe(BinaryComparison):
    """`<=>`: TRUE where both sides are NULL, FALSE where one is, else
    `=`; never NULL."""

    symbol = "<=>"

    @property
    def nullable(self):
        return False

    def eval(self, ctx):
        l = ctx.eval(self.left)
        r = ctx.eval(self.right)
        if isinstance(l.dtype, StringType) and isinstance(r.dtype,
                                                          StringType):
            ld, rd = _string_eq_domain(ctx, l), _string_eq_domain(ctx, r)
        else:
            ct = common_type(l.dtype, r.dtype) or l.dtype
            l, r = cast_val(ctx, l, ct), cast_val(ctx, r, ct)
            ld, rd = l.data, r.data
        lv, rv = _known(ctx, l.validity), _known(ctx, r.validity)
        return Val(boolean, torch.where(lv & rv, ld == rd, ~lv & ~rv))


class LessThan(BinaryComparison):
    symbol = "<"

    def _cmp(self, l, r):
        return l < r


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def _cmp(self, l, r):
        return l <= r


class GreaterThan(BinaryComparison):
    symbol = ">"

    def _cmp(self, l, r):
        return l > r


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def _cmp(self, l, r):
        return l >= r


# ---------------------------------------------------------------------------
# Boolean logic — Kleene three-valued
# ---------------------------------------------------------------------------

def _known(ctx: EvalCtx, validity):
    return validity if validity is not None else ctx.scalar(True, torch.bool)


class And(BinaryExpression):
    symbol = "AND"

    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        l = ctx.eval(self.left)
        r = ctx.eval(self.right)
        if l.validity is None and r.validity is None:
            return Val(boolean, l.data & r.data)
        lv, rv = _known(ctx, l.validity), _known(ctx, r.validity)
        # FALSE wins over NULL: known iff both known or either a known FALSE
        known = (lv & rv) | (lv & ~l.data) | (rv & ~r.data)
        return Val(boolean, (lv & l.data) & (rv & r.data), known)


class Or(BinaryExpression):
    symbol = "OR"

    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        l = ctx.eval(self.left)
        r = ctx.eval(self.right)
        if l.validity is None and r.validity is None:
            return Val(boolean, l.data | r.data)
        lv, rv = _known(ctx, l.validity), _known(ctx, r.validity)
        known = (lv & rv) | (lv & l.data) | (rv & r.data)
        return Val(boolean, (lv & l.data) | (rv & r.data), known)


class UnaryExpression(Expression):
    child_fields = ("child",)

    def __init__(self, child: Expression):
        self.child = child

    def simple_string(self) -> str:
        return f"{self.sql_name()}({self.child.simple_string()})"


class UnaryMinus(UnaryExpression):
    @property
    def dtype(self):
        return self.child.dtype

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if not isinstance(c.dtype, NumericType):
            raise TypeCheckError(
                f"unary minus of {c.dtype.simple_string()}")
        return Val(self.dtype, -c.data, c.validity)


class Abs(UnaryExpression):
    @property
    def dtype(self):
        return self.child.dtype

    def eval(self, ctx):
        c = ctx.eval(self.child)
        return Val(self.dtype, torch.abs(c.data), c.validity)


class BitwiseNot(UnaryExpression):
    @property
    def dtype(self):
        return self.child.dtype

    def eval(self, ctx):
        c = ctx.eval(self.child)
        return Val(self.dtype, ~c.data, c.validity)


class _MathUnary(UnaryExpression):
    """A float64 function of one argument; where `domain_check` fails the
    result is NULL, not NaN (the reference's domain checks). The
    transcendental functions are torch's, which differ from the
    reference's compiled ones and CUDA's in the last bits (the port's
    tests hold them to 4 ulp); sqrt is correctly rounded on every device
    and compares exactly."""

    fn = None
    domain_check = None

    @property
    def dtype(self):
        return float64

    def eval(self, ctx):
        c = ctx.eval(self.child)
        x = cast_val(ctx, c, float64).data
        v = c.validity
        if self.domain_check is not None:
            ok = self.domain_check(x)
            x = torch.where(ok, x, torch.ones_like(x))
            v = ok if v is None else (v & ok)
        return Val(float64, self.fn(x), v)


def _sqrt(x):
    """Correctly rounded on both devices, so they agree bit for bit: CUDA's
    sqrt is, torch's vectorised CPU sqrt is not (it misrounds about one
    double in eight), numpy's is."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)


def _cbrt(x):
    """The real cube root as the reference's compiler computes it:
    |x|^(1/3) with the sign put back (torch has no cbrt)."""
    return torch.copysign(torch.pow(torch.abs(x), 1.0 / 3.0), x)


# log1p as the reference's compiler computes it: below sqrt(2) - 1 in
# magnitude a rational function (Cephes' log1p), evaluated by Horner's rule
# with each step a fused multiply-add; above it log(1 + x)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def _horner(x, coeffs):
    acc = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        acc = _fma(acc, x, torch.full_like(x, c))
    return acc


def _log1p(x):
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + _fma(torch.full_like(x, -0.5), x2, small)
    return torch.where(torch.abs(x) < 0.41421356237309504880, small,
                       torch.log(x + 1.0))


class Sqrt(_MathUnary):
    fn = staticmethod(_sqrt)
    domain_check = staticmethod(lambda x: x >= 0)


class Exp(_MathUnary):
    fn = staticmethod(torch.exp)


class Log(_MathUnary):
    fn = staticmethod(torch.log)
    domain_check = staticmethod(lambda x: x > 0)


class Log10(_MathUnary):
    fn = staticmethod(torch.log10)
    domain_check = staticmethod(lambda x: x > 0)


class Sin(_MathUnary):
    fn = staticmethod(torch.sin)


class Cos(_MathUnary):
    fn = staticmethod(torch.cos)


class Tan(_MathUnary):
    fn = staticmethod(torch.tan)


class Asin(_MathUnary):
    fn = staticmethod(torch.asin)
    domain_check = staticmethod(lambda x: torch.abs(x) <= 1)


class Acos(_MathUnary):
    fn = staticmethod(torch.acos)
    domain_check = staticmethod(lambda x: torch.abs(x) <= 1)


class Atan(_MathUnary):
    fn = staticmethod(torch.atan)


class Sinh(_MathUnary):
    fn = staticmethod(torch.sinh)


class Cosh(_MathUnary):
    fn = staticmethod(torch.cosh)


class Tanh(_MathUnary):
    fn = staticmethod(torch.tanh)


class Log2(_MathUnary):
    fn = staticmethod(torch.log2)
    domain_check = staticmethod(lambda x: x > 0)


class Log1p(_MathUnary):
    fn = staticmethod(_log1p)
    domain_check = staticmethod(lambda x: x > -1)


class Expm1(_MathUnary):
    fn = staticmethod(torch.expm1)


class Degrees(_MathUnary):
    # a product with the constant 180/pi, as numpy's degrees
    fn = staticmethod(lambda x: x * (180.0 / math.pi))


class Radians(_MathUnary):
    fn = staticmethod(lambda x: x * (math.pi / 180.0))


class Cbrt(_MathUnary):
    fn = staticmethod(_cbrt)


class Atan2(BinaryArithmetic):
    symbol = "atan2"

    def _result_type(self, ct):
        return float64

    def _align(self, ctx, l, r, out):
        return (cast_val(ctx, l, float64).data, cast_val(ctx, r, float64).data)

    def _op(self, l, r):
        return torch.atan2(l, r), None


class Signum(UnaryExpression):
    """sign(x) as a double: -1, 1, or x itself where it is a zero or NaN
    (-0.0 and NaN pass through, as the reference's sign gives; torch.sign
    gives +0.0 for both)."""

    @property
    def dtype(self):
        return float64

    def eval(self, ctx):
        c = ctx.eval(self.child)
        x = c.data.to(torch.float64)
        data = torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))
        return Val(float64, data, c.validity)


class Floor(UnaryExpression):
    @property
    def dtype(self):
        ct = self.child.dtype
        return ct if isinstance(ct, (IntegralType, DecimalType)) else int64

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if isinstance(c.dtype, IntegralType):
            return c
        if isinstance(c.dtype, DecimalType):
            f = 10 ** c.dtype.scale
            d = torch.where(c.data >= 0, _floordiv(c.data, f),
                            -_floordiv(-c.data + f - 1, f)) * f
            return Val(c.dtype, d, c.validity)
        return Val(int64, _float_to_int(torch.floor(c.data), torch.int64),
                   c.validity)


class Ceil(UnaryExpression):
    @property
    def dtype(self):
        ct = self.child.dtype
        return ct if isinstance(ct, (IntegralType, DecimalType)) else int64

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if isinstance(c.dtype, IntegralType):
            return c
        if isinstance(c.dtype, DecimalType):
            f = 10 ** c.dtype.scale
            d = torch.where(c.data >= 0, _floordiv(c.data + f - 1, f),
                            -_floordiv(-c.data, f)) * f
            return Val(c.dtype, d, c.validity)
        return Val(int64, _float_to_int(torch.ceil(c.data), torch.int64),
                   c.validity)


class NanVl(Expression):
    """nanvl(a, b): b where a is NaN. A NULL `a` stays NULL even where its
    masked payload is NaN (the null check comes first)."""

    child_fields = ("left", "right")

    def __init__(self, left: Expression, right: Expression):
        self.left = left
        self.right = right

    @property
    def dtype(self):
        return float64

    def eval(self, ctx):
        a = ctx.eval(cast_if(self.left, float64))
        b = ctx.eval(cast_if(self.right, float64))
        n = (ctx.capacity,)
        nan = torch.isnan(a.data)
        data = torch.broadcast_to(torch.where(nan, b.data, a.data), n)
        valid = None
        if a.validity is not None or b.validity is not None:
            av, bv = _known(ctx, a.validity), _known(ctx, b.validity)
            valid = torch.broadcast_to(torch.where(nan, av & bv, av), n)
        return Val(float64, data, valid)


class IsNaN(UnaryExpression):
    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if c.data.dtype.is_floating_point:
            return Val(boolean, torch.isnan(c.data), c.validity)
        return Val(boolean, ctx.scalar(False, torch.bool), c.validity)


class Not(UnaryExpression):
    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        c = ctx.eval(self.child)
        return Val(boolean, ~c.data, c.validity)


class IsNull(UnaryExpression):
    @property
    def dtype(self):
        return boolean

    @property
    def nullable(self):
        return False

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if c.validity is None:
            return Val(boolean, ctx.scalar(False, torch.bool))
        return Val(boolean, ~c.validity)


class IsNotNull(UnaryExpression):
    @property
    def dtype(self):
        return boolean

    @property
    def nullable(self):
        return False

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if c.validity is None:
            return Val(boolean, ctx.scalar(True, torch.bool))
        return Val(boolean, c.validity)


# ---------------------------------------------------------------------------
# Conditionals and IN
# ---------------------------------------------------------------------------

class If(Expression):
    child_fields = ("pred", "then", "otherwise")

    def __init__(self, pred, then, otherwise):
        self.pred = pred
        self.then = then
        self.otherwise = otherwise

    @property
    def dtype(self):
        return common_type(self.then.dtype, self.otherwise.dtype) or \
            self.then.dtype

    def eval(self, ctx):
        return CaseWhen([(self.pred, self.then)], self.otherwise).eval(ctx)


class CaseWhen(Expression):
    child_fields = ("branch_exprs", "else_expr")
    equality_excluded_fields = ("branches",)  # same nodes as branch_exprs

    def __init__(self, branches: Sequence[tuple[Expression, Expression]],
                 else_expr: Expression | None = None):
        self.branches = [(p, v) for p, v in branches]
        self.branch_exprs = [e for pv in self.branches for e in pv]
        self.else_expr = else_expr if else_expr is not None else Literal(None)

    def copy(self, **overrides):
        if "branch_exprs" in overrides:
            be = list(overrides["branch_exprs"])
            overrides["branch_exprs"] = be
            overrides["branches"] = [(be[i], be[i + 1])
                                     for i in range(0, len(be), 2)]
        new = super().copy(**overrides)
        new.__dict__.pop("_hash", None)  # the branches may have changed
        return new

    @property
    def dtype(self):
        # memoised: nested CASEs revisit each level's type from every
        # ancestor (TreeNode.copy drops the memo)
        memo = self.__dict__.get("_dtype_memo")
        if memo is not None:
            return memo
        dt: DataType = null_type
        for _, v in self.branches:
            dt = common_type(dt, v.dtype) or v.dtype
        dt = common_type(dt, self.else_expr.dtype) or dt
        self.__dict__["_dtype_memo"] = dt
        return dt

    def eval(self, ctx):
        out = self.dtype
        if dict_encoded(out):
            return self._eval_string(ctx)
        # every branch runs over the whole tile (x/0 is NULL, not a fault)
        # and the first true predicate picks each row's value
        vals = [(ctx.eval(p), ctx.eval(cast_if(v, out)))
                for p, v in self.branches]
        ev = ctx.eval(cast_if(self.else_expr, out))
        n = (ctx.capacity,)
        data = torch.broadcast_to(ev.data, n)
        valid = torch.broadcast_to(_known(ctx, ev.validity), n)
        decided = torch.zeros(n, dtype=torch.bool, device=ctx.device)
        for p, v in vals:
            pd = p.data if p.validity is None else p.data & p.validity
            hit = pd & ~decided
            data = torch.where(hit, v.data, data)
            valid = torch.where(hit, _known(ctx, v.validity), valid)
            decided = decided | hit
        has_null = ev.validity is not None or \
            any(v.validity is not None for _, v in vals)
        return Val(out, data, valid if has_null else None)


    def _eval_string(self, ctx):
        """String CASE: the branch dictionaries merge into one output
        dictionary (first occurrence order, as the reference's merge), and
        each branch's codes recode into it by one device gather."""
        vals = [(ctx.eval(p), ctx.eval(v)) for p, v in self.branches]
        ev = ctx.eval(self.else_expr)
        strs = [v for _, v in vals] + [ev]
        merged, luts = merge_string_dicts([v.sdict or EMPTY_DICT
                                           for v in strs])
        n = (ctx.capacity,)

        def recode(v, lut):
            return torch.broadcast_to(_take_codes(
                ctx.aux(lambda: lut), v.data), n)

        data = recode(ev, luts[-1])
        valid = torch.broadcast_to(_known(ctx, ev.validity), n)
        decided = torch.zeros(n, dtype=torch.bool, device=ctx.device)
        for (p, v), lut in zip(vals, luts):
            pd = p.data if p.validity is None else p.data & p.validity
            hit = pd & ~decided
            data = torch.where(hit, recode(v, lut), data)
            valid = torch.where(hit, _known(ctx, v.validity), valid)
            decided = decided | hit
        has_null = any(v.validity is not None for v in strs)
        return Val(self.dtype, data, valid if has_null else None, merged)


class Coalesce(Expression):
    child_fields = ("args",)

    def __init__(self, args: Sequence[Expression]):
        self.args = list(args)

    @property
    def dtype(self):
        dt: DataType = null_type
        for a in self.args:
            dt = common_type(dt, a.dtype) or a.dtype
        return dt

    @property
    def nullable(self):
        return all(a.nullable for a in self.args)

    def eval(self, ctx):
        branches = [(IsNotNull(a), a) for a in self.args[:-1]]
        return CaseWhen(branches, self.args[-1]).eval(ctx)


class NullIf(BinaryExpression):
    @property
    def dtype(self):
        return self.left.dtype

    def eval(self, ctx):
        return CaseWhen([(EqualTo(self.left, self.right),
                          Literal(None, self.left.dtype))],
                        self.left).eval(ctx)


class Greatest(Expression):
    """greatest(...) / least(...): NULLs skipped (NULL only where every
    argument is); arguments coerced to their common type. Strings expand
    into the null-skipping CASE chain over the dictionary comparisons
    (codes of two dictionaries do not order)."""

    child_fields = ("args",)
    _reduce = "maximum"

    def __init__(self, args: Sequence[Expression]):
        self.args = list(args)

    @property
    def dtype(self):
        dt = self.args[0].dtype
        for a in self.args[1:]:
            dt = common_type(dt, a.dtype) or dt
        return dt

    def eval(self, ctx):
        out = self.dtype
        if isinstance(out, StringType):
            cmp_cls = GreaterThan if self._reduce == "maximum" else LessThan
            acc = self.args[0]
            for a in self.args[1:]:
                acc = CaseWhen([(IsNull(a), acc), (IsNull(acc), a),
                                (cmp_cls(acc, a), acc)], a)
            return ctx.eval(acc)
        vals = [ctx.eval(cast_if(a, out)) for a in self.args]
        fn = getattr(torch, self._reduce)
        n = (ctx.capacity,)
        data = torch.broadcast_to(vals[0].data, n)
        valid = torch.broadcast_to(_known(ctx, vals[0].validity), n)
        for x in vals[1:]:
            xd = torch.broadcast_to(x.data, n)
            xv = torch.broadcast_to(_known(ctx, x.validity), n)
            data = torch.where(valid & xv, fn(data, xd),
                               torch.where(xv, xd, data))
            valid = valid | xv
        has_null = any(x.validity is not None for x in vals)
        return Val(out, data, valid if has_null else None)


class Least(Greatest):
    _reduce = "minimum"


class In(Expression):
    """SQL three-valued IN over a list: TRUE on a match; else NULL when the
    probe or an item is NULL; else FALSE. A string probe compares value
    hashes with literal items; numeric items are cast to the probe's
    type."""

    child_fields = ("child", "items")

    def __init__(self, child: Expression, items: Sequence[Expression]):
        self.child = child
        self.items = list(items)

    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if isinstance(c.dtype, StringType):
            if not all(isinstance(it, Literal) for it in self.items):
                raise UnsupportedOperationError(
                    "IN over strings needs literals")
            targets = [it.value for it in self.items if it.value is not None]
            has_null_item = len(targets) < len(self.items)
            if targets:
                # membership by a binary search of the sorted target
                # hashes: torch.isin may sort and dedup its input on the
                # card, which reads sizes on the host
                dom = _string_eq_domain(ctx, c)
                lut = ctx.aux(lambda: np.sort(StringDict(targets).hashes))
                flat = dom.reshape(-1)
                pos = torch.searchsorted(lut, flat).clamp_max(
                    lut.shape[0] - 1)
                data = (torch.take(lut, pos) == flat).reshape(dom.shape)
            else:
                data = torch.zeros(c.data.shape, dtype=torch.bool,
                                   device=ctx.device)
            valid = c.validity
            if has_null_item:  # unmatched rows are UNKNOWN, not FALSE
                valid = data if valid is None else valid & data
            return Val(boolean, data, valid)
        vals = [ctx.eval(cast_if(i, c.dtype)) for i in self.items]
        matched = ctx.scalar(False, torch.bool)
        null_any = ctx.scalar(False, torch.bool)
        for x in vals:
            xv = _known(ctx, x.validity)
            matched = matched | ((c.data == x.data) & xv)
            null_any = null_any | ~xv
        valid = matched | ~null_any  # unmatched with a NULL item: NULL
        if c.validity is not None:
            valid = valid & c.validity
        return Val(boolean, matched, valid)


class Round(Expression):
    """round(x, s): half up (away from zero), decimals on their scaled
    integers, doubles as trunc(x * 10^s +- 0.5) * 10^-s."""

    child_fields = ("child", "scale_expr")

    def __init__(self, child: Expression,
                 scale_expr: Expression | None = None):
        self.child = child
        self.scale_expr = scale_expr if scale_expr is not None else Literal(0)

    @property
    def dtype(self):
        ct = self.child.dtype
        return ct if isinstance(ct, (IntegralType, DecimalType)) else float64

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if not isinstance(self.scale_expr, Literal):
            raise UnsupportedOperationError("round() scale must be a literal")
        s = int(self.scale_expr.value or 0)
        if isinstance(c.dtype, DecimalType):
            delta = c.dtype.scale - s
            if delta <= 0:
                return c
            f = 10 ** delta
            half = f // 2
            d = torch.where(c.data >= 0, (c.data + half) // f,
                            -((-c.data + half) // f)) * f
            return Val(c.dtype, d, c.validity)
        if isinstance(c.dtype, IntegralType):
            return c
        x = cast_val(ctx, c, float64).data
        f = 10.0 ** s
        # x * f + 0.5 rounded once and the quotient by f taken as a product
        # with 1/f, as the reference's compiler computes them
        half = torch.where(x >= 0, 0.5, -0.5).to(x.dtype)
        d = torch.trunc(_fma(x, torch.full_like(x, f), half)) * (1.0 / f)
        return Val(float64, d, c.validity)


class BRound(Round):
    """bround(x, s): half to even, decimals on their scaled integers,
    doubles as rint(x * 10^s) * 10^-s."""

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if not isinstance(self.scale_expr, Literal):
            raise UnsupportedOperationError(
                "bround() scale must be a literal")
        s = int(self.scale_expr.value or 0)
        if isinstance(c.dtype, DecimalType):
            delta = c.dtype.scale - s
            if delta <= 0:
                return c
            f = 10 ** delta
            half = f // 2
            sign = torch.where(c.data >= 0, 1, -1)
            a = torch.abs(c.data)
            q = _floordiv(a, f)
            r = a - q * f
            up = (r > half) | ((r == half) & (torch.remainder(q, 2) == 1))
            return Val(c.dtype, sign * (q + up.to(q.dtype)) * f, c.validity)
        if isinstance(c.dtype, IntegralType):
            return c
        x = cast_val(ctx, c, float64).data
        f = 10.0 ** s
        # torch.round rounds half to even, as rint
        return Val(float64, torch.round(x * f) * (1.0 / f), c.validity)


# ---------------------------------------------------------------------------
# String functions: dictionary transforms
# ---------------------------------------------------------------------------

class _DictTransform(Expression):
    """A string -> string function applied to the dictionary's values on
    the host, once per dictionary (memoised on it). Where two values map to
    one (substr('ab', 1, 1) = substr('ac', 1, 1)) the mapped dictionary is
    deduplicated and the codes recoded by one device gather, so equal
    strings keep one code: the code-domain aggregate and the rank order
    need it (the reference keeps the duplicates: ROADMAP.md section C).
    Otherwise the device codes pass through unchanged, except in a fused
    stage: there an identity lut is gathered, so that every batch asks for
    the same luts whichever of its dictionaries merge (dictionaries are
    per slice, and a program's key holds only the luts' shapes)."""

    child_fields = ("child",)

    def __init__(self, child: Expression):
        self.child = child

    @property
    def dtype(self):
        return string

    # True where transform() may give None for a value: that value reads
    # as NULL, through an ok lut the codes gather
    may_null = False

    def transform(self, s: str) -> str:
        raise NotImplementedError

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if not isinstance(c.dtype, StringType):
            raise NotPortedError(
                f"{self.sql_name()} of {c.dtype.simple_string()} (a cast "
                "to string)")
        return _dict_transform(ctx, c, self.simple_string(), self.transform,
                               self.may_null)


def _dict_transform(ctx: EvalCtx, c: Val, key: str, fn, may_null: bool,
                    out: DataType = string) -> Val:
    """The dictionary-encoded value of type `out` (a string, or an array,
    map or struct) that `fn` maps `c` to, over its dictionary (see
    _DictTransform); with `may_null`, a value `fn` maps to None reads as
    NULL, its ok lut asked for in every pass (a fused program's luts must
    not depend on what a dictionary holds)."""
    src = c.sdict or StringDict([empty_entry(c.dtype)])
    blank = empty_entry(out)

    def mapped_fn(v):
        r = fn(v)
        return blank if r is None else r

    mapped, lut = src.transformed(key, mapped_fn)
    validity = c.validity
    if may_null:
        def make_ok():
            return np.array([fn(v) is not None for v in
                             (src.values or [empty_entry(c.dtype)])], bool)

        ok = _take_codes(ctx.aux(make_ok, lambda: src._on(
            ("ok", key), ctx.device, make_ok)), c.data)
        validity = ok if validity is None else validity & ok
    if lut is None:
        if not ctx.fused:
            return Val(out, c.data, validity, mapped)
        lut = np.arange(max(len(src.values), 1), dtype=np.int32)
    codes = ctx.aux(lambda: lut, lambda: src._on(
        ("recode", key), ctx.device, lambda: lut))
    return Val(out, _take_codes(codes, c.data), validity, mapped)


class Substring(_DictTransform):
    def __init__(self, child: Expression, pos: Expression,
                 length: Expression | None = None):
        super().__init__(child)
        if not isinstance(pos, Literal) or (
                length is not None and not isinstance(length, Literal)):
            raise NotPortedError("substring with non-literal pos/len")
        self.pos = int(pos.value)
        self.length = None if length is None else int(length.value)

    def transform(self, s):
        # SQL 1-based; pos 0 reads as 1, a negative pos counts from the end
        p = self.pos
        start = max(p - 1, 0) if p > 0 else max(len(s) + p, 0)
        if self.length is None:
            return s[start:]
        return s[start:start + max(self.length, 0)]


class Upper(_DictTransform):
    def transform(self, s):
        return s.upper()


class _Affix(_DictTransform):
    """prefix + s + suffix: concat of one string column with literals."""

    def __init__(self, child: Expression, prefix: str, suffix: str):
        super().__init__(child)
        self.prefix = prefix
        self.suffix = suffix

    def transform(self, s):
        return self.prefix + s + self.suffix


class Lower(_DictTransform):
    def transform(self, s):
        return s.lower()


class Trim(_DictTransform):
    def transform(self, s):
        return s.strip()


class LTrim(_DictTransform):
    def transform(self, s):
        return s.lstrip()


class RTrim(_DictTransform):
    def transform(self, s):
        return s.rstrip()


def _lit_value(e: Expression, what: str):
    """The value of a literal argument; a column there is not ported (nor
    supported by the reference)."""
    if not isinstance(e, Literal):
        raise NotPortedError(f"{what} with a non-literal argument")
    return e.value


class StringReplace(_DictTransform):
    def __init__(self, child: Expression, search: Expression,
                 replace: Expression):
        super().__init__(child)
        self.search = str(_lit_value(search, "replace"))
        self.replace = str(_lit_value(replace, "replace"))

    def transform(self, s):
        return s.replace(self.search, self.replace)


class Lpad(_DictTransform):
    def __init__(self, child, length: Expression, pad: Expression):
        super().__init__(child)
        self.length = int(_lit_value(length, "lpad/rpad"))
        self.pad = str(_lit_value(pad, "lpad/rpad"))

    def transform(self, s):
        if len(s) >= self.length:
            return s[: self.length]
        need = self.length - len(s)
        return (self.pad * need)[:need] + s


class Rpad(Lpad):
    def transform(self, s):
        if len(s) >= self.length:
            return s[: self.length]
        need = self.length - len(s)
        return s + (self.pad * need)[:need]


class Initcap(_DictTransform):
    def transform(self, s):
        return " ".join(w[:1].upper() + w[1:].lower() if w else w
                        for w in s.split(" "))


class Reverse(_DictTransform):
    def transform(self, s):
        return s[::-1]


class Repeat(_DictTransform):
    def __init__(self, child, n: Expression):
        super().__init__(child)
        self.n = int(_lit_value(n, "repeat"))

    def transform(self, s):
        return s * self.n


class SubstringIndex(_DictTransform):
    def __init__(self, child, delim: Expression, count: Expression):
        super().__init__(child)
        self.delim = str(_lit_value(delim, "substring_index"))
        self.count = int(_lit_value(count, "substring_index"))

    def transform(self, s):
        parts = s.split(self.delim)
        if self.count > 0:
            return self.delim.join(parts[: self.count])
        if self.count < 0:
            return self.delim.join(parts[self.count:])
        return ""


class RegexpExtract(_DictTransform):
    """regexp_extract(col, pattern[, idx]): Python `re` over each
    dictionary value; no match gives ''."""

    def __init__(self, child, pattern: Expression, idx: Expression = None):
        super().__init__(child)
        self.pattern = str(_lit_value(pattern, "regexp_extract"))
        self.idx = 1 if idx is None else int(_lit_value(idx,
                                                        "regexp_extract"))
        self._rx = re.compile(self.pattern)

    def transform(self, s):
        m = self._rx.search(s)
        if m is None:
            return ""
        g = m.group(self.idx)
        return "" if g is None else g


class RegexpReplace(_DictTransform):
    """regexp_replace(col, pattern, replacement): SQL's replacement names
    groups Java's way ($1, read as Python's \\1); the DataFrame form
    (`java_refs` False) hands its replacement to `re.sub` as it is, as the
    reference's functions.regexp_replace does."""

    def __init__(self, child, pattern: Expression, repl: Expression,
                 java_refs: bool = True):
        super().__init__(child)
        self.pattern = str(_lit_value(pattern, "regexp_replace"))
        self.repl = str(_lit_value(repl, "regexp_replace"))
        self.java_refs = java_refs
        self._rx = re.compile(self.pattern)

    def transform(self, s):
        repl = re.sub(r"\$(\d)", r"\\\1", self.repl) if self.java_refs \
            else self.repl
        return self._rx.sub(repl, s)


class Left(_DictTransform):
    def __init__(self, child, n: Expression):
        super().__init__(child)
        self.n = int(_lit_value(n, "left"))

    def transform(self, s):
        return s[: self.n] if self.n >= 0 else ""


class Right(_DictTransform):
    def __init__(self, child, n: Expression):
        super().__init__(child)
        self.n = int(_lit_value(n, "right"))

    def transform(self, s):
        return s[-self.n:] if self.n > 0 else ""


class Overlay(_DictTransform):
    """overlay(s, replace, pos[, len]), 1-based."""

    def __init__(self, child, repl: Expression, pos: Expression,
                 length: Expression | None = None):
        super().__init__(child)
        self.repl = str(_lit_value(repl, "overlay"))
        self.pos = int(_lit_value(pos, "overlay"))
        self.length = len(self.repl) if length is None \
            else int(_lit_value(length, "overlay"))

    def transform(self, s):
        p = self.pos - 1
        return s[:p] + self.repl + s[p + self.length:]


class Soundex(_DictTransform):
    _CODES = {**{c: "1" for c in "bfpv"}, **{c: "2" for c in "cgjkqsxz"},
              **{c: "3" for c in "dt"}, "l": "4",
              **{c: "5" for c in "mn"}, "r": "6"}

    def transform(self, s):
        if not s or not s[0].isalpha():
            return s
        out = s[0].upper()
        prev = self._CODES.get(s[0].lower(), "")
        for ch in s[1:].lower():
            code = self._CODES.get(ch, "")
            if code and code != prev:
                out += code
            if ch not in "hw":
                prev = code
            if len(out) == 4:
                break
        return out.ljust(4, "0")


class Md5(_DictTransform):
    def transform(self, s):
        return hashlib.md5(s.encode()).hexdigest()


class Sha1(_DictTransform):
    def transform(self, s):
        return hashlib.sha1(s.encode()).hexdigest()


class Sha2(_DictTransform):
    """sha2(s, bits): 0 means 256; a length other than 224, 256, 384 or
    512 gives NULL."""

    may_null = True

    def __init__(self, child, bits: Expression):
        super().__init__(child)
        self.bits = int(_lit_value(bits, "sha2")) or 256

    def transform(self, s):
        if self.bits not in (224, 256, 384, 512):
            return None
        h = hashlib.new(f"sha{self.bits}")
        h.update(s.encode())
        return h.hexdigest()


class Base64(_DictTransform):
    def transform(self, s):
        return base64.b64encode(s.encode()).decode()


class Unbase64(_DictTransform):
    """unbase64(s): NULL where s is not valid base64 (or decodes to bytes
    that are not UTF-8); characters outside the alphabet are dropped."""

    may_null = True

    def transform(self, s):
        try:
            return base64.b64decode(s.encode()).decode()
        except Exception:
            return None


class Translate(_DictTransform):
    def __init__(self, child, matching: Expression, replace: Expression):
        super().__init__(child)
        self.matching = str(_lit_value(matching, "translate"))
        self.replace = str(_lit_value(replace, "translate"))
        self._table = str.maketrans(
            self.matching,
            self.replace.ljust(len(self.matching))[: len(self.matching)])

    def transform(self, s):
        return s.translate(self._table)


class FormatNumber(Expression):
    """format_number(x, d): numeric -> string has no bounded dictionary,
    so the optimizer's RewriteHostOnlyExpressions makes a host UDF of it
    (`format_fn`); this node only resolves the type."""

    child_fields = ("child",)

    def __init__(self, child: Expression, d: Expression):
        self.child = child
        self.d = int(_lit_value(d, "format_number"))

    @property
    def dtype(self):
        return string

    def format_fn(self):
        d = self.d

        def fn(a):
            return np.array([None if v is None else f"{float(v):,.{d}f}"
                             for v in a], dtype=object)

        return fn

    def eval(self, ctx):
        raise UnsupportedOperationError(
            "format_number must be rewritten to a host UDF (optimizer rule "
            "RewriteHostOnlyExpressions)")


class _ConcatWsAffix(_DictTransform):
    """concat_ws(sep, ...) over one string column with literals: the
    literals before and after joined by `sep` on each side."""

    def __init__(self, child: Expression, sep: str, prefix: str, suffix: str):
        super().__init__(child)
        self.sep = sep
        self.prefix = prefix
        self.suffix = suffix

    def transform(self, s):
        out = s if not self.prefix else self.prefix + self.sep + s
        return out if not self.suffix else out + self.sep + self.suffix


class ConcatWs(Expression):
    """concat_ws(sep, ...): all literals make one literal and one column
    with literals is a dictionary transform; over two or more columns the
    optimizer's RewriteHostOnlyExpressions makes a host UDF of it."""

    child_fields = ("args",)

    def __init__(self, sep: Expression, args: Sequence[Expression]):
        self.sep = str(_lit_value(sep, "concat_ws"))
        self.args = list(args)

    @property
    def dtype(self):
        return string

    def eval(self, ctx):
        cols = [i for i, a in enumerate(self.args)
                if not isinstance(a, Literal)]
        if len(cols) > 1:
            raise UnsupportedOperationError(
                "concat_ws of multiple string columns must be rewritten to "
                "a host UDF (optimizer rule RewriteHostOnlyExpressions)")
        if not cols:
            return Literal(self.sep.join(
                str(a.value) for a in self.args)).eval(ctx)
        i = cols[0]
        prefix = self.sep.join(str(a.value) for a in self.args[:i])
        suffix = self.sep.join(str(a.value) for a in self.args[i + 1:])
        return ctx.eval(_ConcatWsAffix(self.args[i], self.sep, prefix,
                                       suffix))


def _like_to_regex(pattern: str, escape: str = "\\") -> str:
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "^" + "".join(out) + "$"


class _StringPredicate(Expression):
    """A string -> boolean predicate: a boolean lookup table over the
    dictionary's values, built on the host once per dictionary (memoised
    on it) and gathered by the codes on the device."""

    child_fields = ("child",)

    def __init__(self, child: Expression, pattern: str):
        self.child = child
        self.pattern = pattern

    @property
    def dtype(self):
        return boolean

    def matcher(self):
        raise NotImplementedError

    def eval(self, ctx):
        m = self.matcher()
        return _value_luts(ctx, ctx.eval(self.child),
                           f"{type(self).__name__}:{self.pattern}", boolean,
                           lambda v: bool(m(v)), nullable=False)


class Like(_StringPredicate):
    def matcher(self):
        rx = re.compile(_like_to_regex(self.pattern), re.DOTALL)
        return lambda s: rx.match(s) is not None


class RLike(_StringPredicate):
    def matcher(self):
        rx = re.compile(self.pattern)
        return lambda s: rx.search(s) is not None


class StartsWith(_StringPredicate):
    def matcher(self):
        p = self.pattern
        return lambda s: s.startswith(p)


class EndsWith(_StringPredicate):
    def matcher(self):
        p = self.pattern
        return lambda s: s.endswith(p)


class Contains(_StringPredicate):
    def matcher(self):
        p = self.pattern
        return lambda s: p in s


class _StringIntLut(Expression):
    """A string function giving an integer per dictionary entry: an int32
    lut built on the host once per dictionary and gathered by the codes."""

    child_fields = ("child",)

    def __init__(self, child: Expression):
        self.child = child

    @property
    def dtype(self):
        return int32

    def int_of(self, s: str) -> int:
        raise NotImplementedError

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if not isinstance(c.dtype, StringType):
            raise NotPortedError(f"{self.sql_name()} of "
                                 f"{c.dtype.simple_string()} (a cast to "
                                 "string)")
        return _value_luts(ctx, c, self.simple_string(), int32,
                           self.int_of, nullable=False)


class Length(_StringIntLut):
    def int_of(self, s):
        return len(s)


class RegexpInstr(_StringIntLut):
    """regexp_instr(str, regexp): 1-based position of the first match, 0
    where none."""

    def __init__(self, child, pattern: Expression):
        super().__init__(child)
        self.pattern = str(_lit_value(pattern, "regexp_instr"))
        self._rx = re.compile(self.pattern)

    def int_of(self, s):
        m = self._rx.search(s)
        return (m.start() + 1) if m is not None else 0


class RegexpCount(_StringIntLut):
    def __init__(self, child, pattern: Expression):
        super().__init__(child)
        self.pattern = str(_lit_value(pattern, "regexp_count"))
        self._rx = re.compile(self.pattern)

    def int_of(self, s):
        return sum(1 for _ in self._rx.finditer(s))


class Levenshtein(_StringIntLut):
    def __init__(self, child, other: Expression):
        super().__init__(child)
        self.other = str(_lit_value(other, "levenshtein"))

    def int_of(self, s):
        a, b = s, self.other
        if len(a) < len(b):
            a, b = b, a
        prev = list(range(len(b) + 1))
        for i, ca in enumerate(a, 1):
            cur = [i]
            for j, cb in enumerate(b, 1):
                cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                               prev[j - 1] + (ca != cb)))
            prev = cur
        return prev[-1]


class Ascii(_StringIntLut):
    def int_of(self, s):
        return ord(s[0]) if s else 0


class Instr(_StringIntLut):
    def __init__(self, child, sub: Expression):
        super().__init__(child)
        self.sub = str(_lit_value(sub, "instr/locate/position"))

    def int_of(self, s):
        return s.find(self.sub) + 1  # 1-based; 0 = not found


class _ArrayLut(Expression):
    """A function computed once per dictionary entry into a value and a
    validity (`value_of` gives both), which the codes gather on the device:
    over strings, and over the lists and dicts of array, map and struct
    columns. A dictionary-encoded result (a string, an array, a struct
    field that is a string) is a dictionary transform (deduplicated as
    _DictTransform's); a numeric, date or boolean one a value lut beside a
    validity lut, both asked for in every pass."""

    child_fields = ("child",)

    def __init__(self, child: Expression):
        self.child = child

    def value_of(self, s):
        raise NotImplementedError

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if not dict_encoded(c.dtype):
            raise TypeCheckError(f"{self.sql_name()} of "
                                 f"{c.dtype.simple_string()}")
        key = self.simple_string()
        out = self.dtype

        if dict_encoded(out):
            def fn(v):
                val, ok = self.value_of(v)
                return val if ok else None

            return _dict_transform(ctx, c, key, fn, True, out)

        def device_fn(v):
            val, ok = self.value_of(v)
            return _device_value(out, val) if ok else None

        return _value_luts(ctx, c, key, out, device_fn)


class GetJsonObject(_ArrayLut):
    """get_json_object(json_str, '$.path'): dotted fields and [n] indexing.
    Misses and JSON nulls are NULL; a non-scalar result is written back as
    JSON."""

    def __init__(self, child: Expression, path: Expression):
        super().__init__(child)
        self.path = str(_lit_value(path, "get_json_object"))

    @property
    def dtype(self):
        return string

    def value_of(self, s):
        try:
            cur = json.loads(s)
        except (ValueError, TypeError):
            return "", False
        p = self.path
        if p.startswith("$"):
            p = p[1:]
        # the whole path must tokenize: an unsupported segment ($[*],
        # quoted keys) means NULL, not a partial walk
        tokens = list(re.finditer(r"\.([A-Za-z_][\w]*)|\[(\d+)\]", p))
        if "".join(m.group(0) for m in tokens) != p:
            return "", False
        for name, idx in ((m.group(1), m.group(2)) for m in tokens):
            if name:
                if not isinstance(cur, dict) or name not in cur:
                    return "", False
                cur = cur[name]
            else:
                i = int(idx)
                if not isinstance(cur, list) or i >= len(cur):
                    return "", False
                cur = cur[i]
        if cur is None:
            return "", False
        if isinstance(cur, (dict, list)):
            return json.dumps(cur), True
        if isinstance(cur, bool):
            return ("true" if cur else "false"), True
        return str(cur), True


class Crc32(_ArrayLut):
    @property
    def dtype(self):
        return int64

    def value_of(self, s):
        return zlib.crc32(str(s).encode()), True


class RegexpSubstr(_ArrayLut):
    """regexp_substr(str, regexp): the first match, or NULL."""

    def __init__(self, child, pattern: Expression):
        super().__init__(child)
        self.pattern = str(_lit_value(pattern, "regexp_substr"))
        self._rx = re.compile(self.pattern)

    @property
    def dtype(self):
        return string

    def value_of(self, s):
        m = self._rx.search(s)
        return (m.group(0), True) if m is not None else ("", False)


class ToNumber(_ArrayLut):
    """to_number / try_to_number(str, format) -> decimal per the format
    ('9'/'0' digits, D or . decimal point, G or , grouping, S sign, $
    currency). A string the format does not match raises in to_number
    and is NULL in try_to_number."""

    def __init__(self, child, fmt: Expression, strict: bool = False):
        super().__init__(child)
        self.fmt = str(_lit_value(fmt, "to_number"))
        self.strict = strict
        f = self.fmt.upper().replace("D", ".").replace("G", ",")
        self.scale = len(f.split(".", 1)[1].replace(",", "")) \
            if "." in f else 0
        self.precision = max(sum(1 for ch in f if ch in "90"), 1)

    @property
    def dtype(self):
        return DecimalType(self.precision, self.scale)

    def _miss(self, s):
        if self.strict:
            raise ExecutionError(
                f"to_number: {s!r} does not match format {self.fmt!r}")
        return 0, False

    def value_of(self, s):
        import decimal as _d

        pat = []
        for ch in self.fmt.upper():
            if ch in "90":
                pat.append(r"\d")
            elif ch in "G,":
                pat.append(",?")
            elif ch in "D.":
                pat.append(r"\.?")
            elif ch == "S":
                pat.append("[+-]?")
            elif ch == "$":
                pat.append(r"\$?")
            else:
                return self._miss(s)
        rx = "[+-]?" + "".join(pat) if "S" not in self.fmt.upper() \
            else "".join(pat)
        t = s.strip()
        if not re.fullmatch(rx.replace(r"\d", r"\d?"), t):
            return self._miss(s)
        neg = t.startswith("-") or t.endswith("-")
        t = t.strip("+-").replace(",", "").replace("$", "")
        try:
            v = _d.Decimal(t)
        except _d.InvalidOperation:
            return self._miss(s)
        if neg:
            v = -v
        return int(v.scaleb(self.scale).to_integral_value()), True


# ---------------------------------------------------------------------------
# Collections: arrays, maps and structs as dictionary-encoded columns
# ---------------------------------------------------------------------------

class Split(_DictTransform):
    """string -> array<string> by a regex delimiter: one regex run per
    dictionary entry, into an array dictionary. Under explode(),
    GenerateExec reads `split_lists` directly."""

    def __init__(self, child: Expression, delim: Expression):
        super().__init__(child)
        self.delim = str(delim.value)
        self._rx = re.compile(self.delim)

    @property
    def dtype(self):
        return ArrayType(string)

    def split_lists(self, values: list[str]) -> list[list[str]]:
        return [self._rx.split(v) for v in values]

    def transform(self, s):
        return self._rx.split(s)

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if not isinstance(c.dtype, StringType):
            raise TypeCheckError("split() needs a string")
        return _dict_transform(ctx, c, self.simple_string(), self.transform,
                               False, self.dtype)


class Explode(Expression):
    """Generator marker: the analyzer moves it into a Generate node
    (ExtractGenerators)."""

    child_fields = ("child",)

    def __init__(self, child: Expression):
        self.child = child

    @property
    def dtype(self):
        ct = self.child.dtype
        return ct.element_type if isinstance(ct, ArrayType) else ct

    def eval(self, ctx):
        raise UnsupportedOperationError(
            "explode() must be planned as a Generate operator")


class Size(_ArrayLut):
    @property
    def dtype(self):
        return int32

    def value_of(self, lst):
        return len(lst), True


class ArrayContains(_ArrayLut):
    def __init__(self, child: Expression, value: Expression):
        super().__init__(child)
        self.value = _lit_value(value, "array_contains")

    @property
    def dtype(self):
        return boolean

    def value_of(self, lst):
        return (self.value in lst), True


class ArrayMin(_ArrayLut):
    @property
    def dtype(self):
        ct = self.child.dtype
        return ct.element_type if isinstance(ct, ArrayType) else ct

    def value_of(self, lst):
        vals = [v for v in lst if v is not None]
        return (min(vals), True) if vals else (0, False)


class ArrayMax(ArrayMin):
    def value_of(self, lst):
        vals = [v for v in lst if v is not None]
        return (max(vals), True) if vals else (0, False)


class ElementAt(_ArrayLut):
    """element_at(arr, i): 1-based, negative from the end; NULL out of
    range or at a NULL element."""

    def __init__(self, child: Expression, idx: Expression):
        super().__init__(child)
        self.idx = int(_lit_value(idx, "element_at"))

    @property
    def dtype(self):
        ct = self.child.dtype
        return ct.element_type if isinstance(ct, ArrayType) else ct

    def value_of(self, lst):
        i = self.idx - 1 if self.idx > 0 else len(lst) + self.idx
        if 0 <= i < len(lst) and lst[i] is not None:
            return lst[i], True
        return 0, False


class ElementAtString(ElementAt):
    """element_at over array<string> (the reference's class of its own:
    a dictionary transform with a real NULL out of range)."""

    @property
    def dtype(self):
        return string


class GetStructField(_ArrayLut):
    """struct.field: the field of each dictionary entry, into a lut (a
    numeric field) or a derived dictionary (a string or nested field)."""

    def __init__(self, child: Expression, name: str):
        super().__init__(child)
        self.field_name = name

    @property
    def dtype(self):
        ct = self.child.dtype
        if isinstance(ct, StructType):
            ft = ct.field_type(self.field_name)
            if ft is not None:
                return ft
        return null_type

    def value_of(self, d):
        if isinstance(d, dict) and d.get(self.field_name) is not None:
            return d[self.field_name], True
        return 0, False

    def simple_string(self):
        return f"{self.child.simple_string()}.{self.field_name}"


class GetMapValue(_ArrayLut):
    """map[key] / element_at(map, key) over a literal key."""

    def __init__(self, child: Expression, key: Expression):
        super().__init__(child)
        self.key = _lit_value(key, "a map subscript")

    @property
    def dtype(self):
        ct = self.child.dtype
        return ct.value_type if isinstance(ct, MapType) else null_type

    def value_of(self, m):
        if isinstance(m, dict) and m.get(self.key) is not None:
            return m[self.key], True
        return 0, False


class MapContainsKey(_ArrayLut):
    def __init__(self, child: Expression, key: Expression):
        super().__init__(child)
        self.key = _lit_value(key, "map_contains_key")

    @property
    def dtype(self):
        return boolean

    @property
    def nullable(self):
        return self.child.nullable

    def value_of(self, m):
        return (self.key in m) if isinstance(m, dict) else False, True


class Flatten(_ArrayLut):
    """flatten(array<array<T>>) -> array<T>, one level; a NULL sub-array
    makes the result NULL."""

    @property
    def dtype(self):
        ct = self.child.dtype
        return ct.element_type if isinstance(ct, ArrayType) and \
            isinstance(ct.element_type, ArrayType) else ct

    def value_of(self, lst):
        out = []
        for sub in lst:
            if sub is None:
                return [], False
            out.extend(sub)
        return out, True


class ArrayJoin(_ArrayLut):
    """array_join(arr, sep[, null_replacement]) -> string."""

    def __init__(self, child: Expression, sep: Expression,
                 null_replacement: Expression | None = None):
        super().__init__(child)
        self.sep = str(_lit_value(sep, "array_join"))
        self.null_rep = None if null_replacement is None \
            else str(_lit_value(null_replacement, "array_join"))

    @property
    def dtype(self):
        return string

    def value_of(self, lst):
        parts = []
        for v in lst:
            if v is None:
                if self.null_rep is not None:
                    parts.append(self.null_rep)
            else:
                parts.append(str(v))
        return self.sep.join(parts), True


class ArrayPosition(_ArrayLut):
    """array_position(arr, value): the 1-based index of the first match,
    0 where absent."""

    def __init__(self, child: Expression, value: Expression):
        super().__init__(child)
        self.value = _lit_value(value, "array_position")

    @property
    def dtype(self):
        return int64

    def value_of(self, lst):
        for i, v in enumerate(lst):
            if v == self.value:
                return i + 1, True
        return 0, True


class RegexpExtractAll(_ArrayLut):
    """regexp_extract_all(str, regexp[, idx]) -> array<string>: group 1 by
    default, the whole match for a pattern without groups."""

    def __init__(self, child, pattern: Expression,
                 group: Expression | None = None):
        super().__init__(child)
        self.pattern = str(_lit_value(pattern, "regexp_extract_all"))
        self._rx = re.compile(self.pattern)
        if group is None:
            self.group = 1 if self._rx.groups >= 1 else 0
        else:
            self.group = int(_lit_value(group, "regexp_extract_all"))
            if self.group > self._rx.groups:
                raise AnalysisException(
                    f"regexp_extract_all: regex group count is "
                    f"{self._rx.groups}, but the specified group index "
                    f"is {self.group}")

    @property
    def dtype(self):
        return ArrayType(string)

    def value_of(self, s):
        return [m.group(self.group) or ""
                for m in self._rx.finditer(s)], True


class _ArrayDictTransform(_DictTransform):
    """A list -> list (or map -> list) function over a nested column's
    dictionary entries, deduplicated as every dictionary transform."""

    @property
    def dtype(self):
        return self.child.dtype

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if not dict_encoded(c.dtype) or isinstance(c.dtype, StringType):
            raise TypeCheckError(f"{self.sql_name()} of "
                                 f"{c.dtype.simple_string()}")
        return _dict_transform(ctx, c, self.simple_string(), self.transform,
                               False, self.dtype)


class MapKeys(_ArrayDictTransform):
    @property
    def dtype(self):
        ct = self.child.dtype
        return ArrayType(ct.key_type) if isinstance(ct, MapType) \
            else ArrayType()

    def transform(self, m):
        return list(m.keys()) if isinstance(m, dict) else []


class MapValues(_ArrayDictTransform):
    @property
    def dtype(self):
        ct = self.child.dtype
        return ArrayType(ct.value_type) if isinstance(ct, MapType) \
            else ArrayType()

    def transform(self, m):
        return list(m.values()) if isinstance(m, dict) else []


class SortArray(_ArrayDictTransform):
    """sort_array(arr[, asc]): NULL elements first when ascending, last
    when descending (the reference's sorted() raises on them:
    ROADMAP.md C16)."""

    def __init__(self, child: Expression, asc: Expression | None = None):
        super().__init__(child)
        self.asc = True if asc is None else bool(_lit_value(asc,
                                                            "sort_array"))

    def transform(self, lst):
        vals = sorted((v for v in lst if v is not None),
                      reverse=not self.asc)
        nulls = [None] * (len(lst) - len(vals))
        return nulls + vals if self.asc else vals + nulls


class ArraySortNullsLast(_ArrayDictTransform):
    """array_sort(arr): ascending with NULLs last (sort_array puts them
    first)."""

    def transform(self, lst):
        return sorted([v for v in lst if v is not None]) + \
            [None] * sum(1 for v in lst if v is None)


class ArrayDistinct(_ArrayDictTransform):
    def transform(self, lst):
        return list(dict.fromkeys(lst))


class Slice(_ArrayDictTransform):
    """slice(arr, start, length): 1-based, a negative start from the
    end."""

    def __init__(self, child: Expression, start: Expression,
                 length: Expression):
        super().__init__(child)
        self.start = int(_lit_value(start, "slice"))
        self.length = int(_lit_value(length, "slice"))
        if self.start == 0:
            raise AnalysisException(
                "Unexpected value for start in function slice: "
                "SQL array indices start at 1")

    def transform(self, lst):
        s = self.start - 1 if self.start > 0 else len(lst) + self.start
        if s < 0:
            return []
        return lst[s:s + self.length]


class ArrayRemove(_ArrayDictTransform):
    def __init__(self, child: Expression, value: Expression):
        super().__init__(child)
        self.value = _lit_value(value, "array_remove")

    def transform(self, lst):
        return [v for v in lst if v != self.value]


def build_element_at(child: Expression, idx: Expression) -> Expression:
    """element_at(c, k) and c[k]: a map lookup, or an array element."""
    if not isinstance(idx, Literal):
        raise AnalysisException(
            "element_at / [] requires a literal key; column-valued keys "
            "are not supported yet")
    ct = child.dtype
    if isinstance(ct, MapType):
        return GetMapValue(child, idx)
    if isinstance(ct, ArrayType) and isinstance(ct.element_type, StringType):
        return ElementAtString(child, idx)
    return ElementAt(child, idx)


def host_udf(fn, args, dt: DataType, name: str):
    """`fn` evaluated row by row on the host (PythonEvalExec), as the
    reference builds its constructors and set functions; a nested result
    is dictionary-encoded on the way back."""
    from .pyudf import PythonUDF

    return PythonUDF(fn, list(args), dt, name=name, vectorized=False)


def build_struct_ctor(args, names=None) -> Expression:
    """struct(...) / named_struct('n1', v1, ...): a struct column built on
    the host; struct() names a field after its column, alias or field."""
    if names is None:
        names, vals = [], []
        for i, a in enumerate(args):
            if isinstance(a, (Alias, AttributeReference)):
                names.append(a.name)
                vals.append(a.child if isinstance(a, Alias) else a)
            elif isinstance(a, GetStructField):
                names.append(a.field_name)
                vals.append(a)
            else:
                names.append(f"col{i + 1}")
                vals.append(a)
    else:
        vals = list(args)
    st = StructType(tuple(StructField(n, v.dtype, True)
                          for n, v in zip(names, vals)))
    captured = list(names)
    return host_udf(lambda *cols: dict(zip(captured, cols)), vals, st,
                      "named_struct")


def build_named_struct(args) -> Expression:
    if len(args) % 2 != 0:
        raise AnalysisException("named_struct expects name/value pairs")
    names = [str(_lit_value(a, "named_struct")) for a in args[0::2]]
    return build_struct_ctor(args[1::2], names=names)


def build_array_ctor(args) -> Expression:
    """array(e1, e2, ...): an array column built on the host."""
    et: DataType = null_type
    for a in args:
        et = common_type(et, a.dtype) or a.dtype
    if not args:
        # array(): one dummy input keeps the evaluation shaped
        return host_udf(lambda _x: [], [Literal(0)], ArrayType(et),
                          "array")
    return host_udf(lambda *cols: list(cols), args, ArrayType(et),
                      "array")


def build_map_ctor(args) -> Expression:
    """map(k1, v1, k2, v2, ...): a map column built on the host."""
    if len(args) % 2 != 0:
        raise AnalysisException("map expects key/value pairs")
    kt: DataType = null_type
    vt: DataType = null_type
    for k in args[0::2]:
        kt = common_type(kt, k.dtype) or k.dtype
    for v in args[1::2]:
        vt = common_type(vt, v.dtype) or v.dtype
    n = len(args) // 2
    return host_udf(lambda *cols: {cols[2 * i]: cols[2 * i + 1]
                                     for i in range(n)},
                      args, MapType(kt, vt), "map")


class Concat(Expression):
    """concat / `||`. All literals make one literal, and one string column
    with literals is a dictionary transform. Over two or more columns the
    dictionary product is unbounded: the optimizer's
    RewriteHostOnlyExpressions turns it into a host UDF first."""

    child_fields = ("args",)

    def __init__(self, args: Sequence[Expression]):
        self.args = list(args)

    @property
    def dtype(self):
        return string

    def eval(self, ctx):
        # SQL concat is null-intolerant: any NULL argument nulls the result
        if any(isinstance(a, Literal) and a.value is None for a in self.args):
            return Literal(None, string).eval(ctx)
        cols = [i for i, a in enumerate(self.args)
                if not isinstance(a, Literal)]
        if not cols:
            return Literal("".join(str(a.value) for a in self.args)).eval(ctx)
        if len(cols) > 1:
            raise UnsupportedOperationError(
                "concat of multiple string columns must be rewritten to a "
                "host UDF (optimizer rule RewriteHostOnlyExpressions)")
        i = cols[0]
        prefix = "".join(str(a.value) for a in self.args[:i])
        suffix = "".join(str(a.value) for a in self.args[i + 1:])
        return ctx.eval(_Affix(self.args[i], prefix, suffix))


class DateFormat(Expression):
    """date_format(d, fmt): a Java-style pattern subset mapped to strftime,
    evaluated per row on the host (the value universe is unknown) through
    the host UDF the optimizer makes of it: this node only resolves the
    type."""

    child_fields = ("child",)

    _JAVA_TO_STRF = [("yyyy", "%Y"), ("MM", "%m"), ("dd", "%d"),
                     ("HH", "%H"), ("mm", "%M"), ("ss", "%S"),
                     ("EEEE", "%A"), ("E", "%a"), ("yy", "%y")]

    def __init__(self, child: Expression, fmt: Expression):
        self.child = child
        self.fmt = str(fmt.value)

    @property
    def dtype(self):
        return string

    @classmethod
    def to_strftime(cls, fmt: str) -> str:
        for a, b in cls._JAVA_TO_STRF:
            fmt = fmt.replace(a, b)
        return fmt

    def eval(self, ctx):
        raise UnsupportedOperationError(
            "date_format must be rewritten to a host UDF (optimizer rule "
            "RewriteHostOnlyExpressions)")


# ---------------------------------------------------------------------------
# Dates and intervals
# ---------------------------------------------------------------------------

def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(days):
    """days since the epoch -> (year, month, day): Hinnant's algorithm."""
    z = days.to(torch.int64) + 719468
    era = _floordiv(z, 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def _days_from_civil(y, m, d):
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _floordiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9).to(torch.int64)
    doy = _floordiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _floordiv(yoe, 4) - _floordiv(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


class IntervalLiteral(Expression):
    """Calendar interval (months, days, microseconds): only valid as an
    operand of date +/- (a literal of the reference's CalendarIntervalType;
    the analyzer folds interval arithmetic into one literal)."""

    child_fields = ()

    def __init__(self, months: int = 0, days: int = 0, micros: int = 0):
        self.months = months
        self.days = days
        self.micros = micros

    @property
    def dtype(self):
        raise TypeCheckError(
            "INTERVAL can only be added to/subtracted from dates/timestamps")

    @property
    def resolved(self):
        return True

    @property
    def nullable(self):
        return False

    def negated(self) -> "IntervalLiteral":
        return IntervalLiteral(-self.months, -self.days, -self.micros)

    def simple_string(self):
        return f"interval({self.months}mo {self.days}d {self.micros}us)"


def _apply_interval(side: Val, iv: IntervalLiteral) -> Val:
    """date + interval: the days first, then the months, clamped to the
    end of the target month (2000-01-31 + 1 month = 2000-02-29). A
    timestamp adds the days and microseconds (a month interval on a
    timestamp raises, as in the reference)."""
    if isinstance(side.dtype, TimestampType):
        if iv.months:
            raise UnsupportedOperationError(
                "month intervals on timestamps not supported yet")
        return Val(timestamp, side.data + (iv.days * _US_PER_DAY + iv.micros),
                   side.validity)
    if not isinstance(side.dtype, DateType):
        raise TypeCheckError(
            f"cannot add INTERVAL to {side.dtype.simple_string()}")
    data = side.data
    if iv.days or iv.micros:
        data = data + (iv.days + iv.micros // 86_400_000_000)
    if iv.months:
        data = _add_months(data, iv.months)
    return Val(date, data.to(torch.int32), side.validity)


class DateAdd(BinaryExpression):
    @property
    def dtype(self):
        return date

    def eval(self, ctx):
        l = ctx.eval(self.left)
        r = ctx.eval(cast_if(self.right, int32))
        return Val(date, l.data + r.data, ctx.and_valid(l, r))


class DateSub(BinaryExpression):
    @property
    def dtype(self):
        return date

    def eval(self, ctx):
        l = ctx.eval(self.left)
        r = ctx.eval(cast_if(self.right, int32))
        return Val(date, l.data - r.data, ctx.and_valid(l, r))


class DateDiff(BinaryExpression):
    @property
    def dtype(self):
        return int32

    def eval(self, ctx):
        l = ctx.eval(cast_if(self.left, date))
        r = ctx.eval(cast_if(self.right, date))
        return Val(int32, (l.data - r.data).to(torch.int32),
                   ctx.and_valid(l, r))


class _DatePart(UnaryExpression):
    """A calendar field of a date as an int32, from Hinnant's civil
    calendar on the device (floor divisions: dates before 1970 hold
    negative day numbers)."""

    @property
    def dtype(self):
        return int32

    def eval(self, ctx):
        c = _as_date(ctx, ctx.eval(self.child))
        if not isinstance(c.dtype, DateType):
            raise NotPortedError(f"{self.sql_name()} of "
                                 f"{c.dtype.simple_string()}")
        y, m, d = _civil_from_days(c.data)
        return Val(int32, self._part(c.data, y, m, d), c.validity)

    def _part(self, days, y, m, d):
        raise NotImplementedError


class Year(_DatePart):
    def _part(self, days, y, m, d):
        return y


class Month(_DatePart):
    def _part(self, days, y, m, d):
        return m


class DayOfMonth(_DatePart):
    def _part(self, days, y, m, d):
        return d


class Quarter(_DatePart):
    def _part(self, days, y, m, d):
        return _floordiv(m - 1, 3) + 1


class DayOfWeek(_DatePart):
    """1 = Sunday ... 7 = Saturday."""

    def _part(self, days, y, m, d):
        return (torch.remainder(days.to(torch.int64) + 4, 7) + 1) \
            .to(torch.int32)


class DayOfYear(_DatePart):
    def _part(self, days, y, m, d):
        jan1 = _days_from_civil(y, torch.ones_like(m), torch.ones_like(d))
        return (days - jan1 + 1).to(torch.int32)


class WeekOfYear(_DatePart):
    """The ISO week: the week holding the year's first Thursday is 1."""

    def _part(self, days, y, m, d):
        dow = torch.remainder(days.to(torch.int64) + 3, 7)  # 0 = Monday
        thursday = days.to(torch.int64) - dow + 3
        ty, _, _ = _civil_from_days(thursday)
        jan1 = _days_from_civil(ty, torch.ones_like(m),
                                torch.ones_like(d)).to(torch.int64)
        return (_floordiv(thursday - jan1, 7) + 1).to(torch.int32)


class TruncDate(UnaryExpression):
    """trunc(date, fmt) / date_trunc(fmt, date). `allow_day` only for
    date_trunc: trunc gives NULL for a day-level format."""

    def __init__(self, child, fmt: str = "month", allow_day: bool = False):
        super().__init__(child)
        self.fmt = fmt.lower()
        self.allow_day = allow_day

    @property
    def dtype(self):
        return date

    def eval(self, ctx):
        c = _as_date(ctx, ctx.eval(self.child))
        if not isinstance(c.dtype, DateType):
            raise NotPortedError(f"trunc of {c.dtype.simple_string()}")
        y, m, d = _civil_from_days(c.data)
        one = torch.ones_like(m)
        if self.fmt in ("year", "yyyy", "yy"):
            data = _days_from_civil(y, one, one)
        elif self.fmt == "quarter":
            data = _days_from_civil(y, _floordiv(m - 1, 3) * 3 + 1, one)
        elif self.fmt in ("month", "mon", "mm"):
            data = _days_from_civil(y, m, one)
        elif self.fmt == "week":
            dow = torch.remainder(c.data.to(torch.int64) + 3, 7)  # 0 = Mon
            data = (c.data - dow).to(torch.int32)
        elif self.fmt in ("day", "dd"):
            if not self.allow_day:
                n = (ctx.capacity,)
                return Val(date, torch.zeros_like(c.data),
                           torch.zeros(n, dtype=torch.bool,
                                       device=ctx.device))
            data = c.data
        else:
            raise UnsupportedOperationError(f"trunc format {self.fmt}")
        return Val(date, data, c.validity)


class MakeDate(Expression):
    """make_date(y, m, d): the civil day number, unchecked (a day past the
    month's end runs into the next month, as the reference computes)."""

    child_fields = ("y", "m", "d")

    def __init__(self, y, m, d):
        self.y = y
        self.m = m
        self.d = d

    @property
    def dtype(self):
        return date

    def eval(self, ctx):
        y = ctx.eval(cast_if(self.y, int32))
        m = ctx.eval(cast_if(self.m, int32))
        d = ctx.eval(cast_if(self.d, int32))
        return Val(date, _days_from_civil(y.data, m.data, d.data),
                   ctx.and_valid(y, m, d))


def _add_months(days, months):
    """days + `months` months, the day clamped to the target month's end
    (2000-01-31 + 1 month = 2000-02-29)."""
    y, m, d = _civil_from_days(days)
    total = (y.to(torch.int64) * 12 + (m - 1)) + months
    ny = _floordiv(total, 12).to(torch.int32)
    nm = (torch.remainder(total, 12) + 1).to(torch.int32)
    nmt = total + 1
    nmy = _floordiv(nmt, 12).to(torch.int32)
    nmm = (torch.remainder(nmt, 12) + 1).to(torch.int32)
    one = torch.ones_like(nm)
    dim = _days_from_civil(nmy, nmm, one) - _days_from_civil(ny, nm, one)
    return _days_from_civil(ny, nm, torch.minimum(d, dim))


class AddMonths(BinaryExpression):
    @property
    def dtype(self):
        return date

    def eval(self, ctx):
        l = ctx.eval(cast_if(self.left, date))
        r = ctx.eval(cast_if(self.right, int32))
        return Val(date, _add_months(l.data, r.data), ctx.and_valid(l, r))


class LastDay(UnaryExpression):
    @property
    def dtype(self):
        return date

    def eval(self, ctx):
        c = ctx.eval(cast_if(self.child, date))
        y, m, d = _civil_from_days(c.data)
        ny = torch.where(m == 12, y + 1, y)
        nm = torch.where(m == 12, 1, m + 1)
        return Val(date, (_days_from_civil(ny, nm, torch.ones_like(m)) - 1)
                   .to(torch.int32), c.validity)


class MonthsBetween(BinaryExpression):
    """months_between(a, b) = whole months apart plus the day difference
    over 31 (unrounded, as the reference: Spark rounds to 8 digits), the
    quotient by 31 taken as the product with its reciprocal and that
    product's sum rounded once, as the reference's compiler takes them."""

    @property
    def dtype(self):
        return float64

    def eval(self, ctx):
        l = ctx.eval(cast_if(self.left, date))
        r = ctx.eval(cast_if(self.right, date))
        ly, lm, ld = _civil_from_days(l.data)
        ry, rm, rd = _civil_from_days(r.data)
        months = (ly - ry) * 12 + (lm - rm)
        frac = _fma((ld - rd).to(torch.float64),
                    torch.full_like(ld, 1.0 / 31.0, dtype=torch.float64),
                    months.to(torch.float64))
        return Val(float64, frac, ctx.and_valid(l, r))


# ---------------------------------------------------------------------------
# Timestamps: int64 microseconds since the epoch, no session time zone
# ---------------------------------------------------------------------------

_US_PER_DAY = 86_400_000_000
_EPOCH = datetime.datetime(1970, 1, 1)


def _micros(v: datetime.datetime) -> int:
    """Microseconds from the epoch to `v`'s wall clock (an aware value
    against the epoch in its own zone, as the reference reads it), in
    integer arithmetic: the reference goes through a float of seconds and
    can lose a microsecond (ROADMAP.md C14)."""
    td = v - _EPOCH.replace(tzinfo=v.tzinfo)
    return (td.days * 86_400 + td.seconds) * 1_000_000 + td.microseconds


def _parse_ts(s: str) -> int | None:
    """A timestamp string ('yyyy-mm-dd[ hh:mm:ss[.ffffff]]', 'T' allowed)
    as microseconds, or None."""
    s = s.strip().replace("T", " ")
    for fmt in ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d"):
        try:
            return _micros(datetime.datetime.strptime(s, fmt))
        except ValueError:
            continue
    return None


def _device_value(dt: DataType, v):
    """A host value as Arrow's to_pylist gives it (a nested entry's field
    or element) in `dt`'s device representation: a date as days, a
    timestamp as microseconds, a Decimal scaled to an integer."""
    if isinstance(v, bool) or v is None:
        return v
    if isinstance(dt, TimestampType) and isinstance(v, datetime.datetime):
        return _micros(v)
    if isinstance(dt, DateType) and isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    if isinstance(dt, DecimalType):
        import decimal as _d

        if isinstance(v, _d.Decimal):
            return int(v.scaleb(dt.scale).to_integral_value())
    return v


def _as_date(ctx: EvalCtx, c: Val) -> Val:
    """A timestamp's date (the calendar fields and trunc read it)."""
    return cast_val(ctx, c, date) if isinstance(c.dtype, TimestampType) \
        else c


class _TimePart(UnaryExpression):
    """A clock field of a timestamp (the child cast to a timestamp):
    (micros mod `period`) div `unit`, floor operations, so an instant
    before 1970 reads its own clock."""

    period = _US_PER_DAY
    unit = 3_600_000_000

    @property
    def dtype(self):
        return int32

    def eval(self, ctx):
        c = ctx.eval(cast_if(self.child, timestamp))
        us = torch.remainder(c.data, self.period)
        return Val(int32, _floordiv(us, self.unit).to(torch.int32),
                   c.validity)


class Hour(_TimePart):
    pass


class Minute(_TimePart):
    period = 3_600_000_000
    unit = 60_000_000


class Second(_TimePart):
    period = 60_000_000
    unit = 1_000_000


class UnixTimestamp(UnaryExpression):
    """unix_timestamp(ts): whole seconds since the epoch (floor)."""

    @property
    def dtype(self):
        return int64

    def eval(self, ctx):
        c = ctx.eval(cast_if(self.child, timestamp))
        return Val(int64, _floordiv(c.data, 1_000_000), c.validity)


class FromUnixtime(UnaryExpression):
    """from_unixtime(seconds): a TIMESTAMP, as the reference returns (not
    Spark's formatted string)."""

    @property
    def dtype(self):
        return timestamp

    def eval(self, ctx):
        c = ctx.eval(cast_if(self.child, int64))
        return Val(timestamp, c.data * 1_000_000, c.validity)


def build_make_interval(y, mo, w, d, h, mi, s) -> IntervalLiteral:
    """make_interval(years, months, weeks, days, hours, mins, secs) over
    literal arguments, as interval literals themselves."""
    def val(e, default=0):
        if e is None:
            return default
        if isinstance(e, Literal) and e.value is not None:
            return e.value
        raise AnalysisException("make_interval expects literal arguments")

    months = int(val(y)) * 12 + int(val(mo))
    days = int(val(w)) * 7 + int(val(d))
    micros = int(val(h)) * 3_600_000_000 + int(val(mi)) * 60_000_000 + \
        int(round(float(val(s)) * 1_000_000))
    return IntervalLiteral(months, days, micros)


# ---------------------------------------------------------------------------
# Grouping sets
# ---------------------------------------------------------------------------

class Grouping(UnaryExpression):
    """grouping(col) over GROUPING SETS/ROLLUP/CUBE: folded to a 0/1
    literal per branch when ExpandGroupingSets expands the sets."""

    @property
    def dtype(self):
        return int32

    def eval(self, ctx):
        raise AnalysisException(
            "grouping() is only valid with GROUPING SETS/ROLLUP/CUBE",
            error_class="UNSUPPORTED_GROUPING_EXPRESSION")


class GroupingID(Expression):
    """grouping_id(...): bitmask of the keys a set leaves out, most
    significant bit first. Empty args = all keys."""

    child_fields = ("args",)

    def __init__(self, args: list[Expression]):
        self.args = list(args)

    @property
    def dtype(self):
        return int64

    def simple_string(self) -> str:
        args = ", ".join(a.simple_string() for a in self.args)
        return f"grouping_id({args})"

    def eval(self, ctx):
        raise AnalysisException(
            "grouping_id() is only valid with GROUPING SETS/ROLLUP/CUBE",
            error_class="UNSUPPORTED_GROUPING_EXPRESSION")


# ---------------------------------------------------------------------------
# Aggregate functions (evaluated by the aggregation operator, not eval())
# ---------------------------------------------------------------------------

class AggregateFunction(Expression):
    child_fields = ("child",)

    def __init__(self, child: Expression | None):
        self.child = child

    @property
    def nullable(self):
        return True

    def eval(self, ctx):
        raise AnalysisException(
            f"aggregate function {type(self).__name__} cannot be evaluated "
            "outside an aggregation")


class Sum(AggregateFunction):
    @property
    def dtype(self):
        ct = self.child.dtype
        if isinstance(ct, DecimalType):
            return DecimalType(DecimalType.MAX_PRECISION, ct.scale)
        if isinstance(ct, IntegralType):
            return int64
        return float64


class Count(AggregateFunction):
    def __init__(self, child: Expression | None = None, distinct: bool = False):
        super().__init__(child)
        self.distinct = distinct

    @property
    def dtype(self):
        return int64

    @property
    def nullable(self):
        return False


class Min(AggregateFunction):
    @property
    def dtype(self):
        return self.child.dtype


class Max(AggregateFunction):
    @property
    def dtype(self):
        return self.child.dtype


class Average(AggregateFunction):
    @property
    def dtype(self):
        ct = self.child.dtype
        if isinstance(ct, DecimalType):
            return DecimalType(
                min(ct.precision + 4, DecimalType.MAX_PRECISION),
                min(ct.scale + 4, 10))
        return float64


class Mode(AggregateFunction):
    """mode(col): the most frequent non-null value. Never lowered: the
    optimizer rewrites it into counts per value, a max-count join and a
    min-value tie-break (RewriteModeAggregate), so ties give the smallest
    value, as in the reference."""

    @property
    def dtype(self):
        return self.child.dtype


class BitAndAgg(AggregateFunction):
    """bit_and(col): the bitwise segment reduce (ops/grouping.py
    bitplane_reduce, the hand-written bit kernel on the card). The result
    keeps the input's integral type."""

    kind = "and"

    @property
    def dtype(self):
        ct = self.child.dtype
        if not isinstance(ct, IntegralType):
            raise TypeCheckError(
                f"bit_{self.kind} requires an integral column, got "
                f"{ct.simple_string()}")
        return ct


class BitOrAgg(BitAndAgg):
    kind = "or"


class BitXorAgg(BitAndAgg):
    kind = "xor"


class First(AggregateFunction):
    """The first non-null value of a group (the reference's First with
    ignore_nulls), in the order the aggregate meets its rows: first,
    first_value's aggregate form, any_value, and the other columns of
    DataFrame.dropDuplicates(subset). Over a string column it keeps the
    column's dictionary (the reference drops it, ROADMAP.md C17)."""

    def __init__(self, child: Expression, ignore_nulls: bool = True):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    @property
    def dtype(self):
        return self.child.dtype


class AnyValue(First):
    pass


class _CentralMoment(AggregateFunction):
    ddof = 1

    @property
    def dtype(self):
        return float64


class StddevSamp(_CentralMoment):
    ddof = 1


class StddevPop(_CentralMoment):
    ddof = 0


class VarianceSamp(_CentralMoment):
    ddof = 1


class VariancePop(_CentralMoment):
    ddof = 0


class Percentile(AggregateFunction):
    """Exact percentile at the lower nearest rank, floor(q * (n - 1)), as
    the reference computes percentile, median and percentile_approx (Spark
    interpolates; ROADMAP.md "Known differences"). Non-mergeable: the
    planner gathers to one partition before aggregating."""

    def __init__(self, child: Expression, q: float):
        super().__init__(child)
        self.q = float(q)

    @property
    def dtype(self):
        ct = self.child.dtype
        return ct if isinstance(ct, (IntegralType, DateType, TimestampType,
                                     DecimalType)) else float64


class Median(Percentile):
    def __init__(self, child: Expression):
        super().__init__(child, 0.5)


class CollectSet(AggregateFunction):
    """collect_set: non-mergeable, gathered to one partition; each group's
    list is built on the host and dictionary-encoded as an ArrayType
    column."""

    @property
    def dtype(self):
        return ArrayType(self.child.dtype)


class CollectList(AggregateFunction):
    """collect_list (array_agg): as collect_set, duplicates kept."""

    @property
    def dtype(self):
        return ArrayType(self.child.dtype)
