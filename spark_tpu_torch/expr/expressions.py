"""Expression tree (counterpart of `spark_tpu/expr/expressions.py`, the
subset the port evaluates).

Each expression keeps the JAX package's class name, type rules, null
semantics and `simple_string`, with one `eval(ctx)` written on torch
tensors: attributes, literals (string and decimal ones too), aliases, casts
between the ported types (decimals rescale half-up; float -> decimal rounds
half to even), `+ - * /` (plain ops wrap on integral overflow; the try_
variants give NULL; x/0 gives NULL; decimal + - * stay exact scaled int64),
sort orders, the comparisons (strings compare by value hash for = and <>,
by merged-dictionary rank for the orderings), Kleene and/or/not, is [not]
null, three-valued IN over a list (strings by value hash, literal items
only), CASE WHEN / if / coalesce (every branch over the whole tile, picked
by mask; string results merge the branch dictionaries), round (half up),
abs, date +/- integer days or an INTERVAL literal (months clamped to the
month's end), date_add/date_sub/datediff, grouping()/grouping_id() (the
optimizer folds them per grouping set), the dictionary transforms
substr/substring, upper and concat of one column with literals (on the
host, once per dictionary), and the aggregate functions sum, count, min,
max and avg.
A double scaled by literal factors is computed as the reference's
compiler computes it: a division by a literal as a product with its
reciprocal, and a chain of constant factors folded into one. A cast to a
narrower decimal gives NULL where the value has more digits than the
target precision, as Spark's non-ANSI cast does; a string casts to a date
by parsing its dictionary.
"""

from __future__ import annotations

import datetime
import re
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..columnar.batch import (
    EMPTY_DICT, StringDict, _take_codes, merge_string_dicts,
)
from ..errors import (
    AnalysisException, NotPortedError, TypeCheckError,
    UnsupportedOperationError,
)
from ..plan.tree import TreeNode, next_id
from ..types import (
    BooleanType, DataType, DateType, DecimalType, FractionalType,
    IntegralType, NullType, NumericType, StringType, boolean, common_type,
    date, dict_encoded, float64, infer_type, int32, int64, null_type,
    string,
)
from .eval import EvalCtx, Val

__all__ = [
    "Expression", "Literal", "AttributeReference", "UnresolvedAttribute",
    "UnresolvedStar", "UnresolvedFunction", "Alias", "SortOrder", "Cast",
    "cast_if", "Substring", "In", "If", "CaseWhen", "Coalesce", "Round",
    "Add", "Subtract", "Multiply", "Divide", "TryAdd", "TrySubtract",
    "TryMultiply", "EqualTo", "NotEqualTo", "LessThan", "LessThanOrEqual",
    "GreaterThan", "GreaterThanOrEqual", "And", "Or", "Not", "IsNull",
    "IsNotNull", "Upper", "Concat", "AggregateFunction", "Sum", "Count",
    "Min", "Max", "Average", "Abs", "IntervalLiteral", "DateAdd", "DateSub",
    "DateDiff", "Grouping", "GroupingID", "Like", "DateFormat", "Sqrt",
    "StddevSamp", "StddevPop", "VarianceSamp", "VariancePop",
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
        if isinstance(value, datetime.date):
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
            # a string literal: a one-entry dictionary, every row code 0
            sd = StringDict([""] if self.value is None else [self.value])
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
                   StringDict([""]) if isinstance(to, StringType) else None)
    if isinstance(frm, StringType) and isinstance(to, DateType):
        return _string_to_date(ctx, c)
    if isinstance(frm, StringType) or isinstance(to, StringType):
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
    if isinstance(to, BooleanType):
        return Val(to, data != 0, c.validity)
    if isinstance(frm, FractionalType) and isinstance(to, IntegralType):
        # float -> int truncates toward zero; NaN/inf read as 0
        t = torch.nan_to_num(torch.trunc(data), nan=0.0, posinf=0.0,
                             neginf=0.0)
        return Val(to, t.to(dd), c.validity)
    return Val(to, data.to(dd), c.validity)


def _string_to_date(ctx: EvalCtx, c: Val) -> Val:
    """cast(string as date): each dictionary value parsed once on the host
    (ISO `yyyy-mm-dd`, the first ten characters after trimming; anything
    else is NULL), the codes gathering day numbers and validity."""
    sd = c.sdict or StringDict([""])

    def parse():
        days = np.zeros(max(len(sd.values), 1), dtype=np.int32)
        ok = np.zeros(max(len(sd.values), 1), dtype=bool)
        epoch = datetime.date(1970, 1, 1)
        for i, v in enumerate(sd.values):
            try:
                days[i] = (datetime.date.fromisoformat(v.strip()[:10])
                           - epoch).days
                ok[i] = True
            except ValueError:
                pass
        return days, ok

    dev = ctx.device
    days = ctx.aux(lambda: parse()[0],
                   lambda: sd._on("date_days", dev, lambda: parse()[0]))
    ok = _take_codes(ctx.aux(lambda: parse()[1], lambda: sd._on(
        "date_ok", dev, lambda: parse()[1])), c.data)
    return Val(date, _take_codes(days, c.data),
               ok if c.validity is None else ok & c.validity)


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
        return super().eval(ctx)

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
        return super().eval(ctx)

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
    for f in reversed(factors):
        data = data * f
    return Val(float64, data, v.validity)


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
    compare)."""
    a = l.sdict or StringDict([""])
    b = r.sdict or StringDict([""])
    allv = sorted(set(a.values) | set(b.values))
    pos = {v: i for i, v in enumerate(allv)}
    la = np.array([pos[v] for v in a.values] or [0], dtype=np.int64)
    lb = np.array([pos[v] for v in b.values] or [0], dtype=np.int64)
    return (_take_codes(ctx.aux(lambda: la), l.data),
            _take_codes(ctx.aux(lambda: lb), r.data))


class BinaryComparison(BinaryExpression):
    @property
    def dtype(self):
        return boolean

    def eval(self, ctx):
        l = ctx.eval(self.left)
        r = ctx.eval(self.right)
        if isinstance(l.dtype, StringType) and isinstance(r.dtype,
                                                          StringType):
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


class Sqrt(UnaryExpression):
    """sqrt(x) in float64; a negative input is NULL (the reference's domain
    check). Correctly rounded on both devices, so they agree bit for bit:
    CUDA's sqrt is, torch's vectorised CPU sqrt is not (it misrounds about
    one double in eight), numpy's is."""

    @property
    def dtype(self):
        return float64

    def eval(self, ctx):
        c = ctx.eval(self.child)
        x = cast_val(ctx, c, float64).data
        ok = x >= 0
        x = torch.where(ok, x, torch.ones_like(x))
        v = ok if c.validity is None else (c.validity & ok)
        if x.device.type == "cpu":
            data = torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
        else:
            data = torch.sqrt(x)
        return Val(float64, data, v)


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
        if isinstance(out, StringType):
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
        return Val(string, data, valid if has_null else None, merged)


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
        # times 1/f, as the reference's compiled division by f (cast_val)
        d = torch.trunc(x * f + torch.where(x >= 0, 0.5, -0.5)) * (1.0 / f)
        return Val(float64, d, c.validity)


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

    def transform(self, s: str) -> str:
        raise NotImplementedError

    def eval(self, ctx):
        c = ctx.eval(self.child)
        if not isinstance(c.dtype, StringType):
            raise NotPortedError(
                f"{self.sql_name()} of {c.dtype.simple_string()} (a cast "
                "to string)")
        src = c.sdict or StringDict([""])
        key = self.simple_string()
        mapped, lut = src.transformed(key, self.transform)
        if lut is None:
            if not ctx.fused:
                return Val(string, c.data, c.validity, mapped)
            lut = np.arange(max(len(src.values), 1), dtype=np.int32)
        codes = ctx.aux(lambda: lut, lambda: src._on(
            ("recode", key), ctx.device, lambda: lut))
        return Val(string, _take_codes(codes, c.data), c.validity, mapped)


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
        c = ctx.eval(self.child)
        sd = c.sdict or StringDict([""])

        def make_lut():
            m = self.matcher()
            return np.array([bool(m(v)) for v in (sd.values or [""])], bool)

        lut = ctx.aux(make_lut, lambda: sd._on(
            f"{type(self).__name__}:{self.pattern}", ctx.device, make_lut))
        return Val(boolean, _take_codes(lut, c.data), c.validity)


class Like(_StringPredicate):
    def matcher(self):
        rx = re.compile(_like_to_regex(self.pattern), re.DOTALL)
        return lambda s: rx.match(s) is not None


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
    end of the target month (2000-01-31 + 1 month = 2000-02-29)."""
    if not isinstance(side.dtype, DateType):
        raise TypeCheckError(
            f"cannot add INTERVAL to {side.dtype.simple_string()}")
    data = side.data
    if iv.days or iv.micros:
        data = data + (iv.days + iv.micros // 86_400_000_000)
    if iv.months:
        y, m, d = _civil_from_days(data)
        total = (y.to(torch.int64) * 12 + (m - 1)) + iv.months
        ny = _floordiv(total, 12).to(torch.int32)
        nm = (torch.remainder(total, 12) + 1).to(torch.int32)
        nmt = total + 1
        nmy = _floordiv(nmt, 12).to(torch.int32)
        nmm = (torch.remainder(nmt, 12) + 1).to(torch.int32)
        one = torch.ones_like(nm)
        dim = _days_from_civil(nmy, nmm, one) - _days_from_civil(ny, nm, one)
        data = _days_from_civil(ny, nm, torch.minimum(d, dim))
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
